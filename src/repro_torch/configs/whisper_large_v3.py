"""whisper-large-v3 [audio] — enc-dec, conv/mel frontend stubbed.
[arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,             # encoder layers
    dec_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv=20,
    d_ff=5120,
    vocab=51866,
    encdec=True,
    dec_len=448,
)
