"""PyTorch / CUDA port of ``repro`` for NVIDIA Hopper (H100).

The module layout mirrors ``src/repro`` so each file has a named
counterpart in the JAX reference.  The package imports ``torch`` and
numpy only — never ``jax`` and nothing of ``repro`` — and its entry
points run on the CUDA device unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`).

Ported so far: the default simulation's main path — trace generation,
the monitor, the batched GP forecaster with its hand-written CUDA Gram
kernel, the Eq. 9 safeguard, the three shaping policies and the host
engine ``repro_torch.sim.engine.run_sim`` — and Whisper-large-v3 serving
(``repro_torch.models``, ``repro_torch.serve``), whose teacher-forced
decoder runs the hand-written CUDA flash-attention kernel.
"""
