"""Which hand-written kernel a CUDA attention call takes, and what the
wrapper refuses, checked on the CPU: the route function and the input
checks run before anything is built or launched.

The kernels themselves run only on the card (``-m gpu`` tests in
``test_torch_kernels.py``).  Here the checks get stand-ins that carry a
CUDA device, a dtype and a shape, since this machine has no CUDA tensor.
"""
import math

import jax  # noqa: F401  (every port test file imports both frameworks)
import pytest
import torch

from repro_torch.kernels import flash_attention as fa


class CudaStandIn:
    """What the checks read of a contiguous CUDA tensor."""

    def __init__(self, shape, dtype=torch.bfloat16, device="cuda:0", contiguous=True):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device(device)
        self._contiguous = contiguous

    def dim(self):
        return len(self.shape)

    def numel(self):
        return math.prod(self.shape)

    def is_contiguous(self):
        return self._contiguous


@pytest.mark.parametrize("d", [8, 16, 20, 24, 32, 64, 72, 100, 120, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_picks_the_kernel_by_dtype_and_head_dim(dtype, d):
    want = "sm90" if dtype == torch.bfloat16 and d % 8 == 0 else "simt"
    assert fa.route(dtype, d) == want
    # a base TMA cannot address sends bf16 to the CUDA-core kernel too
    assert fa.route(dtype, d, aligned=False) == "simt"


def test_routes_are_counted_apart():
    assert set(fa.flash_attention.route_launches) == set(fa.ROUTES) == {"sm90", "simt"}
    assert fa.SOURCE.name == "flash_attention.cu"
    assert fa.SOURCE_SM90.name == "flash_attention_sm90.cu"
    assert fa.SOURCE.exists() and fa.SOURCE_SM90.exists()


@pytest.mark.parametrize("q,k,causal,q_offset,want", [
    ((2, 8, 17, 64), (2, 2, 300, 64), True, 283, (2, 8, 2, 17, 300, 64)),
    ((8, 20, 448, 64), (8, 20, 448, 64), True, 0, (8, 20, 20, 448, 448, 64)),
    ((1, 2, 300, 128), (1, 2, 140, 128), False, -160, (1, 2, 2, 300, 140, 128)),
    ((1, 4, 130, 20), (1, 2, 130, 20), True, 0, (1, 4, 2, 130, 130, 20)),
])
def test_check_accepts_what_a_kernel_takes(q, k, causal, q_offset, want):
    qs, ks = CudaStandIn(q), CudaStandIn(k)
    assert fa._check(qs, ks, CudaStandIn(k), causal, q_offset) == want


@pytest.mark.parametrize("case,error,match", [
    ("cpu", ValueError, "CUDA"),
    ("float16", TypeError, "float32 or all bfloat16"),
    ("mixed dtypes", TypeError, "float32 or all bfloat16"),
    ("not contiguous", ValueError, "contiguous"),
    ("head dim 136", ValueError, "head dim"),
    ("causal before the keys", ValueError, "q_offset"),
    ("groups", ValueError, "Hq % Hkv"),
])
def test_check_refuses_what_no_kernel_takes(case, error, match):
    q, k, v = (CudaStandIn((1, 4, 8, 16)), CudaStandIn((1, 2, 8, 16)),
               CudaStandIn((1, 2, 8, 16)))
    causal, q_offset = True, 0
    if case == "cpu":
        q = torch.zeros((1, 4, 8, 16))
    elif case == "float16":
        q, k, v = (CudaStandIn(t.shape, torch.float16) for t in (q, k, v))
    elif case == "mixed dtypes":
        v = CudaStandIn(v.shape, torch.float32)
    elif case == "not contiguous":
        k = CudaStandIn(k.shape, contiguous=False)
    elif case == "head dim 136":
        q, k, v = (CudaStandIn(t.shape[:3] + (136,)) for t in (q, k, v))
    elif case == "causal before the keys":
        q_offset = -1
    elif case == "groups":
        k = v = CudaStandIn((1, 3, 8, 16))
    with pytest.raises(error, match=match):
        fa._check(q, k, v, causal, q_offset)


def test_refused_calls_build_and_launch_nothing():
    q = torch.zeros((1, 2, 4, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q)
    half = CudaStandIn((1, 2, 4, 8), torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(half, half, half)
    wide = CudaStandIn((1, 2, 4, 136))
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(wide, wide, wide)
    short = CudaStandIn((1, 2, 4, 64)), CudaStandIn((1, 2, 3, 64))
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention(short[0], short[1], short[1], causal=True)
    assert fa._LIB is None and fa._LIB_SM90 is None
    assert fa.flash_attention.route_launches == {"sm90": 0, "simt": 0}
    assert fa.flash_attention.launches == 0
