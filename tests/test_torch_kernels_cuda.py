"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (with a reason) where no CUDA device is
present, so they count nothing in a CPU-only run.  On a machine with a card:
``python -m pytest tests/test_torch_kernels_cuda.py -q``.  Tolerances: bf16
outputs atol = rtol = 2e-2 (a bf16 ulp or two, the sums run in another
order); fp32 atol = rtol = 1e-4.
"""

import pytest
import torch

from procedurevrl_torch.ops import _build
from procedurevrl_torch.ops import spatial_attention as k1
from procedurevrl_torch.ops import temporal_attention as k2

pytestmark = pytest.mark.cuda
TOLS = {torch.bfloat16: dict(atol=2e-2, rtol=2e-2),
        torch.float32: dict(atol=1e-4, rtol=1e-4)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [196, 49, 220])
def test_spatial_kernel_matches_plain(card, dtype, n):
    g = torch.Generator(device=card).manual_seed(n)
    qkv = torch.randn(6, n, 3 * 256, generator=g, device=card).to(dtype)
    qkv_c = torch.randn(6, 1, 3 * 256, generator=g, device=card).to(dtype)
    before = _build.LAUNCHES.get(k1.KERNEL, 0)
    out, out_c = k1.spatial_attention(qkv, qkv_c, 4, 0.125)
    assert _build.LAUNCHES[k1.KERNEL] == before + 1
    ref, ref_c = k1.spatial_attention_plain(qkv, qkv_c, 4, 0.125)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])
    torch.testing.assert_close(out_c.float(), ref_c.float(), **TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [8, 1, 16])
def test_temporal_kernel_matches_plain(card, dtype, t):
    g = torch.Generator(device=card).manual_seed(t)
    qkv = torch.randn(3, t, 50, 3 * 256, generator=g, device=card).to(dtype)
    before = _build.LAUNCHES.get(k2.KERNEL, 0)
    out = k2.temporal_attention(qkv, 4, 0.125)
    assert _build.LAUNCHES[k2.KERNEL] == before + 1
    ref = k2.temporal_attention_plain(qkv, 4, 0.125)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])
