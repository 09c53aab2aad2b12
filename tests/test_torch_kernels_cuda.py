"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (with a reason) where no CUDA device is
present, so they count nothing in a CPU-only run.  On a machine with a card:
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q``.
Tolerances: bf16 outputs atol = rtol = 2e-2 (a bf16 ulp or two, the sums
run in another order); fp32 atol = rtol = 1e-4.  Gradients are compared
with the atol scaled by the reference's largest magnitude: a ds value that
rounds to the neighbouring bf16 value moves every product it feeds by one
bf16 ulp of that product's scale.
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


def _close(got, ref, dtype, scaled=False):
    torch.cuda.synchronize()
    tol = dict(TOLS[dtype])
    if scaled:
        tol["atol"] *= max(ref.float().abs().max().item(), 1.0)
    torch.testing.assert_close(got.float(), ref.float(), **tol)


def _spatial_inputs(card, dtype, n, bt=6, heads=4, seed=0):
    g = torch.Generator(device=card).manual_seed(seed + n)
    c = heads * 64

    def r(*shape):
        return torch.randn(*shape, generator=g, device=card).to(dtype)

    return r(bt, n, 3 * c), r(bt, 1, 3 * c), r(bt, n, c), r(bt, 1, c)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [196, 49, 220])
def test_spatial_kernel_matches_plain(card, dtype, n):
    qkv, qkv_c, _, _ = _spatial_inputs(card, dtype, n)
    before = _build.LAUNCHES.get(k1.KERNEL, 0)
    out, out_c = k1.spatial_attention(qkv, qkv_c, 4, 0.125)
    assert _build.LAUNCHES[k1.KERNEL] == before + 1
    ref, ref_c = k1.spatial_attention_plain(qkv, qkv_c, 4, 0.125)
    _close(out, ref, dtype)
    _close(out_c, ref_c, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [196, 49, 220])
def test_spatial_probs_kernel_matches_plain(card, dtype, n):
    qkv, qkv_c, _, _ = _spatial_inputs(card, dtype, n)
    before = _build.LAUNCHES.get(k1.KERNEL_PROBS, 0)
    out, out_c, probs = k1.spatial_attention_fwd_probs(qkv, qkv_c, 4, 0.125)
    assert _build.LAUNCHES[k1.KERNEL_PROBS] == before + 1
    ref, ref_c, ref_p = k1.spatial_attention_fwd_probs_plain(qkv, qkv_c, 4,
                                                             0.125)
    assert probs.shape == ref_p.shape == (6, 4, n + 1, k1.probs_stride(n + 1))
    _close(out, ref, dtype)
    _close(out_c, ref_c, dtype)
    _close(probs, ref_p, dtype)
    # the padding columns are written as zeros
    assert not probs[..., n + 1:].any()
    # the forward-only kernel gives the same outputs
    f, fc = k1.spatial_attention(qkv, qkv_c, 4, 0.125)
    torch.testing.assert_close(f, out, atol=0, rtol=0)
    torch.testing.assert_close(fc, out_c, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [196, 49, 207])
def test_spatial_bwd_kernel_matches_plain(card, dtype, n):
    qkv, qkv_c, g, gc = _spatial_inputs(card, dtype, n, seed=1)
    _, _, probs = k1.spatial_attention_fwd_probs_plain(qkv, qkv_c, 4, 0.125)
    before = _build.LAUNCHES.get(k1.KERNEL_BWD, 0)
    dx, dx_c = k1.spatial_attention_bwd(qkv, qkv_c, probs, g, gc, 4, 0.125)
    assert _build.LAUNCHES[k1.KERNEL_BWD] == before + 1
    ref, ref_c = k1.spatial_attention_bwd_plain(qkv, qkv_c, probs, g, gc, 4,
                                                0.125)
    _close(dx, ref, dtype, scaled=True)
    _close(dx_c, ref_c, dtype, scaled=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_spatial_autograd_runs_both_kernels(card, dtype):
    qkv, qkv_c, g, gc = _spatial_inputs(card, dtype, 196, seed=2)
    qkv.requires_grad_(True)
    qkv_c.requires_grad_(True)
    counts = {k: _build.LAUNCHES.get(k, 0)
              for k in (k1.KERNEL, k1.KERNEL_PROBS, k1.KERNEL_BWD)}
    out, out_c = k1.spatial_attention_autograd(qkv, qkv_c, 4, 0.125)
    torch.autograd.backward((out, out_c), (g, gc))
    assert _build.LAUNCHES.get(k1.KERNEL, 0) == counts[k1.KERNEL]
    assert _build.LAUNCHES[k1.KERNEL_PROBS] == counts[k1.KERNEL_PROBS] + 1
    assert _build.LAUNCHES[k1.KERNEL_BWD] == counts[k1.KERNEL_BWD] + 1
    _, _, probs = k1.spatial_attention_fwd_probs_plain(qkv.detach(),
                                                       qkv_c.detach(), 4, 0.125)
    ref, ref_c = k1.spatial_attention_bwd_plain(qkv.detach(), qkv_c.detach(),
                                                probs, g, gc, 4, 0.125)
    _close(qkv.grad, ref, dtype, scaled=True)
    _close(qkv_c.grad, ref_c, dtype, scaled=True)
    with torch.no_grad():  # no grad: the forward-only kernel
        k1.spatial_attention_autograd(qkv, qkv_c, 4, 0.125)
    assert _build.LAUNCHES[k1.KERNEL] == counts[k1.KERNEL] + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [8, 1, 16])
def test_temporal_kernel_matches_plain(card, dtype, t):
    g = torch.Generator(device=card).manual_seed(t)
    qkv = torch.randn(3, t, 50, 3 * 256, generator=g, device=card).to(dtype)
    before = _build.LAUNCHES.get(k2.KERNEL, 0)
    out = k2.temporal_attention(qkv, 4, 0.125)
    assert _build.LAUNCHES[k2.KERNEL] == before + 1
    ref = k2.temporal_attention_plain(qkv, 4, 0.125)
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [8, 3, 16])
def test_temporal_bwd_kernel_matches_plain(card, dtype, t):
    gen = torch.Generator(device=card).manual_seed(10 + t)
    qkv = torch.randn(3, t, 50, 3 * 256, generator=gen, device=card).to(dtype)
    g = torch.randn(3, t, 50, 256, generator=gen, device=card).to(dtype)
    before = _build.LAUNCHES.get(k2.KERNEL_BWD, 0)
    dx = k2.temporal_attention_bwd(qkv, g, 4, 0.125)
    assert _build.LAUNCHES[k2.KERNEL_BWD] == before + 1
    ref = k2.temporal_attention_bwd_plain(qkv, g, 4, 0.125)
    _close(dx, ref, dtype, scaled=True)


def test_temporal_autograd_runs_both_kernels(card):
    gen = torch.Generator(device=card).manual_seed(3)
    qkv = torch.randn(2, 8, 50, 3 * 256, generator=gen, device=card,
                      requires_grad=True)
    g = torch.randn(2, 8, 50, 256, generator=gen, device=card)
    counts = {k: _build.LAUNCHES.get(k, 0) for k in (k2.KERNEL, k2.KERNEL_BWD)}
    k2.temporal_attention_autograd(qkv, 4, 0.125).backward(g)
    assert _build.LAUNCHES[k2.KERNEL] == counts[k2.KERNEL] + 1
    assert _build.LAUNCHES[k2.KERNEL_BWD] == counts[k2.KERNEL_BWD] + 1
    ref = k2.temporal_attention_bwd_plain(qkv.detach(), g, 4, 0.125)
    _close(qkv.grad, ref, torch.float32, scaled=True)


def _poison(card):
    """Fill freed device memory with NaN: the next outputs that
    ``torch.empty`` hands out then start as NaN, so a kernel that leaves an
    element unwritten, or reads one before writing it, shows it."""
    torch.full((64 << 20,), float("nan"), device=card)
    torch.cuda.synchronize()


@pytest.mark.parametrize("kernel", ["fwd", "fwd_probs", "bwd", "temporal_fwd",
                                    "temporal_bwd"])
def test_kernels_are_deterministic_on_stale_memory(card, kernel):
    """Ten launches, each into NaN-filled memory, give bit-identical, finite
    outputs (a substitute for compute-sanitizer's initcheck and racecheck,
    which do not run on every machine with a card)."""
    qkv, qkv_c, g, gc = _spatial_inputs(card, torch.bfloat16, 196, bt=18,
                                        heads=12, seed=7)
    probs = k1.spatial_attention_fwd_probs(qkv, qkv_c, 12, 0.125)[2]
    t_qkv = qkv.reshape(2, 9, 196, -1)
    t_g = g.reshape(2, 9, 196, -1)
    run = {
        "fwd": lambda: k1.spatial_attention(qkv, qkv_c, 12, 0.125),
        "fwd_probs": lambda: k1.spatial_attention_fwd_probs(qkv, qkv_c, 12,
                                                            0.125),
        "bwd": lambda: k1.spatial_attention_bwd(qkv, qkv_c, probs, g, gc, 12,
                                                0.125),
        "temporal_fwd": lambda: (k2.temporal_attention(t_qkv, 12, 0.125),),
        "temporal_bwd": lambda: (k2.temporal_attention_bwd(t_qkv, t_g, 12,
                                                           0.125),),
    }[kernel]
    first = None
    for _ in range(10):
        _poison(card)
        outs = [o.clone() for o in run()]
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(o).all()) for o in outs)
        if first is None:
            first = outs
        for a, b in zip(outs, first):
            assert torch.equal(a, b)
