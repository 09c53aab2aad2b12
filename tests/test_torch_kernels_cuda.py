"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (with a reason) where no CUDA device is
present, so they count nothing in a CPU-only run.  On a machine with a card:
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q``.
Tolerances: bf16 outputs atol = rtol = 2e-2 (a bf16 ulp or two, the sums
run in another order); fp32 atol = rtol = 1e-4.  Gradients are compared
with the atol scaled by the reference's largest magnitude: a ds value that
rounds to the neighbouring bf16 value moves every product it feeds by one
bf16 ulp of that product's scale.  The MViT forwards are held tighter
(the same limits as ``chip_smoke.py``): bf16 outputs atol 1e-3, rtol 1e-2
(one bf16 ulp is at most 2^-7 of a value), row sums rtol 1e-4, K7's
log-sum-exp atol 1e-4.  K8's bf16 outputs (the pool and its dx) are held
to atol 1e-3, rtol 1e-2 as well (kernel and plain version round the same
fp32 sums; the dx limit scaled like a gradient's), its fp32 dw to the fp32
limit scaled by the largest gradient, and K8dw must repeat bit for bit.  K6sp's bf16 probabilities are
held to atol 1e-5, rtol 1e-2 (one bf16 ulp; a cls probability is ~1/kN).
The bf16 gradients of K5bd, K6bd and K6bs are held to atol 2e-3 times each
gradient's own largest magnitude, with no floor, and rtol 1e-2 (the
``MVIT_GRAD_TOL`` of ``chip_smoke.py``).  The slice 7 pair (K4, K3 and
K1's long range, ``ops/flash_attention.py``) is held as ``chip_smoke.py``
holds it: bf16 outputs atol 1e-3, rtol 1e-2, its row sums rtol 1e-4, its
bf16 gradients to ``MVIT_GRAD_TOL``.
"""

import pytest
import torch

from procedurevrl_torch.ops import _build
from procedurevrl_torch.ops import depthwise_pool as k8
from procedurevrl_torch.ops import flash_attention as fa
from procedurevrl_torch.ops import mvit_attention as k5
from procedurevrl_torch.ops import spatial_attention as k1
from procedurevrl_torch.ops import temporal_attention as k2

pytestmark = pytest.mark.cuda
TOLS = {torch.bfloat16: dict(atol=2e-2, rtol=2e-2),
        torch.float32: dict(atol=1e-4, rtol=1e-4)}
MVIT_FWD_TOLS = {torch.bfloat16: dict(atol=1e-3, rtol=1e-2),
                 torch.float32: TOLS[torch.float32]}
ROWSUM_TOL = dict(atol=0.0, rtol=1e-4)
LSE_TOL = dict(atol=1e-4, rtol=0.0)
PROBS_TOLS = {torch.bfloat16: dict(atol=1e-5, rtol=1e-2),
              torch.float32: TOLS[torch.float32]}
POOL_TOLS = {torch.bfloat16: dict(atol=1e-3, rtol=1e-2),
             torch.float32: TOLS[torch.float32]}
MVIT_GRAD_TOL = dict(atol=2e-3, rtol=1e-2)


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


def _close_grad(got, ref, dtype):
    """A slice 6 backward's gradient: bf16 against its own scale."""
    if dtype == torch.float32:
        return _close(got, ref, dtype, scaled=True)
    torch.cuda.synchronize()
    top = ref.float().abs().max().item()
    torch.testing.assert_close(got.float(), ref.float(),
                               atol=MVIT_GRAD_TOL["atol"] * top,
                               rtol=MVIT_GRAD_TOL["rtol"])


def _spatial_inputs(card, dtype, n, bt=6, heads=4, seed=0):
    g = torch.Generator(device=card).manual_seed(seed + n)
    c = heads * 64

    def r(*shape):
        return torch.randn(*shape, generator=g, device=card).to(dtype)

    return r(bt, n, 3 * c), r(bt, 1, 3 * c), r(bt, n, c), r(bt, 1, c)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [196, 49, 207])
def test_spatial_kernel_matches_plain(card, dtype, n):
    qkv, qkv_c, _, _ = _spatial_inputs(card, dtype, n)
    before = _build.LAUNCHES.get(k1.KERNEL, 0)
    out, out_c = k1.spatial_attention(qkv, qkv_c, 4, 0.125)
    assert _build.LAUNCHES[k1.KERNEL] == before + 1
    ref, ref_c = k1.spatial_attention_plain(qkv, qkv_c, 4, 0.125)
    _close(out, ref, dtype)
    _close(out_c, ref_c, dtype)


def test_spatial_kernel_at_the_forecasting_batch(card):
    """K1f on the zero-shot forecasting test's batch, 16 samples x 8 clips
    x 8 frames of TimeSformer-B: qkv [1024, 196, 2304] bf16 (4.6e8
    elements, 0.93 GB; 12288 items of a frame and a head)."""
    g = torch.Generator(device=card).manual_seed(14)
    qkv = torch.randn(1024, 196, 2304, generator=g, device=card).to(
        torch.bfloat16)
    qkv_c = torch.randn(1024, 1, 2304, generator=g, device=card).to(
        torch.bfloat16)
    before = _build.LAUNCHES.get(k1.KERNEL, 0)
    out, out_c = k1.spatial_attention(qkv, qkv_c, 12, 0.125)
    assert _build.LAUNCHES[k1.KERNEL] == before + 1
    ref, ref_c = k1.spatial_attention_plain(qkv, qkv_c, 12, 0.125)
    _close(out, ref, torch.bfloat16)
    _close(out_c, ref_c, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [196, 49, 207])
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


# bt 37 of 4 heads: 148 items, more than one wave of the backward's
# persistent CTAs (one per SM) and no multiple of their count
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [196, 49, 207])
@pytest.mark.parametrize("bt", [6, 37])
def test_spatial_bwd_kernel_matches_plain(card, dtype, n, bt):
    qkv, qkv_c, g, gc = _spatial_inputs(card, dtype, n, bt=bt, seed=1)
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


def _temporal_inputs(card, dtype, b, t, n, heads, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    c = heads * 64
    qkv = torch.randn(b, t, n, 3 * c, generator=gen, device=card).to(dtype)
    g = torch.randn(b, t, n, c, generator=gen, device=card).to(dtype)
    return qkv, g


# bf16 runs the ring (16-row tiles of two positions of <= 8 frames or one
# of 9-16, groups of 4, 3, 2 or 1 heads); an odd N leaves each clip's last
# tile one position, whose rows the TMA unit fills with zeros and whose
# stores it drops
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [1, 3, 8, 9, 16])
@pytest.mark.parametrize("heads", [4, 6, 5])
def test_temporal_kernels_take_odd_n_and_every_t(card, dtype, t, heads):
    qkv, g = _temporal_inputs(card, dtype, 3, t, 49, heads, 30 + t + heads)
    counts = {k: _build.LAUNCHES.get(k, 0) for k in (k2.KERNEL,
                                                     k2.KERNEL_BWD)}
    _poison(card)
    out = k2.temporal_attention(qkv, heads, 0.125)
    _close(out, k2.temporal_attention_plain(qkv, heads, 0.125), dtype)
    _poison(card)
    dx = k2.temporal_attention_bwd(qkv, g, heads, 0.125)
    _close(dx, k2.temporal_attention_bwd_plain(qkv, g, heads, 0.125), dtype,
           scaled=True)
    assert _build.LAUNCHES[k2.KERNEL] == counts[k2.KERNEL] + 1
    assert _build.LAUNCHES[k2.KERNEL_BWD] == counts[k2.KERNEL_BWD] + 1


@pytest.mark.parametrize("t,n", [(8, 196), (16, 197)])
def test_temporal_ring_ctas_take_several_items(card, t, n):
    """More items than the card holds persistent CTAs (two an SM): each CTA
    walks several, its ring slots reused; 3 x 6 x 98 (t 8) and 3 x 6 x 197
    (t 16, odd N) items of 4 heads."""
    qkv, g = _temporal_inputs(card, torch.bfloat16, 6, t, n, 12, 40 + t)
    items = 6 * 3 * ((n + 1) // 2) if t <= 8 else 6 * 3 * n
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert items >= 4 * 2 * sms
    _poison(card)
    out = k2.temporal_attention(qkv, 12, 0.125)
    _close(out, k2.temporal_attention_plain(qkv, 12, 0.125), torch.bfloat16)
    _poison(card)
    dx = k2.temporal_attention_bwd(qkv, g, 12, 0.125)
    _close(dx, k2.temporal_attention_bwd_plain(qkv, g, 12, 0.125),
           torch.bfloat16, scaled=True)


def test_temporal_bf16_backward_runs_on_autograd_thread(card):
    """K2b's tensor maps are encoded on autograd's backward thread, which
    must bind the device's context first."""
    qkv, g = _temporal_inputs(card, torch.bfloat16, 3, 8, 49, 12, 50)
    a = qkv.clone().requires_grad_(True)
    counts = {k: _build.LAUNCHES.get(k, 0) for k in (k2.KERNEL,
                                                     k2.KERNEL_BWD)}
    k2.temporal_attention_autograd(a, 12, 0.125).backward(g)
    assert _build.LAUNCHES[k2.KERNEL] == counts[k2.KERNEL] + 1
    assert _build.LAUNCHES[k2.KERNEL_BWD] == counts[k2.KERNEL_BWD] + 1
    _close(a.grad, k2.temporal_attention_bwd_plain(qkv, g, 12, 0.125),
           torch.bfloat16, scaled=True)


@pytest.mark.parametrize("t", [8, 3, 16, 11])
def test_temporal_kernels_equal_v3_bit_for_bit(card, t):
    """K2f, K2b and K2v3 share their device functions and arithmetic order:
    in bf16 K2f's output is K2v3f's bit for bit, and K2b's K2v3b's fed
    K2v3f's p (an even N pairs the same positions in both)."""
    qkv, g = _temporal_inputs(card, torch.bfloat16, 4, t, 196, 12, 60 + t)
    out3, probs = k2.temporal_attention_v3(qkv, 12, 0.125)
    assert torch.equal(k2.temporal_attention(qkv, 12, 0.125), out3)
    assert torch.equal(k2.temporal_attention_bwd(qkv, g, 12, 0.125),
                       k2.temporal_attention_v3_bwd(qkv, probs, g, 12, 0.125))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [196, 49, 207, 130])
@pytest.mark.parametrize("bt", [6, 37])
def test_spatial_recompute_and_delta_bwd_match_plain(card, dtype, n, bt):
    qkv, qkv_c, g, gc = _spatial_inputs(card, dtype, n, bt=bt, seed=4)
    out, out_c, probs = k1.spatial_attention_fwd_probs(qkv, qkv_c, 4, 0.125)
    counts = {k: _build.LAUNCHES.get(k, 0)
              for k in (k1.KERNEL_BWD_RECOMPUTE, k1.KERNEL_BWD_DELTA)}
    dx, dx_c = k1.spatial_attention_bwd_recompute(qkv, qkv_c, g, gc, 4, 0.125)
    ref, ref_c = k1.spatial_attention_bwd_recompute_plain(qkv, qkv_c, g, gc, 4,
                                                          0.125)
    _close(dx, ref, dtype, scaled=True)
    _close(dx_c, ref_c, dtype, scaled=True)
    if dtype == torch.bfloat16:  # K1br's p is K1sp's: K1b's result exactly
        db, db_c = k1.spatial_attention_bwd(qkv, qkv_c, probs, g, gc, 4, 0.125)
        assert torch.equal(dx, db) and torch.equal(dx_c, db_c)
    dd, dd_c = k1.spatial_attention_bwd_delta(qkv, qkv_c, probs, out, out_c, g,
                                              gc, 4, 0.125)
    ref, ref_c = k1.spatial_attention_bwd_delta_plain(qkv, qkv_c, probs, out,
                                                      out_c, g, gc, 4, 0.125)
    _close(dd, ref, dtype, scaled=True)
    _close(dd_c, ref_c, dtype, scaled=True)
    for k, n0 in counts.items():
        assert _build.LAUNCHES[k] == n0 + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [196, 49, 207])
@pytest.mark.parametrize("nbuf", [1, 3, 8])
def test_spatial_pipe_equals_the_forward(card, dtype, n, nbuf):
    qkv, qkv_c, _, _ = _spatial_inputs(card, dtype, n, bt=40, seed=5)
    before = _build.LAUNCHES.get(k1.KERNEL_PIPE, 0)
    out, out_c = k1.spatial_attention_pipe(qkv, qkv_c, 4, 0.125, nbuf)
    assert _build.LAUNCHES[k1.KERNEL_PIPE] == before + 1
    assert 1 <= k1.pipe_depth(n, dtype, nbuf) <= nbuf
    ref, ref_c = k1.spatial_attention(qkv, qkv_c, 4, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and torch.equal(out_c, ref_c)
    ref, ref_c = k1.spatial_attention_pipe_plain(qkv, qkv_c, 4, 0.125)
    _close(out, ref, dtype)
    _close(out_c, ref_c, dtype)


def test_spatial_ring_rule_is_the_librarys(card):
    """The bf16 forward's ring depth as the wrapper writes it out
    (``ring_depth``, held at every shape by the CPU tests) is the built
    kernel's own (``spatial_attention_pipe_depth``)."""
    for n in range(1, k1.MAX_LEN):
        for nbuf in (1, 2, 3, 8, 9):
            assert (k1.pipe_depth(n, torch.bfloat16, nbuf)
                    == k1.ring_depth(n, nbuf)), (n, nbuf)


@pytest.mark.parametrize("n", [196, 49, 207, 63, 64])
@pytest.mark.parametrize("hot", [False, True])
def test_spatial_fwd_kernels_agree_bit_for_bit(card, n, hot):
    """K1f, K1sp and K1p (every ring depth) are one forward: the same
    outputs bit for bit; K1br recomputes K1sp's p exactly (K1b's gradients
    on it); with ``hot`` one query's logits pass the clamp at 80."""
    qkv, qkv_c, g, gc = _spatial_inputs(card, torch.bfloat16, n, bt=20,
                                        seed=7)
    if hot:
        qkv[0, 3, :64] = qkv[0, 5, 256:320] * 40  # q of head 0, its k
    out, out_c, probs = k1.spatial_attention_fwd_probs(qkv, qkv_c, 4, 0.125)
    ref, ref_c, ref_p = k1.spatial_attention_fwd_probs_plain(qkv, qkv_c, 4,
                                                             0.125)
    _close(out, ref, torch.bfloat16)
    _close(out_c, ref_c, torch.bfloat16)
    _close(probs, ref_p, torch.bfloat16)
    assert not probs[..., n + 1:].any()
    for twin in [k1.spatial_attention(qkv, qkv_c, 4, 0.125)] + [
            k1.spatial_attention_pipe(qkv, qkv_c, 4, 0.125, nbuf)
            for nbuf in (1, 2, 8)]:
        torch.cuda.synchronize()
        assert torch.equal(twin[0], out) and torch.equal(twin[1], out_c)
    dr = k1.spatial_attention_bwd_recompute(qkv, qkv_c, g, gc, 4, 0.125)
    db = k1.spatial_attention_bwd(qkv, qkv_c, probs, g, gc, 4, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(dr[0], db[0]) and torch.equal(dr[1], db[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [8, 3, 1, 16, 11, 9])
def test_temporal_v3_kernels_match_plain(card, dtype, t):
    gen = torch.Generator(device=card).manual_seed(20 + t)
    qkv = torch.randn(3, t, 49, 3 * 256, generator=gen, device=card).to(dtype)
    g = torch.randn(3, t, 49, 256, generator=gen, device=card).to(dtype)
    counts = {k: _build.LAUNCHES.get(k, 0) for k in (k2.KERNEL_V3,
                                                     k2.KERNEL_V3_BWD)}
    out, probs = k2.temporal_attention_v3(qkv, 4, 0.125)
    ref, ref_p = k2.temporal_attention_v3_fwd_plain(qkv, 4, 0.125)
    _close(out, ref, dtype)
    _close(probs, ref_p, dtype)
    same, none = k2.temporal_attention_v3(qkv, 4, 0.125, save_probs=False)
    assert none is None and torch.equal(same, out)
    dx = k2.temporal_attention_v3_bwd(qkv, probs, g, 4, 0.125)
    _close(dx, k2.temporal_attention_v3_bwd_plain(qkv, probs, g, 4, 0.125),
           dtype, scaled=True)
    assert _build.LAUNCHES[k2.KERNEL_V3] == counts[k2.KERNEL_V3] + 2
    assert _build.LAUNCHES[k2.KERNEL_V3_BWD] == counts[k2.KERNEL_V3_BWD] + 1


def test_temporal_v3_takes_16_frames_and_refuses_17(card):
    """Both dtypes take up to 16 frames (bf16 with one position per
    tensor-core tile past 8); 17 frames are refused."""
    qkv = torch.randn(1, 16, 9, 3 * 256, device=card)
    for dtype in (torch.float32, torch.bfloat16):
        out, probs = k2.temporal_attention_v3(qkv.to(dtype), 4, 0.125)
        ref, ref_p = k2.temporal_attention_v3_fwd_plain(qkv.to(dtype), 4,
                                                        0.125)
        _close(out, ref, dtype)
        _close(probs, ref_p, dtype)
    with pytest.raises(ValueError, match="T <= 16"):
        k2.temporal_attention_v3(torch.randn(1, 17, 9, 3 * 256,
                                             device=card).bfloat16(), 4, 0.125)


@pytest.mark.parametrize("route", ["A", "B"])
def test_knob_routes_run_their_kernels(card, route):
    from procedurevrl_torch.ops.attention_route import AttentionRoute

    r = (AttentionRoute(save_probs=False, pipe=True, temporal_batched=True)
         if route == "A" else AttentionRoute(delta=True))
    want = ({k1.KERNEL_PIPE: 1, k1.KERNEL_BWD_RECOMPUTE: 1, k2.KERNEL_V3: 1,
             k2.KERNEL_V3_BWD: 1} if route == "A" else
            {k1.KERNEL_PROBS: 1, k1.KERNEL_BWD_DELTA: 1, k2.KERNEL: 1,
             k2.KERNEL_BWD: 1})
    qkv, qkv_c, g, gc = _spatial_inputs(card, torch.bfloat16, 196, seed=6)
    t_qkv = torch.randn(2, 3, 196, 3 * 256, device=card).bfloat16()
    before = dict(_build.LAUNCHES)
    qkv.requires_grad_(True)
    t_qkv.requires_grad_(True)
    out, out_c = k1.spatial_attention_autograd(qkv, qkv_c, 4, 0.125, r)
    t_out = k2.temporal_attention_autograd(t_qkv, 4, 0.125, r)
    torch.autograd.backward((out, out_c, t_out),
                            (g, gc, torch.ones_like(t_out)))
    torch.cuda.synchronize()
    ran = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
           if v != before.get(k, 0)}
    assert ran == want


# (B, H, qN, k_shape): ragged query tails and key counts (kN + 1 = 25, 393,
# 1569 are no multiples of 8 or 64)
MVIT_GEOMS = {"small": (2, 2, 70, (2, 3, 4)), "block4": (2, 4, 1568, (8, 7, 7)),
              "wide": (1, 2, 392, (8, 14, 14)),
              "wide_odd": (3, 2, 300, (8, 14, 14))}


def _mvit_inputs(card, dtype, geom, head_last, seed=0, hot=True):
    """q, k, v, kc, vc, rel, g of a head-last call [B, L, H*96] or of its
    head-split fold [B*H, L, 96]; with ``hot`` one query row has logits
    above 80."""
    b, h, qn, k_shape = MVIT_GEOMS[geom]
    kn, kcat = k_shape[0] * k_shape[1] * k_shape[2], sum(k_shape)
    if not head_last:
        b, h = b * h, 1
    gen = torch.Generator(device=card).manual_seed(seed + qn)

    def r(*shape):
        return (0.5 * torch.randn(*shape, generator=gen, device=card)).to(dtype)

    c = h * 96
    x = [r(b, qn, c), r(b, kn, c), r(b, kn, c), r(b, 1, c), r(b, 1, c),
         r(b, qn, h * kcat), r(b, qn, c)]
    if hot:
        x[0][0, 5] = x[1][0, 3] * 40
    return x, k_shape, h


def _mvit_fwd(head_last):
    return ((k5.mvit_attention_hl_fwd, k5.mvit_attention_hl_fwd_plain,
             k5.KERNEL_HL) if head_last else
            (k5.mvit_attention_fwd, k5.mvit_attention_fwd_plain, k5.KERNEL))


def _mvit_bwd(head_last):
    return ((k5.mvit_attention_hl_bwd, k5.mvit_attention_hl_bwd_plain,
             k5.KERNEL_HL_BWD) if head_last else
            (k5.mvit_attention_bwd, k5.mvit_attention_bwd_plain,
             k5.KERNEL_BWD))


def _heads(fn_args, head_last, h):
    return fn_args + ((h,) if head_last else ())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("head_last", [True, False])
@pytest.mark.parametrize("geom", ["small", "block4", "wide"])
def test_mvit_fwd_kernel_matches_plain(card, dtype, head_last, geom):
    x, k_shape, h = _mvit_inputs(card, dtype, geom, head_last)
    kernel, plain, name = _mvit_fwd(head_last)
    args = _heads((*x[:6], k_shape), head_last, h) + (96 ** -0.5,)
    before = _build.LAUNCHES.get(name, 0)
    out, rowsum = kernel(*args)
    assert _build.LAUNCHES[name] == before + 1
    ref, ref_rs = plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **MVIT_FWD_TOLS[dtype])
    torch.testing.assert_close(rowsum, ref_rs, **ROWSUM_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("head_last", [True, False])
@pytest.mark.parametrize("geom", ["small", "block4", "wide"])
def test_mvit_bwd_kernel_matches_plain(card, dtype, head_last, geom):
    x, k_shape, h = _mvit_inputs(card, dtype, geom, head_last, seed=1)
    _, plain_fwd, _ = _mvit_fwd(head_last)
    kernel, plain, name = _mvit_bwd(head_last)
    scale = 96 ** -0.5
    rowsum = plain_fwd(*_heads((*x[:6], k_shape), head_last, h), scale)[1]
    args = _heads((*x[:6], rowsum, x[6], k_shape), head_last, h) + (scale,)
    before = _build.LAUNCHES.get(name, 0)
    grads = kernel(*args)
    assert _build.LAUNCHES[name] == before + 1
    for got, ref in zip(grads, plain(*args)):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        _close(got, ref, dtype, scaled=True)


@pytest.mark.parametrize("head_last", [True, False])
def test_mvit_autograd_runs_both_kernels(card, head_last):
    x, k_shape, h = _mvit_inputs(card, torch.float32, "small", head_last,
                                 seed=2)
    inputs = [t.requires_grad_(True) for t in x[:6]]
    fwd_name, bwd_name = _mvit_fwd(head_last)[2], _mvit_bwd(head_last)[2]
    counts = {k: _build.LAUNCHES.get(k, 0) for k in (fwd_name, bwd_name)}
    scale = 96 ** -0.5
    if head_last:
        out = k5.mvit_attention_hl(*inputs, k_shape, h, scale)
    else:
        out = k5.mvit_attention(*inputs, k_shape, scale)
    out.backward(x[6])
    assert _build.LAUNCHES[fwd_name] == counts[fwd_name] + 1
    assert _build.LAUNCHES[bwd_name] == counts[bwd_name] + 1
    plain_fwd, plain_bwd = _mvit_fwd(head_last)[1], _mvit_bwd(head_last)[1]
    detached = [t.detach() for t in inputs]
    rowsum = plain_fwd(*_heads((*detached, k_shape), head_last, h), scale)[1]
    refs = plain_bwd(*_heads((*detached, rowsum, x[6], k_shape), head_last, h),
                     scale)
    for t, ref in zip(inputs, refs):
        _close(t.grad, ref, torch.float32, scaled=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("head_last", [True, False])
@pytest.mark.parametrize("geom", ["small", "block4", "wide"])
def test_mvit_delta_bwd_kernel_matches_plain(card, dtype, head_last, geom):
    """K5bd / K6bd from the plain forward's row sums and output."""
    x, k_shape, h = _mvit_inputs(card, dtype, geom, head_last, seed=3)
    _, plain_fwd, _ = _mvit_fwd(head_last)
    scale = 96 ** -0.5
    out, rowsum = plain_fwd(*_heads((*x[:6], k_shape), head_last, h), scale)
    args = _heads((*x[:6], rowsum, out, x[6], k_shape), head_last, h) + (scale,)
    if head_last:
        kernel, plain = (k5.mvit_attention_hl_bwd_delta,
                         k5.mvit_attention_hl_bwd_delta_plain)
        name = k5.KERNEL_HL_BWD_DELTA
    else:
        kernel, plain = k5.mvit_attention_bwd_delta, k5.mvit_attention_bwd_delta_plain
        name = k5.KERNEL_BWD_DELTA
    before = _build.LAUNCHES.get(name, 0)
    grads = kernel(*args)
    assert _build.LAUNCHES[name] == before + 1
    for got, ref in zip(grads, plain(*args)):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        _close_grad(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("geom", ["small", "block4", "wide"])
def test_mvit_probs_kernels_match_plain(card, dtype, geom):
    """K6sp: K6f's output bit for bit, and the probabilities; K6bs from the
    plain version's probabilities."""
    x, k_shape, _ = _mvit_inputs(card, dtype, geom, False, seed=4)
    scale = 96 ** -0.5
    args = (*x[:6], k_shape, scale)
    counts = {k: _build.LAUNCHES.get(k, 0)
              for k in (k5.KERNEL_PROBS, k5.KERNEL_BWD_PROBS)}
    out, rowsum, probs = k5.mvit_attention_fwd_probs(*args)
    ref, ref_rs, ref_p = k5.mvit_attention_fwd_probs_plain(*args)
    torch.cuda.synchronize()
    kn = x[1].shape[1]
    assert probs.shape == ref_p.shape == (*out.shape[:2], k5.probs_stride(kn))
    assert torch.equal(out, k5.mvit_attention_fwd(*args)[0])
    torch.testing.assert_close(out.float(), ref.float(), **MVIT_FWD_TOLS[dtype])
    torch.testing.assert_close(rowsum, ref_rs, **ROWSUM_TOL)
    torch.testing.assert_close(probs.float(), ref_p.float(), **PROBS_TOLS[dtype])
    assert not probs[..., kn + 1:].any()
    bargs = (*x[:6], ref_p, x[6], k_shape, scale)
    for got, want in zip(k5.mvit_attention_bwd_probs(*bargs),
                         k5.mvit_attention_bwd_probs_plain(*bargs)):
        _close_grad(got, want, dtype)
    assert _build.LAUNCHES[k5.KERNEL_PROBS] == counts[k5.KERNEL_PROBS] + 1
    assert (_build.LAUNCHES[k5.KERNEL_BWD_PROBS]
            == counts[k5.KERNEL_BWD_PROBS] + 1)


def _mvit_inputs_d(card, geom, head_last, d, seed=0):
    """``_mvit_inputs`` in bf16 at head dim ``d``, one query row's logits
    above 80."""
    b, h, qn, k_shape = MVIT_GEOMS[geom]
    kn, kcat = k_shape[0] * k_shape[1] * k_shape[2], sum(k_shape)
    if not head_last:
        b, h = b * h, 1
    gen = torch.Generator(device=card).manual_seed(seed + qn + d)

    def r(*shape):
        return (0.5 * torch.randn(*shape, generator=gen, device=card)
                ).bfloat16()

    c = h * d
    x = [r(b, qn, c), r(b, kn, c), r(b, kn, c), r(b, 1, c), r(b, 1, c),
         r(b, qn, h * kcat)]
    x[0][0, 5] = x[1][0, 3] * 40
    return x, k_shape, h


@pytest.mark.parametrize("d", [64, 72, 96, 128])
@pytest.mark.parametrize("head_last", [True, False])
@pytest.mark.parametrize("geom", ["small", "block4"])
def test_mvit_fwd_head_dims_match_plain(card, d, head_last, geom):
    """The bf16 forward (three warpgroups of 64 query rows, qN = 70 and
    1568 no multiple of their 192; kN + 1 = 25 and 393 no multiple of the
    64-key tile) at the tile widths 64, 96 (d = 72 and 96) and 128, with a
    logit above 80, against its plain version; K6sp's out and l equal
    K6f's bit for bit and its p the plain version's."""
    x, k_shape, h = _mvit_inputs_d(card, geom, head_last, d)
    kernel, plain, _ = _mvit_fwd(head_last)
    args = _heads((*x, k_shape), head_last, h) + (d ** -0.5,)
    out, rowsum = kernel(*args)
    ref, ref_rs = plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(),
                               **MVIT_FWD_TOLS[torch.bfloat16])
    torch.testing.assert_close(rowsum, ref_rs, **ROWSUM_TOL)
    if head_last:
        return
    po, prs, probs = k5.mvit_attention_fwd_probs(*args)
    _, _, ref_p = k5.mvit_attention_fwd_probs_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(po, out) and torch.equal(prs, rowsum)
    torch.testing.assert_close(probs.float(), ref_p.float(),
                               **PROBS_TOLS[torch.bfloat16])
    assert not probs[..., x[1].shape[1] + 1:].any()


@pytest.mark.parametrize("route", ["C", "D"])
@pytest.mark.parametrize("head_last", [True, False])
def test_mvit_knob_autograd_runs_their_kernels(card, route, head_last):
    """Under grad, ``delta`` (route C) and ``save_probs`` (route D, which
    the head-last K5 ignores) select the kernels of JAX ``_vjp_fwd`` /
    ``_vjp_hl_fwd``."""
    x, k_shape, h = _mvit_inputs(card, torch.bfloat16, "small", head_last,
                                 seed=5)
    inputs = [t.requires_grad_(True) for t in x[:6]]
    scale = 96 ** -0.5
    before = dict(_build.LAUNCHES)
    if head_last:
        out = k5.mvit_attention_hl(*inputs, k_shape, h, scale, True)
        want = {k5.KERNEL_HL: 1, k5.KERNEL_HL_BWD_DELTA: 1}
    else:
        out = k5.mvit_attention(*inputs, k_shape, scale, True, route == "D")
        want = ({k5.KERNEL: 1, k5.KERNEL_BWD_DELTA: 1} if route == "C"
                else {k5.KERNEL_PROBS: 1, k5.KERNEL_BWD_PROBS: 1})
    out.backward(x[6])
    torch.cuda.synchronize()
    ran = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
           if v != before.get(k, 0)}
    assert ran == want


def _kt_inputs(card, dtype, geom, seed=0, hot=True):
    """K7's head-last inputs; with ``hot`` one query row has two logits
    above 80, where the row max and the clamp part."""
    x, k_shape, h = _mvit_inputs(card, dtype, geom, True, seed, hot)
    if hot:
        x[0][0, 5] += x[1][0, 4] * 30
    return x, k_shape, h


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
# wide: kN = 1568, so the last key tile holds 33 of its 64 columns;
# wide_odd: 300 query rows, the last CTA's warpgroups partly or not active
@pytest.mark.parametrize("geom", ["small", "block4", "wide", "wide_odd"])
def test_mvit_kt_fwd_kernel_matches_plain(card, dtype, geom):
    x, k_shape, h = _kt_inputs(card, dtype, geom)
    args = (*x[:6], k_shape, h, 96 ** -0.5)
    before = _build.LAUNCHES.get(k5.KERNEL_KT, 0)
    out, lse = k5.mvit_attention_kt_fwd(*args)
    assert _build.LAUNCHES[k5.KERNEL_KT] == before + 1
    ref, ref_lse = k5.mvit_attention_kt_fwd_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **MVIT_FWD_TOLS[dtype])
    torch.testing.assert_close(lse, ref_lse, **LSE_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
# wide: kN = 1568, so the last key tile holds 33 of its 64 columns;
# wide_odd: 300 query rows, the last CTA's warpgroups partly or not active
@pytest.mark.parametrize("geom", ["small", "block4", "wide", "wide_odd"])
def test_mvit_kt_bwd_kernel_matches_plain(card, dtype, geom):
    x, k_shape, h = _kt_inputs(card, dtype, geom, seed=1)
    scale = 96 ** -0.5
    out, lse = k5.mvit_attention_kt_fwd_plain(*x[:6], k_shape, h, scale)
    args = (*x[:6], out, lse, x[6], k_shape, h, scale)
    before = _build.LAUNCHES.get(k5.KERNEL_KT_BWD, 0)
    grads = k5.mvit_attention_kt_bwd(*args)
    assert _build.LAUNCHES[k5.KERNEL_KT_BWD] == before + 1
    for got, ref in zip(grads, k5.mvit_attention_kt_bwd_plain(*args)):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        _close(got, ref, dtype, scaled=True)


def test_mvit_kt_autograd_runs_both_kernels(card):
    x, k_shape, h = _kt_inputs(card, torch.float32, "small", seed=2)
    inputs = [t.requires_grad_(True) for t in x[:6]]
    counts = {k: _build.LAUNCHES.get(k, 0)
              for k in (k5.KERNEL_KT, k5.KERNEL_KT_BWD)}
    scale = 96 ** -0.5
    k5.mvit_attention_kt(*inputs, k_shape, h, scale).backward(x[6])
    for k, n in counts.items():
        assert _build.LAUNCHES[k] == n + 1
    detached = [t.detach() for t in inputs]
    out, lse = k5.mvit_attention_kt_fwd_plain(*detached, k_shape, h, scale)
    refs = k5.mvit_attention_kt_bwd_plain(*detached, out, lse, x[6], k_shape,
                                          h, scale)
    for t, ref in zip(inputs, refs):
        _close(t.grad, ref, torch.float32, scaled=True)


# (B, T, H, W, C): MViT-v2-S block 4's grid, an odd grid, and a channel
# count that is no multiple of the kernel's 32-channel CTA slice; the five
# stride-1 pools of the MViT-v2-S training step at 18 clips; the edge cases
# of the window tiling: C = 8 and 40, unit axes, an odd W that is no
# multiple of the 7-column strip, a band of rows that does not divide H, one
# batch element, a row wider than one CTA
POOL_GEOMS = {"block4": (2, 8, 14, 14, 384), "odd": (2, 3, 7, 9, 64),
              "c160": (1, 4, 10, 10, 160),
              "step0": (18, 8, 56, 56, 96), "step2": (18, 8, 28, 28, 192),
              "step4": (18, 8, 14, 14, 384), "step14": (18, 8, 14, 14, 768),
              "step15": (18, 8, 7, 7, 768),
              "c8": (2, 3, 9, 11, 8), "c40": (2, 4, 10, 13, 40),
              "hw1": (3, 2, 1, 1, 32), "t1": (2, 1, 12, 9, 64),
              "oddw": (2, 3, 5, 9, 64), "band": (2, 3, 61, 23, 32),
              "b1": (1, 3, 10, 10, 48), "wide": (1, 2, 3, 300, 16)}


def _pool_inputs(card, dtype, geom, seed=0):
    """x as the model hands it (a view of a fused qkv product, token-row
    stride 3C), w27 and g (the shape of x)."""
    b, t, hh, ww, c = POOL_GEOMS[geom]
    gen = torch.Generator(device=card).manual_seed(seed + c)

    def r(*shape, sd=1.0):
        return (sd * torch.randn(*shape, generator=gen, device=card)).to(dtype)

    x = r(b, 1 + t * hh * ww, 3 * c)[:, 1:, c:2 * c].reshape(b, t, hh, ww, c)
    return x, r(27, c, sd=0.1), r(b, t, hh, ww, c)


def _pool_close(got, ref, dtype, scaled=False):
    torch.cuda.synchronize()
    tol = dict(POOL_TOLS[dtype])
    if scaled:
        tol["atol"] *= max(ref.float().abs().max().item(), 1.0)
    torch.testing.assert_close(got.float(), ref.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [1, 2, 4, 8])
@pytest.mark.parametrize("geom", sorted(POOL_GEOMS))
def test_pool_fwd_kernel_matches_plain(card, dtype, s, geom):
    x, w, _ = _pool_inputs(card, dtype, geom)
    assert not x.is_contiguous()
    before = _build.LAUNCHES.get(k8.KERNEL, 0)
    out = k8.depthwise_pool3d_fwd(x, w, s)
    assert _build.LAUNCHES[k8.KERNEL] == before + 1
    _pool_close(out, k8.depthwise_pool3d_taps(x, w, (1, s, s)), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("geom", sorted(POOL_GEOMS))
def test_pool_dx_and_dw_kernels_match_plain(card, dtype, geom):
    x, w, g = _pool_inputs(card, dtype, geom, seed=1)
    counts = {k: _build.LAUNCHES.get(k, 0) for k in (k8.KERNEL_DX,
                                                     k8.KERNEL_DW)}
    dx, dw = k8.depthwise_pool3d_dx(g, w), k8.depthwise_pool3d_dw(x, g)
    for k, n in counts.items():
        assert _build.LAUNCHES[k] == n + 1
    _pool_close(dx, k8.depthwise_pool3d_taps(g, w.flip(0), (1, 1, 1)), dtype,
                scaled=True)
    assert dw.dtype == torch.float32 and dw.shape == w.shape
    ref = k8.taps_dw(x, g, (1, 1, 1))
    _pool_close(dw, ref, torch.float32, scaled=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("geom", sorted(POOL_GEOMS))
def test_pool_dw_kernel_is_repeatable(card, dtype, geom):
    """K8dw sums in a fixed order (no atomics): two runs on the same inputs
    agree bit for bit."""
    x, _, g = _pool_inputs(card, dtype, geom, seed=3)
    first = k8.depthwise_pool3d_dw(x, g)
    assert torch.equal(first, k8.depthwise_pool3d_dw(x, g))


@pytest.mark.parametrize("s", [1, 2])
def test_pool_autograd_runs_the_kernels(card, s):
    """Stride 1: K8f forward, K8f on g with reversed taps for dx, K8dw; a
    strided pool: K8f forward and the tap formulas."""
    x, w, g = _pool_inputs(card, torch.float32, "odd", seed=2)
    g = g[:, :, ::s, ::s].contiguous()
    xl, wl = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    names = (k8.KERNEL, k8.KERNEL_DX, k8.KERNEL_DW)
    counts = {k: _build.LAUNCHES.get(k, 0) for k in names}
    k8.depthwise_pool3d(xl, wl, s).backward(g)
    assert [_build.LAUNCHES.get(k, 0) - counts[k] for k in names] == (
        [1, 1, 1] if s == 1 else [1, 0, 0])
    _pool_close(xl.grad, k8.taps_dx(g, w, (1, s, s), x.shape[1:4]),
                torch.float32, scaled=True)
    _pool_close(wl.grad, k8.taps_dw(x, g, (1, s, s)), torch.float32,
                scaled=True)


def _poison(card):
    """Fill freed device memory with NaN: the next outputs that
    ``torch.empty`` hands out then start as NaN, so a kernel that leaves an
    element unwritten, or reads one before writing it, shows it."""
    torch.full((64 << 20,), float("nan"), device=card)
    torch.cuda.synchronize()


@pytest.mark.parametrize("kernel", ["fwd", "fwd_probs", "bwd", "temporal_fwd",
                                    "temporal_bwd", "pipe", "bwd_recompute",
                                    "bwd_delta", "temporal_v3_fwd",
                                    "temporal_v3_bwd", "mvit_hl_fwd",
                                    "mvit_hl_bwd", "mvit_fwd", "mvit_bwd",
                                    "mvit_kt_fwd", "mvit_kt_bwd", "pool_fwd",
                                    "pool_dx", "pool_dw", "mvit_hl_bwd_delta",
                                    "mvit_bwd_delta", "mvit_fwd_probs",
                                    "mvit_bwd_probs", "temporal_v3_fwd_16",
                                    "temporal_v3_bwd_16", "temporal_fwd_16",
                                    "temporal_bwd_16"])
def test_kernels_are_deterministic_on_stale_memory(card, kernel):
    """Ten launches, each into NaN-filled memory, give bit-identical, finite
    outputs (a substitute for compute-sanitizer's initcheck and racecheck,
    which do not run on every machine with a card)."""
    qkv, qkv_c, g, gc = _spatial_inputs(card, torch.bfloat16, 196, bt=18,
                                        heads=12, seed=7)
    out, out_c, probs = k1.spatial_attention_fwd_probs(qkv, qkv_c, 12, 0.125)
    t_qkv = qkv.reshape(3, 6, 196, -1)
    t_g = g.reshape(3, 6, 196, -1)
    t_probs = k2.temporal_attention_v3(t_qkv, 12, 0.125)[1]
    scale = 96 ** -0.5
    m_hl, ks_hl, h_hl = _mvit_inputs(card, torch.bfloat16, "block4", True,
                                     seed=7, hot=False)
    m_hs, ks_hs, _ = _mvit_inputs(card, torch.bfloat16, "wide", False,
                                  seed=7, hot=False)
    rs_hl = k5.mvit_attention_hl_fwd(*m_hl[:6], ks_hl, h_hl, scale)[1]
    o_hl = k5.mvit_attention_hl_fwd(*m_hl[:6], ks_hl, h_hl, scale)[0]
    o_hs, rs_hs, p_hs = k5.mvit_attention_fwd_probs(*m_hs[:6], ks_hs, scale)
    gen16 = torch.Generator(device=card).manual_seed(16)
    t16_qkv = torch.randn(2, 16, 49, 3 * 768, generator=gen16,
                          device=card).bfloat16()
    t16_g = torch.randn(2, 16, 49, 768, generator=gen16,
                        device=card).bfloat16()
    t16_probs = k2.temporal_attention_v3(t16_qkv, 12, 0.125)[1]
    m_kt, ks_kt, h_kt = _kt_inputs(card, torch.bfloat16, "wide", seed=7,
                                   hot=False)
    o_kt, lse_kt = k5.mvit_attention_kt_fwd(*m_kt[:6], ks_kt, h_kt, scale)
    px, pw, pg = _pool_inputs(card, torch.bfloat16, "block4", seed=7)
    run = {
        "fwd": lambda: k1.spatial_attention(qkv, qkv_c, 12, 0.125),
        "fwd_probs": lambda: k1.spatial_attention_fwd_probs(qkv, qkv_c, 12,
                                                            0.125),
        "bwd": lambda: k1.spatial_attention_bwd(qkv, qkv_c, probs, g, gc, 12,
                                                0.125),
        "temporal_fwd": lambda: (k2.temporal_attention(t_qkv, 12, 0.125),),
        "temporal_bwd": lambda: (k2.temporal_attention_bwd(t_qkv, t_g, 12,
                                                           0.125),),
        "pipe": lambda: k1.spatial_attention_pipe(qkv, qkv_c, 12, 0.125),
        "bwd_recompute": lambda: k1.spatial_attention_bwd_recompute(
            qkv, qkv_c, g, gc, 12, 0.125),
        "bwd_delta": lambda: k1.spatial_attention_bwd_delta(
            qkv, qkv_c, probs, out, out_c, g, gc, 12, 0.125),
        "temporal_v3_fwd": lambda: k2.temporal_attention_v3(t_qkv, 12, 0.125),
        "temporal_v3_bwd": lambda: (k2.temporal_attention_v3_bwd(
            t_qkv, t_probs, t_g, 12, 0.125),),
        "mvit_hl_fwd": lambda: k5.mvit_attention_hl_fwd(*m_hl[:6], ks_hl, h_hl,
                                                        scale),
        "mvit_hl_bwd": lambda: k5.mvit_attention_hl_bwd(
            *m_hl[:6], rs_hl, m_hl[6], ks_hl, h_hl, scale),
        "mvit_fwd": lambda: k5.mvit_attention_fwd(*m_hs[:6], ks_hs, scale),
        "mvit_bwd": lambda: k5.mvit_attention_bwd(*m_hs[:6], rs_hs, m_hs[6],
                                                  ks_hs, scale),
        "mvit_kt_fwd": lambda: k5.mvit_attention_kt_fwd(*m_kt[:6], ks_kt,
                                                        h_kt, scale),
        "mvit_kt_bwd": lambda: k5.mvit_attention_kt_bwd(
            *m_kt[:6], o_kt, lse_kt, m_kt[6], ks_kt, h_kt, scale),
        "pool_fwd": lambda: (k8.depthwise_pool3d_fwd(px, pw, 1),),
        "pool_dx": lambda: (k8.depthwise_pool3d_dx(pg, pw),),
        "pool_dw": lambda: (k8.depthwise_pool3d_dw(px, pg),),
        "mvit_hl_bwd_delta": lambda: k5.mvit_attention_hl_bwd_delta(
            *m_hl[:6], rs_hl, o_hl, m_hl[6], ks_hl, h_hl, scale),
        "mvit_bwd_delta": lambda: k5.mvit_attention_bwd_delta(
            *m_hs[:6], rs_hs, o_hs, m_hs[6], ks_hs, scale),
        "mvit_fwd_probs": lambda: k5.mvit_attention_fwd_probs(
            *m_hs[:6], ks_hs, scale),
        "mvit_bwd_probs": lambda: k5.mvit_attention_bwd_probs(
            *m_hs[:6], p_hs, m_hs[6], ks_hs, scale),
        "temporal_v3_fwd_16": lambda: k2.temporal_attention_v3(
            t16_qkv, 12, 0.125),
        "temporal_v3_bwd_16": lambda: (k2.temporal_attention_v3_bwd(
            t16_qkv, t16_probs, t16_g, 12, 0.125),),
        "temporal_fwd_16": lambda: (k2.temporal_attention(t16_qkv, 12,
                                                          0.125),),
        "temporal_bwd_16": lambda: (k2.temporal_attention_bwd(
            t16_qkv, t16_g, 12, 0.125),),
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


def _flash_inputs(card, dtype, b, n, heads, d, cls, seed=0):
    """q, k, v (and qc, kc, vc) as the thirds of one projection, g, gc."""
    gen = torch.Generator(device=card).manual_seed(seed + n + d)
    c = heads * d

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=card).to(dtype)

    x = list(r(b, n, 3 * c).split(c, dim=-1))
    g, gc = r(b, n, c), r(b, 1, c)
    if cls:
        x += list(r(b, 1, 3 * c).split(c, dim=-1))
    return x, g, gc


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cls", [False, True])
@pytest.mark.parametrize("n,d", [(1, 64), (63, 64), (197, 64), (255, 64),
                                 (257, 64), (1024, 64), (130, 32), (150, 96),
                                 (200, 128), (197, 16), (100, 48), (197, 80),
                                 (130, 256)])
def test_flash_kernels_match_plain(card, dtype, cls, n, d):
    heads, scale = 2, d ** -0.5
    x, g, gc = _flash_inputs(card, dtype, 3, n, heads, d, cls)
    if cls:
        got = fa.flash_attention_cls_fwd(*x, heads, scale)
        want = fa.flash_attention_cls_fwd_plain(*x, heads, scale)
        grads = fa.flash_attention_cls_bwd(*x, g, gc, got[-1], heads, scale)
        rgrads = fa.flash_attention_cls_bwd_plain(*x, g, gc, heads, scale)
        assert all(torch.equal(a, b) for a, b in zip(
            fa.flash_attention_cls(*x, heads, scale), got))
    else:
        got = fa.flash_attention_fwd(*x, heads, scale)
        want = fa.flash_attention_fwd_plain(*x, heads, scale)
        grads = fa.flash_attention_bwd(*x, g, got[-1], heads, scale)
        rgrads = fa.flash_attention_bwd_plain(*x, g, heads, scale)
        assert torch.equal(fa.flash_attention(*x, heads, scale), got[0])
    for a, r in zip(got[:-1], want[:-1]):
        torch.cuda.synchronize()
        torch.testing.assert_close(a.float(), r.float(),
                                   **MVIT_FWD_TOLS[dtype])
    torch.testing.assert_close(got[-1], want[-1], **ROWSUM_TOL)
    for a, r in zip(grads, rgrads):
        _close_grad(a, r, dtype)


def test_flash_autograd_runs_both_kernels(card):
    x, g, gc = _flash_inputs(card, torch.bfloat16, 4, 197, 12, 64, True)
    leaves = [t.detach().clone().requires_grad_(True) for t in x]
    names = (fa.KERNEL_CLS, fa.KERNEL_CLS_BWD)
    before = [_build.LAUNCHES.get(k, 0) for k in names]
    out, outc = fa.flash_attention_cls_autograd(*leaves, 12, 0.125)
    torch.autograd.backward((out, outc), (g, gc))
    assert [_build.LAUNCHES.get(k, 0) - n for k, n in zip(names, before)] == [1, 1]
    for a, r in zip(leaves, fa.flash_attention_cls_bwd_plain(*x, g, gc, 12,
                                                             0.125)):
        _close_grad(a.grad, r, torch.bfloat16)
    names = (fa.KERNEL, fa.KERNEL_BWD)
    before = [_build.LAUNCHES.get(k, 0) for k in names]
    leaves = [t.detach().clone().requires_grad_(True) for t in x[:3]]
    fa.flash_attention_autograd(*leaves, 12, 0.125).backward(g)
    assert [_build.LAUNCHES.get(k, 0) - n for k, n in zip(names, before)] == [1, 1]


def test_k1_kernels_refuse_past_208(card):
    """Every K1 wrapper stops at N + 1 = 208; the model's entry sends
    longer frames to the pair before any launch."""
    qkv, qkv_c, g, gc = _spatial_inputs(card, torch.bfloat16, 208)
    _, _, probs = k1.spatial_attention_fwd_probs_plain(qkv, qkv_c, 4, 0.125)
    for call in (lambda: k1.spatial_attention(qkv, qkv_c, 4, 0.125),
                 lambda: k1.spatial_attention_fwd_probs(qkv, qkv_c, 4, 0.125),
                 lambda: k1.spatial_attention_pipe(qkv, qkv_c, 4, 0.125),
                 lambda: k1.spatial_attention_bwd(qkv, qkv_c, probs, g, gc, 4,
                                                  0.125)):
        with pytest.raises(ValueError, match="N \\+ 1 <= 208"):
            call()


@pytest.mark.parametrize("n", [207, 208, 256, 1024])
def test_k1_long_range_takes_the_pair(card, n):
    """K1 past N + 1 = 208 runs the pair on the fused qkv (no K1 kernel),
    and holds K1's plain function."""
    qkv, qkv_c, g, gc = _spatial_inputs(card, torch.bfloat16, n, bt=4,
                                        heads=12)
    before = dict(_build.LAUNCHES)
    a = qkv.detach().clone().requires_grad_(True)
    out, out_c = k1.spatial_attention_autograd(a, qkv_c, 12, 0.125)
    torch.autograd.backward((out, out_c), (g, gc))
    delta = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
             if v != before.get(k, 0)}
    if n + 1 <= k1.MAX_LEN:
        assert delta == {k1.KERNEL_PROBS: 1, k1.KERNEL_BWD: 1}
        ro, _ = k1.spatial_attention_plain(qkv, qkv_c, 12, 0.125)
        _close(out, ro, torch.bfloat16)
        return
    assert delta == {fa.KERNEL_QKV: 1, fa.KERNEL_QKV_BWD: 1}
    ro, roc, _ = fa.flash_attention_qkv_fwd_plain(qkv, qkv_c, 12, 0.125)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ro.float(),
                               **MVIT_FWD_TOLS[torch.bfloat16])
    dq, _ = fa.flash_attention_qkv_bwd_plain(qkv, qkv_c, g, gc, 12, 0.125)
    _close_grad(a.grad, dq, torch.bfloat16)


def test_flash_refuses_what_it_does_not_take(card):
    for d in (12, 264):  # not a multiple of 8; past the widest tile: taken
        x, _, _ = _flash_inputs(card, torch.bfloat16, 2, 20, 2, d, False)
        _close(fa.flash_attention(*x, 2, 0.125),
               fa.flash_attention_plain(*x, 2, 0.125), torch.bfloat16)
    x, _, _ = _flash_inputs(card, torch.bfloat16, 1, 1025, 1, 64, False)
    with pytest.raises(ValueError, match="N <= 1024"):
        fa.flash_attention(*x, 1, 0.125)
    x, _, _ = _flash_inputs(card, torch.float16, 2, 20, 2, 64, False)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(*x, 2, 0.125)
    # rows of 132 bf16 (264 bytes), starting 8 bytes in
    q = torch.zeros(2, 20, 132, device=card, dtype=torch.bfloat16)[..., 4:]
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(q, q, q, 2, 0.125)


@pytest.mark.parametrize("kernel", ["fwd", "bwd", "cls_fwd", "cls_bwd"])
def test_flash_kernels_are_deterministic_on_stale_memory(card, kernel):
    """As ``test_kernels_are_deterministic_on_stale_memory``, for the pair."""
    x, g, gc = _flash_inputs(card, torch.bfloat16, 6, 197, 12, 64, True,
                             seed=7)
    l4 = fa.flash_attention_fwd(*x[:3], 12, 0.125)[1]
    l3 = fa.flash_attention_cls_fwd(*x, 12, 0.125)[2]
    run = {"fwd": lambda: fa.flash_attention_fwd(*x[:3], 12, 0.125),
           "bwd": lambda: fa.flash_attention_bwd(*x[:3], g, l4, 12, 0.125),
           "cls_fwd": lambda: fa.flash_attention_cls_fwd(*x, 12, 0.125),
           "cls_bwd": lambda: fa.flash_attention_cls_bwd(*x, g, gc, l3, 12,
                                                         0.125)}[kernel]
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


# ------------------------------------------- head dims other than 64 / 96


@pytest.mark.parametrize("d", [32, 128])
def test_k1_other_head_dims_take_the_pair(card, d):
    """K1's function at a head dim other than 64 runs the pair on the fused
    qkv (no K1 kernel) and holds the pair's plain version."""
    heads, bt, n = 128 // d * 2, 4, 196
    gen = torch.Generator(device=card).manual_seed(d)
    c = heads * d
    r = lambda *s: torch.randn(*s, generator=gen, device=card).bfloat16()
    qkv, qkv_c, g, gc = r(bt, n, 3 * c), r(bt, 1, 3 * c), r(bt, n, c), r(bt, 1, c)
    before = dict(_build.LAUNCHES)
    a = qkv.detach().clone().requires_grad_(True)
    out, out_c = k1.spatial_attention_autograd(a, qkv_c, heads, d ** -0.5)
    torch.autograd.backward((out, out_c), (g, gc))
    delta = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
             if v != before.get(k, 0)}
    assert delta == {fa.KERNEL_QKV: 1, fa.KERNEL_QKV_BWD: 1}
    ro, roc, _ = fa.flash_attention_qkv_fwd_plain(qkv, qkv_c, heads, d ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ro.float(),
                               **MVIT_FWD_TOLS[torch.bfloat16])
    dq, _ = fa.flash_attention_qkv_bwd_plain(qkv, qkv_c, g, gc, heads,
                                             d ** -0.5)
    _close_grad(a.grad, dq, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("d,t", [(32, 8), (128, 8), (32, 16)])
def test_k2_route_takes_the_pair(card, dtype, batched, d, t):
    """K2's function at a head dim other than 64, on either route, runs the
    pair on the time-major qkv (no K2 kernel) and holds the pair's plain
    version."""
    heads, b, n = 128 // d * 2, 2, 50
    gen = torch.Generator(device=card).manual_seed(d + t)
    c = heads * d
    qkv = torch.randn(b, t, n, 3 * c, generator=gen, device=card).to(dtype)
    g = torch.randn(b, t, n, c, generator=gen, device=card).to(dtype)
    before = dict(_build.LAUNCHES)
    a = qkv.detach().clone().requires_grad_(True)
    route = k2.AttentionRoute(temporal_batched=batched)
    out = k2.temporal_attention_autograd(a, heads, d ** -0.5, route)
    out.backward(g)
    delta = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
             if v != before.get(k, 0)}
    assert delta == {fa.KERNEL_T: 1, fa.KERNEL_T_BWD: 1}
    ro, _ = fa.flash_attention_temporal_fwd_plain(qkv, heads, d ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ro.float(), **MVIT_FWD_TOLS[dtype])
    _close_grad(a.grad, fa.flash_attention_temporal_bwd_plain(
        qkv, g, heads, d ** -0.5), dtype)


# the head dims the tensor-core kernels do not take: (d, heads) that JAX's
# _heads_per_block admits for the pair, d for the MViT kernels
PAIR_ODD = [(12, 32), (320, 2)]
MVIT_ODD = [20, 136]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cls", [False, True])
@pytest.mark.parametrize("d,heads", PAIR_ODD)
def test_flash_kernels_at_once_refused_head_dims(card, dtype, cls, d, heads):
    """The pair at d = 12 and 320 (the scalar kernels, column groups past
    256) against its plain version, forward and backward."""
    scale = d ** -0.5
    x, g, gc = _flash_inputs(card, dtype, 2, 40, heads, d, cls)
    if cls:
        got = fa.flash_attention_cls_fwd(*x, heads, scale)
        want = fa.flash_attention_cls_fwd_plain(*x, heads, scale)
        grads = fa.flash_attention_cls_bwd(*x, g, gc, got[-1], heads, scale)
        rgrads = fa.flash_attention_cls_bwd_plain(*x, g, gc, heads, scale)
    else:
        got = fa.flash_attention_fwd(*x, heads, scale)
        want = fa.flash_attention_fwd_plain(*x, heads, scale)
        grads = fa.flash_attention_bwd(*x, g, got[-1], heads, scale)
        rgrads = fa.flash_attention_bwd_plain(*x, g, heads, scale)
    for a, r in zip(got[:-1], want[:-1]):
        torch.cuda.synchronize()
        torch.testing.assert_close(a.float(), r.float(),
                                   **MVIT_FWD_TOLS[dtype])
    torch.testing.assert_close(got[-1], want[-1], **ROWSUM_TOL)
    for a, r in zip(grads, rgrads):
        _close_grad(a, r, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [12, 320])
def test_k1_and_k2_functions_at_once_refused_head_dims(card, dtype, d):
    """K1's function (fused qkv + CLS) and K2's (time-major qkv) on the pair
    at d = 12 and 320."""
    heads = dict(PAIR_ODD)[d]
    scale = d ** -0.5
    gen = torch.Generator(device=card).manual_seed(d)
    c = heads * d
    r = lambda *s: torch.randn(*s, generator=gen, device=card).to(dtype)
    qkv, qkv_c, g, gc = r(2, 30, 3 * c), r(2, 1, 3 * c), r(2, 30, c), r(2, 1, c)
    out, out_c, l = fa.flash_attention_qkv_fwd(qkv, qkv_c, heads, scale)
    ro, roc, rl = fa.flash_attention_qkv_fwd_plain(qkv, qkv_c, heads, scale)
    torch.cuda.synchronize()
    for a, b in ((out, ro), (out_c, roc)):
        torch.testing.assert_close(a.float(), b.float(), **MVIT_FWD_TOLS[dtype])
    torch.testing.assert_close(l, rl, **ROWSUM_TOL)
    for a, b in zip(fa.flash_attention_qkv_bwd(qkv, qkv_c, g, gc, l, heads,
                                               scale),
                    fa.flash_attention_qkv_bwd_plain(qkv, qkv_c, g, gc, heads,
                                                     scale)):
        _close_grad(a, b, dtype)
    qkv, g = r(2, 8, 5, 3 * c), r(2, 8, 5, c)
    out, l = fa.flash_attention_temporal_fwd(qkv, heads, scale)
    ro, rl = fa.flash_attention_temporal_fwd_plain(qkv, heads, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ro.float(), **MVIT_FWD_TOLS[dtype])
    torch.testing.assert_close(l, rl, **ROWSUM_TOL)
    _close_grad(fa.flash_attention_temporal_bwd(qkv, g, l, heads, scale),
                fa.flash_attention_temporal_bwd_plain(qkv, g, heads, scale),
                dtype)


def _mvit_d_inputs(card, dtype, b, h, qn, k_shape, d, seed=0):
    """q, k, v, kc, vc, rel, g of a head-last call [B, L, H*d], one query
    row with logits above 80."""
    kn, kcat = k_shape[0] * k_shape[1] * k_shape[2], sum(k_shape)
    gen = torch.Generator(device=card).manual_seed(seed + qn + d)

    def r(*shape):
        return (0.5 * torch.randn(*shape, generator=gen, device=card)).to(dtype)

    c = h * d
    x = [r(b, qn, c), r(b, kn, c), r(b, kn, c), r(b, 1, c), r(b, 1, c),
         r(b, qn, h * kcat), r(b, qn, c)]
    x[0][0, 5] = x[1][0, 3] * 40
    return x


def _fold_heads(t, h):
    b, n, c = t.shape
    return t.reshape(b, n, h, c // h).transpose(1, 2).reshape(
        b * h, n, c // h).contiguous()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [8, 72, 128])
def test_mvit_fwd_kernels_at_other_head_dims(card, dtype, d):
    """K5f, K6f, K6sp and K7f at head dims other than 96 against their
    plain versions."""
    k_shape, scale = (2, 8, 8), d ** -0.5
    x = _mvit_d_inputs(card, dtype, 2, 2, 333, k_shape, d)
    tol = MVIT_FWD_TOLS[dtype]
    out, rs = k5.mvit_attention_hl_fwd(*x[:6], k_shape, 2, scale)
    ref, ref_rs = k5.mvit_attention_hl_fwd_plain(*x[:6], k_shape, 2, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(rs, ref_rs, **ROWSUM_TOL)
    out, lse = k5.mvit_attention_kt_fwd(*x[:6], k_shape, 2, scale)
    ref, ref_lse = k5.mvit_attention_kt_fwd_plain(*x[:6], k_shape, 2, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(lse, ref_lse, **LSE_TOL)
    xs = [_fold_heads(t, 2) for t in x]
    out, rs, p = k5.mvit_attention_fwd_probs(*xs[:6], k_shape, scale)
    ref, ref_rs, ref_p = k5.mvit_attention_fwd_probs_plain(*xs[:6], k_shape,
                                                           scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(p.float(), ref_p.float(), **PROBS_TOLS[dtype])
    assert torch.equal(out, k5.mvit_attention_fwd(*xs[:6], k_shape, scale)[0])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", MVIT_ODD)
def test_mvit_kernels_at_once_refused_head_dims(card, dtype, d):
    """K5f/K5b, K6f/K6b, K6sp/K6bs, K7f/K7b and K5bd at d = 20 and 136 (the
    scalar kernels, two column groups at 136) against their plain
    versions."""
    k_shape, scale, h = (2, 4, 4), d ** -0.5, 2
    x = _mvit_d_inputs(card, dtype, 2, h, 70, k_shape, d)
    q, k, v, kc, vc, rel, g = x
    tol = MVIT_FWD_TOLS[dtype]
    out, rs = k5.mvit_attention_hl_fwd(*x[:6], k_shape, h, scale)
    ref, ref_rs = k5.mvit_attention_hl_fwd_plain(*x[:6], k_shape, h, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(rs, ref_rs, **ROWSUM_TOL)
    for a, r in zip(k5.mvit_attention_hl_bwd(*x[:6], ref_rs, g, k_shape, h,
                                             scale),
                    k5.mvit_attention_hl_bwd_plain(*x[:6], ref_rs, g, k_shape,
                                                   h, scale)):
        _close_grad(a, r, dtype)
    for a, r in zip(k5.mvit_attention_hl_bwd_delta(*x[:6], ref_rs, ref, g,
                                                   k_shape, h, scale),
                    k5.mvit_attention_hl_bwd_delta_plain(*x[:6], ref_rs, ref,
                                                         g, k_shape, h,
                                                         scale)):
        _close_grad(a, r, dtype)
    out, lse = k5.mvit_attention_kt_fwd(*x[:6], k_shape, h, scale)
    ref, ref_lse = k5.mvit_attention_kt_fwd_plain(*x[:6], k_shape, h, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(lse, ref_lse, **LSE_TOL)
    for a, r in zip(k5.mvit_attention_kt_bwd(*x[:6], ref, ref_lse, g, k_shape,
                                             h, scale),
                    k5.mvit_attention_kt_bwd_rounded_plain(
                        *x[:6], ref, ref_lse, g, k_shape, h, scale)):
        _close_grad(a, r, dtype)
    xs = [_fold_heads(t, h) for t in x]
    out, rs, p = k5.mvit_attention_fwd_probs(*xs[:6], k_shape, scale)
    ref, ref_rs, ref_p = k5.mvit_attention_fwd_probs_plain(*xs[:6], k_shape,
                                                           scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(p.float(), ref_p.float(), **PROBS_TOLS[dtype])
    assert torch.equal(out, k5.mvit_attention_fwd(*xs[:6], k_shape, scale)[0])
    for a, r in zip(k5.mvit_attention_bwd(*xs[:6], ref_rs, xs[6], k_shape,
                                          scale),
                    k5.mvit_attention_bwd_plain(*xs[:6], ref_rs, xs[6],
                                                k_shape, scale)):
        _close_grad(a, r, dtype)
    for a, r in zip(k5.mvit_attention_bwd_probs(*xs[:6], ref_p, xs[6],
                                                k_shape, scale),
                    k5.mvit_attention_bwd_probs_plain(*xs[:6], ref_p, xs[6],
                                                      k_shape, scale)):
        _close_grad(a, r, dtype)


# the backward pair at ragged shapes: qN 333 (not a multiple of 64), kN + 1
# = 129 (one key past the key-major CTA's 128), and the key-major pass
# over 1 query chunk or 4 (6 query tiles: chunks of 2, 2, 2 and none)
@pytest.mark.parametrize("splits", [1, 4])
@pytest.mark.parametrize("d", [72, 96])
@pytest.mark.parametrize("variant", ["K5b", "K6b", "K5bd", "K7b", "K6bs"])
def test_mvit_bwd_pair_at_ragged_shapes(card, variant, d, splits):
    k_shape, scale, h = (2, 8, 8), d ** -0.5, 2
    x = _mvit_d_inputs(card, torch.bfloat16, 2, h, 333, k_shape, d)
    if variant in ("K6b", "K6bs"):
        x, b, heads = [_fold_heads(t, h) for t in x], 4, 1
    else:
        b, heads = 2, h
    q, k, v, kc, vc, rel, g = x
    kw = {}
    if variant == "K7b":
        out, lse = k5.mvit_attention_kt_fwd_plain(*x[:6], k_shape, h, scale)
        kw = dict(out=out, stats=lse)
        want = k5.mvit_attention_kt_bwd_rounded_plain(*x[:6], out, lse, g,
                                                      k_shape, h, scale)
        var = k5.ROWMAX
    elif variant == "K6bs":
        _, _, p = k5.mvit_attention_fwd_probs_plain(*x[:6], k_shape, scale)
        kw = dict(probs=p)
        want = k5.mvit_attention_bwd_probs_plain(*x[:6], p, g, k_shape, scale)
        var = k5.SAVED
    elif variant == "K6b":
        _, rs = k5.mvit_attention_fwd_plain(*x[:6], k_shape, scale)
        kw = dict(stats=rs)
        want = k5.mvit_attention_bwd_plain(*x[:6], rs, g, k_shape, scale)
        var = k5.RECOMPUTE
    else:
        out, rs = k5.mvit_attention_hl_fwd_plain(*x[:6], k_shape, h, scale)
        if variant == "K5bd":
            kw = dict(out=out, stats=rs)
            want = k5.mvit_attention_hl_bwd_delta_plain(*x[:6], rs, out, g,
                                                        k_shape, h, scale)
            var = k5.DELTA
        else:
            kw = dict(stats=rs)
            want = k5.mvit_attention_hl_bwd_plain(*x[:6], rs, g, k_shape, h,
                                                  scale)
            var = k5.RECOMPUTE
    got = k5._bwd_kernel(var, "test", *x[:6], g, k_shape, b, heads, scale,
                         splits=splits, **kw)
    for a, r in zip(got, want):
        _close_grad(a, r, torch.bfloat16)


def test_key_splits_fill_the_card(card):
    """MViT-v2-S at 18 clips: the key-major pass splits block 0's query
    range (4 key tiles x 18 slices alone fill a fraction of the card) and
    no other block's."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert k5.key_splits(18, 25088, 392, sms) > 1
    for bh, qn, kn in ((36, 6272, 1568), (72, 1568, 1568)):
        assert k5.key_splits(bh, qn, kn, sms) * -(-(kn + 1) // k5.KM) * bh >= sms


# ---------------------------------------------------------------- slice 16
# The softmax shifts under max and none: every variant against its plain
# version on queries aimed past the clamp (``chip_smoke.py``'s phase 32
# checks at smaller shapes and its limits; under none the rows that
# overflow in the plain version must be exactly the kernel's non-finite
# rows, and the others are compared), and the entries' routes.

def _smoke():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke


def _hold(pairs, twins=()):
    cs = _smoke()
    torch.cuda.synchronize()
    for name, got, want, tol in pairs:
        assert bool(torch.isfinite(got.float()).all()), name
        if got.numel():
            torch.testing.assert_close(got.float(), want.float(), **tol,
                                       msg=lambda m, n=name: f"{n}: {m}")
    for name, got, twin in twins:
        assert all(cs.same_bits(torch, a, b) for a, b in zip(got, twin)), name


SHIFT_CASES = ("k1", "k1 N 48", "k2", "k2 T 16", "k4", "k3", "pair layouts",
               "k5", "k6", "k6sp")


@pytest.mark.parametrize("shift", ["max", "none"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", SHIFT_CASES)
def test_shift_variants_match_plain(card, case, dtype, shift):
    cs = _smoke()
    if case == "pair layouts" and dtype == torch.float32:
        pytest.skip("the pair's other layouts are held in bf16")
    if case == "k2 T 16" and dtype == torch.float32:
        pytest.skip("float32 K2 at 16 frames of 12 heads exceeds the scalar "
                    "kernels' shared memory")
    gen = torch.Generator(device=card).manual_seed(16)
    if case.startswith("k1"):
        n = 48 if "48" in case else 196
        _hold(*cs.k1_shift_checks(torch, gen, k1, shift, dtype, 6, n))
    elif case.startswith("k2"):
        t = 16 if "16" in case else 8
        _hold(*cs.k2_shift_checks(torch, gen, k2, shift, dtype, 3, t, 49))
    elif case in ("k4", "k3"):
        _hold(cs.pair_shift_checks(torch, gen, fa, shift, dtype, 4,
                                   197 if case == "k4" else 196, case == "k3"))
    elif case == "pair layouts":
        _hold(cs.pair_layout_checks(torch, gen, fa, shift))
    else:
        head_last = case == "k5"
        _hold(cs.mvit_shift_checks(torch, gen, k5, shift, dtype, case,
                                   head_last, 2, 2 if head_last else 1,
                                   1568 if head_last else 392,
                                   (8, 7, 7), saved=case == "k6sp"))


@pytest.mark.parametrize("shift", ["max", "none"])
def test_shift_routes_run_their_kernels(card, shift):
    """The entries under each shift launch their own kernels: K1sp + K1b,
    K2f + K2b, K4f + K4b, K5f + K5b and K6f + K6b under autograd (the MViT
    backward under max from the forward's output)."""
    from procedurevrl_torch.ops.attention_route import AttentionRoute

    gen = torch.Generator(device=card).manual_seed(3)
    r = lambda *s: (0.5 * torch.randn(*s, generator=gen, device=card)
                    ).bfloat16().requires_grad_(True)
    route = AttentionRoute(spatial_shift=shift, temporal_shift=shift)
    _build.reset_launches()
    out = k1.spatial_attention_autograd(r(4, 196, 2304), r(4, 1, 2304), 12,
                                        0.125, route)
    (out[0].float().sum() + out[1].float().sum()).backward()
    k2.temporal_attention_autograd(r(2, 8, 49, 2304), 12, 0.125,
                                   route).float().sum().backward()
    fa.flash_attention_autograd(r(4, 197, 768), r(4, 197, 768),
                                r(4, 197, 768), 12, 0.125,
                                shift).float().sum().backward()
    x = [r(2, 392, 192), r(2, 98, 192), r(2, 98, 192), r(2, 1, 192),
         r(2, 1, 192), r(2, 392, 2 * 16)]
    k5.mvit_attention_hl(*x, (2, 7, 7), 2, 96 ** -0.5,
                         shift=shift).float().sum().backward()
    x = [t.detach().reshape(4, t.shape[1], 96 if t.shape[2] == 192 else 16)
         .requires_grad_(True) for t in x]
    k5.mvit_attention(*x, (2, 7, 7), 96 ** -0.5,
                      shift=shift).float().sum().backward()
    torch.cuda.synchronize()
    want = {k1.KERNEL_PROBS: 1, k1.KERNEL_BWD: 1, k2.KERNEL: 1,
            k2.KERNEL_BWD: 1, fa.KERNEL: 1, fa.KERNEL_BWD: 1,
            k5.KERNEL_HL: 1, k5.KERNEL_HL_BWD: 1, k5.KERNEL: 1,
            k5.KERNEL_BWD: 1}
    assert _build.LAUNCHES == want
