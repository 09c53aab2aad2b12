"""K5 and K6 of the PyTorch port (MViT pooled attention with the decomposed
rel-pos bias) against the JAX package.

The port's plain versions (and the ``MViTAttention`` autograd function,
which on the CPU runs them) are held against ``flash_attention_mvit_hl``
(K5, head-last) and ``flash_attention_mvit`` (K6, head-split), whose Pallas
kernels run in interpret mode here, forward and ``jax.grad`` with respect
to q, k, v, kc, vc and rel.  Geometry: B = 2, H = 2 heads of 96, a ragged
query count (qN = 70), key grid (2, 3, 4) so kN + 1 = 25 is not a multiple
of 8, and one query row scaled so that its logits pass 80 (the clamp
shift).  Tolerance: fp32 atol = rtol = 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procedurevrl_tpu.ops.pallas_mvit_attention import (
    flash_attention_mvit, flash_attention_mvit_hl,
)
from procedurevrl_torch.ops import mvit_attention as ma

TOL = dict(atol=2e-5, rtol=2e-5)
B, H, D, QN = 2, 2, 96, 70
K_SHAPE = (2, 3, 4)
KN, KCAT = 24, 9
SCALE = D ** -0.5


def _inputs(seed, hot=True):
    """Head-last q [B, qN, H*D], k, v [B, kN, H*D], kc, vc [B, 1, H*D],
    rel [B, qN, H*kcat], g like q; with ``hot`` one query row of the first
    sample has logits above 80."""
    rng = np.random.RandomState(seed)
    c = H * D
    mk = lambda *s: (rng.randn(*s) * 0.5).astype(np.float32)
    x = dict(q=mk(B, QN, c), k=mk(B, KN, c), v=mk(B, KN, c), kc=mk(B, 1, c),
             vc=mk(B, 1, c), rel=mk(B, QN, H * KCAT), g=mk(B, QN, c))
    if hot:
        x["q"][0, 5] = x["k"][0, 3] * 40.0  # q.k * scale well above 80
    return x


def _fold(a):
    """[B, L, H*c] -> [B*H, L, c] (numpy)."""
    b, n, c = a.shape
    return np.ascontiguousarray(
        a.reshape(b, n, H, c // H).transpose(0, 2, 1, 3).reshape(b * H, n,
                                                                 c // H))


def _torch(x):
    return {k: torch.from_numpy(v) for k, v in x.items()}


ARGS = ("q", "k", "v", "kc", "vc", "rel")


def _jax_fwd_grads(fn, x):
    args = [jnp.asarray(x[k]) for k in ARGS]
    out, vjp = jax.vjp(fn, *args)
    return np.asarray(out), [np.asarray(a) for a in vjp(jnp.asarray(x["g"]))]


def test_hot_row_passes_the_clamp():
    x = _inputs(0)
    s = ma._logits(*(torch.from_numpy(_fold(x[k])) for k in ("q", "k", "kc",
                                                              "rel")),
                   K_SHAPE, SCALE)
    assert s.max().item() > 90.0


@pytest.mark.parametrize("hot", [False, True])
def test_head_last_plain_matches_jax(hot):
    x = _inputs(1, hot)
    ref, ref_grads = _jax_fwd_grads(
        lambda *a: flash_attention_mvit_hl(*a, K_SHAPE, H, SCALE), x)
    t = _torch(x)
    out, rowsum = ma.mvit_attention_hl_fwd_plain(
        *(t[k] for k in ARGS), K_SHAPE, H, SCALE)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert rowsum.shape == (B, H, QN)
    grads = ma.mvit_attention_hl_bwd_plain(*(t[k] for k in ARGS), rowsum,
                                           t["g"], K_SHAPE, H, SCALE)
    for name, got, want in zip(ARGS, grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=name)


@pytest.mark.parametrize("hot", [False, True])
def test_head_split_plain_matches_jax(hot):
    x = {k: _fold(v) for k, v in _inputs(2, hot).items()}
    ref, ref_grads = _jax_fwd_grads(
        lambda *a: flash_attention_mvit(*a, K_SHAPE, SCALE), x)
    t = _torch(x)
    out, rowsum = ma.mvit_attention_fwd_plain(*(t[k] for k in ARGS), K_SHAPE,
                                              SCALE)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert rowsum.shape == (B * H, 1, QN)
    grads = ma.mvit_attention_bwd_plain(*(t[k] for k in ARGS), rowsum,
                                        t["g"], K_SHAPE, SCALE)
    for name, got, want in zip(ARGS, grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=name)


# the JAX backward each knob selects (``_vjp_bwd`` / ``_vjp_hl_bwd``):
# (head_last, knob) -> the function that reaches its Pallas kernel
JAX_BWD = {(True, ""): "_bwd_hl", (True, "MVIT_DELTA"): "_bwd_hl_delta",
           (True, "MVIT_SAVE_PROBS"): "_bwd_hl", (False, ""): "_bwd",
           (False, "MVIT_DELTA"): "_bwd_delta",
           (False, "MVIT_SAVE_PROBS"): "_bwd_saved"}


@pytest.mark.parametrize("knob", ["", "MVIT_DELTA", "MVIT_SAVE_PROBS"])
@pytest.mark.parametrize("head_last", [True, False])
def test_autograd_entry_matches_jax_grad(head_last, knob, monkeypatch):
    """The model's entry under autograd on the CPU: the plain forward, then
    the written-out backward, against ``jax.grad``; with a knob set for JAX
    and given to the port's entry as the model gives it (K5bd / K6bd, or
    K6sp + K6bs)."""
    from procedurevrl_tpu.ops import pallas_mvit_attention as pm

    if knob:
        monkeypatch.setenv(knob, "1")
    taken = []
    for name in set(JAX_BWD.values()):
        fn = getattr(pm, name)
        monkeypatch.setattr(pm, name, lambda *a, _f=fn, _n=name, **kw:
                            taken.append(_n) or _f(*a, **kw))
    x = _inputs(3)
    if not head_last:
        x = {k: _fold(v) for k, v in x.items()}
        fn = lambda *a: flash_attention_mvit(*a, K_SHAPE, SCALE)
    else:
        fn = lambda *a: flash_attention_mvit_hl(*a, K_SHAPE, H, SCALE)
    ref, ref_grads = _jax_fwd_grads(fn, x)
    assert taken == [JAX_BWD[head_last, knob]]
    t = {k: v.requires_grad_(k in ARGS) for k, v in _torch(x).items()}
    delta, save_probs = knob == "MVIT_DELTA", knob == "MVIT_SAVE_PROBS"
    if head_last:
        out = ma.mvit_attention_hl(*(t[k] for k in ARGS), K_SHAPE, H, SCALE,
                                   delta)
    else:
        out = ma.mvit_attention(*(t[k] for k in ARGS), K_SHAPE, SCALE, delta,
                                save_probs)
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)
    out.backward(t["g"])
    for name, want in zip(ARGS, ref_grads):
        np.testing.assert_allclose(t[name].grad.numpy(), want, **TOL,
                                   err_msg=name)


def test_layouts_agree():
    """K5 on [B, qN, H*96] and K6 on the head-split fold are one function."""
    x = _torch(_inputs(4))
    out_hl, rs_hl = ma.mvit_attention_hl_fwd(*(x[k] for k in ARGS), K_SHAPE,
                                             H, SCALE)
    f = {k: torch.from_numpy(_fold(v.numpy())) for k, v in x.items()}
    out, rs = ma.mvit_attention_fwd(*(f[k] for k in ARGS), K_SHAPE, SCALE)
    np.testing.assert_allclose(_fold(out_hl.numpy()), out.numpy(), **TOL)
    np.testing.assert_allclose(rs_hl.reshape(-1, QN).numpy(),
                               rs[:, 0].numpy(), **TOL)


def test_routing_copies_the_reference():
    """``hl_supported`` routes MViT-v2-S's blocks as the JAX package does:
    the three wide-key blocks (kN = 1568) head-split, the rest head-last."""
    from procedurevrl_tpu.ops.pallas_mvit_attention import (
        hl_supported as jax_hl_supported,
    )

    for kn, c, h in [(392, 96, 1), (1568, 192, 2), (392, 192, 2),
                     (1568, 384, 4), (392, 384, 4), (1568, 768, 8),
                     (392, 768, 8), (24, 192, 2)]:
        assert ma.hl_supported(kn, c, h) == jax_hl_supported(kn, c, h)
    assert not ma.hl_supported(1568, 192, 2)
    assert ma.hl_supported(392, 96, 1)


def test_wrappers_check_shapes():
    x = _torch(_inputs(5))
    with pytest.raises(ValueError, match="do not fit"):
        ma.mvit_attention_hl_fwd(*(x[k] for k in ARGS), (2, 3, 3), H, SCALE)
    with pytest.raises(ValueError, match="rowsum"):
        ma.mvit_attention_hl_bwd(*(x[k] for k in ARGS),
                                 torch.zeros(B, H, QN + 1), x["g"], K_SHAPE, H,
                                 SCALE)


def test_mutation_check_plants_each_fault():
    """``tools/mutation_check.py`` finds the text it mutates exactly once in
    each kernel source, and each mutant changes it."""
    from procedurevrl_torch.ops import _build
    from procedurevrl_torch.tools import mutation_check as mc

    src = (_build.CSRC / "mvit_attention.cu").read_text()
    assert src.count(mc._MASK) == 1
    for m in mc.MUTANTS.values():
        text = (_build.CSRC / m.source).read_text()
        assert text.count(m.anchor) == 1, m
        assert m.line != m.anchor and m.line not in text, m
        assert m.check in mc.CHECKS
    assert {m.source for m in mc.MUTANTS.values()} == {
        "mvit_attention.cu", "depthwise_pool.cu", "spatial_attention.cu",
        "temporal_attention.cu", "flash_attention.cu", "common.cuh"}
