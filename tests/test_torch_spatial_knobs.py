"""The spatial kernels of the JAX package's knob routes (K1br, K1bd, K1p)
against the JAX package.

On the CPU each wrapper runs its plain version.  They are held against the
JAX package's own paths, Pallas in interpret mode:
- K1br (``spatial_attention_bwd_recompute``) against
  ``jax.grad(flash_attention_cls_qkv)`` with ``SPATIAL_SAVE_PROBS=0`` (the
  recompute backward ``_bwd_cls_qkv_kernel``);
- K1bd (``spatial_attention_bwd_delta``) against the same grad with
  ``SPATIAL_SAVE_PROBS=1 SPATIAL_DELTA=1`` and ``jax.device_count`` forced
  to 1 (``_bwd_cls_qkv_kernel_sp_delta``; under the conftest's 8 host
  devices JAX would take the recompute backward);
- K1p (``spatial_attention_pipe``) against ``_flash_cls_qkv_fwd_pipe`` at
  b = 24, N = 49, H = 4 and at the production head grouping b = 36, H = 12.
JAX takes its qkv columns in the window order of ``qkv_window_perm``; the
inputs are permuted for it and its gradients permuted back.  One case puts
a logit above 80.  Tolerances: fp32 atol = rtol = 2e-5 for values, 5e-5
for gradients (``tests/test_pallas_attention.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procedurevrl_tpu.ops import pallas_attention as pa
from procedurevrl_tpu.ops.attention import qkv_window_perm
from procedurevrl_torch.ops import _build
from procedurevrl_torch.ops import spatial_attention as k1

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
D = 64


def _case(seed: int, bt: int, n: int, heads: int, hot: bool):
    rng = np.random.RandomState(seed)
    c = heads * D
    qkv = (0.5 * rng.randn(bt, n, 3 * c)).astype(np.float32)
    qkv_c = (0.5 * rng.randn(bt, 1, 3 * c)).astype(np.float32)
    if hot:
        # frame 1, patch query 5, head 0 against key 10: logit 96
        qkv[1, 5, :D] = 3.0
        qkv[1, 10, c:c + D] = 4.0
    g = rng.randn(bt, n, c).astype(np.float32)
    gc = rng.randn(bt, 1, c).astype(np.float32)
    return qkv, qkv_c, g, gc


def _perm(c: int, heads: int) -> np.ndarray:
    return np.asarray(qkv_window_perm(c, heads, pa._heads_per_block(D, heads)))


def _jax_grad(qkv, qkv_c, g, gc, heads):
    """jax.grad of <f, g> + <cls, gc> through flash_attention_cls_qkv, in
    [q | k | v] columns."""
    perm = _perm(qkv.shape[-1] // 3, heads)

    def f(a, b):
        fo, co = pa.flash_attention_cls_qkv(a, b, heads, D ** -0.5)
        return jnp.sum(fo * g) + jnp.sum(co * gc)

    da, db = jax.grad(f, argnums=(0, 1))(jnp.asarray(qkv[..., perm]),
                                         jnp.asarray(qkv_c[..., perm]))
    out, out_c = np.empty_like(qkv), np.empty_like(qkv_c)
    out[..., perm] = np.asarray(da)
    out_c[..., perm] = np.asarray(db)
    return out, out_c


@pytest.mark.parametrize("hot", [False, True], ids=["normal", "logit_above_80"])
def test_k1br_matches_jax_recompute_grad(hot, monkeypatch):
    monkeypatch.setenv("SPATIAL_SAVE_PROBS", "0")
    seen = []
    kernel = pa._bwd_cls_qkv_kernel
    monkeypatch.setattr(pa, "_bwd_cls_qkv_kernel",
                        lambda *a, **kw: seen.append(1) or kernel(*a, **kw))
    qkv, qkv_c, g, gc = _case(31 + hot, 2, 196, 2, hot)
    t = torch.from_numpy
    launches = dict(_build.LAUNCHES)
    dx, dx_c = k1.spatial_attention_bwd_recompute(t(qkv), t(qkv_c), t(g),
                                                  t(gc), 2, D ** -0.5)
    assert _build.LAUNCHES == launches  # CPU tensors: the plain version
    jx, jx_c = _jax_grad(qkv, qkv_c, g, gc, 2)
    assert seen  # JAX took its recompute kernel
    np.testing.assert_allclose(dx.numpy(), jx, **GRAD_TOL)
    np.testing.assert_allclose(dx_c.numpy(), jx_c, **GRAD_TOL)

    # the autograd Function of the recompute route (K1f or K1p forward,
    # K1br backward) gives the same gradients and K1f's outputs
    for nbuf in (None, 3):
        a = t(qkv).requires_grad_(True)
        b = t(qkv_c).requires_grad_(True)
        out, out_c = k1.SpatialAttentionRecompute.apply(a, b, 2, D ** -0.5,
                                                        nbuf)
        torch.autograd.backward((out, out_c), (t(g), t(gc)))
        np.testing.assert_allclose(a.grad.numpy(), dx.numpy(), **TOL)
        np.testing.assert_allclose(b.grad.numpy(), dx_c.numpy(), **TOL)
        ref, ref_c = k1.spatial_attention(t(qkv), t(qkv_c), 2, D ** -0.5)
        assert torch.equal(out, ref) and torch.equal(out_c, ref_c)


@pytest.mark.parametrize("hot", [False, True], ids=["normal", "logit_above_80"])
def test_k1bd_matches_jax_delta_grad(hot, monkeypatch):
    # the delta backward exists only on JAX's single-device saved-probs
    # path: force the gate open (tests/test_pallas_attention.py does too)
    monkeypatch.setattr(jax, "device_count", lambda *a, **k: 1)
    monkeypatch.setenv("SPATIAL_SAVE_PROBS", "1")
    monkeypatch.setenv("SPATIAL_DELTA", "1")
    seen = []
    kernel = pa._bwd_cls_qkv_kernel_sp_delta
    monkeypatch.setattr(pa, "_bwd_cls_qkv_kernel_sp_delta",
                        lambda *a, **kw: seen.append(1) or kernel(*a, **kw))
    qkv, qkv_c, g, gc = _case(41 + hot, 2, 196, 2, hot)
    t = torch.from_numpy
    out, out_c, probs = k1.spatial_attention_fwd_probs(t(qkv), t(qkv_c), 2,
                                                       D ** -0.5)
    launches = dict(_build.LAUNCHES)
    dx, dx_c = k1.spatial_attention_bwd_delta(t(qkv), t(qkv_c), probs, out,
                                              out_c, t(g), t(gc), 2, D ** -0.5)
    assert _build.LAUNCHES == launches
    jx, jx_c = _jax_grad(qkv, qkv_c, g, gc, 2)
    assert seen  # JAX took its delta kernel
    np.testing.assert_allclose(dx.numpy(), jx, **GRAD_TOL)
    np.testing.assert_allclose(dx_c.numpy(), jx_c, **GRAD_TOL)

    # delta equals the jacobian row sums in exact arithmetic: K1b agrees
    db, db_c = k1.spatial_attention_bwd(t(qkv), t(qkv_c), probs, t(g), t(gc),
                                        2, D ** -0.5)
    np.testing.assert_allclose(dx.numpy(), db.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(dx_c.numpy(), db_c.numpy(), **GRAD_TOL)

    a = t(qkv).requires_grad_(True)
    b = t(qkv_c).requires_grad_(True)
    fo, fc = k1.SpatialAttentionDelta.apply(a, b, 2, D ** -0.5)
    torch.autograd.backward((fo, fc), (t(g), t(gc)))
    np.testing.assert_allclose(a.grad.numpy(), dx.numpy(), **TOL)
    np.testing.assert_allclose(b.grad.numpy(), dx_c.numpy(), **TOL)


@pytest.mark.parametrize("bt,heads", [(24, 4), (36, 12)],
                         ids=["b24_h4", "production_grouping"])
def test_k1p_matches_jax_pipelined_forward(bt, heads, monkeypatch):
    monkeypatch.setenv("SPATIAL_PIPE", "1")
    qkv, qkv_c, _, _ = _case(51 + heads, bt, 49, heads, hot=True)
    perm = _perm(heads * D, heads)
    jo, jo_c = pa._flash_cls_qkv_fwd_pipe(jnp.asarray(qkv[..., perm]),
                                          jnp.asarray(qkv_c[..., perm]),
                                          heads, D ** -0.5)
    launches = dict(_build.LAUNCHES)
    out, out_c = k1.spatial_attention_pipe(torch.from_numpy(qkv),
                                           torch.from_numpy(qkv_c), heads,
                                           D ** -0.5, nbuf=pa._pipe_nbuf())
    assert _build.LAUNCHES == launches
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(out_c.numpy(), np.asarray(jo_c), **TOL)


def test_k1p_wrapper_refuses_an_empty_ring():
    qkv, qkv_c, _, _ = _case(61, 2, 20, 2, hot=False)
    with pytest.raises(ValueError, match="nbuf"):
        k1.spatial_attention_pipe(torch.from_numpy(qkv),
                                  torch.from_numpy(qkv_c), 2, D ** -0.5, 0)
