"""Backward of the port's attention kernels (K1b, K2b) against the JAX
package.

On the CPU each wrapper runs its plain version: ``spatial_attention_bwd``
and ``temporal_attention_bwd`` write the backward out, and the autograd
Functions call them.  They are held against ``torch.autograd`` through the
plain forwards and against ``jax.grad`` of ``flash_attention_cls_qkv`` /
``flash_attention_temporal`` (Pallas in interpret mode; on the 8 virtual
CPU devices the JAX spatial grad takes its recompute backward, which
``tests/test_pallas_attention.py`` holds equal to the saved-probabilities
one).  Tolerance: fp32, atol = rtol = 2e-5 (the repository's parity
tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procedurevrl_tpu.ops.attention import qkv_window_perm
from procedurevrl_tpu.ops.pallas_attention import (
    _heads_per_block, flash_attention_cls_qkv, flash_attention_temporal,
)
from procedurevrl_torch.ops import _build
from procedurevrl_torch.ops import spatial_attention as k1
from procedurevrl_torch.ops import temporal_attention as k2

TOL = dict(atol=2e-5, rtol=2e-5)
D = 64


def _spatial_case(saturate: bool):
    rng = np.random.RandomState(21 + saturate)
    bt, n, heads = 2, 196, 2
    c = heads * D
    s = 0.3 if saturate else 1.0
    qkv = (s * rng.randn(bt, n, 3 * c)).astype(np.float32)
    qkv_c = (s * rng.randn(bt, 1, 3 * c)).astype(np.float32)
    if saturate:
        # frame 1, patch query 5, head 0: keys 10 and 20 give logits 96, ~85
        qkv[1, 5, 0:D] = 4.0
        qkv[1, 10, c:c + D] = 3.0
        qkv[1, 20, c:c + D] = 2.66
    g = rng.randn(bt, n, c).astype(np.float32)
    gc = rng.randn(bt, 1, c).astype(np.float32)
    return qkv, qkv_c, g, gc, heads


def _jax_k1_grad(qkv, qkv_c, g, gc, heads, scale):
    """jax.grad of <f, g> + <cls, gc>, mapped back to [q | k | v] columns."""
    perm = np.asarray(qkv_window_perm(qkv.shape[-1] // 3, heads,
                                      _heads_per_block(D, heads)))

    def f(a, b):
        fo, co = flash_attention_cls_qkv(a, b, heads, scale)
        return jnp.sum(fo * g) + jnp.sum(co * gc)

    da, db = jax.grad(f, argnums=(0, 1))(jnp.asarray(qkv[..., perm]),
                                         jnp.asarray(qkv_c[..., perm]))
    out, out_c = np.empty_like(qkv), np.empty_like(qkv_c)
    out[..., perm] = np.asarray(da)
    out_c[..., perm] = np.asarray(db)
    return out, out_c


def _autograd(fn, inputs, grads):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, [torch.from_numpy(g) for g in grads])
    return [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("saturate", [False, True],
                         ids=["normal", "logits_above_80"])
def test_k1_backward_matches_jax_grad(saturate):
    qkv, qkv_c, g, gc, heads = _spatial_case(saturate)
    scale = D ** -0.5
    t = torch.from_numpy
    _, _, probs = k1.spatial_attention_fwd_probs(t(qkv), t(qkv_c), heads,
                                                 scale)
    launches = dict(_build.LAUNCHES)
    dx, dx_c = k1.spatial_attention_bwd(t(qkv), t(qkv_c), probs, t(g), t(gc),
                                        heads, scale)
    assert _build.LAUNCHES == launches  # CPU tensors: the plain version
    jx, jx_c = _jax_k1_grad(qkv, qkv_c, g, gc, heads, scale)
    np.testing.assert_allclose(dx.numpy(), jx, **TOL)
    np.testing.assert_allclose(dx_c.numpy(), jx_c, **TOL)

    # the autograd Function (K1sp forward, K1b backward) gives the same
    fn_grads = _autograd(
        lambda a, b: k1.SpatialAttention.apply(a, b, heads, scale),
        (qkv, qkv_c), (g, gc))
    np.testing.assert_allclose(fn_grads[0], dx.numpy(), **TOL)
    np.testing.assert_allclose(fn_grads[1], dx_c.numpy(), **TOL)

    # autograd through the plain forward: equal while no logit is clamped;
    # with a logit above 80 the clamp's zero derivative makes it differ,
    # where the kernels (JAX's and the port's) take the softmax jacobian
    ag = _autograd(lambda a, b: k1.spatial_attention_plain(a, b, heads, scale),
                   (qkv, qkv_c), (g, gc))
    if saturate:
        assert np.abs(ag[0] - dx.numpy()).max() > 1e-3
    else:
        np.testing.assert_allclose(ag[0], dx.numpy(), **TOL)
        np.testing.assert_allclose(ag[1], dx_c.numpy(), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_forward_with_probs_gives_the_forward(dtype):
    qkv, qkv_c, _, _, heads = _spatial_case(False)
    qkv, qkv_c = torch.from_numpy(qkv).to(dtype), torch.from_numpy(qkv_c).to(dtype)
    out, out_c, probs = k1.spatial_attention_fwd_probs(qkv, qkv_c, heads,
                                                       D ** -0.5)
    ref, ref_c = k1.spatial_attention(qkv, qkv_c, heads, D ** -0.5)
    assert torch.equal(out, ref) and torch.equal(out_c, ref_c)
    L = qkv.shape[1] + 1
    assert probs.dtype == dtype
    assert probs.shape == (qkv.shape[0], heads, L, k1.probs_stride(L))
    assert not probs[..., L:].any()
    np.testing.assert_allclose(probs.float().sum(-1).numpy(), 1.0,
                               atol=1e-5 if dtype == torch.float32 else 2e-2)


def _temporal_case(b, t, n, heads=2):
    rng = np.random.RandomState(100 + t + n)
    qkv = (0.5 * rng.randn(b, t, n, 3 * heads * D)).astype(np.float32)
    g = rng.randn(b, t, n, heads * D).astype(np.float32)
    return qkv, g, heads


# T = 1, 9 and 16 and an odd N, as the forward's parity cases
@pytest.mark.parametrize("b,t,n", [(2, 8, 196), (2, 3, 20), (2, 1, 49),
                                   (2, 9, 49), (1, 16, 49)])
def test_k2_backward_matches_jax_grad(b, t, n):
    qkv, g, heads = _temporal_case(b, t, n)
    scale = D ** -0.5
    launches = dict(_build.LAUNCHES)
    dx = k2.temporal_attention_bwd(torch.from_numpy(qkv), torch.from_numpy(g),
                                   heads, scale).numpy()
    assert _build.LAUNCHES == launches
    ref = np.asarray(jax.grad(
        lambda a: jnp.sum(flash_attention_temporal(a, heads, scale) * g))(
            jnp.asarray(qkv)))
    np.testing.assert_allclose(dx, ref, **TOL)
    (ag,) = _autograd(lambda a: k2.temporal_attention_plain(a, heads, scale),
                      (qkv,), (g,))
    np.testing.assert_allclose(ag, dx, **TOL)
    (fn,) = _autograd(lambda a: k2.TemporalAttention.apply(a, heads, scale),
                      (qkv,), (g,))
    np.testing.assert_allclose(fn, dx, **TOL)


def test_autograd_entries_dispatch_on_grad():
    """Under grad the model's entries go through the autograd Functions;
    without, straight to the forward wrappers (K1f, K2f)."""
    qkv, qkv_c, _, _, heads = _spatial_case(False)
    a = torch.from_numpy(qkv).requires_grad_(True)
    b = torch.from_numpy(qkv_c)
    out, _ = k1.spatial_attention_autograd(a, b, heads, 0.125)
    assert out.grad_fn is not None and "SpatialAttention" in type(
        out.grad_fn).__name__
    with torch.no_grad():
        out, _ = k1.spatial_attention_autograd(a, b, heads, 0.125)
    assert out.grad_fn is None
    x = torch.zeros(1, 3, 4, 3 * heads * D, requires_grad=True)
    assert "TemporalAttention" in type(
        k2.temporal_attention_autograd(x, heads, 0.125).grad_fn).__name__
