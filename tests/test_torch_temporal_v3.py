"""The saved-probability temporal pair of ``TEMPORAL_BATCHED=1`` (K2v3f,
K2v3b) against the JAX package.

On the CPU the wrappers run their plain versions.  They are held against
``flash_attention_temporal`` with ``TEMPORAL_BATCHED=1`` (the v3 Pallas
kernels ``_temporal_fwd_kernel_v3`` / ``_temporal_bwd_kernel_v3`` in
interpret mode), value and ``jax.grad``, at T = 8 (N = 196) and T = 3,
with one logit above 80.  Tolerances: fp32 atol = rtol = 2e-5 for values,
5e-5 for gradients (``tests/test_pallas_attention.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procedurevrl_tpu.ops import pallas_attention as pa
from procedurevrl_tpu.ops.pallas_attention import flash_attention_temporal
from procedurevrl_torch.ops import _build
from procedurevrl_torch.ops import temporal_attention as k2

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
D = 64


def _case(b, t, n, heads=2):
    rng = np.random.RandomState(200 + t + n)
    c = heads * D
    qkv = (0.5 * rng.randn(b, t, n, 3 * c)).astype(np.float32)
    # batch 1, patch 7, head 1: frame 0 against frame t-1 gives logit 96
    qkv[1, 0, 7, D:2 * D] = 3.0
    qkv[1, t - 1, 7, c + D:c + 2 * D] = 4.0
    g = rng.randn(b, t, n, c).astype(np.float32)
    return qkv, g, heads


@pytest.mark.parametrize("b,t,n", [(2, 8, 196), (2, 3, 20)])
def test_k2v3_matches_jax_batched(b, t, n, monkeypatch):
    monkeypatch.setenv("TEMPORAL_BATCHED", "1")
    seen = []
    for name in ("_temporal_fwd_kernel_v3", "_temporal_bwd_kernel_v3"):
        kernel = getattr(pa, name)
        monkeypatch.setattr(pa, name, lambda *a, _k=kernel, _n=name, **kw:
                            seen.append(_n) or _k(*a, **kw))
    qkv, g, heads = _case(b, t, n)
    scale = D ** -0.5
    launches = dict(_build.LAUNCHES)
    out, probs = k2.temporal_attention_v3(torch.from_numpy(qkv), heads, scale)
    dx = k2.temporal_attention_v3_bwd(torch.from_numpy(qkv), probs,
                                      torch.from_numpy(g), heads, scale)
    assert _build.LAUNCHES == launches  # CPU tensors: the plain versions
    assert probs.shape == (b, n, heads, t, t)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)

    jo = np.asarray(flash_attention_temporal(jnp.asarray(qkv), heads, scale))
    jdx = np.asarray(jax.grad(
        lambda a: jnp.sum(flash_attention_temporal(a, heads, scale) * g))(
            jnp.asarray(qkv)))
    assert set(seen) == {"_temporal_fwd_kernel_v3", "_temporal_bwd_kernel_v3"}
    np.testing.assert_allclose(out.numpy(), jo, **TOL)
    np.testing.assert_allclose(dx.numpy(), jdx, **GRAD_TOL)

    # the autograd Function (K2v3f saving p, K2v3b) gives the same
    a = torch.from_numpy(qkv).requires_grad_(True)
    o = k2.TemporalAttentionV3.apply(a, heads, scale)
    o.backward(torch.from_numpy(g))
    assert torch.equal(o, out)
    np.testing.assert_allclose(a.grad.numpy(), dx.numpy(), **TOL)
    # and the default pair K2f / K2b computes the same function
    np.testing.assert_allclose(
        k2.temporal_attention_bwd(torch.from_numpy(qkv), torch.from_numpy(g),
                                  heads, scale).numpy(), dx.numpy(), **TOL)


def test_k2v3_forward_without_store():
    qkv, _, heads = _case(2, 3, 20)
    out, probs = k2.temporal_attention_v3(torch.from_numpy(qkv), heads, 0.125,
                                          save_probs=False)
    assert probs is None
    assert torch.equal(out, k2.temporal_attention(torch.from_numpy(qkv),
                                                  heads, 0.125))


def test_k2v3_backward_checks_the_saved_probs():
    qkv, g, heads = _case(2, 3, 20)
    with pytest.raises(ValueError, match="probs"):
        k2.temporal_attention_v3_bwd(torch.from_numpy(qkv),
                                     torch.zeros(2, 20, heads, 3, 4),
                                     torch.from_numpy(g), heads, 0.125)
