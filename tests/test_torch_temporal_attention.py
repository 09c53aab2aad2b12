"""K2 of the PyTorch port (temporal attention forward) against the JAX
package.

On the CPU the port's wrapper runs its plain version; the JAX side is
``flash_attention_temporal`` with the Pallas kernel in interpret mode, on
the same numpy inputs (both take the standard [q | k | v] column order).
Tolerance: fp32, atol = rtol = 2e-5 (the repository's parity tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procedurevrl_tpu.ops.attention import mhsa_temporal as jax_mhsa_temporal
from procedurevrl_tpu.ops.pallas_attention import flash_attention_temporal
from procedurevrl_torch.ops import _build
from procedurevrl_torch.ops.attention import mhsa_temporal
from procedurevrl_torch.ops.temporal_attention import (
    temporal_attention, temporal_attention_plain,
)

TOL = dict(atol=2e-5, rtol=2e-5)
D = 64


# T = 1, 9 and 16 and an odd N: the geometries the kernels tile apart
# (two positions of <= 8 frames per 16-row tile, one of 9-16, a last
# tile of a clip with one position)
@pytest.mark.parametrize("b,t,n", [(2, 8, 196), (1, 4, 50), (2, 1, 49),
                                   (2, 9, 49), (1, 16, 49)])
def test_k2_plain_matches_jax_kernel(b, t, n):
    rng = np.random.RandomState(b + t + n)
    heads = 2
    qkv = (0.5 * rng.randn(b, t, n, 3 * heads * D)).astype(np.float32)
    launches = dict(_build.LAUNCHES)
    out = temporal_attention(torch.from_numpy(qkv), heads, D ** -0.5).numpy()
    ref = np.asarray(flash_attention_temporal(jnp.asarray(qkv), heads,
                                              D ** -0.5))
    assert out.shape == (b, t, n, heads * D)
    np.testing.assert_allclose(out, ref, **TOL)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert _build.LAUNCHES == launches


def test_k2_clamp_shift_matches_kernel_not_row_max():
    """Logits above 80: the port follows the kernel's exp(min(s, 80))."""
    rng = np.random.RandomState(5)
    b, t, n, heads = 1, 8, 196, 2
    c = heads * D
    qkv = (0.3 * rng.randn(b, t, n, 3 * c)).astype(np.float32)
    # patch 7, head 1: query frame 2 against key frames 3 (s = 96), 6 (~85)
    qkv[0, 2, 7, D:2 * D] = 4.0
    qkv[0, 3, 7, c + D:c + 2 * D] = 3.0
    qkv[0, 6, 7, c + D:c + 2 * D] = 2.66
    out = temporal_attention(torch.from_numpy(qkv), heads, D ** -0.5).numpy()
    ref = np.asarray(flash_attention_temporal(jnp.asarray(qkv), heads,
                                              D ** -0.5))
    np.testing.assert_allclose(out, ref, **TOL)
    v3 = qkv[0, 3, 7, 2 * c + D:2 * c + 2 * D]
    v6 = qkv[0, 6, 7, 2 * c + D:2 * c + 2 * D]
    got = out[0, 2, 7, D:2 * D]
    np.testing.assert_allclose(got, 0.5 * (v3 + v6), atol=1e-4)
    # a row-max softmax would put ~all weight on frame 3
    assert np.abs(got - v3).max() > 0.1


# (T, N, knobs, TPU.USE_PALLAS_ATTENTION, whether both sides take the
# kernel): JAX takes it only with Pallas on, TEMPORAL_PALLAS not 0, T <= 16
# and a temporal geometry (``ops/attention.py:247-258``), else its XLA path
# on the (T, N) transpose; the port routes by the same rule
@pytest.mark.parametrize("t,n,knobs,use_pallas,kernel", [
    pytest.param(8, 196, {}, True, True, id="8-196"),
    pytest.param(4, 30, {}, True, True, id="4-30"),
    pytest.param(32, 20, {}, True, False, id="32-20-past-max-t"),
    pytest.param(8, 20, {}, False, False, id="8-20-no-pallas"),
    pytest.param(8, 20, {"TEMPORAL_PALLAS": "0"}, True, False,
                 id="8-20-temporal-pallas-0")])
def test_mhsa_temporal_matches_jax(t, n, knobs, use_pallas, kernel,
                                   monkeypatch):
    from procedurevrl_tpu.ops import pallas_attention as pa
    from procedurevrl_torch.ops import temporal_attention as k2
    from procedurevrl_torch.ops.attention_route import AttentionRoute

    for key, value in knobs.items():
        monkeypatch.setenv(key, value)
    calls = {"jax": 0, "port": 0}
    jax_k2, port_k2 = pa.flash_attention_temporal, k2.temporal_attention_autograd
    monkeypatch.setattr(pa, "flash_attention_temporal", lambda *a, **kw: (
        calls.__setitem__("jax", calls["jax"] + 1) or jax_k2(*a, **kw)))
    monkeypatch.setattr(k2, "temporal_attention_autograd", lambda *a, **kw: (
        calls.__setitem__("port", calls["port"] + 1) or port_k2(*a, **kw)))
    route = AttentionRoute.from_env(use_pallas)
    rng = np.random.RandomState(9 + t)
    b, heads = 2, 2
    c = heads * D
    x = rng.randn(b, t, n, c).astype(np.float32)
    qkv_w = (0.05 * rng.randn(c, 3 * c)).astype(np.float32)  # JAX [in, out]
    qkv_b = (0.05 * rng.randn(3 * c)).astype(np.float32)
    proj_w = (0.05 * rng.randn(c, c)).astype(np.float32)
    proj_b = (0.05 * rng.randn(c)).astype(np.float32)
    ref = jax_mhsa_temporal(jnp.asarray(x), jnp.asarray(qkv_w),
                            jnp.asarray(qkv_b), jnp.asarray(proj_w),
                            jnp.asarray(proj_b), heads,
                            use_pallas=use_pallas)
    t_ = torch.from_numpy
    out = mhsa_temporal(t_(x), t_(qkv_w.T.copy()), t_(qkv_b),
                        t_(proj_w.T.copy()), t_(proj_b), heads, route=route)
    assert calls == {"jax": int(kernel), "port": int(kernel)}
    assert out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_k2_plain_bf16_dtypes():
    """bf16 in, bf16 out; equals the fp32 computation on the rounded
    inputs to bf16 output precision."""
    rng = np.random.RandomState(13)
    qkv = torch.from_numpy(rng.randn(2, 8, 20, 3 * 2 * D).astype(np.float32))
    out = temporal_attention_plain(qkv.bfloat16(), 2, D ** -0.5)
    assert out.dtype == torch.bfloat16
    ref = temporal_attention_plain(qkv.bfloat16().float(), 2, D ** -0.5)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=2e-2,
                               rtol=2e-2)
