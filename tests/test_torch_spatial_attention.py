"""K1 of the PyTorch port (spatial attention forward, CLS as a separate
stream) against the JAX package.

On the CPU the port's wrapper runs its plain version; the JAX side is
``flash_attention_cls_qkv`` with the Pallas kernel in interpret mode, fed
the same numpy inputs through its window column permutation.  Tolerance:
fp32, atol = rtol = 2e-5 (the repository's parity tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procedurevrl_tpu.ops.attention import attention_core as jax_attention_core
from procedurevrl_tpu.ops.attention import mhsa_cls as jax_mhsa_cls
from procedurevrl_tpu.ops.attention import mhsa_xla as jax_mhsa_xla
from procedurevrl_tpu.ops.attention import qkv_window_perm
from procedurevrl_tpu.ops.pallas_attention import (
    _heads_per_block, flash_attention_cls_qkv,
)
from procedurevrl_torch.ops import _build
from procedurevrl_torch.ops.attention import mhsa_cls, mhsa_xla
from procedurevrl_torch.ops.spatial_attention import (
    spatial_attention, spatial_attention_plain,
)

TOL = dict(atol=2e-5, rtol=2e-5)
D = 64


def _jax_k1(qkv, qkv_c, heads, scale):
    c = qkv.shape[-1] // 3
    perm = np.asarray(qkv_window_perm(c, heads, _heads_per_block(D, heads)))
    f, cl = flash_attention_cls_qkv(jnp.asarray(qkv[..., perm]),
                                    jnp.asarray(qkv_c[..., perm]), heads, scale)
    return np.asarray(f), np.asarray(cl)


def _port_k1(qkv, qkv_c, heads, scale):
    f, cl = spatial_attention(torch.from_numpy(qkv), torch.from_numpy(qkv_c),
                              heads, scale)
    return f.numpy(), cl.numpy()


@pytest.mark.parametrize("bt,heads", [(2, 2), (3, 4)])
def test_k1_plain_matches_jax_kernel(bt, heads):
    rng = np.random.RandomState(bt * 10 + heads)
    n, c = 196, heads * D
    qkv = rng.randn(bt, n, 3 * c).astype(np.float32)
    qkv_c = rng.randn(bt, 1, 3 * c).astype(np.float32)
    launches = dict(_build.LAUNCHES)
    f, cl = _port_k1(qkv, qkv_c, heads, D ** -0.5)
    jf, jcl = _jax_k1(qkv, qkv_c, heads, D ** -0.5)
    assert f.shape == (bt, n, c) and cl.shape == (bt, 1, c)
    np.testing.assert_allclose(f, jf, **TOL)
    np.testing.assert_allclose(cl, jcl, **TOL)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert _build.LAUNCHES == launches


def test_k1_clamp_shift_matches_kernel_not_row_max():
    """Logits above 80 in one row: the port follows the kernel's
    exp(min(s, 80)) shift, which differs there from a row-max softmax."""
    rng = np.random.RandomState(3)
    bt, n, heads = 2, 196, 2
    c = heads * D
    qkv = (0.3 * rng.randn(bt, n, 3 * c)).astype(np.float32)
    qkv_c = (0.3 * rng.randn(bt, 1, 3 * c)).astype(np.float32)
    # frame 1, patch query 5, head 0: keys 10 and 20 give logits 96 and ~85
    qkv[1, 5, 0:D] = 4.0
    qkv[1, 10, c:c + D] = 3.0
    qkv[1, 20, c:c + D] = 2.66
    scale = D ** -0.5
    f, cl = _port_k1(qkv, qkv_c, heads, scale)
    jf, jcl = _jax_k1(qkv, qkv_c, heads, scale)
    np.testing.assert_allclose(f, jf, **TOL)
    np.testing.assert_allclose(cl, jcl, **TOL)
    # both keys saturate: equal weights, where a row max gives key 10 ~all
    v10, v20 = qkv[1, 10, 2 * c:2 * c + D], qkv[1, 20, 2 * c:2 * c + D]
    np.testing.assert_allclose(f[1, 5, :D], 0.5 * (v10 + v20), atol=1e-4)
    x = np.concatenate([qkv, qkv_c], axis=1).reshape(bt, n + 1, 3, heads, D)
    q, k, v = (jnp.asarray(x[:, :, i].transpose(0, 2, 1, 3)) for i in range(3))
    row_max = np.asarray(jax_attention_core(q, k, v, scale))[1, 0, 5]
    assert np.abs(row_max - f[1, 5, :D]).max() > 0.1


# (N, PALLAS_MIN_LEN, TPU.USE_PALLAS_ATTENTION, whether both sides take the
# kernel): JAX takes it only for PALLAS_MIN_LEN <= N <= 1024 with Pallas on
# (``ops/attention.py:184-188``), else concatenates [cls; frames] for its
# XLA path; the port routes by the same rule, read into its route
@pytest.mark.parametrize("n,min_len,use_pallas,kernel", [
    pytest.param(196, "1", True, True, id="196"),
    pytest.param(50, "1", True, True, id="50"),
    pytest.param(50, None, True, False, id="50-below-min-len"),
    pytest.param(196, None, False, False, id="196-no-pallas")])
def test_mhsa_cls_matches_jax(n, min_len, use_pallas, kernel, monkeypatch):
    from procedurevrl_tpu.ops import pallas_attention as pa
    from procedurevrl_torch.ops import spatial_attention as k1
    from procedurevrl_torch.ops.attention_route import AttentionRoute

    if min_len is not None:
        monkeypatch.setenv("PALLAS_MIN_LEN", min_len)
    calls = {"jax": 0, "port": 0}
    jax_k1, port_k1 = pa.flash_attention_cls_qkv, k1.spatial_attention_autograd
    monkeypatch.setattr(pa, "flash_attention_cls_qkv", lambda *a, **kw: (
        calls.__setitem__("jax", calls["jax"] + 1) or jax_k1(*a, **kw)))
    monkeypatch.setattr(k1, "spatial_attention_autograd", lambda *a, **kw: (
        calls.__setitem__("port", calls["port"] + 1) or port_k1(*a, **kw)))
    route = AttentionRoute.from_env(use_pallas)
    rng = np.random.RandomState(7 + n)
    bt, heads = 2, 2
    c = heads * D
    x = rng.randn(bt, n, c).astype(np.float32)
    cls_x = rng.randn(bt, 1, c).astype(np.float32)
    qkv_w = (0.05 * rng.randn(c, 3 * c)).astype(np.float32)  # JAX [in, out]
    qkv_b = (0.05 * rng.randn(3 * c)).astype(np.float32)
    proj_w = (0.05 * rng.randn(c, c)).astype(np.float32)
    proj_b = (0.05 * rng.randn(c)).astype(np.float32)
    jf, jcl = jax_mhsa_cls(jnp.asarray(x), jnp.asarray(cls_x),
                           jnp.asarray(qkv_w), jnp.asarray(qkv_b),
                           jnp.asarray(proj_w), jnp.asarray(proj_b), heads,
                           use_pallas=use_pallas)
    t = torch.from_numpy
    f, cl = mhsa_cls(t(x), t(cls_x), t(qkv_w.T.copy()), t(qkv_b),
                     t(proj_w.T.copy()), t(proj_b), heads, route=route)
    assert calls == {"jax": int(kernel), "port": int(kernel)}
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), **TOL)
    np.testing.assert_allclose(cl.numpy(), np.asarray(jcl), **TOL)


def test_k1_plain_bf16_rounds_probs_to_value_dtype():
    """bf16 inputs: logits/softmax in fp32, probs cast to bf16 before PV,
    fp32 accumulation, bf16 output; equals the fp32 computation on the
    bf16-rounded inputs and probs to bf16 output precision."""
    rng = np.random.RandomState(11)
    bt, n, heads = 2, 196, 2
    c = heads * D
    qkv = torch.from_numpy(rng.randn(bt, n, 3 * c).astype(np.float32))
    qkv_c = torch.from_numpy(rng.randn(bt, 1, 3 * c).astype(np.float32))
    f, cl = spatial_attention_plain(qkv.bfloat16(), qkv_c.bfloat16(), heads,
                                    D ** -0.5)
    assert f.dtype == torch.bfloat16 and cl.dtype == torch.bfloat16
    f32, cl32 = spatial_attention_plain(qkv.bfloat16().float(),
                                        qkv_c.bfloat16().float(), heads,
                                        D ** -0.5)
    # bf16 output rounding (2^-8 relative) plus probs rounded to bf16
    np.testing.assert_allclose(f.float().numpy(), f32.numpy(), atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_allclose(cl.float().numpy(), cl32.numpy(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("masking", ["none", "key_padding", "causal"])
def test_mhsa_xla_matches_jax(masking):
    """The plain (row-max softmax) attention path, the Attention module's
    third dispatch."""
    rng = np.random.RandomState(17)
    b, n, heads = 2, 20, 2
    c = heads * D
    x = rng.randn(b, n, c).astype(np.float32)
    qkv_w = (0.05 * rng.randn(c, 3 * c)).astype(np.float32)  # JAX [in, out]
    qkv_b = (0.05 * rng.randn(3 * c)).astype(np.float32)
    proj_w = (0.05 * rng.randn(c, c)).astype(np.float32)
    proj_b = (0.05 * rng.randn(c)).astype(np.float32)
    mask = None
    if masking == "key_padding":
        mask = np.zeros((b, n), bool)
        mask[0, -5:] = True
    causal = masking == "causal"
    ref = jax_mhsa_xla(jnp.asarray(x), jnp.asarray(qkv_w), jnp.asarray(qkv_b),
                       jnp.asarray(proj_w), jnp.asarray(proj_b), heads,
                       key_padding_mask=None if mask is None else jnp.asarray(mask),
                       causal=causal)
    t = torch.from_numpy
    out = mhsa_xla(t(x), t(qkv_w.T.copy()), t(qkv_b), t(proj_w.T.copy()),
                   t(proj_b), heads,
                   key_padding_mask=None if mask is None else t(mask),
                   causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
