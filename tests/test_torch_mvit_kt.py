"""K7 of the PyTorch port (key-tiled head-last MViT pooled attention with
the row-max softmax) and the routes of ``MVIT_KT`` / ``MVIT_POOL``, against
the JAX package.

The port's plain versions (and ``MViTAttentionKT``, which on the CPU runs
them) are held against ``flash_attention_mvit_hl_kt`` with its Pallas
kernels in interpret mode, forward, log-sum-exp and ``jax.grad`` with
respect to q, k, v, kc, vc and rel, at the JAX test's geometry
(``tests/test_mvit_pallas.py:240``: B 1, H 2 heads of 96, q grid (6, 10,
10), key grid (8, 14, 14), so the TPU kernel walks ragged key chunks).  A
row whose logits pass 80 shows that K7 takes the row max where K5 takes
the clamp.  ``MultiScaleAttention`` with ``MVIT_KT=1`` is held against the
JAX module with ``MVIT_KT=1`` at (8, 14, 14), width 192, 2 heads (JAX
``test_mvit_kt_model_dispatch``).  Tolerances: K7 forward fp32 atol = rtol
= 2e-5, gradients 5e-5; the module's outputs 5e-5 and gradients 2e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procedurevrl_tpu.models import mvit as jm
from procedurevrl_tpu.ops import pallas_mvit_attention as jpa
from procedurevrl_torch.config import load_config
from procedurevrl_torch.models import mvit as pm
from procedurevrl_torch.ops import mvit_attention as ma
from procedurevrl_torch.utils import weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
H, D = 2, 96
SCALE = D ** -0.5
ARGS = ("q", "k", "v", "kc", "vc", "rel")


def _inputs(seed, qn, k_shape, hot=False):
    """Head-last q [1, qN, H*96], k, v [1, kN, H*96], kc, vc [1, 1, H*96],
    rel [1, qN, H*kcat], g like q; with ``hot`` query row 5 has two logits
    far above 80 (keys 3 and 4, the first the larger)."""
    rng = np.random.RandomState(seed)
    kn, c = int(np.prod(k_shape)), H * D
    mk = lambda *s: (0.3 * rng.randn(*s)).astype(np.float32)
    x = dict(q=mk(1, qn, c), k=mk(1, kn, c), v=mk(1, kn, c), kc=mk(1, 1, c),
             vc=mk(1, 1, c), rel=mk(1, qn, H * sum(k_shape)), g=mk(1, qn, c))
    if hot:
        x["q"][0, 5] = x["k"][0, 3] * 150.0 + x["k"][0, 4] * 120.0
    return x


def _jax(x, k_shape):
    """JAX K7: (out, lse [1, H, qN], grads of the six inputs)."""
    args = [jnp.asarray(x[k]) for k in ARGS]
    out, vjp = jax.vjp(lambda *a: jpa.flash_attention_mvit_hl_kt(
        *a, k_shape, H, SCALE), *args)
    lse = jpa._fwd_hl_kt(*args, k_shape, H, SCALE)[1]  # [B, 1, qN, H]
    grads = vjp(jnp.asarray(x["g"]))
    return (np.asarray(out), np.asarray(lse)[:, 0].transpose(0, 2, 1),
            [np.asarray(a) for a in grads])


def test_plain_versions_match_jax():
    k_shape = (8, 14, 14)
    x = _inputs(0, 600, k_shape)
    ref, ref_lse, ref_grads = _jax(x, k_shape)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    out, lse = ma.mvit_attention_kt_fwd_plain(*(t[k] for k in ARGS), k_shape,
                                              H, SCALE)
    np.testing.assert_allclose(out.numpy(), ref, **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, **FWD_TOL)
    grads = ma.mvit_attention_kt_bwd_plain(*(t[k] for k in ARGS), out, lse,
                                           t["g"], k_shape, H, SCALE)
    for name, got, want in zip(ARGS, grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL,
                                   err_msg=name)
    # the model's entry under autograd: plain forward, then the written-out
    # backward
    leaves = {k: v.clone().requires_grad_(True) for k, v in t.items()
              if k in ARGS}
    got = ma.mvit_attention_kt(*(leaves[k] for k in ARGS), k_shape, H, SCALE)
    np.testing.assert_allclose(got.detach().numpy(), ref, **FWD_TOL)
    got.backward(t["g"])
    for name, want in zip(ARGS, ref_grads):
        np.testing.assert_allclose(leaves[name].grad.numpy(), want,
                                   **GRAD_TOL, err_msg=name)


def test_a_logit_above_80_takes_the_row_max():
    """With a row whose logits pass 80, K7's plain version follows JAX K7
    (row max) and differs from K5's clamp shift, which weighs the two hot
    keys alike, on that row only."""
    k_shape = (2, 3, 4)
    x = _inputs(1, 70, k_shape, hot=True)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    s = ma._logits(*(ma._split(t[k], H) for k in ("q", "k", "kc", "rel")),
                   k_shape, SCALE)
    assert s.max().item() > 100.0
    ref, ref_lse, ref_grads = _jax(x, k_shape)
    out, lse = ma.mvit_attention_kt_fwd_plain(*(t[k] for k in ARGS), k_shape,
                                              H, SCALE)
    np.testing.assert_allclose(out.numpy(), ref, **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, **FWD_TOL)
    grads = ma.mvit_attention_kt_bwd_plain(*(t[k] for k in ARGS), out, lse,
                                           t["g"], k_shape, H, SCALE)
    for name, got, want in zip(ARGS, grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL,
                                   err_msg=name)
    clamp = ma.mvit_attention_hl_plain(*(t[k] for k in ARGS), k_shape, H,
                                       SCALE)
    diff = (out - clamp).abs().amax(dim=-1)[0]
    assert diff[5].item() > 1e-2
    assert diff[torch.arange(70) != 5].max().item() < 1e-5


def test_wrappers_check_shapes():
    k_shape = (2, 3, 4)
    t = {k: torch.from_numpy(v) for k, v in _inputs(2, 70, k_shape).items()}
    out, lse = ma.mvit_attention_kt_fwd(*(t[k] for k in ARGS), k_shape, H,
                                        SCALE)
    assert lse.shape == (1, H, 70) and lse.dtype == torch.float32
    with pytest.raises(ValueError, match="rowsum"):
        ma.mvit_attention_kt_bwd(*(t[k] for k in ARGS), out, lse[:, :1],
                                 t["g"], k_shape, H, SCALE)
    with pytest.raises(ValueError, match="out"):
        ma.mvit_attention_kt_bwd(*(t[k] for k in ARGS), out[:, 1:], lse,
                                 t["g"], k_shape, H, SCALE)


def test_routing_copies_the_reference():
    for c, h in [(96, 1), (192, 2), (384, 4), (768, 8), (16, 2), (200, 2)]:
        assert ma.kt_supported(c, h) == jpa.kt_supported(c, h), (c, h)
        assert ma._hl_kt_geometry(c, h, c // h) == jpa._hl_kt_geometry(
            c, h, c // h)


def test_multiscale_attention_kt_matches_jax(monkeypatch):
    """The wide-key block of JAX ``test_mvit_kt_model_dispatch`` with
    ``MVIT_KT=1`` on both sides: the port calls its K7 entry."""
    monkeypatch.setenv("MVIT_KT", "1")
    thw, dim = (8, 14, 14), 192
    assert not ma.hl_supported(int(np.prod(thw)), dim, H)
    kw = dict(num_heads=H, qkv_bias=True, kernel_q=(), kernel_kv=(3, 3, 3),
              stride_q=(), stride_kv=(1, 1, 1), mode="conv",
              has_cls_embed=True, rel_pos_spatial=True, rel_pos_temporal=True,
              residual_pooling=True)
    jmod = jm.MultiScaleAttention(dim=dim, dim_out=dim, input_size=thw,
                                  use_pallas=True, **kw)
    route = pm.MViTRoute.from_env()
    assert route.kt
    port = pm.MultiScaleAttention(dim, dim, thw, route=route, **kw)
    rng = np.random.RandomState(1)
    x = (0.5 * rng.randn(1, 1 + int(np.prod(thw)), dim)).astype(np.float32)
    g = (0.02 * rng.randn(*x.shape)).astype(np.float32)
    params = jax.jit(lambda k, a: jmod.init(k, a, thw))(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def out_and_grads(p, a, gg):
        out, vjp = jax.vjp(lambda p, a: jmod.apply({"params": p}, a, thw)[0],
                           p, a)
        return out, vjp(gg)

    ref, (jgrads, jdx) = jax.jit(out_and_grads)(params, jnp.asarray(x),
                                                jnp.asarray(g))
    state = {}
    weights._mvit_attention(jax.tree_util.tree_map(np.asarray, params), "",
                            state)
    port.load_state_dict(state, strict=True)
    calls = []
    orig = ma.mvit_attention_kt
    monkeypatch.setattr(ma, "mvit_attention_kt",
                        lambda *a: calls.append(1) or orig(*a))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt, thw)[0]
    assert calls == [1]
    tol = dict(atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)
    out.backward(torch.from_numpy(g))
    want = {}
    weights._mvit_attention(jax.tree_util.tree_map(np.asarray, jgrads), "",
                            want)
    gtol = dict(atol=2e-4, rtol=2e-4)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **gtol,
                                   err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **gtol)


def test_knob_routes_on_the_mvit_v2_s_schedule(monkeypatch):
    """MViT-v2-S of the shipped config built with ``MVIT_POOL=kernel`` and
    ``MVIT_KT=1``, routed by geometry alone (no forward pass): K7 at blocks
    1 and 3, K6 at block 14, K5 elsewhere; the 17 stride-1 pools on K8 (the
    q pools of blocks 0, 2, 4-13 and 15, the k and v pools of blocks 14 and
    15), the 31 strided ones on the conv."""
    monkeypatch.setenv("MVIT_POOL", "kernel")
    monkeypatch.setenv("MVIT_KT", "1")
    cfg = pm.MViTConfig.from_cfg(load_config(os.path.join(
        ROOT, "configs/HowTo100M/procedurevrl_mvitv2_adamw.yaml")))
    assert (cfg.route.pool, cfg.route.kt) == ("kernel", True)
    plan = cfg.block_schedule()[0]
    routes = {}
    for i, spec in enumerate(plan):
        kshape = pm._pooled_thw(spec["input_size"], spec["kernel_kv"],
                                spec["stride_kv"])
        kn, c, h = int(np.prod(kshape)), spec["dim_out"], spec["num_heads"]
        assert ma.hl_supported(kn, c, h) == jpa.hl_supported(kn, c, h)
        assert ma.kt_supported(c, h) == jpa.kt_supported(c, h)
        routes[i] = ("K5" if ma.hl_supported(kn, c, h)
                     else "K7" if cfg.route.kt and ma.kt_supported(c, h) else "K6")
    assert [i for i, r in routes.items() if r == "K7"] == [1, 3]
    assert [i for i, r in routes.items() if r == "K6"] == [14]
    enc = pm.MViTEncoder(cfg)
    on_k8, on_conv = [], []
    for name, mod in enc.named_modules():
        if isinstance(mod, pm.DepthwisePool3D):
            (on_k8 if mod.takes_pool_op() else on_conv).append(name)
    blocks = lambda names, p: sorted(int(n.split(".")[1]) for n in names
                                     if n.endswith(p))
    assert blocks(on_k8, "pool_q") == [0, 2] + list(range(4, 14)) + [15]
    assert blocks(on_k8, "pool_k") == blocks(on_k8, "pool_v") == [14, 15]
    assert len(on_k8) == 17 and len(on_conv) == 31
    assert all(enc.blocks[i].attn.route.kt for i in range(16))
