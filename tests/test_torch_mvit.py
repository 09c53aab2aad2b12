"""The MViT-v2 modules of the PyTorch port against the JAX package.

Each port module gets the JAX module's parameters (through the inverse
converter of ``utils/weights.py``) and the same numpy inputs; forward
outputs and gradients (of ``sum(out * G)`` for a fixed numpy G, with
respect to the input and every parameter) are compared.  The JAX pooled
attention kernels run in interpret mode.  Geometry (small): head dim 16,
1-2 heads; the encoder at crop 64, 4 frames, embed 16, depth 3, one
width/head doubling at block 1, q strides at blocks 0-2, kv stride
adaptive [1, 4, 4], where every block takes the kernel route (qN >= 64),
and an odd grid (crop 56, q stride 2 at blocks 1 and 2, kv adaptive
[1, 8, 8]) whose last block is too small for the kernels and resizes its
rel-pos tables (``_interp_rel_pos``).  Attention alone runs at
geometries on both routes: qN >= 64 takes the kernel entries, qN < 64 the
plain logits path, on both sides.  The head-split route (K6) is forced
with the port's ``hl_supported`` patched to False and ``MVIT_HL=0`` on the
JAX side.  Tolerance: fp32 atol = rtol = 2e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procedurevrl_tpu.models import mvit as jm
from procedurevrl_tpu.ops.common import (
    grouped_layer_norm_fp32 as jax_grouped_ln,
)
from procedurevrl_torch.models import mvit as pm
from procedurevrl_torch.ops import mvit_attention as ma
from procedurevrl_torch.ops.common import grouped_layer_norm_fp32
from procedurevrl_torch.utils import weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-5, rtol=2e-5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _compare_grads(port_module, jax_grads, convert, x_grad, jax_x_grad):
    """Port parameter gradients vs the JAX gradient tree mapped onto the
    port's names by ``convert``."""
    want = {}
    convert(_np_tree(jax_grads), want)
    got = {n: p.grad for n, p in port_module.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)
    np.testing.assert_allclose(x_grad, jax_x_grad, **TOL)


def _run_both(jax_module, port_module, convert, x, extra, seed):
    """Init the JAX module on x, load its parameters into the port module,
    and compare outputs and gradients.  The JAX side runs under ``jit``:
    eager dispatch of the interpret-mode kernels is several times slower."""
    params = jax.jit(lambda k, xx: jax_module.init(k, xx, *extra))(
        jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    state = {}
    convert(_np_tree(params), state)
    port_module.load_state_dict(state, strict=True)

    def jax_out(p, xx):
        out = jax_module.apply({"params": p}, xx, *extra)
        return out[0] if isinstance(out, tuple) else out

    def out_and_grads(p, xx, gg):
        out, vjp = jax.vjp(jax_out, p, xx)
        return out, vjp(gg)

    shape = jax.eval_shape(jax_out, params, jnp.asarray(x)).shape
    # a small cotangent keeps the gradients O(1), where fp32 sums over
    # thousands of terms stay inside the 2e-5 tolerance
    g = (0.02 * np.random.RandomState(seed + 100).randn(*shape)).astype(
        np.float32)
    ref, (jgrads, jx) = jax.jit(out_and_grads)(params, jnp.asarray(x),
                                               jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_(True)
    out = port_module(xt, *extra)
    out = out[0] if isinstance(out, tuple) else out
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    out.backward(torch.from_numpy(g))
    _compare_grads(port_module, jgrads, convert, xt.grad.numpy(),
                   np.asarray(jx))


@pytest.mark.parametrize("heads", [1, 3])
def test_grouped_layer_norm_matches_jax(heads):
    rng = np.random.RandomState(heads)
    x = rng.randn(2, 5, heads * 16).astype(np.float32)
    w, b = rng.randn(16).astype(np.float32), rng.randn(16).astype(np.float32)
    g = rng.randn(*x.shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda x, w, b: jax_grouped_ln(x, w, b, heads, 1e-6),
                       *map(jnp.asarray, (x, w, b)))
    refs = vjp(jnp.asarray(g))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    out = grouped_layer_norm_fp32(xt, wt, bt, heads, 1e-6)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    out.backward(torch.from_numpy(g))
    for t, want in zip((xt, wt, bt), refs):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), **TOL)


# dim, dim_out, heads, input grid, q kernel/stride, kv kernel/stride; the
# first two take the kernel route (qN 128), the "small_q" ones the plain
# logits path (qN 32 < MIN_FUSED_QN)
ATTN = {
    "kv_pooled": (32, 32, 2, (2, 8, 8), (3, 3, 3), (1, 1, 1), (3, 3, 3),
                  (1, 2, 2)),
    "q_strided": (16, 32, 2, (2, 16, 16), (3, 3, 3), (1, 2, 2), (3, 3, 3),
                  (1, 4, 4)),
    "small_q": (16, 32, 2, (2, 8, 8), (3, 3, 3), (1, 2, 2), (3, 3, 3),
                (1, 2, 2)),
    "small_q_wide_kv": (32, 32, 2, (2, 8, 8), (3, 3, 3), (1, 2, 2),
                        (3, 3, 3), (1, 1, 1)),
}


def _attn_modules(name, mode="conv", has_cls=True, use_pallas=True):
    dim, dim_out, heads, thw, kq, sq, kkv, skv = ATTN[name]
    kw = dict(num_heads=heads, qkv_bias=True, kernel_q=kq, kernel_kv=kkv,
              stride_q=sq, stride_kv=skv, mode=mode, has_cls_embed=has_cls,
              rel_pos_spatial=True, rel_pos_temporal=True,
              residual_pooling=True)
    jax_mod = jm.MultiScaleAttention(dim=dim, dim_out=dim_out,
                                     input_size=thw, use_pallas=use_pallas,
                                     **kw)
    port = pm.MultiScaleAttention(dim, dim_out, thw,
                                  route=pm.MViTRoute(use_pallas=use_pallas),
                                  **kw)
    x = np.random.RandomState(7).randn(
        2, int(has_cls) + int(np.prod(thw)), dim).astype(np.float32)
    return jax_mod, port, x, thw


def _attn_convert(tree, out):
    weights._mvit_attention(tree, "", out)


@pytest.mark.parametrize("name", sorted(ATTN))
def test_multiscale_attention_matches_jax(name):
    jax_mod, port, x, thw = _attn_modules(name)
    _run_both(jax_mod, port, _attn_convert, x, (thw,), seed=1)


def test_multiscale_attention_without_pallas_matches_jax(monkeypatch):
    """``TPU.USE_PALLAS_ATTENTION False``: a block the kernels would take
    runs the plain logits path on both sides (JAX ``mvit.py:751-757``)."""
    calls = []
    for fn in ("mvit_attention_hl", "mvit_attention", "mvit_attention_kt"):
        orig = getattr(ma, fn)
        monkeypatch.setattr(ma, fn, lambda *a, _o=orig: calls.append(1) or
                            _o(*a))
    jax_mod, port, x, thw = _attn_modules("kv_pooled", use_pallas=False)
    _run_both(jax_mod, port, _attn_convert, x, (thw,), seed=3)
    assert not calls


@pytest.mark.parametrize("mode,has_cls", [("max", True), ("avg", True),
                                          ("conv", False)])
def test_multiscale_attention_other_pools_match_jax(mode, has_cls):
    """Max and average pooling, and a token set without the CLS token (the
    logits path: the kernels need the CLS key)."""
    jax_mod, port, x, thw = _attn_modules("q_strided", mode, has_cls)
    _run_both(jax_mod, port, _attn_convert, x, (thw,), seed=5)


def test_multiscale_attention_head_split_route(monkeypatch):
    """The K6 route (fold to [B*H, L, d] and back) on both sides."""
    monkeypatch.setenv("MVIT_HL", "0")
    monkeypatch.setattr(ma, "hl_supported", lambda *a: False)
    calls = []
    orig = ma.mvit_attention
    monkeypatch.setattr(ma, "mvit_attention",
                        lambda *a: calls.append(1) or orig(*a))
    jax_mod, port, x, thw = _attn_modules("kv_pooled")
    _run_both(jax_mod, port, _attn_convert, x, (thw,), seed=2)
    assert calls


def test_multiscale_attention_routes_through_the_entries(monkeypatch):
    """The route follows the geometry: qN >= MIN_FUSED_QN calls the
    head-last entry, a smaller query grid the plain logits path, which
    calls none."""
    seen = []
    for fn in ("mvit_attention_hl", "mvit_attention"):
        orig = getattr(ma, fn)
        monkeypatch.setattr(ma, fn, lambda *a, _o=orig, _n=fn:
                            seen.append(_n) or _o(*a))
    for name, expect in (("kv_pooled", ["mvit_attention_hl"]),
                         ("q_strided", ["mvit_attention_hl"]),
                         ("small_q", []), ("small_q_wide_kv", [])):
        seen.clear()
        _, port, x, thw = _attn_modules(name)
        port(torch.from_numpy(x), thw)
        assert seen == expect, name


@pytest.mark.parametrize("name", sorted(ATTN))
def test_multiscale_block_matches_jax(name):
    dim, dim_out, heads, thw, kq, sq, kkv, skv = ATTN[name]
    kw = dict(num_heads=heads, input_size=thw, mlp_ratio=4.0, qkv_bias=True,
              kernel_q=kq, kernel_kv=kkv, stride_q=sq, stride_kv=skv,
              mode="conv", has_cls_embed=True, rel_pos_spatial=True,
              rel_pos_temporal=True, residual_pooling=True,
              dim_mul_in_att=True)
    jax_mod = jm.MultiScaleBlock(dim=dim, dim_out=dim_out, use_pallas=True,
                                 **kw)
    port = pm.MultiScaleBlock(dim, dim_out, **kw)
    x = np.random.RandomState(3).randn(
        2, 1 + int(np.prod(thw)), dim).astype(np.float32)

    def convert(tree, out):
        weights._mvit_block(tree, "", out)

    _run_both(jax_mod, port, convert, x, (thw,), seed=3)


ENCODERS = {
    "fused": dict(spatial_size=64, pool_q_stride=((0, 1, 1, 1),
                                                  (1, 1, 2, 2),
                                                  (2, 1, 1, 1)),
                  pool_kv_stride_adaptive=(1, 4, 4)),
    "odd": dict(spatial_size=56, pool_q_stride=((0, 1, 1, 1), (1, 1, 2, 2),
                                                (2, 1, 2, 2)),
                pool_kv_stride_adaptive=(1, 8, 8)),
    "abs_pos": dict(spatial_size=32, pool_q_stride=((1, 1, 2, 2),),
                    pool_kv_stride_adaptive=(1, 4, 4), use_abs_pos=True),
    "sep_pos": dict(spatial_size=32, pool_q_stride=((1, 1, 2, 2),),
                    pool_kv_stride_adaptive=(1, 4, 4), use_abs_pos=True,
                    sep_pos_embed=True),
}


def _mvit_cfg(name, cls):
    return cls(temporal_size=4, embed_dim=16, num_heads=1, depth=3,
               dim_mul=((1, 2.0),), head_mul=((1, 2.0),),
               pool_kvq_kernel=(3, 3, 3), **ENCODERS[name])


def test_encoder_geometries_reach_both_routes():
    """The "fused" geometry runs every block through the kernel entry; the
    "odd" one has a block below MIN_FUSED_QN whose rel-pos tables are
    resized."""
    for name, small in (("fused", []), ("odd", [2])):
        plan = _mvit_cfg(name, pm.MViTConfig).block_schedule()[0]
        qn = [int(np.prod(pm._pooled_thw(s["input_size"], s["kernel_q"],
                                         s["stride_q"]))) for s in plan]
        assert [i for i, n in enumerate(qn) if n < ma.MIN_FUSED_QN] == small
    enc = pm.MViTEncoder(_mvit_cfg("odd", pm.MViTConfig))
    attn = enc.blocks[2].attn
    assert attn.rel_pos_h.shape[0] == 5  # resized to 2 * 4 - 1 = 7
    with pytest.raises(NotImplementedError, match="not ported"):
        pm.MViTEncoder(pm.MViTConfig(norm_stem=True))


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_encoder_matches_jax(name):
    jax_mod = jm.MViTEncoder(cfg=_mvit_cfg(name, jm.MViTConfig),
                             use_pallas=True)
    port = pm.MViTEncoder(_mvit_cfg(name, pm.MViTConfig))
    size = ENCODERS[name]["spatial_size"]
    x = np.random.RandomState(5).randn(2, 4, size, size, 3).astype(np.float32)

    def convert(tree, out):
        weights._mvit_encoder(tree, out, pre="")

    _run_both(jax_mod, port, convert, x, (), seed=4)


def test_encoder_schedule_matches_jax():
    """MViT-v2-S of the shipped config: the same block plan on both sides,
    13 blocks head-last and 3 head-split."""
    from procedurevrl_tpu.config import get_cfg as jax_get_cfg
    from procedurevrl_torch.config import load_config

    path = os.path.join(ROOT, "configs/HowTo100M/procedurevrl_mvitv2_adamw.yaml")
    plan, dims, final = pm.MViTConfig.from_cfg(load_config(path)).block_schedule()
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(path)
    jplan, jdims, jfinal = jm.MViTConfig.from_cfg(jcfg).block_schedule()
    assert (plan, dims, final) == (jplan, jdims, jfinal)
    routes = []
    for spec in plan:
        kshape = pm._pooled_thw(spec["input_size"], spec["kernel_kv"],
                                spec["stride_kv"])
        routes.append(ma.hl_supported(int(np.prod(kshape)), spec["dim_out"],
                                      spec["num_heads"]))
    assert [i for i, r in enumerate(routes) if not r] == [1, 3, 14]


def test_bf16_pool_weight_gradient_is_deterministic():
    """The depthwise pool's bf16 weight gradient on the CPU: equal across
    runs and close to the fp32 one (a channels-last input to ``conv3d``
    gave garbage here)."""
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(6, 2, 16, 16, 16).astype(np.float32))
    pool = pm.DepthwisePool3D(8, (3, 3, 3), (1, 4, 4), heads=2)
    torch.nn.init.normal_(pool.weight, generator=torch.Generator().manual_seed(0))
    grads = []
    for dtype in (torch.bfloat16, torch.bfloat16, torch.float32):
        pool.weight.grad = None
        pool(x.to(dtype)).float().sum().backward()
        grads.append(pool.weight.grad.clone())
    assert torch.equal(grads[0], grads[1])
    torch.testing.assert_close(grads[0], grads[2], atol=0.5, rtol=2e-2)
