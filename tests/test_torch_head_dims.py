"""Head dims other than the shipped models' on the PyTorch port's kernels,
against the JAX package, which runs its kernels at every head dim its
shape rules admit:

- the key-tiled pair (``ops/flash_attention.py``) takes every head dim
  that is a multiple of 8 up to 256 on one of its tile widths, and its
  plain version matches JAX ``flash_attention_headfused`` at d = 16 and 80;
- K1's function at a head dim other than 64 takes the pair on the fused
  qkv (``spatial_attention.on_pair``), K2's function takes the pair's
  temporal layout on either route, and a 2-layer TimeSformer of 4 heads of
  32 matches JAX's (its K1 and K2 kernels in interpret mode), forward and
  gradients;
- the MViT kernels take every head dim that is a multiple of 8 up to 128
  on one of their tile widths, and at d = 72 (MViT-v2-L's) the plain
  versions match JAX ``flash_attention_mvit`` / ``flash_attention_mvit_hl``
  (interpret mode), as does a multiscale attention block.

On the CPU every wrapper runs its plain version; the kernels themselves
are held at these head dims by ``tests/test_torch_kernels_cuda.py`` on the
card.  Tolerance: fp32, atol = rtol = 2e-5 (the repository's parity
tolerance), 5e-5 for gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procedurevrl_tpu.models import mvit as jm
from procedurevrl_tpu.models.timesformer import TimeSformer as JaxTimeSformer
from procedurevrl_tpu.ops import pallas_attention as pa
from procedurevrl_tpu.ops.pallas_mvit_attention import (
    flash_attention_mvit, flash_attention_mvit_hl,
)
from procedurevrl_torch.models import mvit as pm
from procedurevrl_torch.models.timesformer import TimeSformer
from procedurevrl_torch.ops import flash_attention as fa
from procedurevrl_torch.ops import mvit_attention as ma
from procedurevrl_torch.ops import spatial_attention as k1
from procedurevrl_torch.ops import temporal_attention as k2
from procedurevrl_torch.ops.attention_route import AttentionRoute
from procedurevrl_torch.utils.weights import params_from_jax
from test_torch_mvit import _attn_convert, _run_both
from test_torch_timesformer import random_params

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)


def _count(monkeypatch, pairs):
    """Wrap each (module, name) with a counter of its calls."""
    calls = {name: 0 for _, name in pairs}
    for mod, name in pairs:
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **kw: (
            calls.__setitem__(_n, calls[_n] + 1) or _f(*a, **kw)))
    return calls


# ------------------------------------------------------------ the pair


@pytest.mark.parametrize("d,width", [(8, 32), (16, 32), (32, 32), (48, 64),
                                     (72, 96), (80, 96), (128, 128),
                                     (136, 192), (200, 256), (256, 256)])
def test_pair_takes_every_head_dim_that_is_a_multiple_of_8(d, width):
    assert fa.tile_width(d) == width


@pytest.mark.parametrize("d", [4, 12, 100, 264, 512])
def test_pair_refuses_other_head_dims_naming_the_limit(d):
    with pytest.raises(ValueError, match="multiples of 8 up to 256"):
        fa.tile_width(d)


@pytest.mark.parametrize("d", [16, 80])
def test_pair_plain_matches_jax_at_other_head_dims(d):
    heads, b, n = 8, 1, 20  # 8 heads: JAX's 128-lane geometry for d = 16, 80
    c, scale = heads * d, d ** -0.5
    rng = np.random.RandomState(d)
    q, k, v, g = (rng.randn(b, n, c).astype(np.float32) for _ in range(4))
    ref, vjp = jax.vjp(lambda *a: pa.flash_attention_headfused(
        *a, heads, scale), *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    np.testing.assert_allclose(fa.flash_attention(*t, heads, scale).numpy(),
                               np.asarray(ref), **TOL)
    grads = fa.flash_attention_bwd(*t, torch.from_numpy(g), None, heads,
                                   scale)
    for a, r in zip(grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **GRAD_TOL)


# ----------------------------------------------------------- K1 and K2


@pytest.mark.parametrize("n,d,pair", [(196, 64, False), (207, 64, False),
                                      (208, 64, True), (196, 32, True),
                                      (196, 80, True), (196, 128, True)])
def test_k1_takes_the_pair_past_its_own_kernels(n, d, pair):
    assert k1.on_pair(n, d) == pair


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("batched", [False, True])
def test_k2_takes_the_pair_at_other_head_dims(d, batched, monkeypatch):
    calls = _count(monkeypatch, [(fa, "flash_attention_temporal_autograd"),
                                 (k2, "temporal_attention"),
                                 (k2, "temporal_attention_v3")])
    heads, scale = 2, d ** -0.5
    rng = np.random.RandomState(d)
    qkv = torch.from_numpy(rng.randn(2, 4, 3, 3 * heads * d).astype(np.float32))
    route = AttentionRoute(temporal_batched=batched)
    with torch.no_grad():
        k2.temporal_attention_autograd(qkv, heads, scale, route)
    on_pair = d != k2.HEAD_DIM
    assert calls["flash_attention_temporal_autograd"] == int(on_pair)
    assert calls["temporal_attention" + ("_v3" if batched else "")] == int(
        not on_pair)


@pytest.mark.parametrize("t", [4, 8])
def test_k2_function_on_the_pair_matches_jax(t):
    heads, d, b, n = 4, 32, 2, 3  # 4 heads of 32: JAX's 128-lane block
    scale = d ** -0.5
    rng = np.random.RandomState(t)
    qkv = rng.randn(b, t, n, 3 * heads * d).astype(np.float32)
    g = rng.randn(b, t, n, heads * d).astype(np.float32)
    ref, vjp = jax.vjp(lambda x: pa.flash_attention_temporal(x, heads, scale),
                       jnp.asarray(qkv))
    (jdx,) = vjp(jnp.asarray(g))
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = fa.flash_attention_temporal_autograd(x, heads, scale)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jdx), **GRAD_TOL)


def test_timesformer_at_head_dim_32_matches_jax(monkeypatch):
    """Two divided space-time blocks of 4 heads of 32: JAX runs K1 and K2
    (interpret mode); the port takes the pair for both passes."""
    monkeypatch.setenv("PALLAS_MIN_LEN", "1")
    geom = dict(img_size=32, patch_size=16, embed_dim=128, depth=2,
                num_heads=4, num_frames=2, drop_path_rate=0.0)
    # K1's forward under grad: the saved-probability kernel on one device,
    # the recompute one on a device mesh
    k1_fwd = ("_fwd_cls_qkv_kernel_sp", "_fwd_cls_qkv_kernel")
    jcalls = _count(monkeypatch, [(pa, n) for n in k1_fwd
                                  + ("_temporal_fwd_kernel",)])
    pcalls = _count(monkeypatch, [(fa, "flash_attention_qkv_autograd"),
                                  (fa, "flash_attention_temporal_autograd"),
                                  (k1, "spatial_attention"),
                                  (k2, "temporal_attention")])
    rng = np.random.RandomState(32)
    x = rng.randn(2, 2, 32, 32, 3).astype(np.float32)
    jmodel = JaxTimeSformer(**geom, dtype=jnp.float32, use_pallas=True)
    params = random_params(jmodel, x, rng)
    g = (0.1 * rng.randn(2, geom["embed_dim"])).astype(np.float32)

    def loss(p, xx):
        out = jmodel.apply({"params": p}, xx, deterministic=True)
        return jnp.sum(out * g), out

    (_, ref), (jgp, jgx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    assert sum(jcalls[n] for n in k1_fwd) > 0, jcalls
    assert jcalls["_temporal_fwd_kernel"] > 0, jcalls

    model = TimeSformer(**geom, route=AttentionRoute.from_env())
    model.load_state_dict(params_from_jax(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = model(xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    (out * torch.from_numpy(g)).sum().backward()
    assert pcalls == {"flash_attention_qkv_autograd": geom["depth"],
                      "flash_attention_temporal_autograd": geom["depth"],
                      "spatial_attention": 0, "temporal_attention": 0}
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **GRAD_TOL)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgp))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   **GRAD_TOL, err_msg=name)


# ------------------------------------------------------------------ MViT


@pytest.mark.parametrize("d,width", [(8, 64), (64, 64), (72, 96), (96, 96),
                                     (104, 128), (128, 128)])
def test_mvit_kernels_take_every_head_dim_that_is_a_multiple_of_8(d, width):
    assert ma.tile_width(d) == width


@pytest.mark.parametrize("d", [12, 136, 256])
def test_mvit_kernels_refuse_other_head_dims_naming_the_limit(d):
    with pytest.raises(ValueError, match="multiples of 8 up to 128"):
        ma.tile_width(d)


B, H, D72, QN, K_SHAPE = 2, 2, 72, 70, (2, 3, 4)
ARGS = ("q", "k", "v", "kc", "vc", "rel")


def _mvit_inputs(seed):
    """Head-last q [B, qN, H*72], k, v, kc, vc, rel, g, one query row with
    logits above 80."""
    rng = np.random.RandomState(seed)
    c, kn, kcat = H * D72, int(np.prod(K_SHAPE)), sum(K_SHAPE)
    mk = lambda *s: (rng.randn(*s) * 0.5).astype(np.float32)
    x = dict(q=mk(B, QN, c), k=mk(B, kn, c), v=mk(B, kn, c), kc=mk(B, 1, c),
             vc=mk(B, 1, c), rel=mk(B, QN, H * kcat), g=mk(B, QN, c))
    x["q"][0, 5] = x["k"][0, 3] * 40.0
    return x


def _fold(a):
    b, n, c = a.shape
    return np.ascontiguousarray(a.reshape(b, n, H, c // H).transpose(
        0, 2, 1, 3).reshape(b * H, n, c // H))


@pytest.mark.parametrize("head_last", [True, False])
def test_mvit_attention_at_head_dim_72_matches_jax(head_last):
    x = _mvit_inputs(72 + head_last)
    if not head_last:
        x = {k: _fold(v) for k, v in x.items()}
    scale = D72 ** -0.5
    if head_last:
        jfn = lambda *a: flash_attention_mvit_hl(*a, K_SHAPE, H, scale)
    else:
        jfn = lambda *a: flash_attention_mvit(*a, K_SHAPE, scale)
    ref, vjp = jax.vjp(jfn, *(jnp.asarray(x[k]) for k in ARGS))
    jgrads = vjp(jnp.asarray(x["g"]))
    t = {k: torch.from_numpy(v).requires_grad_(k in ARGS)
         for k, v in x.items()}
    args = [t[k] for k in ARGS]
    out = (ma.mvit_attention_hl(*args, K_SHAPE, H, scale) if head_last
           else ma.mvit_attention(*args, K_SHAPE, scale))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    out.backward(t["g"])
    for k, r in zip(ARGS, jgrads):
        np.testing.assert_allclose(t[k].grad.numpy(), np.asarray(r),
                                   **GRAD_TOL, err_msg=k)


def test_multiscale_attention_at_head_dim_72_matches_jax():
    """A multiscale attention block of 2 heads of 72 (MViT-v2-L's width 144
    at stage 1) on the kernel route (qN 128) on both sides."""
    kw = dict(num_heads=2, qkv_bias=True, kernel_q=(3, 3, 3),
              kernel_kv=(3, 3, 3), stride_q=(1, 1, 1), stride_kv=(1, 2, 2),
              mode="conv", has_cls_embed=True, rel_pos_spatial=True,
              rel_pos_temporal=True, residual_pooling=True)
    thw = (2, 8, 8)
    jax_mod = jm.MultiScaleAttention(dim=144, dim_out=144, input_size=thw,
                                     use_pallas=True, **kw)
    port = pm.MultiScaleAttention(144, 144, thw,
                                  route=pm.MViTRoute(use_pallas=True), **kw)
    x = np.random.RandomState(72).randn(2, 1 + int(np.prod(thw)),
                                        144).astype(np.float32)
    _run_both(jax_mod, port, _attn_convert, x, (thw,), seed=72)
