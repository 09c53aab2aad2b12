"""The MViT knobs that select no new kernel, against the JAX package.

``MVIT_HL=0`` sends every fused block to the head-split kernel K6 on both
sides; JAX reads it at trace time, the port once into
``MViTRoute.from_env``.  The TPU layout knobs ``MVIT_RELV2``,
``MVIT_SAVE_REL`` and ``MVIT_MAXPOOL=taps`` are refused by the port; the
values JAX reads as off build the default route.  Tolerances: fp32 atol =
rtol = 2e-5, gradients 5e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procedurevrl_tpu.models import mvit as jm
from procedurevrl_torch.models import mvit as pm
from procedurevrl_torch.ops import mvit_attention as ma
from procedurevrl_torch.utils import weights
from test_torch_mvit import ATTN, _run_both

TOL = dict(atol=2e-5, rtol=2e-5)
KNOBS = ("MVIT_HL", "MVIT_RELV2", "MVIT_SAVE_REL", "MVIT_MAXPOOL")


def _clear(monkeypatch):
    for key in KNOBS:
        monkeypatch.delenv(key, raising=False)


@pytest.mark.parametrize("value,hl", [("0", False), ("1", True),
                                      ("false", True), ("", True)])
def test_the_route_reads_mvit_hl_as_jax(value, hl, monkeypatch):
    """JAX compares the string: only ``0`` turns the head-last kernel off."""
    _clear(monkeypatch)
    monkeypatch.setenv("MVIT_HL", value)
    assert pm.MViTRoute.from_env().hl is hl


@pytest.mark.parametrize("key,value", [
    ("MVIT_RELV2", "gather"), ("MVIT_RELV2", "einsum"), ("MVIT_RELV2", "1"),
    ("MVIT_SAVE_REL", "1"), ("MVIT_SAVE_REL", "true"),
    ("MVIT_MAXPOOL", "taps")])
def test_the_tpu_layout_knobs_are_refused(key, value, monkeypatch):
    _clear(monkeypatch)
    monkeypatch.setenv(key, value)
    with pytest.raises(ValueError, match=key):
        pm.MViTRoute.from_env()


@pytest.mark.parametrize("key,value", [
    ("MVIT_RELV2", "0"), ("MVIT_RELV2", ""), ("MVIT_SAVE_REL", "0"),
    ("MVIT_SAVE_REL", ""), ("MVIT_MAXPOOL", "xla")])
def test_the_values_jax_reads_as_off_build_the_default(key, value,
                                                       monkeypatch):
    _clear(monkeypatch)
    monkeypatch.setenv(key, value)
    assert pm.MViTRoute.from_env() == pm.MViTRoute()
    assert "mvit_rel" not in pm.REMAT_NAMES


def _block(name, route, hl_env, monkeypatch):
    """A MultiScaleBlock of ``ATTN[name]`` on both sides; JAX reads
    ``MVIT_HL`` at trace time."""
    for key, value in hl_env.items():
        monkeypatch.setenv(key, value)
    dim, dim_out, heads, thw, kq, sq, kkv, skv = ATTN[name]
    kw = dict(num_heads=heads, input_size=thw, mlp_ratio=4.0, qkv_bias=True,
              kernel_q=kq, kernel_kv=kkv, stride_q=sq, stride_kv=skv,
              mode="conv", has_cls_embed=True, rel_pos_spatial=True,
              rel_pos_temporal=True, residual_pooling=True,
              dim_mul_in_att=True)
    jax_mod = jm.MultiScaleBlock(dim=dim, dim_out=dim_out, use_pallas=True,
                                 **kw)
    port = pm.MultiScaleBlock(dim, dim_out, route=route, **kw)
    x = np.random.RandomState(3).randn(
        2, 1 + int(np.prod(thw)), dim).astype(np.float32)
    return jax_mod, port, x, thw


def _convert(tree, out):
    weights._mvit_block(tree, "", out)


@pytest.mark.parametrize("name", ["q_strided"])
def test_hl_off_sends_every_fused_block_to_k6(name, monkeypatch):
    """``MVIT_HL=0``: the blocks K5 takes on the default route run K6 on
    both sides (JAX ``mvit.py:657``), outputs and gradients."""
    route = pm.MViTRoute(hl=False, kt=True)
    jax_mod, port, x, thw = _block(name, route, {"MVIT_HL": "0",
                                                 "MVIT_KT": "1"}, monkeypatch)
    assert ma.hl_supported(int(np.prod(pm._pooled_thw(
        thw, ATTN[name][6], ATTN[name][7]))), ATTN[name][1], ATTN[name][2])
    seen = []
    for fn in ("mvit_attention_hl", "mvit_attention", "mvit_attention_kt"):
        orig = getattr(ma, fn)
        monkeypatch.setattr(ma, fn, lambda *a, _o=orig, _n=fn:
                            seen.append(_n) or _o(*a))
    _run_both(jax_mod, port, _convert, x, (thw,), seed=6)
    assert seen == ["mvit_attention"]


@pytest.mark.parametrize("ties", [False, True])
def test_the_default_max_pool_matches_jax(ties):
    """The max pool every route takes (mode ``max``'s q/k/v pools and the
    pooled skip): forward on continuous and tied integer data, against
    JAX's ``reduce_window``."""
    rng = np.random.RandomState(5)
    x = (rng.randint(-2, 3, (2, 3, 6, 6, 4)) if ties
         else rng.randn(2, 3, 6, 6, 4)).astype(np.float32)
    for kernel, stride in (((3, 3, 3), (1, 2, 2)), ((1, 3, 3), (1, 1, 1))):
        pad = [k // 2 for k in kernel]
        want = np.asarray(jm._max_pool_3d(jnp.asarray(x), kernel, stride,
                                          pad))
        got = pm._max_pool_3d(torch.from_numpy(x), kernel, stride, pad)
        np.testing.assert_array_equal(got.numpy(), want)
