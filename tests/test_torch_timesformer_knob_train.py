"""Slice 5 of the PyTorch port as a whole: one TimeSformer order-pretraining
AdamW step on the JAX package's attention knob routes against the JAX
package's ``make_train_step`` under the same knobs, and the routing of
``spatial_attention_autograd`` / ``temporal_attention_autograd`` for every
knob combination.

- Route A: ``SPATIAL_SAVE_PROBS=0 SPATIAL_PIPE=1 TEMPORAL_BATCHED=1`` (the
  port: K1p + K1br, K2v3f + K2v3b; JAX: ``_pipe_kernel`` +
  ``_bwd_cls_qkv_kernel``, the v3 temporal pair).
- Route B: ``SPATIAL_DELTA=1`` (the port: K1sp + K1bd, K2f + K2b; JAX:
  ``_bwd_cls_qkv_kernel_sp_delta``, which it takes only on one device, so
  ``jax.device_count`` is forced to 1 around its step).

The geometry, towers, batch, fixed diffusion draws and tolerances are
those of ``tests/test_torch_train.py`` (depth 2, width 128, 2 heads of 64,
``PALLAS_MIN_LEN=1`` so that JAX runs its Pallas kernels in interpret
mode): loss, KL, MSE and gradients fp32 atol = rtol = 2e-5; updated
parameters 1e-6 where the gradient exceeds 1e-6, else within one step
(2 lr).  On the CPU the port's wrappers run their plain versions; the test
counts which wrappers each route reached.
"""

import math
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from procedurevrl_tpu.config import get_cfg as jax_get_cfg
from procedurevrl_tpu.engine.steps import TrainState
from procedurevrl_tpu.engine.steps import make_train_step as jax_make_train_step
from procedurevrl_tpu.models.order_transformer import (
    OrderTransformer as JaxOrderTransformer,
)
from procedurevrl_tpu.ops import pallas_attention as pa
from procedurevrl_tpu.solver import construct_optimizer as jax_optimizer
from procedurevrl_tpu.solver import lr_schedule as jax_lr_schedule
from procedurevrl_tpu.utils.converter import convert_procedurevrl
from procedurevrl_torch.config import get_cfg
from procedurevrl_torch.engine.steps import make_train_step
from procedurevrl_torch.models.procedurevrl import ProcedureVRL
from procedurevrl_torch.ops import spatial_attention as k1
from procedurevrl_torch.ops import temporal_attention as k2
from procedurevrl_torch.ops.attention_route import AttentionRoute
from procedurevrl_torch.solver.lr_policy import lr_schedule
from procedurevrl_torch.solver.optimizer import construct_optimizer
from procedurevrl_torch.utils import weights
from test_torch_train import (
    GEOM, LR, TOL, TOWERS, _bank, _batch, _cfg, _draws, _flat, _jax_params,
    _torch_batch, _torch_draws,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = ("SPATIAL_SAVE_PROBS", "SPATIAL_DELTA", "SPATIAL_PIPE",
         "SPATIAL_PIPE_NBUF", "TEMPORAL_BATCHED")
ROUTES = {
    "A": ({"SPATIAL_SAVE_PROBS": "0", "SPATIAL_PIPE": "1",
           "TEMPORAL_BATCHED": "1"},
          {"spatial_attention_pipe", "spatial_attention_bwd_recompute",
           "temporal_attention_v3", "temporal_attention_v3_bwd"},
          ("_pipe_kernel", "_bwd_cls_qkv_kernel", "_temporal_fwd_kernel_v3",
           "_temporal_bwd_kernel_v3")),
    "B": ({"SPATIAL_DELTA": "1"},
          {"spatial_attention_fwd_probs", "spatial_attention_bwd_delta",
           "temporal_attention", "temporal_attention_bwd"},
          ("_bwd_cls_qkv_kernel_sp_delta",)),
}
# the wrappers whose calls are counted on the port side
WRAPPERS = ((k1, "spatial_attention"), (k1, "spatial_attention_pipe"),
            (k1, "spatial_attention_fwd_probs"), (k1, "spatial_attention_bwd"),
            (k1, "spatial_attention_bwd_recompute"),
            (k1, "spatial_attention_bwd_delta"), (k2, "temporal_attention"),
            (k2, "temporal_attention_bwd"), (k2, "temporal_attention_v3"),
            (k2, "temporal_attention_v3_bwd"))


def _count(monkeypatch, pairs, seen: set) -> None:
    for mod, name in pairs:
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **kw:
                            seen.add(_n) or _f(*a, **kw))


@pytest.fixture(scope="module")
def jax_init():
    """The bank and the JAX model with its initial parameters, shared by
    both routes (the parameters do not depend on the route)."""
    bank = _bank()
    return (bank, *_jax_params(bank))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_knob_train_step_matches_jax(route, jax_init, monkeypatch):
    knobs, port_fns, jax_fns = ROUTES[route]
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("PALLAS_MIN_LEN", "1")
    bank, jmodel, params = jax_init
    batch, draws = _batch(2), _draws(3)

    orig = JaxOrderTransformer.pretrain

    def fixed_pretrain(self, x, mask_inds=None, pad_start=None,
                       level_noise=None):
        return orig(self, x, jnp.asarray(draws["mask_inds"]),
                    jnp.asarray(draws["pad_start"]),
                    jnp.asarray(draws["level_noise"]))

    monkeypatch.setattr(JaxOrderTransformer, "pretrain", fixed_pretrain)
    jax_seen = set()
    _count(monkeypatch, [(pa, name) for name in jax_fns], jax_seen)
    if route == "B":
        monkeypatch.setattr(jax, "device_count", lambda *a, **k: 1)
    jcfg = _cfg(jax_get_cfg())
    sched = jax_lr_schedule(jcfg, 10)
    tx = jax_optimizer(params, jcfg, sched)
    jstep = jax_make_train_step(jmodel, tx, jcfg, bank, sched, 2)
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    jgrads, jmetrics, _ = jax.jit(jstep.grad_step)(
        params, 0, zeros, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(5))
    state = jax.jit(jstep.apply_step)(
        TrainState.create(params, tx),
        jax.tree_util.tree_map(lambda g: 2 * g, jgrads))
    jmetrics = dict(jmetrics, grad_norm=optax.global_norm(jgrads))
    assert jax_seen == set(jax_fns), jax_seen  # JAX took the knob kernels
    jgrads = _flat(jax.tree_util.tree_map(np.asarray, jgrads))
    new_params = _flat(jax.tree_util.tree_map(np.asarray, state.params))

    # the port, its route read from the same environment
    model = ProcedureVRL(**GEOM, **TOWERS, route=AttentionRoute.from_env())
    model.load_state_dict(weights.params_from_jax(params), strict=True)
    port_seen = set()
    _count(monkeypatch, WRAPPERS, port_seen)
    cfg = _cfg(get_cfg())
    step = make_train_step(model, construct_optimizer(model, cfg), cfg,
                           torch.from_numpy(bank), lr_schedule(cfg, 10))
    metrics = step(_torch_batch(batch), draws=_torch_draws(draws))
    assert port_seen == port_fns, port_seen

    for k in ("loss", "kl", "mse", "top1_err", "top5_err", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   **TOL, err_msg=k)
    assert math.isfinite(float(metrics["loss"]))
    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
    grads = _flat(convert_procedurevrl({n: p.grad for n, p in trained.items()}))
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        np.testing.assert_allclose(g, jgrads[k], **TOL, err_msg=str(k))
    after = _flat(convert_procedurevrl(
        {n: p.detach() for n, p in model.named_parameters()}))
    for k, p in after.items():
        sure = np.abs(jgrads[k]) > 1e-6
        np.testing.assert_allclose(p[sure], new_params[k][sure], atol=1e-6,
                                   rtol=1e-6, err_msg=str(k))
        np.testing.assert_allclose(p[~sure], new_params[k][~sure],
                                   atol=2 * LR, rtol=0, err_msg=str(k))


# (save_probs, delta, pipe) -> (forward under grad, backward, forward
# without grad), as the table of JAX _facq_fwd / _facq_bwd on one device
SPATIAL_TABLE = {
    (True, False, False): ("spatial_attention_fwd_probs",
                           "spatial_attention_bwd", "spatial_attention"),
    (True, False, True): ("spatial_attention_fwd_probs",
                          "spatial_attention_bwd", "spatial_attention_pipe"),
    (True, True, False): ("spatial_attention_fwd_probs",
                          "spatial_attention_bwd_delta", "spatial_attention"),
    (True, True, True): ("spatial_attention_fwd_probs",
                         "spatial_attention_bwd_delta",
                         "spatial_attention_pipe"),
    (False, False, False): ("spatial_attention",
                            "spatial_attention_bwd_recompute",
                            "spatial_attention"),
    (False, True, False): ("spatial_attention",
                           "spatial_attention_bwd_recompute",
                           "spatial_attention"),
    (False, False, True): ("spatial_attention_pipe",
                           "spatial_attention_bwd_recompute",
                           "spatial_attention_pipe"),
    (False, True, True): ("spatial_attention_pipe",
                          "spatial_attention_bwd_recompute",
                          "spatial_attention_pipe"),
}


@pytest.mark.parametrize("knobs", sorted(SPATIAL_TABLE),
                         ids=lambda k: "save%d_delta%d_pipe%d" % k)
def test_spatial_route_table(knobs, monkeypatch):
    save_probs, delta, pipe = knobs
    monkeypatch.setenv("SPATIAL_SAVE_PROBS", str(int(save_probs)))
    monkeypatch.setenv("SPATIAL_DELTA", str(int(delta)))
    monkeypatch.setenv("SPATIAL_PIPE", str(int(pipe)))
    monkeypatch.setenv("SPATIAL_PIPE_NBUF", "2")
    route = AttentionRoute.from_env()
    assert route == AttentionRoute(save_probs, delta, pipe, 2, False)
    fwd, bwd, nograd = SPATIAL_TABLE[knobs]
    seen = []
    for name in ("spatial_attention", "spatial_attention_pipe",
                 "spatial_attention_fwd_probs", "spatial_attention_bwd",
                 "spatial_attention_bwd_recompute",
                 "spatial_attention_bwd_delta"):
        fn = getattr(k1, name)
        monkeypatch.setattr(k1, name, lambda *a, _f=fn, _n=name, **kw:
                            seen.append((_n, a[4:])) or _f(*a, **kw))
    monkeypatch.setattr(k1, "_warned_pipe_vs_saveprobs", False)
    rng = np.random.RandomState(7)
    qkv = torch.from_numpy(rng.randn(2, 6, 3 * 128).astype(np.float32))
    qkv_c = torch.from_numpy(rng.randn(2, 1, 3 * 128).astype(np.float32))

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(2):
            seen.clear()
            a = qkv.clone().requires_grad_(True)
            out, out_c = k1.spatial_attention_autograd(a, qkv_c, 2, 0.125,
                                                       route)
            (out.sum() + out_c.sum()).backward()
            assert [n for n, _ in seen] == [fwd, bwd]
    pipe_warnings = [w for w in caught if "SPATIAL_PIPE" in str(w.message)]
    assert len(pipe_warnings) == (1 if save_probs and pipe else 0)
    if fwd == "spatial_attention_pipe":
        assert seen[0][1] == (2,)  # the ring depth the route asks for

    seen.clear()
    with torch.no_grad():
        k1.spatial_attention_autograd(qkv, qkv_c, 2, 0.125, route)
    assert [n for n, _ in seen] == [nograd]


@pytest.mark.parametrize("batched", [False, True])
def test_temporal_route(batched, monkeypatch):
    monkeypatch.setenv("TEMPORAL_BATCHED", str(int(batched)))
    route = AttentionRoute.from_env()
    seen = []
    for name in ("temporal_attention", "temporal_attention_bwd",
                 "temporal_attention_v3", "temporal_attention_v3_bwd"):
        fn = getattr(k2, name)
        monkeypatch.setattr(k2, name, lambda *a, _f=fn, _n=name, **kw:
                            seen.append((_n, kw)) or _f(*a, **kw))
    qkv = torch.from_numpy(
        np.random.RandomState(8).randn(1, 3, 4, 3 * 128).astype(np.float32))
    a = qkv.clone().requires_grad_(True)
    k2.temporal_attention_autograd(a, 2, 0.125, route).sum().backward()
    want = (["temporal_attention_v3", "temporal_attention_v3_bwd"] if batched
            else ["temporal_attention", "temporal_attention_bwd"])
    assert [n for n, _ in seen] == want
    seen.clear()
    with torch.no_grad():
        k2.temporal_attention_autograd(qkv, 2, 0.125, route)
    if batched:
        assert seen == [("temporal_attention_v3", {"save_probs": False})]
    else:
        assert seen == [("temporal_attention", {})]


@pytest.mark.parametrize("knob,value", [("SPATIAL_PIPE", "maybe"),
                                        ("SPATIAL_PIPE_NBUF", "two"),
                                        ("SPATIAL_PIPE_NBUF", "0"),
                                        ("TEMPORAL_BATCHED", "2"),
                                        ("SPATIAL_SHIFT", "rowmax"),
                                        ("TEMPORAL_SHIFT", ""),
                                        ("TEMPORAL_PALLAS", "2"),
                                        ("PALLAS_MIN_LEN", "many")])
def test_a_malformed_knob_raises(knob, value, monkeypatch):
    monkeypatch.setenv(knob, value)
    with pytest.raises(ValueError, match=knob):
        AttentionRoute.from_env()


def _tiny_cfg(model: str, *opts):
    from procedurevrl_torch.config import load_config

    if model == "mvit":
        return load_config(os.path.join(
            ROOT, "configs/HowTo100M/procedurevrl_mvitv2_sgd.yaml"),
            ["DEV.LOAD_DUMMY_DATA", "True", *opts])
    return load_config(
        os.path.join(ROOT, "configs/COIN/step_classification.yaml"),
        ["TRAIN.ENABLE", "False", "DEV.MATCH_LANG_EMB", "True",
         "DEV.LOAD_DUMMY_DATA", "True", "TIMESFORMER.DEPTH", "1",
         "DATA.NUM_FRAMES", "2", "DATA.TRAIN_CROP_SIZE", "32",
         "DATA.TEST_CROP_SIZE", "32", *opts])


# A shift knob on the kernel routes: every kernel takes its knob's variant.
# The tiny TimeSformer (crop 32, N = 4 frame tokens: PALLAS_MIN_LEN=1 sends
# the spatial pass to K1, and the temporal pass takes K2 there by default)
# and an MViT-v2-S attention block routed to K5 (``test_torch_mvit``'s
# "kv_pooled", outputs and gradients) against the JAX model under the same
# knob, its Pallas kernels in interpret mode (its caches cleared first: JAX
# reads the knob when it traces), fp32 atol = rtol = 2e-5.  The kernel-level
# cases, on logits where the shifts part, are ``tests/test_torch_shift.py``.
@pytest.mark.parametrize("model,knob,value", [
    ("timesformer", "SPATIAL_SHIFT", "max"),
    ("timesformer", "SPATIAL_SHIFT", "none"),
    ("timesformer", "TEMPORAL_SHIFT", "max"),
    ("timesformer", "TEMPORAL_SHIFT", "none"),
    ("mvit", "MVIT_SHIFT", "max"),
    ("mvit", "MVIT_SHIFT", "none")])
def test_an_unported_knob_raises_at_build(model, knob, value, monkeypatch):
    """The knob builds, takes the kernels' route and matches JAX."""
    from procedurevrl_tpu.models import mvit as jm
    from procedurevrl_tpu.models.timesformer import (
        TimeSformer as JaxTimeSformer,
    )
    from procedurevrl_torch.models import mvit as pm
    from procedurevrl_torch.models.timesformer import TimeSformer
    from procedurevrl_torch.ops import mvit_attention as ma
    from test_torch_mvit import ATTN, _attn_convert, _run_both
    from test_torch_timesformer import GEOM as ENC, TOL as ENC_TOL
    from test_torch_timesformer import random_params

    monkeypatch.setenv(knob, value)
    monkeypatch.setenv("PALLAS_MIN_LEN", "1")
    jax.clear_caches()
    if model == "mvit":
        seen = []
        entry = ma.mvit_attention_hl
        monkeypatch.setattr(ma, "mvit_attention_hl",
                            lambda *a: seen.append(a[-1]) or entry(*a))
        dim, dim_out, heads, thw, kq, sq, kkv, skv = ATTN["kv_pooled"]
        kw = dict(num_heads=heads, qkv_bias=True, kernel_q=kq,
                  kernel_kv=kkv, stride_q=sq, stride_kv=skv, mode="conv",
                  has_cls_embed=True, rel_pos_spatial=True,
                  rel_pos_temporal=True, residual_pooling=True)
        jmod = jm.MultiScaleAttention(dim=dim, dim_out=dim_out,
                                      input_size=thw, use_pallas=True, **kw)
        route = pm.MViTRoute.from_env(use_pallas=True)
        assert route.shift == value
        port = pm.MultiScaleAttention(dim, dim_out, thw, route=route, **kw)
        x = np.random.RandomState(7).randn(
            2, 1 + int(np.prod(thw)), dim).astype(np.float32)
        _run_both(jmod, port, _attn_convert, x, (thw,), seed=4)
        assert seen and set(seen) == {value}
        return
    seen = []
    for mod, name in WRAPPERS:
        fn = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda *a, _f=fn, _n=name, **k:
            seen.append((_n, k.get("shift", a[-1]))) or _f(*a, **k))
    rng = np.random.RandomState(21)
    x = rng.randn(2, 4, 32, 32, 3).astype(np.float32)
    jmodel = JaxTimeSformer(**ENC, dtype=jnp.float32, use_pallas=True)
    params = random_params(jmodel, x, rng)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x),
                                  deterministic=True))
    route = AttentionRoute.from_env(use_pallas=True)
    model = TimeSformer(**ENC, route=route).eval()
    model.load_state_dict(weights.params_from_jax(params), strict=True)
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **ENC_TOL)
    ours = "spatial_attention" if knob == "SPATIAL_SHIFT" else (
        "temporal_attention")
    assert {s for n, s in seen if n == ours} == {value}
    assert {s for n, s in seen if n != ours} == {"clamp"}


# The same knobs where no kernel runs: the port builds and runs, and
# matches the JAX model (fp32, atol = rtol = 2e-5) with the same weights
# and numpy inputs.  SPATIAL_SHIFT: TPU.USE_PALLAS_ATTENTION False;
# TEMPORAL_SHIFT: TEMPORAL_PALLAS=0 at N = 4 < PALLAS_MIN_LEN; MVIT_SHIFT:
# a kernel-sized block with TPU.USE_PALLAS_ATTENTION False.
@pytest.mark.parametrize("knob,value", [
    ("SPATIAL_SHIFT", "max"), ("SPATIAL_SHIFT", "none"),
    ("TEMPORAL_SHIFT", "max"), ("TEMPORAL_SHIFT", "none"),
    ("MVIT_SHIFT", "max"), ("MVIT_SHIFT", "none")])
def test_a_shift_knob_runs_where_no_kernel_does(knob, value, monkeypatch):
    from procedurevrl_tpu.models import mvit as jm
    from procedurevrl_tpu.models.timesformer import (
        TimeSformer as JaxTimeSformer,
    )
    from procedurevrl_torch.models import mvit as pm
    from procedurevrl_torch.models.timesformer import TimeSformer
    from procedurevrl_torch.ops import mvit_attention as ma
    from test_torch_mvit import ATTN, _attn_convert, _run_both
    from test_torch_timesformer import GEOM as ENC, TOL as ENC_TOL
    from test_torch_timesformer import random_params

    monkeypatch.setenv(knob, value)
    monkeypatch.delenv("PALLAS_MIN_LEN", raising=False)
    if knob == "MVIT_SHIFT":
        for fn in ("mvit_attention_hl", "mvit_attention", "mvit_attention_kt"):
            monkeypatch.setattr(ma, fn, lambda *a: pytest.fail("a kernel ran"))
        dim, dim_out, heads, thw, kq, sq, kkv, skv = ATTN["kv_pooled"]
        kw = dict(num_heads=heads, qkv_bias=True, kernel_q=kq,
                  kernel_kv=kkv, stride_q=sq, stride_kv=skv, mode="conv",
                  has_cls_embed=True, rel_pos_spatial=True,
                  rel_pos_temporal=True, residual_pooling=True)
        jmod = jm.MultiScaleAttention(dim=dim, dim_out=dim_out,
                                      input_size=thw, use_pallas=False, **kw)
        route = pm.MViTRoute.from_env(use_pallas=False)
        assert route.shift == value
        port = pm.MultiScaleAttention(dim, dim_out, thw, route=route, **kw)
        x = np.random.RandomState(7).randn(
            2, 1 + int(np.prod(thw)), dim).astype(np.float32)
        _run_both(jmod, port, _attn_convert, x, (thw,), seed=4)
        return
    for mod, name in WRAPPERS:
        monkeypatch.setattr(mod, name, lambda *a, **k: pytest.fail("K1/K2"))
    use_pallas = knob == "TEMPORAL_SHIFT"
    if use_pallas:
        monkeypatch.setenv("TEMPORAL_PALLAS", "0")
    rng = np.random.RandomState(21)
    x = rng.randn(2, 4, 32, 32, 3).astype(np.float32)
    jmodel = JaxTimeSformer(**ENC, dtype=jnp.float32, use_pallas=use_pallas)
    params = random_params(jmodel, x, rng)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x),
                                  deterministic=True))
    route = AttentionRoute.from_env(use_pallas=use_pallas)
    assert (route.spatial_shift if knob == "SPATIAL_SHIFT"
            else route.temporal_shift) == value
    model = TimeSformer(**ENC, route=route).eval()
    model.load_state_dict(weights.params_from_jax(params), strict=True)
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **ENC_TOL)


def test_the_kt_route_runs_under_a_max_shift(monkeypatch):
    """``MVIT_KT=1 MVIT_SHIFT=max``: K7 always takes the row max, so a block
    routed to it runs under the knob and matches JAX, whose K7 does not
    read it (the wide-key block of ``test_torch_mvit_kt``)."""
    from test_torch_mvit_kt import test_multiscale_attention_kt_matches_jax

    monkeypatch.setenv("MVIT_SHIFT", "max")
    test_multiscale_attention_kt_matches_jax(monkeypatch)


def test_a_malformed_mvit_shift_raises(monkeypatch):
    from procedurevrl_torch.models.mvit import MViTConfig

    monkeypatch.setenv("MVIT_SHIFT", "clampp")
    with pytest.raises(ValueError, match="MVIT_SHIFT"):
        MViTConfig.from_cfg(_tiny_cfg("mvit"))


@pytest.mark.parametrize("use_pallas", [True, False])
def test_the_builders_read_use_pallas(use_pallas, monkeypatch):
    """``TPU.USE_PALLAS_ATTENTION`` reaches both encoders' routes, with
    ``TEMPORAL_PALLAS`` and ``PALLAS_MIN_LEN`` from the environment; MViT's
    ``MVIT_DELTA`` / ``MVIT_SAVE_PROBS`` are read by the same build."""
    from procedurevrl_torch.models.build import build_model
    from procedurevrl_torch.models.mvit import MViTConfig, MViTRoute

    monkeypatch.setenv("TEMPORAL_PALLAS", "0")
    monkeypatch.setenv("PALLAS_MIN_LEN", "1")
    monkeypatch.setenv("MVIT_DELTA", "1")
    monkeypatch.setenv("MVIT_SAVE_PROBS", "true")
    flag = ["TPU.USE_PALLAS_ATTENTION", str(use_pallas)]
    model, _ = build_model(_tiny_cfg("timesformer", *flag), "cpu")
    want = AttentionRoute(use_pallas=use_pallas, temporal_pallas=False,
                          min_len=1)
    blk = model.blocks[0]
    assert blk.attn.route == want and blk.temporal_attn.route == want
    cfg = MViTConfig.from_cfg(_tiny_cfg("mvit", *flag))
    assert cfg.route == MViTRoute(use_pallas=use_pallas, delta=True,
                                  save_probs=True)


def test_the_builder_reads_the_route_once(monkeypatch):
    from procedurevrl_torch.config import load_config
    from procedurevrl_torch.models.build import build_model

    for k, v in ROUTES["A"][0].items():
        monkeypatch.setenv(k, v)
    cfg = load_config(os.path.join(ROOT, "configs/COIN/step_classification.yaml"),
                      ["TRAIN.ENABLE", "False", "DEV.MATCH_LANG_EMB", "True",
                       "DEV.LOAD_DUMMY_DATA", "True", "TIMESFORMER.DEPTH", "1",
                       "DATA.NUM_FRAMES", "2", "DATA.TRAIN_CROP_SIZE", "32",
                       "DATA.TEST_CROP_SIZE", "32"])
    model, _ = build_model(cfg, "cpu")
    for k in ROUTES["A"][0]:
        monkeypatch.delenv(k)
    want = AttentionRoute(save_probs=False, pipe=True, temporal_batched=True)
    blk = model.blocks[0]
    assert blk.attn.route == want and blk.temporal_attn.route == want
