"""Slice 7 of the PyTorch port as a whole: TimeSformer with ``space_only``
attention (kernel K4) and the divided model on ``SPATIAL_FUSED_QKV=0``
(kernel K3) against the JAX package.

- the ``space_only`` encoder's forward against JAX ``TimeSformer`` with
  ``attention_type="space_only"`` (K4 in interpret mode,
  ``PALLAS_MIN_LEN=1``), and its weight round trip, bit for bit;
- one order-pretraining AdamW step against ``make_train_step`` on
  ``space_only``, and one on ``SPATIAL_FUSED_QKV=0``, each side asserting
  which kernels it took: the step geometry, towers, batch, fixed diffusion
  draws and tolerances of ``tests/test_torch_train.py`` at depth 1;
- ``build_model`` on ``TIMESFORMER.ATTENTION_TYPE``.

Tolerance: fp32, atol = rtol = 2e-5 (the repository's parity tolerance).
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from procedurevrl_tpu.config import get_cfg as jax_get_cfg
from procedurevrl_tpu.engine.steps import make_train_step as jax_make_train_step
from procedurevrl_tpu.models.order_transformer import (
    OrderTransformer as JaxOrderTransformer,
)
from procedurevrl_tpu.models.procedurevrl import ProcedureVRL as JaxProcedureVRL
from procedurevrl_tpu.models.timesformer import TimeSformer as JaxTimeSformer
from procedurevrl_tpu.ops import pallas_attention as pa
from procedurevrl_tpu.solver import construct_optimizer as jax_optimizer
from procedurevrl_tpu.solver import lr_schedule as jax_lr_schedule
from procedurevrl_tpu.utils.converter import convert_procedurevrl
from procedurevrl_torch.config import get_cfg
from procedurevrl_torch.engine.steps import make_train_step
from procedurevrl_torch.models.procedurevrl import ProcedureVRL
from procedurevrl_torch.models.timesformer import TimeSformer
from procedurevrl_torch.ops import flash_attention as fa
from procedurevrl_torch.ops import spatial_attention as k1
from procedurevrl_torch.ops import temporal_attention as k2
from procedurevrl_torch.ops.attention_route import AttentionRoute
from procedurevrl_torch.solver.lr_policy import lr_schedule
from procedurevrl_torch.solver.optimizer import construct_optimizer
from procedurevrl_torch.utils.weights import params_from_jax
from test_torch_timesformer import random_params
from test_torch_train import (
    GEOM, TOL, TOWERS, _bank, _batch, _cfg, _draws, _flat, _torch_batch,
    _torch_draws,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENC = dict(img_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=2,
           num_frames=4, drop_path_rate=0.0)
STEP_GEOM = dict(GEOM, depth=1)


def _count(monkeypatch, pairs):
    """Wrap each (module, name) with a counter of its calls."""
    calls = {name: 0 for _, name in pairs}
    for mod, name in pairs:
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **kw: (
            calls.__setitem__(_n, calls[_n] + 1) or _f(*a, **kw)))
    return calls


@pytest.mark.parametrize("crop,frames", [(32, 4), (48, 2)])
def test_space_only_timesformer_matches_jax(crop, frames, monkeypatch):
    monkeypatch.setenv("PALLAS_MIN_LEN", "1")
    jcalls = _count(monkeypatch, [(pa, "_fwd_kernel"),
                                  (pa, "_fwd_cls_qkv_kernel")])
    pcalls = _count(monkeypatch, [(fa, "flash_attention_autograd"),
                                  (k1, "spatial_attention_autograd"),
                                  (k2, "temporal_attention_autograd")])
    rng = np.random.RandomState(crop + frames)
    x = rng.randn(2, frames, crop, crop, 3).astype(np.float32)
    jmodel = JaxTimeSformer(**ENC, attention_type="space_only",
                            dtype=jnp.float32, use_pallas=True)
    params = random_params(jmodel, x, rng)
    assert "time_embed" not in params
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x),
                                  deterministic=True))
    assert jcalls["_fwd_kernel"] > 0 and jcalls["_fwd_cls_qkv_kernel"] == 0

    model = TimeSformer(**ENC, attention_type="space_only").eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    assert pcalls == {"flash_attention_autograd": ENC["depth"],
                      "spatial_attention_autograd": 0,
                      "temporal_attention_autograd": 0}
    assert out.shape == (2, ENC["embed_dim"])
    np.testing.assert_allclose(out, ref, **TOL)


def test_space_only_params_round_trip_bit_for_bit():
    """JAX tree -> ``params_from_jax`` -> port -> JAX ``convert_procedurevrl``
    gives the tree back; the port's own init has the same keys and shapes
    (no time embedding, no temporal modules)."""
    geom = dict(ENC, attention_type="space_only")
    jmodel = JaxProcedureVRL(**geom, num_classes=40, label_dim=64,
                             match_lang_emb=True)
    params = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, 4, 32, 32, 3)),
        label_emb=jnp.zeros((40, 64))))(jax.random.PRNGKey(0))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    model = ProcedureVRL(**geom, label_dim=64)
    port = params_from_jax(params)
    model.load_state_dict(port, strict=True)
    assert not any("temporal" in k or k == "time_embed" for k in port)
    back = convert_procedurevrl(model.state_dict())
    flat, flat_back = flatten_dict(params), flatten_dict(back)
    assert set(flat) == set(flat_back)
    for key, val in flat.items():
        assert flat_back[key].dtype == np.float32
        assert np.array_equal(flat_back[key], val), key
    fresh = ProcedureVRL(**geom, label_dim=64)
    fresh.reset_parameters(torch.Generator().manual_seed(1))
    assert {k: v.shape for k, v in fresh.state_dict().items()} == {
        k: v.shape for k, v in port.items()}


# (attention type, knobs, the JAX kernels each step must take and not take,
# the port entries and their calls per step at depth 1, no remat)
STEPS = {
    "space_only": ("space_only", {},
                   ("_fwd_kernel", "_bwd_kernel"), ("_fwd_cls_qkv_kernel",),
                   {"flash_attention_autograd": 1,
                    "flash_attention_cls_autograd": 0,
                    "spatial_attention_autograd": 0,
                    "temporal_attention_autograd": 0}),
    "split_qkv": ("divided_space_time", {"SPATIAL_FUSED_QKV": "0"},
                  ("_fwd_cls_kernel", "_bwd_cls_kernel"),
                  ("_fwd_cls_qkv_kernel", "_fwd_kernel"),
                  {"flash_attention_autograd": 0,
                   "flash_attention_cls_autograd": 1,
                   "spatial_attention_autograd": 0,
                   "temporal_attention_autograd": 1}),
}


@pytest.mark.parametrize("case", sorted(STEPS))
def test_train_step_matches_jax(case, monkeypatch):
    attention_type, knobs, jax_took, jax_not, port_calls = STEPS[case]
    monkeypatch.setenv("PALLAS_MIN_LEN", "1")
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    bank = _bank()
    batch, draws = _batch(2), _draws(3)
    jcalls = _count(monkeypatch, [(pa, n) for n in jax_took + jax_not])
    jmodel = JaxProcedureVRL(**STEP_GEOM, **TOWERS, num_classes=bank.shape[0],
                             attention_type=attention_type, use_pallas=True)
    b, m, t, s = batch["frames"].shape[:4]
    text = {"clip_text_ids": jnp.ones((b * m, 77), jnp.int32),
            "clip_vis_feat": jnp.zeros((b * m, bank.shape[1]))}
    key = jax.random.PRNGKey(0)
    rngs = {"params": key, "diffusion": jax.random.fold_in(key, 1),
            "subset": jax.random.fold_in(key, 2),
            "droppath": jax.random.fold_in(key, 3)}
    params = jax.jit(lambda: jmodel.init(
        rngs, jnp.zeros((b, m, t, s, s, 3)), text=text,
        label_emb=jnp.asarray(bank), train=True))()["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    orig = JaxOrderTransformer.pretrain

    def fixed_pretrain(self, x, mask_inds=None, pad_start=None,
                       level_noise=None):
        return orig(self, x, jnp.asarray(draws["mask_inds"]),
                    jnp.asarray(draws["pad_start"]),
                    jnp.asarray(draws["level_noise"]))

    monkeypatch.setattr(JaxOrderTransformer, "pretrain", fixed_pretrain)
    jcfg = _cfg(jax_get_cfg())
    sched = jax_lr_schedule(jcfg, 10)
    jstep = jax_make_train_step(jmodel, jax_optimizer(params, jcfg, sched),
                                jcfg, bank, sched, 2)
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    jgrads, jmetrics, _ = jax.jit(jstep.grad_step)(
        params, 0, zeros, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(5))
    jmetrics = dict(jmetrics, grad_norm=optax.global_norm(jgrads))
    assert all(jcalls[n] > 0 for n in jax_took), jcalls
    assert all(jcalls[n] == 0 for n in jax_not), jcalls
    jgrads = _flat(jax.tree_util.tree_map(np.asarray, jgrads))

    model = ProcedureVRL(**STEP_GEOM, **TOWERS, attention_type=attention_type,
                         route=AttentionRoute.from_env())
    model.load_state_dict(params_from_jax(params), strict=True)
    pcalls = _count(monkeypatch, [(fa, "flash_attention_autograd"),
                                  (fa, "flash_attention_cls_autograd"),
                                  (k1, "spatial_attention_autograd"),
                                  (k2, "temporal_attention_autograd")])
    cfg = _cfg(get_cfg())
    step = make_train_step(model, construct_optimizer(model, cfg), cfg,
                           torch.from_numpy(bank), lr_schedule(cfg, 10))
    metrics = step(_torch_batch(batch), draws=_torch_draws(draws))
    # the encoder's blocks only: the order transformer and the text tower
    # never take K4, though PALLAS_MIN_LEN=1 would let an unmasked pass
    assert pcalls == port_calls, pcalls

    for k in ("loss", "kl", "mse", "top1_err", "top5_err", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   **TOL, err_msg=k)
    assert math.isfinite(float(metrics["loss"]))
    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
    grads = _flat(convert_procedurevrl({n: p.grad for n, p in trained.items()}))
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        np.testing.assert_allclose(g, jgrads[k], **TOL, err_msg=str(k))


def _tiny_cfg(*opts):
    from procedurevrl_torch.config import load_config

    return load_config(
        os.path.join(ROOT, "configs/COIN/step_classification.yaml"),
        ["TRAIN.ENABLE", "False", "DEV.MATCH_LANG_EMB", "True",
         "DEV.LOAD_DUMMY_DATA", "True", "TIMESFORMER.DEPTH", "1",
         "DATA.NUM_FRAMES", "2", "DATA.TRAIN_CROP_SIZE", "32",
         "DATA.TEST_CROP_SIZE", "32", *opts])


def test_build_model_takes_space_only_and_refuses_joint():
    from procedurevrl_torch.models.build import build_model

    model, _ = build_model(_tiny_cfg("TIMESFORMER.ATTENTION_TYPE",
                                     "space_only"), "cpu")
    assert model.attention_type == "space_only"
    assert not hasattr(model, "time_embed")
    assert not any("temporal" in k for k in model.state_dict())
    with pytest.raises(NotImplementedError, match="joint_space_time"):
        build_model(_tiny_cfg("TIMESFORMER.ATTENTION_TYPE",
                              "joint_space_time"), "cpu")


def test_build_model_reads_split_qkv(monkeypatch):
    from procedurevrl_torch.models.build import build_model

    monkeypatch.setenv("SPATIAL_FUSED_QKV", "0")
    model, _ = build_model(_tiny_cfg(), "cpu")
    assert model.blocks[0].attn.route == AttentionRoute(fused_qkv=False)
    monkeypatch.setenv("SPATIAL_FUSED_QKV", "maybe")
    with pytest.raises(ValueError, match="SPATIAL_FUSED_QKV"):
        build_model(_tiny_cfg(), "cpu")
