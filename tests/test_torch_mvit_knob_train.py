"""Slice 4 of the PyTorch port as a whole: one MViT-v2 order-pretraining
AdamW step with ``MVIT_POOL=kernel`` and ``MVIT_KT=1`` against the JAX
package's ``make_train_step`` with the same knobs.

The geometry is that of ``tests/test_torch_mvit_train.py`` with a stride-1
q pool at block 0 (``pool_q_stride`` [0, 1, 1, 1], as every block of
MViT-v2-S has one), so that the port's knob route takes that pool through
``depthwise_pool3d`` (its plain versions on the CPU: the tap forward, the
forward with reversed taps for dx and the tap dw).  At this size the JAX
routes fall back: the conftest's 8 host devices fail its pool kernel's
``jax.device_count() == 1`` gate, so it runs the conv, and ``hl_supported``
holds at every block, so K7 is never taken.  Those are the same functions,
so the test holds the port's knob-routed modules against the reference.
A second case sends every block of the port through K7 (``hl_supported``
patched to False on the port side only), which is K5's function wherever
no logit reaches 80.  The model is built from the JAX tree by
``params_from_jax``.  Tolerances as there: loss, KL, MSE and gradients
fp32 atol = rtol = 2e-5; updated parameters 1e-6 where the gradient
exceeds 1e-6, else within one step (2 lr).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from procedurevrl_tpu.config import get_cfg as jax_get_cfg
from procedurevrl_tpu.engine.steps import TrainState
from procedurevrl_tpu.engine.steps import make_train_step as jax_make_train_step
from procedurevrl_tpu.models import mvit as jm
from procedurevrl_tpu.models.order_transformer import (
    OrderTransformer as JaxOrderTransformer,
)
from procedurevrl_tpu.models.procedurevrl import ProcedureVRL as JaxProcedureVRL
from procedurevrl_tpu.solver import construct_optimizer as jax_optimizer
from procedurevrl_tpu.solver import lr_schedule as jax_lr_schedule
from procedurevrl_tpu.utils.converter import convert_procedurevrl
from procedurevrl_torch.config import get_cfg
from procedurevrl_torch.engine.steps import make_train_step
from procedurevrl_torch.models import mvit as pm
from procedurevrl_torch.models.procedurevrl import ProcedureVRLMViT
from procedurevrl_torch.ops import depthwise_pool as dp
from procedurevrl_torch.ops import mvit_attention as ma
from procedurevrl_torch.solver.lr_policy import lr_schedule
from procedurevrl_torch.solver.optimizer import construct_optimizer
from procedurevrl_torch.utils import weights
from test_torch_mvit_train import (
    B, GEOM, LR, M, S, T, TOL, TOWERS, K, _bank, _batch, _cfg, _draws, _flat,
)

KNOB_GEOM = dict(GEOM, pool_q_stride=((0, 1, 1, 1), (1, 1, 2, 2)))


def _jax_params(bank):
    model = JaxProcedureVRL(encoder_name="mvit", num_frames=T,
                            mvit_cfg=jm.MViTConfig(**KNOB_GEOM), **TOWERS,
                            num_classes=K, use_pallas=True)
    text = {"clip_text_ids": jnp.ones((B * M, 77), jnp.int32),
            "clip_vis_feat": jnp.zeros((B * M, TOWERS["label_dim"]))}
    key = jax.random.PRNGKey(0)
    rngs = {"params": key, "diffusion": jax.random.fold_in(key, 1),
            "subset": jax.random.fold_in(key, 2),
            "droppath": jax.random.fold_in(key, 3)}
    params = jax.jit(lambda: model.init(
        rngs, jnp.zeros((B, M, T, S, S, 3)), text=text,
        label_emb=jnp.asarray(bank), train=True))()["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("all_kt", [False, True])
def test_knob_train_step_matches_jax(all_kt, monkeypatch):
    monkeypatch.setenv("MVIT_POOL", "kernel")
    monkeypatch.setenv("MVIT_KT", "1")
    bank = _bank()
    batch, draws = _batch(2), _draws(3)
    jmodel, params = _jax_params(bank)
    orig = JaxOrderTransformer.pretrain

    def fixed_pretrain(self, x, mask_inds=None, pad_start=None,
                       level_noise=None):
        return orig(self, x, jnp.asarray(draws["mask_inds"]),
                    jnp.asarray(draws["pad_start"]),
                    jnp.asarray(draws["level_noise"]))

    monkeypatch.setattr(JaxOrderTransformer, "pretrain", fixed_pretrain)
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
    jmetrics = dict(jmetrics, grad_norm=optax.global_norm(jgrads),
                    lr=sched(jnp.int32(0)))
    jgrads = _flat(jax.tree_util.tree_map(np.asarray, jgrads))
    new_params = _flat(jax.tree_util.tree_map(np.asarray, state.params))

    # the port's config as MViTConfig.from_cfg builds it under the knobs
    cfg = pm.MViTConfig(**KNOB_GEOM, route=pm.MViTRoute(
        pool=pm.pool_route_from_env(), kt=True))
    model = ProcedureVRLMViT(cfg, **TOWERS)
    model.load_state_dict(weights.params_from_jax(params), strict=True)
    if all_kt:
        monkeypatch.setattr(ma, "hl_supported", lambda *a: False)
    calls = {"pool": [], "kt": 0}
    pool_apply = dp.DepthwisePool3DFunction.apply
    monkeypatch.setattr(dp.DepthwisePool3DFunction, "apply",
                        lambda *a: calls["pool"].append(a[2:]) or
                        pool_apply(*a))
    kt_entry = ma.mvit_attention_kt

    def counted_kt(*a):
        calls["kt"] += 1
        return kt_entry(*a)

    monkeypatch.setattr(ma, "mvit_attention_kt", counted_kt)
    tcfg = _cfg(get_cfg())
    step = make_train_step(model, construct_optimizer(model, tcfg), tcfg,
                           torch.from_numpy(bank), lr_schedule(tcfg, 10))
    metrics = step({k: torch.from_numpy(v) for k, v in batch.items()},
                   draws={k: torch.from_numpy(np.asarray(v))
                          for k, v in draws.items()})
    # block 0's q pool (stride 1) on the kernel route, once per clip batch
    # pass; K7 at both blocks only when the port routes them there
    assert calls["pool"] and all(c == (1, True) for c in calls["pool"])
    assert calls["kt"] == (len(calls["pool"]) * 2 if all_kt else 0)

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
