"""Slice 6 of the PyTorch port as a whole: one MViT-v2 order-pretraining SGD
step (momentum 0.9, Nesterov, weight decay 1e-4, as
``configs/HowTo100M/procedurevrl_mvitv2_sgd.yaml`` trains) on the JAX
package's ``MVIT_DELTA`` / ``MVIT_SAVE_PROBS`` routes against its
``make_train_step`` under the same knobs.

- Route C, ``MVIT_DELTA=1``: head-last blocks K5f + K5bd, head-split
  blocks K6f + K6bd (JAX ``_bwd_hl_delta``, ``_bwd_delta``).
- Route D, ``MVIT_SAVE_PROBS=1 MVIT_DELTA=1``: K5f + K5bd, and K6sp + K6bs
  (JAX ``_bwd_hl_delta``, ``_fwd(save_probs=True)`` + ``_bwd_saved``).

The geometry, towers, batch, draws and tolerances are those of
``tests/test_torch_mvit_train.py``; ``hl_supported`` is patched on both
sides to hold only for one head, so that block 0 takes the head-last
kernel and block 1 (2 heads) the head-split one.  On the CPU the port's
wrappers run their plain versions; each side records the backward it took.
Tolerances: loss, KL, MSE and gradients fp32 atol = rtol = 2e-5; updated
parameters 1e-6 where the gradient exceeds 1e-6, else within one step
(2 lr).
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
from procedurevrl_tpu.models.order_transformer import (
    OrderTransformer as JaxOrderTransformer,
)
from procedurevrl_tpu.ops import pallas_mvit_attention as jpm
from procedurevrl_tpu.solver import construct_optimizer as jax_optimizer
from procedurevrl_tpu.solver import lr_schedule as jax_lr_schedule
from procedurevrl_tpu.utils.converter import convert_procedurevrl
from procedurevrl_torch.config import get_cfg
from procedurevrl_torch.engine.steps import make_train_step
from procedurevrl_torch.models import mvit as pm
from procedurevrl_torch.models.procedurevrl import ProcedureVRLMViT
from procedurevrl_torch.ops import mvit_attention as ma
from procedurevrl_torch.solver.lr_policy import lr_schedule
from procedurevrl_torch.solver.optimizer import construct_optimizer
from procedurevrl_torch.utils import weights
from test_torch_mvit_train import (
    GEOM, LR, TOL, TOWERS, _bank, _batch, _cfg, _draws, _flat, _jax_params,
)

# route -> (knobs, the JAX backwards traced, the port wrappers called)
ROUTES = {
    "C": ({"MVIT_DELTA": "1"}, {"_bwd_hl_delta", "_bwd_delta"},
          {"mvit_attention_hl_fwd", "mvit_attention_hl_bwd_delta",
           "mvit_attention_fwd", "mvit_attention_bwd_delta"}),
    "D": ({"MVIT_SAVE_PROBS": "1", "MVIT_DELTA": "1"},
          {"_bwd_hl_delta", "_bwd_saved"},
          {"mvit_attention_hl_fwd", "mvit_attention_hl_bwd_delta",
           "mvit_attention_fwd_probs", "mvit_attention_bwd_probs"}),
}
JAX_BWDS = ("_bwd_hl", "_bwd_hl_delta", "_bwd", "_bwd_delta", "_bwd_saved")
PORT_WRAPPERS = ("mvit_attention_hl_fwd", "mvit_attention_hl_bwd",
                 "mvit_attention_hl_bwd_delta", "mvit_attention_fwd",
                 "mvit_attention_bwd", "mvit_attention_bwd_delta",
                 "mvit_attention_fwd_probs", "mvit_attention_bwd_probs",
                 "mvit_attention_kt_fwd")


def _record(monkeypatch, module, names, seen: set) -> None:
    for name in names:
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _f=fn, _n=name, **kw:
                            seen.add(_n) or _f(*a, **kw))


def _sgd(cfg):
    cfg = _cfg(cfg)
    cfg.SOLVER.OPTIMIZING_METHOD = "sgd"
    cfg.SOLVER.MOMENTUM = 0.9
    cfg.SOLVER.NESTEROV = True
    return cfg


@pytest.fixture(scope="module")
def jax_init():
    """The bank and the JAX model with its initial parameters, shared by
    both routes (the parameters do not depend on the route)."""
    bank = _bank()
    return (bank, *_jax_params(bank))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_sgd_knob_train_step_matches_jax(route, jax_init, monkeypatch):
    knobs, jax_bwds, port_fns = ROUTES[route]
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    # block 0 (1 head) head-last, block 1 (2 heads) head-split, both sides
    one_head = lambda kn, c, h: h == 1
    monkeypatch.setattr(jpm, "hl_supported", one_head)
    monkeypatch.setattr(ma, "hl_supported", one_head)
    bank, jmodel, params = jax_init
    batch, draws = _batch(2), _draws(3)
    orig = JaxOrderTransformer.pretrain

    def fixed_pretrain(self, x, mask_inds=None, pad_start=None,
                       level_noise=None):
        return orig(self, x, jnp.asarray(draws["mask_inds"]),
                    jnp.asarray(draws["pad_start"]),
                    jnp.asarray(draws["level_noise"]))

    monkeypatch.setattr(JaxOrderTransformer, "pretrain", fixed_pretrain)
    jax_seen, port_seen = set(), set()
    _record(monkeypatch, jpm, JAX_BWDS, jax_seen)
    jcfg = _sgd(jax_get_cfg())
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
    assert jax_seen == jax_bwds

    # the port's config as MViTConfig.from_cfg builds it under the knobs
    cfg = pm.MViTConfig(**GEOM, route=pm.MViTRoute(
        delta=True, save_probs=route == "D"))
    model = ProcedureVRLMViT(cfg, **TOWERS)
    model.load_state_dict(weights.params_from_jax(params), strict=True)
    _record(monkeypatch, ma, PORT_WRAPPERS, port_seen)
    tcfg = _sgd(get_cfg())
    optimizer = construct_optimizer(model, tcfg)
    assert isinstance(optimizer, torch.optim.SGD)
    step = make_train_step(model, optimizer, tcfg, torch.from_numpy(bank),
                           lr_schedule(tcfg, 10))
    metrics = step({k: torch.from_numpy(v) for k, v in batch.items()},
                   draws={k: torch.from_numpy(np.asarray(v))
                          for k, v in draws.items()})
    assert port_seen == port_fns

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
