"""The port's SGD and Adam rules against the JAX package's optax chains
(``procedurevrl_tpu/solver/optimizer.py:90-112``).

Two parameters, one in the main group (``SOLVER.WEIGHT_DECAY``) and one in
the ``bn`` group (``BN.WEIGHT_DECAY`` 0), take three steps of the same
numpy gradients at a constant LR of 1e-2 through ``construct_optimizer``
of both packages: SGD with momentum 0 and 0.9, Nesterov on and off, weight
decay 0 and 1e-4, and Adam with weight decay 0, 1e-4 and 1e-2 (at 1e-2
coupled and decoupled decay differ by ~1e-4, far above the limit).
Tolerance: fp32 atol = rtol = 1e-6 on the parameters after each step
(XLA's CPU Adam drifts from a float64 Adam by ~1e-5 of an update, the
port's by ~5e-7 of one).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from procedurevrl_tpu.config import get_cfg as jax_get_cfg
from procedurevrl_tpu.solver import construct_optimizer as jax_optimizer
from procedurevrl_torch.config import get_cfg
from procedurevrl_torch.solver.optimizer import construct_optimizer, set_lr

LR = 1e-2
STEPS = 3


class TwoParams(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.main_w = torch.nn.Parameter(torch.from_numpy(w.copy()))
        self.bn_w = torch.nn.Parameter(torch.from_numpy(b.copy()))


def _cfg(cfg, method, momentum, nesterov, wd):
    cfg.SOLVER.OPTIMIZING_METHOD = method
    cfg.SOLVER.BASE_LR = LR
    cfg.SOLVER.MOMENTUM = momentum
    cfg.SOLVER.NESTEROV = nesterov
    cfg.SOLVER.WEIGHT_DECAY = wd
    cfg.BN.WEIGHT_DECAY = 0.0
    return cfg


CASES = [("sgd", m, n, wd) for m in (0.0, 0.9) for n in (False, True)
         for wd in (0.0, 1e-4)] + [("adam", 0.9, True, wd)
                                   for wd in (0.0, 1e-4, 1e-2)]


@pytest.mark.parametrize("method,momentum,nesterov,wd", CASES)
def test_three_steps_match_optax(method, momentum, nesterov, wd):
    rng = np.random.RandomState(int(1e4 * (momentum + wd)) + nesterov)
    w = rng.randn(4, 3).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    grads = [(rng.randn(4, 3).astype(np.float32),
              rng.randn(5).astype(np.float32)) for _ in range(STEPS)]

    params = {"main_w": jnp.asarray(w), "bn_w": jnp.asarray(b)}
    tx = jax_optimizer(params, _cfg(jax_get_cfg(), method, momentum, nesterov,
                                    wd), lambda step: LR)
    state = tx.init(params)
    model = TwoParams(w, b)
    opt = construct_optimizer(model, _cfg(get_cfg(), method, momentum,
                                          nesterov, wd))
    assert type(opt) is {"sgd": torch.optim.SGD,
                         "adam": torch.optim.Adam}[method]
    for gw, gb in grads:
        updates, state = tx.update({"main_w": jnp.asarray(gw),
                                    "bn_w": jnp.asarray(gb)}, state, params)
        params = optax.apply_updates(params, updates)
        model.main_w.grad = torch.from_numpy(gw)
        model.bn_w.grad = torch.from_numpy(gb)
        set_lr(opt, LR)
        opt.step()
        for name in ("main_w", "bn_w"):
            np.testing.assert_allclose(getattr(model, name).detach().numpy(),
                                       np.asarray(params[name]), atol=1e-6,
                                       rtol=1e-6, err_msg=name)


def test_low_precision_moments_and_unknown_methods_raise():
    model = TwoParams(np.zeros((2, 2), np.float32), np.zeros(2, np.float32))
    cfg = _cfg(get_cfg(), "adam", 0.9, True, 0.0)
    cfg.TPU.MOMENT_DTYPE = "bfloat16"
    with pytest.raises(NotImplementedError, match="MOMENT_DTYPE"):
        construct_optimizer(model, cfg)
    with pytest.raises(NotImplementedError, match="lars"):
        construct_optimizer(model, _cfg(get_cfg(), "lars", 0.9, True, 0.0))
