"""Learning-rate policies (counterpart of
``procedurevrl_tpu/solver/lr_policy.py``; reference
``lib/utils/lr_policy.py:8-87``).

``get_lr_at_epoch`` gives the LR at a fractional epoch with linear warm-up;
``lr_schedule`` turns it into a per-optimizer-step function, which the
train step evaluates on the host before each update (as the reference
sets the LR every iteration, ``tools/train_net.py:123-124``).
"""

from __future__ import annotations

import math
from typing import Callable


def _cosine(cfg, cur_epoch: float) -> float:
    if not cfg.SOLVER.COSINE_END_LR < cfg.SOLVER.BASE_LR:
        raise ValueError("cosine policy needs COSINE_END_LR < BASE_LR")
    return (cfg.SOLVER.COSINE_END_LR
            + (cfg.SOLVER.BASE_LR - cfg.SOLVER.COSINE_END_LR)
            * (math.cos(math.pi * cur_epoch / cfg.SOLVER.MAX_EPOCH) + 1.0)
            * 0.5)


def _steps_with_relative_lrs(cfg, cur_epoch: float) -> float:
    steps = list(cfg.SOLVER.STEPS) + [cfg.SOLVER.MAX_EPOCH]
    ind = 0
    for ind, step in enumerate(steps):
        if cur_epoch < step:
            break
    # an epoch before STEPS[0] ends the loop at ind = 0: LRS[-1], as the
    # reference indexes it
    return cfg.SOLVER.LRS[ind - 1] * cfg.SOLVER.BASE_LR


_POLICIES = {"cosine": _cosine,
             "steps_with_relative_lrs": _steps_with_relative_lrs}


def get_lr_at_epoch(cfg, cur_epoch: float) -> float:
    """LR at a (fractional) epoch, with linear warm-up
    (reference ``lib/utils/lr_policy.py:9-28``)."""
    if cfg.SOLVER.LR_POLICY not in _POLICIES:
        raise NotImplementedError(f"LR policy {cfg.SOLVER.LR_POLICY}")
    policy = _POLICIES[cfg.SOLVER.LR_POLICY]
    lr = policy(cfg, cur_epoch)
    if cur_epoch < cfg.SOLVER.WARMUP_EPOCHS:
        lr_start = cfg.SOLVER.WARMUP_START_LR
        lr_end = policy(cfg, cfg.SOLVER.WARMUP_EPOCHS)
        alpha = (lr_end - lr_start) / cfg.SOLVER.WARMUP_EPOCHS
        lr = cur_epoch * alpha + lr_start
    return lr


def lr_schedule(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """Optimizer step -> LR: ``get_lr_at_epoch`` at epoch
    ``step / steps_per_epoch``."""
    return lambda step: get_lr_at_epoch(cfg, step / float(steps_per_epoch))
