"""Helpers of the train and test loops (counterpart of
``procedurevrl_tpu/utils/misc.py:23-78``; reference ``lib/utils/misc.py``)."""

from __future__ import annotations

import math

import torch

from procedurevrl_torch.utils.logging import get_logger

logger = get_logger(__name__)


class NaNLossError(RuntimeError):
    pass


def check_nan_losses(loss: float) -> None:
    """Abort on a NaN loss; an infinite one trains on, as in JAX
    (reference ``lib/utils/misc.py:25-32``)."""
    if math.isnan(loss):
        raise NaNLossError("ERROR: Got NaN losses")


def params_count(model: torch.nn.Module) -> int:
    """Parameters of ``model``, frozen ones included (reference ``:35-46``)."""
    return sum(p.numel() for p in model.parameters())


def flops_count_timesformer(cfg) -> float:
    """Closed-form forward GFLOPs of one clip through the TimeSformer-B
    encoder at ``DATA.NUM_FRAMES`` x ``DATA.TRAIN_CROP_SIZE``^2 (the
    reference counts with fvcore at start-up, ``:126-158``)."""
    T = cfg.DATA.NUM_FRAMES
    S = (cfg.DATA.TRAIN_CROP_SIZE // 16) ** 2
    D, depth = 768, cfg.TIMESFORMER.DEPTH
    per_block = (
        # qkv + proj for two attentions
        2 * (S * T) * 4 * D * D * 2
        # temporal attention scores and values
        + 2 * S * T * T * D * 2
        # spatial attention
        + 2 * T * (S + 1) * (S + 1) * D * 2
        # mlp
        + 2 * (S * T) * 8 * D * D
    )
    stem = 2 * (S * T) * (16 * 16 * 3) * D
    return (stem + depth * per_block) / 1e9


def log_model_info(model: torch.nn.Module, cfg) -> None:
    """Parameters, the encoder's forward GFLOPs per clip and the device
    memory in use: ``torch.cuda.memory_allocated`` of the model's card, 0
    on the CPU (reference ``:161-186``)."""
    logger.info("Params: {:,}".format(params_count(model)))
    logger.info("Encoder fwd GFLOPs/clip: {:.1f}".format(
        flops_count_timesformer(cfg)))
    device = next(model.parameters()).device
    mem = (torch.cuda.memory_allocated(device) / 1024 ** 3
           if device.type == "cuda" else 0.0)
    logger.info("Mem: {:,} GB".format(mem))


def is_eval_epoch(cfg, cur_epoch: int) -> bool:
    """The last epoch and every ``TRAIN.EVAL_PERIOD``-th (reference
    ``:189-203``, no multigrid)."""
    if cur_epoch + 1 == cfg.SOLVER.MAX_EPOCH:
        return True
    return (cur_epoch + 1) % cfg.TRAIN.EVAL_PERIOD == 0
