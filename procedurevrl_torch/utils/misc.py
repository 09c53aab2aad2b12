"""Helpers of the train and test loops and the launch of a group of
processes (counterpart of ``procedurevrl_tpu/utils/misc.py:23-101``;
reference ``lib/utils/misc.py``, ``lib/utils/multiprocessing.py``)."""

from __future__ import annotations

import datetime
import math
import time
from typing import Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from procedurevrl_torch.utils.device import resolve_device
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


def spawn_group(fn: Callable, nprocs: int, args: Sequence = (),
                timeout: Optional[float] = None) -> None:
    """Run ``fn(i, *args)`` for ``i`` in ``range(nprocs)``, each in a
    process of its own (the ``spawn`` start method), and join them.  A
    process that raises or dies ends the others and raises here
    (``torch.multiprocessing``'s ``ProcessRaisedException`` /
    ``ProcessExitedException``); a group still running ``timeout`` seconds
    after the start is killed and raises ``TimeoutError``.  ``fn`` and
    ``args`` reach each process pickled through a pipe, which blocks the
    start if a process dies before it has read them: keep them small
    (paths and configs, not arrays)."""
    ctx = mp.start_processes(fn, args=tuple(args), nprocs=nprocs,
                             join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if deadline is not None and time.monotonic() > deadline:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
            for proc in ctx.processes:
                proc.join()
            raise TimeoutError(f"a group of {nprocs} processes ran past "
                               f"{timeout} s")


def backend_of(device: Union[str, torch.device], cfg) -> str:
    """The process group's backend: gloo on the CPU, else
    ``DIST_BACKEND`` (nccl by default; gloo lets ranks share a card, which
    NCCL refuses).  NCCL without a card, or with more ranks on a host than
    cards, raises."""
    if torch.device(device).type == "cpu":
        return "gloo"
    backend = cfg.DIST_BACKEND
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards == 0:
            raise RuntimeError("DIST_BACKEND nccl needs a CUDA device: pass "
                               "device='cpu' for gloo on the CPU")
        if cfg.NUM_GPUS > cards:
            raise RuntimeError(f"DIST_BACKEND nccl takes one card a rank: "
                               f"NUM_GPUS {cfg.NUM_GPUS} > {cards} cards "
                               "(DIST_BACKEND gloo shares them)")
    elif backend != "gloo":
        raise ValueError(f"DIST_BACKEND {backend!r}: expected nccl or gloo")
    return backend


def run_rank(local_rank: int, func: Callable, cfg, init_method: str,
              backend: str, device_type: str, timeout: float) -> None:
    """One rank of :func:`launch_job`: global rank ``SHARD_ID x NUM_GPUS +
    local_rank``, card ``local_rank`` (modulo the cards, where gloo shares
    them), the group joined before ``func(cfg, device)`` and left after."""
    world = cfg.NUM_GPUS * cfg.NUM_SHARDS
    rank = cfg.SHARD_ID * cfg.NUM_GPUS + local_rank
    device = torch.device("cpu")
    if device_type == "cuda":
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        func(cfg, device)
    finally:
        dist.destroy_process_group()


def launch_job(cfg, init_method: str, func: Callable,
               device: Union[str, torch.device, None] = None,
               timeout: float = 1800.0,
               join_timeout: Optional[float] = None) -> None:
    """Run ``func(cfg, device)`` (a module-level function: the ranks are
    spawned) on this host's share of the job (reference ``lib/utils/
    misc.py:272-300``; JAX collapses it to one call): one process with no
    group for ``NUM_GPUS 1, NUM_SHARDS 1``, else ``NUM_GPUS`` processes
    joined to a group of ``NUM_GPUS x NUM_SHARDS`` at ``init_method``
    (``tcp://host:port`` or ``file://path``) with ``timeout`` seconds for
    each collective, on gloo for ``device='cpu'`` and on
    :func:`backend_of`'s backend on the cards (``device`` None: the
    card).  ``join_timeout`` bounds the whole group (:func:`spawn_group`).
    """
    device = resolve_device(device)
    if cfg.NUM_GPUS * cfg.NUM_SHARDS <= 1:
        func(cfg, device)
        return
    backend = backend_of(device, cfg)
    spawn_group(run_rank, cfg.NUM_GPUS,
                (func, cfg, init_method, backend, device.type, timeout),
                join_timeout)
