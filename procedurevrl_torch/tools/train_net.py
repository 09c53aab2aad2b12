"""Order-pretraining loop (counterpart of ``tools/train_net.py``; reference
``tools/train_net.py:56-247``).

Each optimizer step takes ``accum = GLOBAL_BATCH_SIZE // TRAIN.BATCH_SIZE``
micro-batches of ``TRAIN.BATCH_SIZE`` samples (each sample 9 clips), runs
the pretraining branch forward and backward on each, and applies one AdamW
update with the LR of the schedule.  Metrics stay on the device until a log
boundary (every ``LOG_PERIOD`` steps, the end of the warm-up and the last
step), where they reach the host and feed the :class:`TrainMeter`, so the
steps queue on the card without a host round trip each.

Data is the synthetic pretraining split (``DEV.LOAD_DUMMY_DATA``); the real
HowTo100M loader, evaluation during training and checkpoint saving come
later.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Dict, List, Optional, Union

import torch

from procedurevrl_torch.datasets.synthetic import SyntheticPretrain
from procedurevrl_torch.engine.steps import make_train_step
from procedurevrl_torch.models.build import build_model
from procedurevrl_torch.solver.lr_policy import lr_schedule
from procedurevrl_torch.solver.optimizer import construct_optimizer
from procedurevrl_torch.utils import weights
from procedurevrl_torch.utils.device import resolve_device
from procedurevrl_torch.utils.meters import TrainMeter

logger = logging.getLogger("procedurevrl_torch")

WARMUP_STEPS = 2  # optimizer steps left out of ``clips_per_sec``


def _to_host(metrics: Dict[str, Union[torch.Tensor, float]]
             ) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def train(cfg, device: Union[str, torch.device, None] = None,
          max_steps: Optional[int] = None) -> Dict:
    """Train entry: build the model (random init from ``RNG_SEED``, or
    ``TRAIN.CHECKPOINT_FILE_PATH``) and run ``SOLVER.MAX_EPOCH`` epochs of
    the synthetic pretraining split, or ``max_steps`` optimizer steps.
    ``device`` defaults to the card; pass ``"cpu"`` for the plain path.

    Returns ``history`` (one dict of host floats per optimizer step:
    ``loss``, ``kl``, ``mse``, ``top1_err``, ``top5_err``, ``lr``,
    ``grad_norm``), ``steps``, ``clips_per_step`` and ``clips_per_sec``:
    clips of the steps after the first ``WARMUP_STEPS`` over host seconds
    from the end of step ``WARMUP_STEPS`` to the end of the last step (each
    end is a host read of that step's metrics); None with no such step."""
    device = resolve_device(device)
    logger.info("Train with config:\n%s", cfg.dump())
    if not cfg.DEV.LOAD_DUMMY_DATA:
        raise NotImplementedError("video decoding is not ported yet: set "
                                  "DEV.LOAD_DUMMY_DATA True")
    model, label_emb = build_model(cfg, device)
    if label_emb is None or cfg.TRAIN.TEXT == "":
        raise NotImplementedError("only order pretraining (TRAIN.LABEL_EMB "
                                  "and TRAIN.TEXT set) is ported so far")
    if cfg.TRAIN.CHECKPOINT_FILE_PATH:
        weights.load_into(model, weights.load_reference_checkpoint(
            cfg.TRAIN.CHECKPOINT_FILE_PATH))
    vocab = (model.text_model.token_embedding.num_embeddings
             if model.text_model is not None else 49408)
    dataset = SyntheticPretrain(cfg, text_vocab=vocab,
                                vis_dim=label_emb.shape[1])
    batch_size = cfg.TRAIN.BATCH_SIZE
    iters_per_epoch = dataset.num_batches(batch_size)
    accum = max(cfg.GLOBAL_BATCH_SIZE // max(batch_size, 1), 1)
    steps_per_epoch = max(iters_per_epoch // accum, 1)
    if iters_per_epoch < accum:
        raise ValueError(f"an epoch of {iters_per_epoch} micro-batches "
                         f"cannot fill {accum} accumulation steps")
    sched = lr_schedule(cfg, steps_per_epoch)
    optimizer = construct_optimizer(model, cfg)
    train_step = make_train_step(model, optimizer, cfg, label_emb, sched,
                                 accum)
    total = cfg.SOLVER.MAX_EPOCH * steps_per_epoch
    if max_steps is not None:
        total = min(total, max_steps)
    clips_per_step = accum * batch_size * dataset.clips
    meter = TrainMeter(steps_per_epoch, cfg)
    logger.info("%d optimizer steps of %d micro-batches x %d samples "
                "(%d clips)", total, accum, batch_size, clips_per_step)

    history: List[Dict[str, float]] = []
    pending: List[Dict[str, Union[torch.Tensor, float]]] = []
    gen = torch.Generator(device=device)
    t_timed = None
    step = 0
    meter.iter_tic()
    while step < total:
        epoch, cur_iter = divmod(step, steps_per_epoch)
        first = epoch * iters_per_epoch + cur_iter * accum
        micro = [dataset.batch(batch_size, first + i, gen)
                 for i in range(accum)]
        pending.append(train_step(micro if accum > 1 else micro[0]))
        step += 1
        if (step % cfg.LOG_PERIOD == 0 or step == total
                or step == WARMUP_STEPS):
            for m in pending:
                host = _to_host(m)
                if not math.isfinite(host["loss"]):
                    raise RuntimeError(f"loss is {host['loss']} at step "
                                       f"{len(history) + 1}")
                history.append(host)
                meter.update_stats(
                    host["top1_err"], host["top5_err"], host["loss"],
                    host["lr"], accum * batch_size,
                    extra={k: host[k] for k in ("kl", "mse", "grad_norm")})
            pending = []
            if step == WARMUP_STEPS:
                t_timed = time.perf_counter()
        meter.iter_toc()
        meter.log_iter_stats(epoch, cur_iter)
        meter.iter_tic()
        if cur_iter + 1 == steps_per_epoch or step == total:
            meter.log_epoch_stats(epoch)
            meter.reset()
    timed = total - WARMUP_STEPS
    rate = (timed * clips_per_step / (time.perf_counter() - t_timed)
            if timed > 0 else None)
    return {"history": history, "steps": total,
            "clips_per_step": clips_per_step, "clips_per_sec": rate}
