"""Training loop (counterpart of ``tools/train_net.py``; reference
``tools/train_net.py:56-530``): order pretraining, the COIN finetunes
(step classification, task classification and step forecasting heads),
the EPIC-Kitchens-100 verb + noun full finetune, and the BatchNorm video
family on Kinetics.

Each optimizer step takes ``accum = GLOBAL_BATCH_SIZE // (TRAIN.BATCH_SIZE
x hosts)`` micro-batches of ``TRAIN.BATCH_SIZE`` samples a host, runs the
model's forward and backward on each, and applies one update (AdamW, SGD
or Adam) with the LR of the schedule.  A pretraining sample is 9 clips; a
finetuning sample
is one clip, or ``MODEL.NUM_SEG`` clips for forecasting.  Metrics stay on
the device until a log boundary (every ``LOG_PERIOD`` steps, the end of
the warm-up and the last step), where they reach the host and feed the
:class:`TrainMeter`, so the steps queue on the card without a host round
trip each.  Where ``TRAIN.EVAL_PERIOD <= SOLVER.MAX_EPOCH`` the val split
is evaluated after every epoch that :func:`misc.is_eval_epoch` names (the
finetuning configs; the pretraining configs set 100), and after the last
step of a run that ``max_steps`` cut short, through a :class:`ValMeter`
(EPIC-Kitchens: an :class:`EPICValMeter` of the verb, noun and action
accuracies, and the train meter takes the action accuracies and the verb
and noun metrics, JAX ``tools/train_net.py:172-177``, :226-236, :348).

Checkpoints (``utils/checkpoint.py``): the model starts from the
pretrained encoder of ``TIMESFORMER.PRETRAINED_MODEL``, then from
``OUTPUT_DIR``'s last checkpoint under ``TRAIN.AUTO_RESUME`` or from
``TRAIN.CHECKPOINT_FILE_PATH``; a resumed run continues the epoch, the
optimizer step, its random streams and its LR where the file left them.
After every ``TRAIN.CHECKPOINT_PERIOD``-th epoch and the last, the state
goes to ``OUTPUT_DIR/checkpoints``, written by a thread under
``TPU.ASYNC_CHECKPOINT``.  A NaN loss aborts the run (an infinite one
trains on, as in JAX).  Data comes from ``datasets/loader.py:construct_loader``
(the HowTo100M / COIN dataset, decoded files or, under
``DEV.LOAD_DUMMY_DATA``, its ``synthetic://`` index; the EPIC-Kitchens
dataset, files or its dummy split), reshuffled each epoch and copied to
the card one batch ahead (``prefetch_to_device``).

The BatchNorm video family (SlowFast, ResNet, X3D; since slice 20, on
Kinetics) trains in train mode, each micro-batch updating the model's
running statistics; under ``BN.USE_PRECISE_STATS`` they are re-estimated
(:func:`precise_bn`) before every checkpoint and val epoch, so the file
and the val epoch see the precise ones; ``BN.FROZEN`` (read by the model)
keeps them fixed.  A checkpoint holds them (the model's buffers), and
``TRAIN.AUTO_RESUME`` restores them bit for bit.

In a group of processes (``utils/misc.py:launch_job``, ``parallel/ddp.py``)
each rank takes its rows of every global batch, the model trains inside
``DistributedDataParallel`` (and ``TPU.SHARD_OPT_STATE`` shards the
optimizer, ZeRO-1), the logged metrics are means over the ranks, the val
meters take every rank's valid rows, and only rank 0 logs and writes.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, Optional, Union

import torch

from procedurevrl_torch.datasets.loader import (
    Loader, construct_loader, prefetch_to_device, shuffle_dataset,
)
from procedurevrl_torch.engine.steps import (
    make_bn_stats_step, make_eval_step, make_train_step,
)
from procedurevrl_torch.models.build import build_model
from procedurevrl_torch.parallel import ddp
from procedurevrl_torch.parallel.collectives import (
    all_gather_rows, sync_global_barrier,
)
from procedurevrl_torch.solver.lr_policy import lr_schedule
from procedurevrl_torch.utils import checkpoint as cu
from procedurevrl_torch.utils import misc, weights
from procedurevrl_torch.utils.bn import compute_precise_bn_stats
from procedurevrl_torch.utils.device import resolve_device
from procedurevrl_torch.utils.logging import get_logger, setup_logging
from procedurevrl_torch.utils.meters import (
    EPICValMeter, TrainMeter, ValMeter,
)
from procedurevrl_torch.utils.metrics import (
    multitask_topk_accuracies, topk_accuracies, topk_errors,
)

logger = get_logger(__name__)

WARMUP_STEPS = 2  # optimizer steps left out of ``clips_per_sec``


def _to_host(metrics: Dict[str, Union[torch.Tensor, float]]
             ) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def device_batches(loader: Loader, device, cfg) -> Iterator:
    """One epoch of ``loader`` on ``device``: ``(dev_batch, n_valid, extra,
    host_batch)`` per batch, through ``prefetch_to_device``."""
    return prefetch_to_device(loader, device, size=cfg.TPU.PREFETCH_DEPTH)


def eval_epoch(val_loader: Loader, eval_step,
               val_meter: Union[ValMeter, EPICValMeter], cfg, cur_epoch: int,
               device: torch.device) -> Dict:
    """One pass over the val split in global batches of ``TRAIN.BATCH_SIZE``
    a host (JAX ``tools/train_net.py:204-250``): top-1 / top-5 errors of
    each global batch's valid rows (every rank's ``n_valid``) into
    ``val_meter``, or for EPIC-Kitchens' (verb, noun) logits the verb,
    noun and action accuracies; returns its epoch stats."""
    if len(val_loader) == 0:
        raise ValueError("the val split has no batch")
    val_meter.iter_tic()
    batches = device_batches(val_loader, device, cfg)
    with contextlib.closing(batches):
        for cur_iter, (batch, n_valid, _extra, _host) in enumerate(batches):
            preds = eval_step(batch)
            if isinstance(preds, tuple):  # EPIC: verb / noun / action
                preds = tuple(all_gather_rows(p, n_valid) for p in preds)
                labels = tuple(all_gather_rows(batch[k], n_valid)
                               for k in ("verb", "noun"))
                (v1, v5), (n1, n5) = (topk_accuracies(p, lab, (1, 5))
                                      for p, lab in zip(preds, labels))
                a1, a5 = multitask_topk_accuracies(preds, labels, (1, 5))
                val_meter.update_stats((float(v1), float(n1), float(a1)),
                                       (float(v5), float(n5), float(a5)),
                                       labels[0].shape[0])
            else:
                labels = all_gather_rows(batch["labels"].reshape(-1), n_valid)
                top1, top5 = topk_errors(all_gather_rows(preds, n_valid),
                                         labels, (1, 5))
                val_meter.update_stats(float(top1), float(top5),
                                       labels.shape[0])
            val_meter.iter_toc()
            val_meter.log_iter_stats(cur_epoch, cur_iter)
            val_meter.iter_tic()
    stats = val_meter.log_epoch_stats(cur_epoch)
    val_meter.reset()
    return stats


def precise_bn(model: torch.nn.Module, stats_step, loader: Loader,
               device, cfg) -> None:
    """Precise BN before a checkpoint or a val epoch (JAX
    ``tools/train_net.py:404-423``): the model's running statistics
    re-estimated over ``BN.NUM_BATCHES_PRECISE`` batches of the train split
    (``utils/bn.py``) with its weights frozen; the prefetch iterator is
    closed after the last batch it takes, so the loader's producer stops."""
    batches = device_batches(loader, device, cfg)
    with contextlib.closing(batches):
        precise = compute_precise_bn_stats(
            stats_step, {k: v.clone() for k, v in model.bn_state().items()},
            (b for b, _n, _e, _h in batches),
            min(cfg.BN.NUM_BATCHES_PRECISE, len(loader)))
    with torch.no_grad():
        for k, v in model.bn_state().items():
            v.copy_(precise[k])


def _check_multigrid(cfg) -> None:
    """The multigrid schedule (JAX ``tools/train_net.py:256-263``,
    ``utils/multigrid.py``) rewrites the epochs, the LR steps and (T, S, B):
    refuse its knobs rather than train another schedule."""
    for knob in ("LONG_CYCLE", "SHORT_CYCLE"):
        if getattr(cfg.MULTIGRID, knob):
            raise NotImplementedError(
                f"MULTIGRID.{knob}: the multigrid schedule "
                "(utils/multigrid.py) is not ported yet (ROADMAP.md Queue 1 "
                "item 7)")


def train(cfg, device: Union[str, torch.device, None] = None,
          max_steps: Optional[int] = None) -> Dict:
    """Train entry: build the model (random init from ``RNG_SEED``, the
    pretrained encoder, then a checkpoint: see the module), and run the
    train split from the start epoch to ``SOLVER.MAX_EPOCH``, or for
    ``max_steps`` optimizer steps.  A run cut at an epoch's end saves
    that epoch's checkpoint where one is due; a run cut inside an epoch
    saves none for it.  ``device`` defaults to the card; pass ``"cpu"``
    for the plain path.

    Returns ``history`` (one dict of host floats per optimizer step of this
    run: the train step's metrics, ``loss``, ``top1_err``, ``top5_err``,
    ``lr``, ``grad_norm``, and for pretraining ``kl``, ``mse``;
    EPIC-Kitchens: see ``make_train_step``), ``val`` (the val meter's stats
    of each val epoch), ``steps`` (of this run), ``start_epoch`` and
    ``start_step`` (0-based epoch and optimizer step it began at),
    ``checkpoints`` (the files it wrote), ``clips_per_step``,
    ``clips_per_sec``: clips of the steps after the run's first
    ``WARMUP_STEPS`` over host seconds from the end of its step
    ``WARMUP_STEPS`` to the end of its last step (each end is a host read
    of that step's metrics; val epochs in between are left out, checkpoint
    saves are not), None with no such step, and ``model``, the trained
    model.  ``MULTIGRID.LONG_CYCLE`` or ``SHORT_CYCLE`` and ``TPU.MESH_MODEL
    > 1`` raise ``NotImplementedError``.  In a group of processes each
    rank calls it with its card; the clips are the global batch's."""
    _check_multigrid(cfg)
    ddp.check_mesh(cfg)
    device = resolve_device(device)
    setup_logging(cfg.OUTPUT_DIR)
    logger.info("Train with config:\n%s", cfg.dump())
    model, label_emb = build_model(cfg, device)
    weights.load_pretrained_encoder(model, cfg)
    misc.log_model_info(model, cfg)
    train_loader = construct_loader(cfg, "train")
    batch_size, _ = ddp.batch_plan(cfg.TRAIN.BATCH_SIZE, cfg)  # global
    iters_per_epoch = len(train_loader)
    accum = ddp.accumulation(cfg)
    steps_per_epoch = max(iters_per_epoch // accum, 1)
    if iters_per_epoch < accum:
        raise ValueError(f"an epoch of {iters_per_epoch} micro-batches "
                         f"cannot fill {accum} accumulation steps")
    sched = lr_schedule(cfg, steps_per_epoch)
    optimizer = ddp.build_optimizer(model, cfg)
    start_epoch, start_step = cu.load_train_checkpoint(cfg, model, optimizer)
    train_step = make_train_step(ddp.wrap_model(model), optimizer, cfg,
                                 label_emb, sched, accum, start_step)
    val = (construct_loader(cfg, "val")
           if cfg.TRAIN.EVAL_PERIOD <= cfg.SOLVER.MAX_EPOCH else None)
    eval_step = make_eval_step(model, cfg, label_emb)
    is_epic = cfg.TRAIN.DATASET == "Epickitchens"
    val_meter = (EPICValMeter if is_epic else ValMeter)(
        len(val) if val else 0, cfg)
    first = start_epoch * steps_per_epoch  # the run's first step in the plan
    total = max(cfg.SOLVER.MAX_EPOCH * steps_per_epoch - first, 0)
    cut = max_steps is not None and max_steps < total
    if cut:
        total = max_steps
    clips_per_step = accum * batch_size * train_loader.dataset.clips
    meter = TrainMeter(steps_per_epoch, cfg)
    ckpt = cu.AsyncCheckpointer() if cfg.TPU.ASYNC_CHECKPOINT else None
    stats_step = (make_bn_stats_step(model, cfg) if cfg.BN.USE_PRECISE_STATS
                  and getattr(model, "has_batch_stats", False) else None)
    logger.info("Start epoch: %d (optimizer step %d); %d optimizer steps of "
                "%d micro-batches x %d samples (%d clips)", start_epoch + 1,
                start_step, total, accum, batch_size, clips_per_step)

    history: List[Dict[str, float]] = []
    val_stats: List[Dict] = []
    saved: List[str] = []
    pending: List[Dict[str, Union[torch.Tensor, float]]] = []
    t_timed = t_end = None
    eval_seconds = 0.0  # val epochs inside the timed steps
    done = 0  # steps of this run
    epoch = start_epoch
    meter.iter_tic()
    while done < total:
        shuffle_dataset(train_loader, epoch)
        batches = device_batches(train_loader, device, cfg)
        with contextlib.closing(batches):
            for cur_iter in range(steps_per_epoch):
                micro = []
                for _ in range(accum):
                    batch = next(batches)[0]
                    batch.pop("index", None)
                    micro.append(batch)
                pending.append(train_step(micro if accum > 1 else micro[0]))
                done += 1
                if (done % cfg.LOG_PERIOD == 0 or done == total
                        or done == WARMUP_STEPS):
                    for m in pending:
                        host = _to_host(m)
                        misc.check_nan_losses(host["loss"])
                        history.append(host)
                        if is_epic:  # the action accuracies, as JAX passes
                            meter.update_stats(
                                host["top1_acc"], host["top5_acc"],
                                host["loss"], host["lr"], accum * batch_size,
                                extra={k: v for k, v in host.items()
                                       if k.startswith(("verb", "noun"))})
                        else:
                            meter.update_stats(
                                host["top1_err"], host["top5_err"],
                                host["loss"], host["lr"], accum * batch_size,
                                extra={k: host[k] for k in
                                       ("kl", "mse", "grad_norm")
                                       if k in host})
                    pending = []
                    if done == WARMUP_STEPS:
                        t_timed = time.perf_counter()
                    if done == total:
                        t_end = time.perf_counter()
                meter.iter_toc()
                meter.log_iter_stats(epoch, cur_iter)
                meter.iter_tic()
                if done == total:
                    break
        epoch_end = cur_iter + 1 == steps_per_epoch
        meter.log_epoch_stats(epoch)
        meter.reset()
        is_checkp = epoch_end and cu.is_checkpoint_epoch(cfg, epoch)
        is_eval = val is not None and (
            (epoch_end and misc.is_eval_epoch(cfg, epoch))
            or (cut and done == total))
        if (is_checkp or is_eval) and stats_step is not None:
            precise_bn(model, stats_step, train_loader, device, cfg)
        if is_checkp:
            save = ckpt.save if ckpt is not None else cu.save_checkpoint
            saved.append(save(cfg.OUTPUT_DIR, model, optimizer, cfg, epoch,
                              start_step + done))
        if is_eval:
            if device.type == "cuda":  # queued train steps stay timed
                torch.cuda.synchronize(device)
            t_eval = time.perf_counter()
            val_stats.append(eval_epoch(val, eval_step, val_meter, cfg,
                                        epoch, device))
            if t_timed is not None and done < total:
                eval_seconds += time.perf_counter() - t_eval
        epoch += 1
    if ckpt is not None:
        ckpt.wait()  # the save in flight is on disk, or its error raised
    sync_global_barrier()  # rank 0's files are on disk for every rank
    logger.info("Training done.")
    timed = total - WARMUP_STEPS
    rate = (timed * clips_per_step / (t_end - t_timed - eval_seconds)
            if timed > 0 else None)
    return {"history": history, "val": val_stats, "steps": total,
            "start_epoch": start_epoch, "start_step": start_step,
            "checkpoints": saved, "clips_per_step": clips_per_step,
            "clips_per_sec": rate, "model": model}
