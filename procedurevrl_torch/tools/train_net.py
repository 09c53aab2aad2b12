"""Training loop (counterpart of ``tools/train_net.py``; reference
``tools/train_net.py:56-530``): order pretraining, and the COIN finetunes
(step classification, task classification and step forecasting heads).

Each optimizer step takes ``accum = GLOBAL_BATCH_SIZE // TRAIN.BATCH_SIZE``
micro-batches of ``TRAIN.BATCH_SIZE`` samples, runs the model's forward
and backward on each, and applies one update (AdamW, SGD or Adam) with the
LR of the schedule.  A pretraining sample is 9 clips; a finetuning sample
is one clip, or ``MODEL.NUM_SEG`` clips for forecasting.  Metrics stay on
the device until a log boundary (every ``LOG_PERIOD`` steps, the end of
the warm-up and the last step), where they reach the host and feed the
:class:`TrainMeter`, so the steps queue on the card without a host round
trip each.  Where ``TRAIN.EVAL_PERIOD <= SOLVER.MAX_EPOCH`` the val split
is evaluated after every epoch that :func:`misc.is_eval_epoch` names (the
finetuning configs; the pretraining configs set 100), and after the last
step of a run that ``max_steps`` cut short, through a :class:`ValMeter`.

Checkpoints (``utils/checkpoint.py``): the model starts from the
pretrained encoder of ``TIMESFORMER.PRETRAINED_MODEL``, then from
``OUTPUT_DIR``'s last checkpoint under ``TRAIN.AUTO_RESUME`` or from
``TRAIN.CHECKPOINT_FILE_PATH``; a resumed run continues the epoch, the
optimizer step, its random streams and its LR where the file left them.
After every ``TRAIN.CHECKPOINT_PERIOD``-th epoch and the last, the state
goes to ``OUTPUT_DIR/checkpoints``, written by a thread under
``TPU.ASYNC_CHECKPOINT``.  A NaN loss aborts the run (an infinite one
trains on, as in JAX).  Data is synthetic (``DEV.LOAD_DUMMY_DATA``: the
pretraining split, or the train and val splits of :class:`SyntheticClips`);
the real loaders are not ported yet.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Union

import torch

from procedurevrl_torch.datasets.synthetic import SyntheticClips, SyntheticPretrain
from procedurevrl_torch.engine.steps import make_eval_step, make_train_step
from procedurevrl_torch.models.build import build_model
from procedurevrl_torch.solver.lr_policy import lr_schedule
from procedurevrl_torch.solver.optimizer import construct_optimizer
from procedurevrl_torch.utils import checkpoint as cu
from procedurevrl_torch.utils import misc, weights
from procedurevrl_torch.utils.device import resolve_device
from procedurevrl_torch.utils.logging import get_logger, setup_logging
from procedurevrl_torch.utils.meters import TrainMeter, ValMeter
from procedurevrl_torch.utils.metrics import topk_errors

logger = get_logger(__name__)

WARMUP_STEPS = 2  # optimizer steps left out of ``clips_per_sec``


def _to_host(metrics: Dict[str, Union[torch.Tensor, float]]
             ) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def eval_epoch(dataset: SyntheticClips, eval_step, val_meter: ValMeter,
               cfg, cur_epoch: int, device: torch.device) -> Dict:
    """One pass over the val split in batches of ``TRAIN.BATCH_SIZE``
    (JAX ``tools/train_net.py:204-250``): top-1 / top-5 errors of the
    predictions per batch into ``val_meter``; returns its epoch stats."""
    gen = torch.Generator(device=device)
    batch_size = cfg.TRAIN.BATCH_SIZE
    n_batches = dataset.num_batches(batch_size)
    if n_batches == 0:
        raise ValueError("the val split has no batch")
    val_meter.iter_tic()
    for cur_iter in range(n_batches):
        batch = dataset.batch(batch_size, cur_iter, gen)
        preds = eval_step(batch)
        top1, top5 = topk_errors(preds, batch["labels"], (1, 5))
        val_meter.update_stats(float(top1), float(top5), preds.shape[0])
        val_meter.iter_toc()
        val_meter.log_iter_stats(cur_epoch, cur_iter)
        val_meter.iter_tic()
    stats = val_meter.log_epoch_stats(cur_epoch)
    val_meter.reset()
    return stats


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
    synthetic train split from the start epoch to ``SOLVER.MAX_EPOCH``, or
    for ``max_steps`` optimizer steps.  A run cut at an epoch's end saves
    that epoch's checkpoint where one is due; a run cut inside an epoch
    saves none for it.  ``device`` defaults to the card; pass ``"cpu"``
    for the plain path.

    Returns ``history`` (one dict of host floats per optimizer step of this
    run: ``loss``, ``top1_err``, ``top5_err``, ``lr``, ``grad_norm``, and
    for pretraining ``kl``, ``mse``), ``val`` (the :class:`ValMeter` stats
    of each val epoch), ``steps`` (of this run), ``start_epoch`` and
    ``start_step`` (0-based epoch and optimizer step it began at),
    ``checkpoints`` (the files it wrote), ``clips_per_step``,
    ``clips_per_sec``: clips of the steps after the run's first
    ``WARMUP_STEPS`` over host seconds from the end of its step
    ``WARMUP_STEPS`` to the end of its last step (each end is a host read
    of that step's metrics; val epochs in between are left out, checkpoint
    saves are not), None with no such step, and ``model``, the trained
    model.  ``MULTIGRID.LONG_CYCLE`` or ``SHORT_CYCLE`` raises
    ``NotImplementedError``."""
    _check_multigrid(cfg)
    device = resolve_device(device)
    setup_logging(cfg.OUTPUT_DIR)
    logger.info("Train with config:\n%s", cfg.dump())
    if not cfg.DEV.LOAD_DUMMY_DATA:
        raise NotImplementedError("video decoding is not ported yet: set "
                                  "DEV.LOAD_DUMMY_DATA True")
    model, label_emb = build_model(cfg, device)
    weights.load_pretrained_encoder(model, cfg)
    misc.log_model_info(model, cfg)
    if cfg.TRAIN.LABEL_EMB != "" and cfg.TRAIN.TEXT != "":
        vocab = (model.text_model.token_embedding.num_embeddings
                 if model.text_model is not None else 49408)
        dataset = SyntheticPretrain(cfg, text_vocab=vocab,
                                    vis_dim=label_emb.shape[1])
    else:
        dataset = SyntheticClips(cfg, "train")
    batch_size = cfg.TRAIN.BATCH_SIZE
    iters_per_epoch = dataset.num_batches(batch_size)
    accum = max(cfg.GLOBAL_BATCH_SIZE // max(batch_size, 1), 1)
    steps_per_epoch = max(iters_per_epoch // accum, 1)
    if iters_per_epoch < accum:
        raise ValueError(f"an epoch of {iters_per_epoch} micro-batches "
                         f"cannot fill {accum} accumulation steps")
    sched = lr_schedule(cfg, steps_per_epoch)
    optimizer = construct_optimizer(model, cfg)
    start_epoch, start_step = cu.load_train_checkpoint(cfg, model, optimizer)
    train_step = make_train_step(model, optimizer, cfg, label_emb, sched,
                                 accum, start_step)
    val = (SyntheticClips(cfg, "val")
           if cfg.TRAIN.EVAL_PERIOD <= cfg.SOLVER.MAX_EPOCH else None)
    eval_step = make_eval_step(model, cfg, label_emb)
    val_meter = ValMeter(val.num_batches(batch_size) if val else 0, cfg)
    first = start_epoch * steps_per_epoch  # the run's first step in the plan
    total = max(cfg.SOLVER.MAX_EPOCH * steps_per_epoch - first, 0)
    cut = max_steps is not None and max_steps < total
    if cut:
        total = max_steps
    clips_per_step = accum * batch_size * dataset.clips
    meter = TrainMeter(steps_per_epoch, cfg)
    ckpt = cu.AsyncCheckpointer() if cfg.TPU.ASYNC_CHECKPOINT else None
    logger.info("Start epoch: %d (optimizer step %d); %d optimizer steps of "
                "%d micro-batches x %d samples (%d clips)", start_epoch + 1,
                start_step, total, accum, batch_size, clips_per_step)

    history: List[Dict[str, float]] = []
    val_stats: List[Dict] = []
    saved: List[str] = []
    pending: List[Dict[str, Union[torch.Tensor, float]]] = []
    gen = torch.Generator(device=device)
    t_timed = t_end = None
    eval_seconds = 0.0  # val epochs inside the timed steps
    done = 0  # steps of this run
    meter.iter_tic()
    while done < total:
        epoch, cur_iter = divmod(first + done, steps_per_epoch)
        index = epoch * iters_per_epoch + cur_iter * accum
        micro = [dataset.batch(batch_size, index + i, gen)
                 for i in range(accum)]
        pending.append(train_step(micro if accum > 1 else micro[0]))
        done += 1
        if (done % cfg.LOG_PERIOD == 0 or done == total
                or done == WARMUP_STEPS):
            for m in pending:
                host = _to_host(m)
                misc.check_nan_losses(host["loss"])
                history.append(host)
                meter.update_stats(
                    host["top1_err"], host["top5_err"], host["loss"],
                    host["lr"], accum * batch_size,
                    extra={k: host[k] for k in ("kl", "mse", "grad_norm")
                           if k in host})
            pending = []
            if done == WARMUP_STEPS:
                t_timed = time.perf_counter()
            if done == total:
                t_end = time.perf_counter()
        meter.iter_toc()
        meter.log_iter_stats(epoch, cur_iter)
        meter.iter_tic()
        epoch_end = cur_iter + 1 == steps_per_epoch
        if epoch_end or done == total:
            meter.log_epoch_stats(epoch)
            meter.reset()
        if epoch_end and cu.is_checkpoint_epoch(cfg, epoch):
            save = ckpt.save if ckpt is not None else cu.save_checkpoint
            saved.append(save(cfg.OUTPUT_DIR, model, optimizer, cfg, epoch,
                              start_step + done))
        if val is not None and ((epoch_end and misc.is_eval_epoch(cfg, epoch))
                                or (cut and done == total)):
            if device.type == "cuda":  # queued train steps stay timed
                torch.cuda.synchronize(device)
            t_eval = time.perf_counter()
            val_stats.append(eval_epoch(val, eval_step, val_meter, cfg,
                                        epoch, device))
            if t_timed is not None and done < total:
                eval_seconds += time.perf_counter() - t_eval
    if ckpt is not None:
        ckpt.wait()  # the save in flight is on disk, or its error raised
    logger.info("Training done.")
    timed = total - WARMUP_STEPS
    rate = (timed * clips_per_step / (t_end - t_timed - eval_seconds)
            if timed > 0 else None)
    return {"history": history, "val": val_stats, "steps": total,
            "start_epoch": start_epoch, "start_step": start_step,
            "checkpoints": saved, "clips_per_step": clips_per_step,
            "clips_per_sec": rate, "model": model}
