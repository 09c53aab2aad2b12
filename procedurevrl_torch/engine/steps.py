"""Train and eval steps (counterpart of ``procedurevrl_tpu/engine/steps.py``;
reference ``tools/train_net.py:101-247``).

The train step takes normalised uint8 frames through the model, its loss,
top-1 / top-5 errors, backward, and one optimizer update with the LR set
on the host from the schedule.  Order pretraining (``TRAIN.LABEL_EMB`` and
``TRAIN.TEXT`` set) runs the pretraining branch and the KL + MSE loss,
with the errors of the student's softmax; finetuning (the COIN step, task
and forecasting heads) the logits of the head, ``MODEL.LOSS_FUNC`` through
``get_loss_func`` (``smooth`` is label smoothing 0.2, its default) and
the errors of the logits (JAX ``steps.py:180-197``); under
``MIXUP.ENABLED`` the frames are mixed first (``engine/mixup.py``) and the
loss is the soft-target cross-entropy on the mixed targets.
EPIC-Kitchens (``TRAIN.DATASET Epickitchens``) takes the verb and noun
logits, :func:`epic_loss` and the verb, noun and action top-1 / top-5
accuracies, and mixes nothing, whatever ``MIXUP.ENABLED`` says (JAX
``steps.py:174-187`` builds its mixup but never applies it there).
Parameters of the frozen groups
(``solver/optimizer.py``: the linear probe's encoder, a finetune's
``head``) have ``requires_grad=False``: no gradient, no update, and where
the whole encoder is frozen no backward through it (the model runs it
without autograd), as JAX's ``stop_frozen_gradients`` deletes that
backward.  With ``accum_steps > 1`` it takes that many
micro-batches, sums their gradients and divides by their number before the
one update (the mean of micro-batch gradients, JAX ``steps.py:225-252``).

Random streams: one ``torch.Generator`` each for "diffusion", "subset",
"droppath", "mixup" and "dropout" (the BatchNorm family's heads), on the
model's device, re-seeded for every
micro-batch from ``RNG_SEED``, the optimizer step, the micro-batch index
and the stream's index in :data:`STREAMS`, alike on every rank of a
group of processes: there each draw over the batch axis is made at the
global batch's shape and this rank keeps its rows
(``parallel/collectives.py:draw_rows``), so N ranks draw what one process
draws for the global batch, as JAX draws once under its global view.
Metrics stay on the device as tensors (``lr`` is a float): the caller
reads them at log boundaries, so steps queue on the card without a host
round trip.

A model with BatchNorm statistics (``has_batch_stats``: SlowFast,
ResNet, X3D) updates them in each train-mode forward, once per micro-batch,
as JAX's ``apply_train`` carries ``new_ms`` (``steps.py:122-133``), and
evaluates with them; :func:`make_bn_stats_step` is the forward that only
updates them (precise BN).

Data parallel (``parallel/ddp.py``): ``model`` may be the
``DistributedDataParallel`` wrapper; every micro-batch but the last runs
under its ``no_sync``, so the gradients are averaged over the ranks once,
on the last backward, and the gradient norm reads the averaged gradient.
The metrics are means over the ranks (one all-reduce a step).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from procedurevrl_torch.engine.losses import (
    epic_loss, get_loss_func, pretrain_loss, soft_target_cross_entropy,
)
from procedurevrl_torch.engine.mixup import Mixup
from procedurevrl_torch.parallel.collectives import all_reduce_mean_dict
from procedurevrl_torch.solver.optimizer import set_lr
from procedurevrl_torch.utils.metrics import (
    multitask_topk_accuracies, topk_accuracies, topk_errors,
)

# a new stream goes last: each stream's seed follows its index
STREAMS = ("diffusion", "subset", "droppath", "mixup", "dropout")

Batch = Mapping[str, torch.Tensor]


def normalize_frames(frames: torch.Tensor, cfg) -> torch.Tensor:
    """uint8 frames -> ``(x / 255 - mean) / std`` in float32, on the frames'
    device; float frames pass through (already normalised)."""
    if frames.dtype != torch.uint8:
        return frames
    mean = torch.tensor(cfg.DATA.MEAN, dtype=torch.float32, device=frames.device)
    std = torch.tensor(cfg.DATA.STD, dtype=torch.float32, device=frames.device)
    return (frames.float() / 255.0 - mean) / std


def seed_generators(gens: Dict[str, torch.Generator], seed: int, step: int,
                    micro: int = 0) -> None:
    """Re-seed every stream from (seed, optimizer step, micro-batch,
    stream index)."""
    for i, name in enumerate(STREAMS):
        state = np.random.SeedSequence([seed, step, micro, i]).generate_state(1)
        gens[name].manual_seed(int(state[0]))


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    cfg, label_emb: Optional[torch.Tensor],
                    sched: Callable[[int], float],
                    accum_steps: int = 1, start_step: int = 0) -> Callable:
    """The train step of the task ``cfg`` selects; its first call is
    optimizer step ``start_step`` (a resumed run's restored step), whose
    number seeds the random streams and picks the LR of ``sched``.

    ``train_step(batch, draws=None)``: ``batch`` holds ``frames`` (uint8 or
    normalised float) and ``labels`` [B] (EPIC-Kitchens: ``verb`` and
    ``noun`` [B]), for pretraining frames [B, M, T, H, W, 3] with
    ``clip_text_ids`` [B, M, 77] and ``clip_vis_feat`` [B, M, 512], for
    finetuning the model's layout ([B, T, ...], or [B, M*T, ...] for
    forecasting); with ``accum_steps > 1`` it is a sequence of that many
    such micro-batches.  ``draws`` (a mapping, or one per micro-batch)
    fixes the model's random draws (see ``ProcedureVRL.forward``) and,
    under its key "mixup", the mixup's (``engine/mixup.py``).  Returns the
    metrics ``loss``, ``top1_err``, ``top5_err`` (and for pretraining
    ``kl``, ``mse``; EPIC-Kitchens: ``loss``, ``verb_loss``,
    ``noun_loss``, ``verb_top1_acc``, ``verb_top5_acc``, ``noun_top1_acc``,
    ``noun_top5_acc`` and the action's ``top1_acc``, ``top5_acc``; means
    over the micro-batches), ``grad_norm`` (of the averaged gradients) and
    ``lr``.  After the call every trained parameter's ``.grad`` holds the
    gradient the update used."""
    is_pretrain = cfg.TRAIN.LABEL_EMB != "" and cfg.TRAIN.TEXT != ""
    is_epic = cfg.TRAIN.DATASET == "Epickitchens"
    loss_name = cfg.MODEL.LOSS_FUNC
    if is_pretrain:
        finetune_loss = None
    elif is_epic:  # JAX steps.py:175
        finetune_loss = get_loss_func(
            "cross_entropy" if loss_name == "kldiv" else loss_name)
    else:
        finetune_loss = get_loss_func(loss_name)
    mixup = (Mixup(mixup_alpha=cfg.MIXUP.ALPHA,
                   cutmix_alpha=cfg.MIXUP.CUTMIX_ALPHA, prob=cfg.MIXUP.PROB,
                   switch_prob=cfg.MIXUP.SWITCH_PROB, label_smoothing=0.1,
                   num_classes=cfg.MODEL.NUM_CLASSES)
             if cfg.MIXUP.ENABLED else None)
    topk = cfg.TRAIN.TOPK
    params = [p for g in optimizer.param_groups for p in g["params"]]
    device = next(model.parameters()).device
    gens = {name: torch.Generator(device=device) for name in STREAMS}
    state = {"step": start_step}

    def pretrain_metrics(batch: Batch, frames: torch.Tensor,
                         draws: Optional[Mapping]):
        ids, vis = batch["clip_text_ids"], batch["clip_vis_feat"]
        meta = {"clip_text_ids": ids.reshape(-1, ids.shape[-1]),
                "clip_vis_feat": vis.reshape(-1, vis.shape[-1])}
        student, teacher, mse_pair = model(
            frames, text=meta, label_emb=label_emb, train=True,
            generators=gens, draws=draws)
        loss, kl, mse = pretrain_loss(student, teacher, mse_pair, topk)
        with torch.no_grad():
            preds = torch.softmax(student.float(), dim=1)
            labels = batch["labels"].reshape(-1)[:1].to(preds.device).expand(
                preds.shape[0])
            top1, top5 = topk_errors(preds, labels, (1, 5))
        return loss, {"loss": loss.detach(), "kl": kl.detach(),
                      "mse": mse.detach(), "top1_err": top1, "top5_err": top5}

    def epic_metrics(batch: Batch, frames: torch.Tensor,
                     draws: Optional[Mapping]):
        verb, noun = model(frames, label_emb=label_emb, train=True,
                           generators=gens, draws=draws)
        lv_true = batch["verb"].reshape(-1).to(verb.device)
        ln_true = batch["noun"].reshape(-1).to(noun.device)
        loss, lv, ln = epic_loss(verb, noun, lv_true, ln_true, finetune_loss)
        with torch.no_grad():
            v1, v5 = topk_accuracies(verb, lv_true, (1, 5))
            n1, n5 = topk_accuracies(noun, ln_true, (1, 5))
            a1, a5 = multitask_topk_accuracies((verb, noun),
                                               (lv_true, ln_true), (1, 5))
        return loss, {"loss": loss.detach(), "verb_loss": lv.detach(),
                      "noun_loss": ln.detach(), "verb_top1_acc": v1,
                      "verb_top5_acc": v5, "noun_top1_acc": n1,
                      "noun_top5_acc": n5, "top1_acc": a1, "top5_acc": a5}

    def finetune_metrics(batch: Batch, frames: torch.Tensor,
                         draws: Optional[Mapping]):
        labels = batch["labels"].reshape(-1).to(frames.device)
        if mixup is not None:
            frames, soft = mixup(frames, labels, gens["mixup"],
                                 (draws or {}).get("mixup"))
        logits = model(frames, label_emb=label_emb, train=True,
                       generators=gens, draws=draws)
        loss = (soft_target_cross_entropy(logits, soft) if mixup is not None
                else finetune_loss(logits, labels))
        with torch.no_grad():
            top1, top5 = topk_errors(logits, labels, (1, 5))
        return loss, {"loss": loss.detach(), "top1_err": top1,
                      "top5_err": top5}

    def loss_and_metrics(batch: Batch, draws: Optional[Mapping]):
        frames = normalize_frames(batch["frames"], cfg)
        if is_pretrain:
            return pretrain_metrics(batch, frames, draws)
        if is_epic:
            return epic_metrics(batch, frames, draws)
        return finetune_metrics(batch, frames, draws)

    def train_step(batch: Union[Batch, Sequence[Batch]],
                   draws: Union[None, Mapping, Sequence[Mapping]] = None
                   ) -> Dict[str, Union[torch.Tensor, float]]:
        micro = list(batch) if isinstance(batch, (list, tuple)) else [batch]
        if len(micro) != accum_steps:
            raise ValueError(f"train_step: {len(micro)} micro-batches, "
                             f"expected {accum_steps}")
        per_micro = (list(draws) if isinstance(draws, (list, tuple))
                     else [draws] * len(micro))
        step = state["step"]
        model.train()
        optimizer.zero_grad(set_to_none=True)
        sums: Dict[str, torch.Tensor] = {}
        for i, (mb, dr) in enumerate(zip(micro, per_micro)):
            seed_generators(gens, cfg.RNG_SEED, step, i)
            last = i == len(micro) - 1
            with (contextlib.nullcontext() if last or not hasattr(
                    model, "no_sync") else model.no_sync()):
                loss, metrics = loss_and_metrics(mb, dr)
                loss.backward()
            for k, v in metrics.items():
                sums[k] = sums[k] + v if k in sums else v
        # a trained tensor the loss does not reach (the forecast's pad
        # embedding) takes a zero gradient, as in JAX: its decay applies
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if accum_steps > 1:
            torch._foreach_mul_(grads, 1.0 / accum_steps)
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        lr = sched(step)
        set_lr(optimizer, lr)
        optimizer.step()
        state["step"] = step + 1
        out: Dict[str, Union[torch.Tensor, float]] = {
            k: v / len(micro) for k, v in sums.items()}
        out["grad_norm"] = grad_norm
        out["lr"] = lr
        return all_reduce_mean_dict(out)

    return train_step


def make_bn_stats_step(model: torch.nn.Module, cfg
                       ) -> Callable[[Dict[str, torch.Tensor], Batch],
                                     Dict[str, torch.Tensor]]:
    """``stats_step(model_state, batch)``: the model's BN statistics set to
    ``model_state``, one train-mode forward of ``batch`` without autograd
    (weights untouched), and the updated statistics, copied (JAX
    ``make_bn_stats_step``, ``steps.py:255-267``: its draws those of step
    0); the model keeps the updated ones until the caller sets others."""
    device = next(model.parameters()).device
    gens = {name: torch.Generator(device=device) for name in STREAMS}

    def stats_step(model_state: Dict[str, torch.Tensor],
                   batch: Batch) -> Dict[str, torch.Tensor]:
        own = model.bn_state()
        with torch.no_grad():
            for k, v in model_state.items():
                own[k].copy_(v)
            seed_generators(gens, cfg.RNG_SEED, 0)
            model.train()
            model(normalize_frames(batch["frames"], cfg), train=True,
                  generators=gens)
        return {k: v.clone() for k, v in own.items()}

    return stats_step


def make_eval_step(model: torch.nn.Module, cfg,
                   label_emb: Optional[torch.Tensor]
                   ) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """Eval forward: ``eval_step({"frames": [B, T, H, W, 3]})`` ([B, M*T, H,
    W, 3] for forecasting) returns the post-softmax predictions [B, K]
    (reference ``lib/models/vit.py:355-357``) on the model's device, or
    for EPIC-Kitchens the (verb [B, 97], noun [B, 300]) logits as the model
    gives them; ``label_emb`` is None for a finetuning head."""

    def eval_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return model(normalize_frames(batch["frames"], cfg),
                         label_emb=label_emb, train=False)

    return eval_step
