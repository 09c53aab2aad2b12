"""Train and eval steps (counterpart of ``procedurevrl_tpu/engine/steps.py``;
reference ``tools/train_net.py:101-247``).

The train step takes normalised uint8 frames through the model, its loss,
top-1 / top-5 errors, backward, and one optimizer update with the LR set
on the host from the schedule.  Order pretraining (``TRAIN.LABEL_EMB`` and
``TRAIN.TEXT`` set) runs the pretraining branch and the KL + MSE loss,
with the errors of the student's softmax; finetuning (the COIN step, task
and forecasting heads) the logits of the head, ``MODEL.LOSS_FUNC`` through
``get_loss_func`` (``smooth`` is label smoothing 0.2, its default) and
the errors of the logits (JAX ``steps.py:180-197``).  Parameters of the frozen groups
(``solver/optimizer.py``: the linear probe's encoder, a finetune's
``head``) have ``requires_grad=False``: no gradient, no update, and where
the whole encoder is frozen no backward through it (the model runs it
without autograd), as JAX's ``stop_frozen_gradients`` deletes that
backward.  EPIC-Kitchens' verb + noun step and mixup raise.  With ``accum_steps > 1`` it takes that many
micro-batches, sums their gradients and divides by their number before the
one update (the mean of micro-batch gradients, JAX ``steps.py:225-252``).

Random streams: one ``torch.Generator`` each for "diffusion", "subset" and
"droppath", on the model's device, re-seeded for every micro-batch from
``RNG_SEED``, the optimizer step and the micro-batch index.  Metrics stay
on the device as tensors (``lr`` is a float): the caller reads them at log
boundaries, so steps queue on the card without a host round trip.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from procedurevrl_torch.engine.losses import get_loss_func, pretrain_loss
from procedurevrl_torch.solver.optimizer import set_lr
from procedurevrl_torch.utils.metrics import topk_errors

STREAMS = ("diffusion", "subset", "droppath")

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
    normalised float) and ``labels`` [B], for pretraining frames [B, M, T,
    H, W, 3] with ``clip_text_ids`` [B, M, 77] and ``clip_vis_feat`` [B, M,
    512], for finetuning the model's layout ([B, T, ...], or [B, M*T, ...]
    for forecasting); with ``accum_steps > 1`` it is a sequence of that
    many such micro-batches.  ``draws`` (a mapping, or one per micro-batch)
    fixes the model's random draws (see ``ProcedureVRL.forward``).  Returns
    the metrics ``loss``, ``top1_err``, ``top5_err`` (and for pretraining
    ``kl``, ``mse``; means over the micro-batches), ``grad_norm`` (of the
    averaged gradients) and ``lr``.  After the call every trained
    parameter's ``.grad`` holds the gradient the update used."""
    is_pretrain = cfg.TRAIN.LABEL_EMB != "" and cfg.TRAIN.TEXT != ""
    if not is_pretrain:
        if cfg.TRAIN.DATASET == "Epickitchens":
            raise NotImplementedError("EPIC-Kitchens finetuning (verb + noun "
                                      "heads) comes with the EPIC slice")
        if cfg.MIXUP.ENABLED:
            raise NotImplementedError("MIXUP.ENABLED: mixup "
                                      "(engine/mixup.py) comes with the EPIC "
                                      "slice")
    finetune_loss = None if is_pretrain else get_loss_func(cfg.MODEL.LOSS_FUNC)
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

    def finetune_metrics(batch: Batch, frames: torch.Tensor,
                         draws: Optional[Mapping]):
        logits = model(frames, label_emb=label_emb, train=True,
                       generators=gens, draws=draws)
        labels = batch["labels"].reshape(-1).to(logits.device)
        loss = finetune_loss(logits, labels)
        with torch.no_grad():
            top1, top5 = topk_errors(logits, labels, (1, 5))
        return loss, {"loss": loss.detach(), "top1_err": top1,
                      "top5_err": top5}

    def loss_and_metrics(batch: Batch, draws: Optional[Mapping]):
        frames = normalize_frames(batch["frames"], cfg)
        if is_pretrain:
            return pretrain_metrics(batch, frames, draws)
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
        return out

    return train_step


def make_eval_step(model: torch.nn.Module, cfg,
                   label_emb: Optional[torch.Tensor]
                   ) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """Eval forward: ``eval_step({"frames": [B, T, H, W, 3]})`` ([B, M*T, H,
    W, 3] for forecasting) returns the post-softmax predictions [B, K]
    (reference ``lib/models/vit.py:355-357``) on the model's device;
    ``label_emb`` is None for a finetuning head."""

    def eval_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return model(normalize_frames(batch["frames"], cfg),
                         label_emb=label_emb, train=False)

    return eval_step
