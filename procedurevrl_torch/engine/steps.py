"""Train and eval steps (counterpart of ``procedurevrl_tpu/engine/steps.py``;
reference ``tools/train_net.py:101-247``).

The train step is the order-pretraining step: normalised uint8 frames
through the model's pretraining branch, the KL + MSE loss, softmax top-1 /
top-5 errors, backward, and one optimizer update with the LR set on the
host from the schedule.  With ``accum_steps > 1`` it takes that many
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

from procedurevrl_torch.engine.losses import pretrain_loss
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
                    cfg, label_emb: torch.Tensor, sched: Callable[[int], float],
                    accum_steps: int = 1) -> Callable:
    """The order-pretraining train step.

    ``train_step(batch, draws=None)``: ``batch`` holds ``frames``
    [B, M, T, H, W, 3] (uint8 or normalised float), ``labels`` [B],
    ``clip_text_ids`` [B, M, 77] and ``clip_vis_feat`` [B, M, 512]; with
    ``accum_steps > 1`` it is a sequence of that many such micro-batches.
    ``draws`` (a mapping, or one per micro-batch) fixes the model's random
    draws (see ``ProcedureVRL.forward``).  Returns the metrics ``loss``,
    ``kl``, ``mse``, ``top1_err``, ``top5_err`` (means over the
    micro-batches), ``grad_norm`` (of the averaged gradients) and ``lr``.
    After the call every trained parameter's ``.grad`` holds the gradient
    the update used."""
    if cfg.TRAIN.LABEL_EMB == "" or cfg.TRAIN.TEXT == "":
        raise NotImplementedError("only the order-pretraining train step is "
                                  "ported so far")
    topk = cfg.TRAIN.TOPK
    params = [p for g in optimizer.param_groups for p in g["params"]]
    gens = {name: torch.Generator(device=label_emb.device) for name in STREAMS}
    state = {"step": 0}

    def loss_and_metrics(batch: Batch, draws: Optional[Mapping]):
        frames = normalize_frames(batch["frames"], cfg)
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
        grads = [p.grad for p in params if p.grad is not None]
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
    """Eval forward: ``eval_step({"frames": [B, T, H, W, 3]})`` returns the
    post-softmax predictions [B, K] (reference ``lib/models/vit.py:355-357``)
    on the model's device."""

    def eval_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return model(normalize_frames(batch["frames"], cfg),
                         label_emb=label_emb, train=False)

    return eval_step
