"""Pretraining loss (counterpart of ``procedurevrl_tpu/engine/losses.py:27-63``;
reference ``tools/train_net.py:129-173``):
``KLDivLoss(reduction='batchmean')`` between ``log_softmax(student)`` and a
top-k-sharpened teacher distribution, plus ``MSELoss(reduction='mean')`` on
the diffusion (target, prediction) pair.  The cross-entropy family of the
finetuning paths comes with those paths.
"""

from __future__ import annotations

from typing import Tuple

import torch


def topk_sharpen(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the entries equal to one of the top-k values of their row (ties
    all kept), renormalise (reference ``tools/train_net.py:156-158``)."""
    if k == 0:
        return probs
    topv = torch.topk(probs, k, dim=1).values  # [B, k]
    keep = (probs[:, None, :] == topv[:, :, None]).to(probs.dtype)
    sharpened = (probs[:, None, :] * keep).sum(dim=1)
    return sharpened / sharpened.sum(dim=1, keepdim=True)


def kl_div_batchmean(log_pred: torch.Tensor,
                     target_probs: torch.Tensor) -> torch.Tensor:
    """torch ``KLDivLoss(reduction='batchmean')``: sum(t (log t - x)) / B,
    with 0 log 0 := 0."""
    t = target_probs
    pos = t > 0
    logt = torch.where(pos, torch.log(torch.where(pos, t, torch.ones_like(t))),
                       torch.zeros_like(t))
    pointwise = torch.where(pos, t * (logt - log_pred), torch.zeros_like(t))
    return pointwise.sum() / log_pred.shape[0]


def pretrain_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                  mse_pair: Tuple[torch.Tensor, torch.Tensor], topk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """KL(student || sharpened teacher) + diffusion MSE; returns
    (total, kl, mse).  No gradient flows into the teacher."""
    with torch.no_grad():
        teacher = topk_sharpen(torch.softmax(teacher_logits.float(), dim=1),
                               topk)
    logp = torch.log_softmax(student_logits.float(), dim=1)
    kl = kl_div_batchmean(logp, teacher)
    mse = ((mse_pair[0].float() - mse_pair[1].float()) ** 2).mean()
    return kl + mse, kl, mse
