"""Losses (counterpart of ``procedurevrl_tpu/engine/losses.py``; reference
``tools/train_net.py:129-173``, ``lib/models/losses.py``):

- pretraining: ``KLDivLoss(reduction='batchmean')`` between
  ``log_softmax(student)`` and a top-k-sharpened teacher distribution,
  plus ``MSELoss(reduction='mean')`` on the diffusion (target, prediction)
  pair;
- finetuning: mean cross-entropy, label-smoothing CE (0.2, ``smooth``),
  soft-target CE, BCE on probabilities or logits, and MIL-NCE (unwired, as
  in the reference), by name through :func:`get_loss_func`;
- EPIC-Kitchens: :func:`epic_loss`, the mean of the verb and noun losses.
"""

from __future__ import annotations

from typing import Callable, Tuple

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


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.float(), dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch; integer labels."""
    logp = _log_softmax(logits)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()


def label_smoothing_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                  smoothing: float = 0.2) -> torch.Tensor:
    """timm ``LabelSmoothingCrossEntropy`` (reference
    ``tools/train_net.py:130``)."""
    logp = _log_softmax(logits)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    smooth = -logp.mean(dim=-1)
    return ((1.0 - smoothing) * nll + smoothing * smooth).mean()


def soft_target_cross_entropy(logits: torch.Tensor,
                              target_probs: torch.Tensor) -> torch.Tensor:
    """timm ``SoftTargetCrossEntropy`` (the mixup path)."""
    return (-target_probs * _log_softmax(logits)).sum(dim=-1).mean()


def bce(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary CE of probabilities clipped to [1e-12, 1 - 1e-12]."""
    p = probs.float().clamp(1e-12, 1 - 1e-12)
    return -(targets * torch.log(p) + (1 - targets) * torch.log(1 - p)).mean()


def bce_logit(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary CE of logits, in the stable form."""
    x = logits.float()
    return (x.clamp_min(0) - x * targets
            + torch.log1p(torch.exp(-x.abs()))).mean()


def milnce(video_emb: torch.Tensor, text_emb: torch.Tensor) -> torch.Tensor:
    """MIL-NCE over candidate narrations (reference
    ``lib/models/losses.py:11-23``): video_emb [B, C], text_emb [B, n, C]
    or [B, C]; each video's own n narrations are its positives."""
    if text_emb.dim() == 2:
        text_emb = text_emb[:, None]
    x = torch.einsum("bc,knc->bkn", video_emb.float(), text_emb.float())
    x = x.reshape(x.shape[0], -1)  # [B, B*n]
    n = text_emb.shape[1]
    cols = torch.arange(x.shape[1], device=x.device)
    pos = cols[None, :] // n == torch.arange(x.shape[0], device=x.device)[:, None]
    nominator = torch.logsumexp(x.masked_fill(~pos, float("-inf")), dim=1)
    return (torch.logsumexp(x, dim=1) - nominator).mean()


def epic_loss(verb_logits: torch.Tensor, noun_logits: torch.Tensor,
              verb_labels: torch.Tensor, noun_labels: torch.Tensor,
              loss_fn: Callable = cross_entropy
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """0.5 (verb loss + noun loss); returns (total, verb, noun) (JAX
    ``engine/losses.py:124-135``, reference ``tools/train_net.py:166-169``)."""
    lv = loss_fn(verb_logits, verb_labels)
    ln = loss_fn(noun_logits, noun_labels)
    return 0.5 * (lv + ln), lv, ln


_LOSSES = {"cross_entropy": cross_entropy,
           "smooth": label_smoothing_cross_entropy, "bce": bce,
           "bce_logit": bce_logit, "milnce": milnce,
           "soft_target": soft_target_cross_entropy}


def get_loss_func(name: str) -> Callable:
    """Loss by name (reference ``lib/models/losses.py:45-50``)."""
    if name not in _LOSSES:
        raise KeyError(f"loss {name!r}: expected one of {sorted(_LOSSES)}")
    return _LOSSES[name]
