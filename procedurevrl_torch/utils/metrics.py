"""Accuracy metrics (counterpart of ``procedurevrl_tpu/utils/metrics.py``;
reference ``lib/utils/metrics.py:10-103``, :268)."""

from __future__ import annotations

from typing import List, Sequence

import torch


def topks_correct(preds: torch.Tensor, labels: torch.Tensor,
                  ks: Sequence[int]) -> List[torch.Tensor]:
    """Number of top-k-correct predictions for each k (k clamped to the
    class count)."""
    ks = [min(k, preds.shape[1]) for k in ks]
    _, top_inds = torch.topk(preds, max(ks), dim=1)  # [B, max_k]
    correct = top_inds == labels.reshape(-1, 1)
    return [correct[:, :k].sum().float() for k in ks]


def topk_errors(preds: torch.Tensor, labels: torch.Tensor,
                ks: Sequence[int]) -> List[torch.Tensor]:
    """Top-k error rates in percent (reference ``lib/utils/metrics.py``)."""
    return [(1.0 - x / preds.shape[0]) * 100.0
            for x in topks_correct(preds, labels, ks)]


def topk_accuracies(preds: torch.Tensor, labels: torch.Tensor,
                    ks: Sequence[int]) -> List[torch.Tensor]:
    """Top-k accuracies in percent."""
    return [x / preds.shape[0] * 100.0
            for x in topks_correct(preds, labels, ks)]


def multitask_topks_correct(preds: Sequence[torch.Tensor],
                            labels: Sequence[torch.Tensor],
                            ks: Sequence[int]) -> List[torch.Tensor]:
    """Joint top-k of several tasks (EPIC's verb and noun): a sample counts
    when every task's label is inside that task's top k (k clamped to the
    smallest class count; JAX ``utils/metrics.py:40-54``, reference
    ``lib/utils/metrics.py:69-103``)."""
    ks = [min(k, min(p.shape[1] for p in preds)) for k in ks]
    max_k = max(ks)
    joint = None
    for p, lab in zip(preds, labels):
        _, top_inds = torch.topk(p, max_k, dim=1)  # [B, max_k]
        # within the top j of this task, for each j
        within = (top_inds == lab.reshape(-1, 1)).cumsum(dim=1) > 0
        joint = within if joint is None else joint & within
    return [joint[:, k - 1].sum().float() for k in ks]


def multitask_topk_accuracies(preds: Sequence[torch.Tensor],
                              labels: Sequence[torch.Tensor],
                              ks: Sequence[int]) -> List[torch.Tensor]:
    """Joint top-k accuracies in percent (EPIC's action accuracy)."""
    return [x / preds[0].shape[0] * 100.0
            for x in multitask_topks_correct(preds, labels, ks)]


def mean_class_recall(preds: torch.Tensor, labels: torch.Tensor,
                      num_classes: int) -> torch.Tensor:
    """Macro-averaged recall over the classes present in ``labels``, in
    percent (reference ``lib/utils/metrics.py:268``)."""
    labels = labels.reshape(-1).long()
    correct = (preds.argmax(dim=1) == labels).float()
    hits = torch.zeros(num_classes, device=preds.device).index_add_(
        0, labels, correct)
    total = torch.zeros(num_classes, device=preds.device).index_add_(
        0, labels, torch.ones_like(correct))
    present = total > 0
    recall = hits / total.clamp_min(1.0)
    return (recall[present].sum() / present.sum().clamp_min(1)) * 100.0
