"""Accuracy metrics (counterpart of ``procedurevrl_tpu/utils/metrics.py``;
reference ``lib/utils/metrics.py:10-52``)."""

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
