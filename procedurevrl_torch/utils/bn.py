"""Precise BatchNorm statistics (counterpart of
``procedurevrl_tpu/utils/bn.py:24-122``; reference
``lib/utils/bn_helper.py:10-76``).

Training leaves the running statistics behind the weights; precise BN
re-estimates them with the weights frozen over ``num_batches`` batches.
A model state here is the BN running statistics by buffer name
(``...running_mean``, ``...running_var``; ``[C]`` or ``[splits, C]``), as
``_VideoModel.bn_state`` gives them.  One train-mode forward updates them
to ``new = (1 - m) old + m batch``, so ``batch = (new - (1 - m) old) / m``
recovers each batch's statistics exactly; the precise mean is the average
of the batch means and the precise variance the average of ``var +
mean^2`` less the square of the precise mean, as JAX computes them (not
fvcore's running formula).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import torch

State = Dict[str, torch.Tensor]
_MEAN, _VAR = "running_mean", "running_var"


def recover_batch_stats(old: State, new: State, momentum: float = 0.1
                        ) -> State:
    """Invert one running-average update: the batch's statistics."""
    return {k: (new[k] - (1.0 - momentum) * old[k]) / momentum for k in new}


def _var_plus_mean_sq(stats: State) -> State:
    return {k: (v + stats[k[:-len(_VAR)] + _MEAN].square()
                if k.endswith(_VAR) else v) for k, v in stats.items()}


def _finalize(mean_acc: State, sq_acc: State) -> State:
    """var = E[var + mean^2] - E[mean]^2 per BN."""
    return {k: (sq_acc[k] - mean_acc[k[:-len(_VAR)] + _MEAN].square()
                if k.endswith(_VAR) else v) for k, v in mean_acc.items()}


def compute_precise_bn_stats(apply_train_stats: Callable[[State, object],
                                                         State],
                             model_state: State, batches: Iterable,
                             num_batches: int = 200,
                             momentum: float = 0.1) -> State:
    """The running statistics re-estimated over ``num_batches`` of
    ``batches``: ``apply_train_stats(model_state, batch)`` runs one
    train-mode forward from ``model_state`` and returns the updated
    statistics (weights untouched).  Every batch starts from
    ``model_state``; with no batch it is returned as it is."""
    mean_acc = sq_acc = None
    n = 0
    for batch in batches:
        if n >= num_batches:
            break
        stats = recover_batch_stats(model_state,
                                    apply_train_stats(model_state, batch),
                                    momentum)
        n += 1
        sq = _var_plus_mean_sq(stats)
        if mean_acc is None:
            mean_acc = {k: torch.zeros_like(v) for k, v in stats.items()}
            sq_acc = {k: torch.zeros_like(v) for k, v in sq.items()}
        # the streaming average (reference bn_helper.py:62-69)
        mean_acc = {k: a + (stats[k] - a) / n for k, a in mean_acc.items()}
        sq_acc = {k: a + (sq[k] - a) / n for k, a in sq_acc.items()}
    if mean_acc is None:
        return model_state
    return _finalize(mean_acc, sq_acc)


def aggregate_sub_bn_stats(model_state: State) -> Tuple[State, int]:
    """Split statistics ``[splits, C]`` collapsed to one set ``[C]``: the
    mean of the means, the mean of the variances plus the variance of the
    means (reference ``lib/utils/misc.py:254-269``,
    ``SubBatchNorm3d.aggregate_stats``); the model derives the same at
    eval, so this serves only to export a split-statistics state as plain
    BN.  Returns the new state and the number of BNs aggregated."""
    out, count = dict(model_state), 0
    for k, mean in model_state.items():
        if not k.endswith(_MEAN) or mean.dim() != 2:
            continue
        count += 1
        var_key = k[:-len(_MEAN)] + _VAR
        agg = mean.mean(dim=0)
        out[k] = agg
        out[var_key] = (model_state[var_key].mean(dim=0)
                        + (mean - agg).square().mean(dim=0))
    return out, count
