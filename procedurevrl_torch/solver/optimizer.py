"""Optimizer construction with the reference's parameter-group rules
(counterpart of ``procedurevrl_tpu/solver/optimizer.py``; reference
``lib/models/optimizer.py:10-118``).

Groups by parameter name, as the JAX package groups by tree path:

- the CLIP text tower is frozen (``requires_grad=False``, reference
  ``lib/models/vit.py:261``); under finetuning the 512-d pretraining
  ``head`` is frozen too;
- finetune (``TRAIN.MULT != 1`` or ``TRAIN.LINEAR``): names containing
  ``head`` or ``order`` train with SOLVER.WEIGHT_DECAY; the rest is the
  encoder group, frozen under LINEAR, else BN.WEIGHT_DECAY at lr x MULT;
- pretraining: ``bn`` parameters take BN.WEIGHT_DECAY, the rest
  SOLVER.WEIGHT_DECAY.

The update rules are the JAX package's optax chains
(``procedurevrl_tpu/solver/optimizer.py:90-112``):

- ``adamw`` is ``torch.optim.AdamW`` (eps 1e-8, decoupled decay): its
  update ``p - lr wd p - lr m_hat / (sqrt(v_hat) + eps)`` is
  ``scale_by_adam -> add_decayed_weights -> scale(-lr)``;
- ``sgd`` is ``torch.optim.SGD`` (dampening 0, coupled decay): ``g + wd p``
  into the momentum buffer ``b = m b + g`` (the first step's buffer is g,
  as optax's zero-initialised ``trace``), the Nesterov update ``g + m b``
  or ``b``, times ``-lr``: ``add_decayed_weights -> trace(MOMENTUM,
  NESTEROV) -> scale(-lr)``; with momentum 0, plain ``-lr (g + wd p)``;
- ``adam`` is ``torch.optim.Adam`` (eps 1e-8, coupled decay):
  ``add_decayed_weights -> scale_by_adam -> scale(-lr)``.

``TPU.MOMENT_DTYPE bfloat16`` (the JAX package's low-precision Adam
moments) is not ported and raises.  Each group keeps an ``lr_mult``;
:func:`set_lr` writes ``lr x lr_mult`` into every group.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Type

import torch


def _is_text(name: str) -> bool:
    return "text_model" in name or "text_module" in name


def is_encoder(name: str) -> bool:
    """Whether a parameter name belongs to the video encoder: the group
    that ``TRAIN.LINEAR`` freezes and ``TRAIN.MULT`` scales."""
    return not (_is_text(name) or "head" in name or "order" in name)


def _group_of(name: str, cfg) -> str:
    """Group label of one parameter name (``blocks.0.attn.qkv.weight``)."""
    if _is_text(name):
        return "frozen"
    finetune = cfg.TRAIN.MULT != 1.0 or cfg.TRAIN.LINEAR
    if finetune:
        is_pretrain_head = cfg.TRAIN.LABEL_EMB != ""
        if name.startswith("head.") and not is_pretrain_head:
            return "frozen"
        if not is_encoder(name):
            return "heads"
        return "frozen" if cfg.TRAIN.LINEAR else "encoder"
    if cfg.TRAIN.LABEL_EMB == "" and name.startswith("head."):
        return "frozen"
    if "bn" in name:
        return "bn"
    return "main"


def param_groups(model: torch.nn.Module, cfg) -> List[Dict]:
    """Parameter groups of ``model`` with their weight decay and LR
    multiplier; frozen parameters get ``requires_grad=False`` and join no
    group."""
    wd_of = {"heads": cfg.SOLVER.WEIGHT_DECAY, "encoder": cfg.BN.WEIGHT_DECAY,
             "bn": cfg.BN.WEIGHT_DECAY, "main": cfg.SOLVER.WEIGHT_DECAY}
    mult_of = {"heads": 1.0, "encoder": cfg.TRAIN.MULT, "bn": 1.0,
               "main": 1.0}
    groups: Dict[str, List[torch.nn.Parameter]] = {}
    for name, p in model.named_parameters():
        label = _group_of(name, cfg)
        if label == "frozen":
            p.requires_grad_(False)
            continue
        groups.setdefault(label, []).append(p)
    return [{"params": ps, "weight_decay": wd_of[g], "lr_mult": mult_of[g],
             "name": g} for g, ps in sorted(groups.items())]


def optimizer_spec(model: torch.nn.Module, cfg
                   ) -> Tuple[Type[torch.optim.Optimizer], List[Dict], Dict]:
    """The optimizer of ``SOLVER.OPTIMIZING_METHOD`` (``sgd``, ``adam`` or
    ``adamw``) as (class, ``param_groups``, keyword arguments), which
    :func:`construct_optimizer` and the ZeRO-1 wrapper
    (``parallel/ddp.py``) build alike."""
    method = cfg.SOLVER.OPTIMIZING_METHOD
    if method not in ("sgd", "adam", "adamw"):
        raise NotImplementedError(f"Does not support {method} optimizer")
    groups, lr = param_groups(model, cfg), cfg.SOLVER.BASE_LR
    if method == "sgd":
        momentum = cfg.SOLVER.MOMENTUM
        return torch.optim.SGD, groups, dict(
            lr=lr, momentum=momentum, dampening=0.0,
            nesterov=bool(cfg.SOLVER.NESTEROV and momentum))
    if cfg.TPU.MOMENT_DTYPE != "float32":
        raise NotImplementedError(
            f"TPU.MOMENT_DTYPE {cfg.TPU.MOMENT_DTYPE}: low-precision Adam "
            "moments (solver/low_precision.py) are not ported")
    adam = torch.optim.Adam if method == "adam" else torch.optim.AdamW
    return adam, groups, dict(lr=lr, betas=(0.9, 0.999), eps=1e-8)


def construct_optimizer(model: torch.nn.Module, cfg) -> torch.optim.Optimizer:
    """The optimizer of :func:`optimizer_spec`; its LR is set per step by
    :func:`set_lr`."""
    cls, groups, kwargs = optimizer_spec(model, cfg)
    return cls(groups, **kwargs)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_mult"]
