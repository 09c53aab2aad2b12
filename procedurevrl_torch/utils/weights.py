"""Weights in and out of the port (counterpart of
``procedurevrl_tpu/utils/converter.py``).

The port's state dict uses the reference ``.pyth`` names and layouts, so a
reference checkpoint loads as it is, and the JAX package's
``convert_procedurevrl`` maps ``port.state_dict()`` onto the JAX parameter
tree.  ``params_from_jax`` is the inverse of that converter, for moving
JAX-initialised parameters (nested dicts of numpy arrays) into the port.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping

import numpy as np
import torch

_NORMS = ("norm1", "norm2", "temporal_norm1")
_ATTNS = ("attn", "temporal_attn")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(node: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[prefix + ".weight"] = _t(np.asarray(node["kernel"]).T)
    out[prefix + ".bias"] = _t(node["bias"])


def _encoder(enc: Mapping, out: Dict[str, torch.Tensor], in_chans: int = 3
             ) -> None:
    kernel = np.asarray(enc["patch_embed"]["kernel"])  # [p*p*C, D]
    p = int(round((kernel.shape[0] // in_chans) ** 0.5))
    out["patch_embed.proj.weight"] = _t(
        kernel.reshape(p, p, in_chans, -1).transpose(3, 2, 0, 1))
    out["patch_embed.proj.bias"] = _t(enc["patch_embed"]["bias"])
    for key in ("cls_token", "pos_embed", "time_embed"):
        if key in enc:
            out[key] = _t(enc[key])
    depth = sum(1 for k in enc if k.startswith("blocks_"))
    for i in range(depth):
        blk, dst = enc[f"blocks_{i}"], f"blocks.{i}."
        for ln in _NORMS:
            if ln in blk:
                out[dst + ln + ".weight"] = _t(blk[ln]["scale"])
                out[dst + ln + ".bias"] = _t(blk[ln]["bias"])
        for attn in _ATTNS:
            if attn not in blk:
                continue
            a = blk[attn]
            out[dst + attn + ".qkv.weight"] = _t(np.asarray(a["qkv_kernel"]).T)
            if "qkv_bias" in a:
                out[dst + attn + ".qkv.bias"] = _t(a["qkv_bias"])
            out[dst + attn + ".proj.weight"] = _t(np.asarray(a["proj_kernel"]).T)
            out[dst + attn + ".proj.bias"] = _t(a["proj_bias"])
        if "temporal_fc" in blk:
            _linear(blk["temporal_fc"], dst + "temporal_fc", out)
        _linear(blk["mlp"]["fc1"], dst + "mlp.fc1", out)
        _linear(blk["mlp"]["fc2"], dst + "mlp.fc2", out)
    out["norm.weight"] = _t(enc["norm"]["scale"])
    out["norm.bias"] = _t(enc["norm"]["bias"])


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX parameter tree -> the port's state dict.

    Takes the tree of a JAX ``ProcedureVRL`` (``{"encoder": ..., "head":
    ...}``) or of a bare ``TimeSformer``.  Inverse of ``convert_timesformer``
    and ``convert_linear`` in ``procedurevrl_tpu/utils/converter.py``."""
    out: Dict[str, torch.Tensor] = {}
    _encoder(tree["encoder"] if "encoder" in tree else tree, out)
    if "head" in tree:
        _linear(tree["head"], "head", out)
    return out


def strip_prefixes(state: Mapping, prefixes: Iterable[str] = ("module.",
                                                              "model.")
                   ) -> Dict:
    """Drop a DDP ``module.`` and a ``model.`` wrapper prefix carried by
    every key."""
    out = dict(state)
    for prefix in prefixes:
        if out and all(k.startswith(prefix) for k in out):
            out = {k[len(prefix):]: v for k, v in out.items()}
    return out


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The model state of a reference ``.pyth`` checkpoint
    (``{"model_state": ..., ...}``, reference ``lib/utils/checkpoint.py``),
    with the ``module.``/``model.`` prefixes stripped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt.get("model_state", ckpt) if isinstance(ckpt, dict) else ckpt
    return strip_prefixes(state)


def load_into(model: torch.nn.Module, state: Mapping[str, torch.Tensor]
              ) -> List[str]:
    """Load every parameter of ``model`` from ``state``; raises if one is
    missing.  Returns the keys of ``state`` the model has no use for (the
    branches of the full reference model that this port does not run)."""
    missing, unexpected = model.load_state_dict(dict(state), strict=False)
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} parameters of the "
                       f"model, e.g. {missing[:5]}")
    return list(unexpected)
