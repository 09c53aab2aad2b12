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
    if "bias" in node:
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


def _conv(a) -> torch.Tensor:
    """A JAX conv kernel [kt, kh, kw, in, out] in torch's [out, in, kt, kh,
    kw] layout."""
    return _t(np.asarray(a).transpose(4, 3, 0, 1, 2))


def _mvit_attention(a: Mapping, pre: str, out: Dict[str, torch.Tensor]
                    ) -> None:
    """One ``MultiScaleAttention``: qkv, proj, the pool kernels
    [kt, kh, kw, 1, d] -> [d, 1, kt, kh, kw] with their norms, the rel-pos
    tables."""
    _linear(a["qkv"], pre + "qkv", out)
    _linear(a["proj"], pre + "proj", out)
    for p in ("q", "k", "v"):
        if f"pool_{p}" in a:
            out[pre + f"pool_{p}.weight"] = _conv(a[f"pool_{p}"]["kernel"])
            out[pre + f"norm_{p}.weight"] = _t(a[f"norm_{p}"]["scale"])
            out[pre + f"norm_{p}.bias"] = _t(a[f"norm_{p}"]["bias"])
    for rp in ("rel_pos_h", "rel_pos_w", "rel_pos_t"):
        if rp in a:
            out[pre + rp] = _t(a[rp])


def _mvit_block(blk: Mapping, pre: str, out: Dict[str, torch.Tensor]
                ) -> None:
    for ln in ("norm1", "norm2"):
        out[pre + ln + ".weight"] = _t(blk[ln]["scale"])
        out[pre + ln + ".bias"] = _t(blk[ln]["bias"])
    _mvit_attention(blk["attn"], pre + "attn.", out)
    if "proj" in blk:
        _linear(blk["proj"], pre + "proj", out)
    _linear(blk["mlp"]["fc1"], pre + "mlp.fc1", out)
    _linear(blk["mlp"]["fc2"], pre + "mlp.fc2", out)


def _mvit_encoder(enc: Mapping, out: Dict[str, torch.Tensor],
                  pre: str = "video_encoder.") -> None:
    """Inverse of ``convert_mvit``: the stem kernel [kt, kh, kw, C, D] ->
    [D, C, kt, kh, kw], the Dense kernels transposed."""
    out[pre + "patch_embed.proj.weight"] = _conv(enc["patch_embed_kernel"])
    out[pre + "patch_embed.proj.bias"] = _t(enc["patch_embed_bias"])
    for key in ("cls_token", "pos_embed", "pos_embed_spatial",
                "pos_embed_temporal", "pos_embed_class"):
        if key in enc:
            out[pre + key] = _t(enc[key])
    out[pre + "norm.weight"] = _t(enc["norm"]["scale"])
    out[pre + "norm.bias"] = _t(enc["norm"]["bias"])
    depth = sum(1 for k in enc if k.startswith("blocks_"))
    for i in range(depth):
        _mvit_block(enc[f"blocks_{i}"], f"{pre}blocks.{i}.", out)


def _resblocks(tree: Mapping, dst: str, out: Dict[str, torch.Tensor]) -> None:
    """CLIP-style blocks ``resblocks_{i}`` -> ``{dst}{i}.*`` with
    ``nn.MultiheadAttention`` / ``c_fc`` / ``c_proj`` names."""
    depth = sum(1 for k in tree if k.startswith("resblocks_"))
    for i in range(depth):
        blk, pre = tree[f"resblocks_{i}"], f"{dst}{i}."
        for ln in ("ln_1", "ln_2"):
            out[pre + ln + ".weight"] = _t(blk[ln]["scale"])
            out[pre + ln + ".bias"] = _t(blk[ln]["bias"])
        a = blk["attn"]
        out[pre + "attn.in_proj_weight"] = _t(np.asarray(a["qkv_kernel"]).T)
        out[pre + "attn.in_proj_bias"] = _t(a["qkv_bias"])
        out[pre + "attn.out_proj.weight"] = _t(np.asarray(a["proj_kernel"]).T)
        out[pre + "attn.out_proj.bias"] = _t(a["proj_bias"])
        _linear(blk["mlp"]["fc1"], pre + "mlp.c_fc", out)
        _linear(blk["mlp"]["fc2"], pre + "mlp.c_proj", out)


def _order_tfm(tree: Mapping, out: Dict[str, torch.Tensor]) -> None:
    """Inverse of ``convert_order_transformer``."""
    pre = "order_tfm."
    out[pre + "pad_embedding.weight"] = _t(tree["pad_embedding"])
    out[pre + "type_embedding.weight"] = _t(tree["type_embedding"])
    out[pre + "temporalEmbedding.weight"] = _t(tree["temporal_embedding"])
    _linear(tree["time_mlp_fc1"], pre + "time_mlp.1", out)
    _linear(tree["time_mlp_fc2"], pre + "time_mlp.3", out)
    _resblocks(tree, pre + "temporalModelling.resblocks.", out)


def _text_model(tree: Mapping, out: Dict[str, torch.Tensor]) -> None:
    """Inverse of ``convert_clip_text``."""
    pre = "text_model."
    out[pre + "token_embedding.weight"] = _t(tree["token_embedding"])
    out[pre + "positional_embedding"] = _t(tree["positional_embedding"])
    out[pre + "text_projection"] = _t(tree["text_projection"])
    out[pre + "ln_final.weight"] = _t(tree["ln_final"]["scale"])
    out[pre + "ln_final.bias"] = _t(tree["ln_final"]["bias"])
    _resblocks(tree, pre + "transformer.resblocks.", out)


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX parameter tree -> the port's state dict.

    Takes the tree of a JAX ``ProcedureVRL`` (``{"encoder": ..., "head":
    ..., "order_tfm": ..., "text_model": ..., "head_cls": ...}``; the order
    transformer's parameters are the same whether it was built for
    pretraining or for ``num_seg`` forecasting) or of a bare
    ``TimeSformer``; an MViT encoder (the tree has ``patch_embed_kernel``)
    lands under ``video_encoder.``.  Inverse of ``convert_timesformer``,
    ``convert_mvit``, ``convert_linear``, ``convert_order_transformer`` and
    ``convert_clip_text`` in ``procedurevrl_tpu/utils/converter.py``
    (``convert_procedurevrl``)."""
    out: Dict[str, torch.Tensor] = {}
    enc = tree["encoder"] if "encoder" in tree else tree
    if "patch_embed_kernel" in enc:
        _mvit_encoder(enc, out)
    else:
        _encoder(enc, out)
    if "head" in tree:
        _linear(tree["head"], "head", out)
    if "order_tfm" in tree:
        _order_tfm(tree["order_tfm"], out)
    if "text_model" in tree:
        _text_model(tree["text_model"], out)
    if "head_cls" in tree:
        _linear(tree["head_cls"], "head_cls", out)
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
