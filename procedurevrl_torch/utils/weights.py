"""Weights in and out of the port (counterpart of
``procedurevrl_tpu/utils/converter.py``).

The port's state dict uses the reference ``.pyth`` names and layouts, so a
reference checkpoint loads as it is, and the JAX package's
``convert_procedurevrl`` maps ``port.state_dict()`` onto the JAX parameter
tree.  ``params_from_jax`` is the inverse of that converter, for moving
JAX-initialised parameters (nested dicts of numpy arrays) into the port;
``resnet_state_from_jax`` that of ``convert_resnet_video`` for the
BatchNorm video family, ``batch_stats`` included.  A checkpoint the JAX
package wrote (flax msgpack in a pickle) is read by :func:`read_jax_native`
with ``msgpack`` and without flax.

Loading follows JAX ``utils/checkpoint.py``: :func:`load_reference_params`
(a full model's file, shape-filtered, ``time_embed`` resized) and
:func:`load_pretrained_encoder` (the encoder alone from an ImageNet ViT, an
MViT image or video checkpoint, a TimeSformer video checkpoint or a released
ProcedureVRL file); :func:`load_into` is the strict load of the port's own
checkpoints.
"""

from __future__ import annotations

import os
import pickle
import zipfile
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from procedurevrl_torch.utils.logging import get_logger

logger = get_logger(__name__)

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
    ..., "order_tfm": ..., "text_model": ..., "head_cls": ...}``, or
    ``head_v`` and ``head_n`` for EPIC-Kitchens; the order
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
    for head in ("head_cls", "head_v", "head_n"):
        if head in tree:
            _linear(tree[head], head, out)
    return out


# the 1x1x1 convolutions JAX writes as Dense layers (``[in, out]``
# kernels), as ``convert_resnet_video`` lists them
_RESNET_DENSE = ("conv_theta", "conv_phi", "conv_g", "conv_out", "se/fc1",
                 "se/fc2")


def _flat(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def resnet_state_from_jax(params: Mapping, batch_stats: Optional[Mapping]
                          = None) -> Dict[str, torch.Tensor]:
    """JAX ``(params, batch_stats)`` of SlowFast / ResNet / X3D (nested
    dicts of numpy arrays) -> the port's state dict, running statistics
    included: the inverse of ``convert_resnet_video`` (JAX
    ``utils/converter.py:331``).  Conv kernels ``[kt, kh, kw, in, out]`` ->
    ``[out, in, kt, kh, kw]``; the Dense 1x1x1 convolutions ``[in, out]`` ->
    ``[out, in, 1, 1, 1]``; the projection ``[in, out]`` -> ``[out, in]``;
    BN ``scale`` -> ``weight``, ``mean`` / ``var`` -> ``running_mean`` /
    ``running_var`` (``[C]``, or ``[splits, C]``)."""
    out: Dict[str, torch.Tensor] = {}
    for path, v in _flat(params).items():
        mod, leaf = path.rsplit("/", 1)
        key = mod.replace("/", ".")
        if leaf == "scale":
            out[key + ".weight"] = _t(v)
        elif leaf == "bias":
            out[key + ".bias"] = _t(v)
        elif leaf == "kernel" and v.ndim == 5:
            out[key + ".weight"] = _conv(v)
        elif leaf == "kernel" and any(m in mod for m in _RESNET_DENSE):
            out[key + ".weight"] = _t(v.T.reshape(*v.T.shape, 1, 1, 1))
        elif leaf == "kernel":
            out[key + ".weight"] = _t(v.T)
        else:
            raise KeyError(f"no port name for the JAX parameter {path}")
    names = {"mean": "running_mean", "var": "running_var"}
    for path, v in _flat(batch_stats or {}).items():
        mod, leaf = path.rsplit("/", 1)
        out[mod.replace("/", ".") + "." + names[leaf]] = _t(v)
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


TIMESFORMER_ENCODER = ("patch_embed", "blocks", "norm", "cls_token",
                       "pos_embed", "time_embed")


class _PlainUnpickler(pickle.Unpickler):
    """Unpickles builtins only: enough to read the JAX package's checkpoint
    (a dict of bytes, ints and strings), never code."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"{module}.{name} in a plain pickle")


def is_jax_native(path: str) -> bool:
    """Whether ``path`` is a checkpoint of the JAX package: a plain pickle
    of ``{"model_state": <flax msgpack bytes>, ...}`` (JAX
    ``utils/checkpoint.py:153-164``), where torch's files are zip archives
    (or, in the legacy format, start with a pickled magic number)."""
    if zipfile.is_zipfile(path):
        return False
    try:
        with open(path, "rb") as f:
            blob = _PlainUnpickler(f).load()
    except Exception:
        return False
    return isinstance(blob, dict) and isinstance(blob.get("model_state"),
                                                 bytes)


def _flax_ext(code: int, data: bytes):
    """flax's msgpack extensions (``serialization._msgpack_ext_unpack``):
    code 1 an ndarray, 3 a numpy scalar, each the msgpack of ``(shape,
    dtype name, buffer)``; bfloat16 is read through torch, as numpy has no
    such dtype."""
    import msgpack

    if code not in (1, 3):
        raise ValueError(f"msgpack extension {code} is not read here")
    shape, name, buf = msgpack.unpackb(data, raw=False)
    if name == "bfloat16":
        arr = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16
                               ).float().numpy()
    else:
        arr = np.frombuffer(buf, dtype=np.dtype(name)).copy()
    arr = arr.reshape(shape)
    return arr[()] if code == 3 else arr


def flax_tree(data: bytes) -> dict:
    """The tree of flax's ``serialization.to_bytes`` (numpy leaves), read
    with ``msgpack``, flax's own dependency, without flax; a tree whose
    arrays flax chunked (over 2**30 bytes) raises."""
    import msgpack

    tree = msgpack.unpackb(data, ext_hook=_flax_ext, raw=False)
    if _chunked(tree):
        raise ValueError("chunked flax arrays are not read here")
    return tree


def _chunked(tree) -> bool:
    return isinstance(tree, dict) and (
        "__msgpack_chunked_array__" in tree
        or any(_chunked(v) for v in tree.values()))


def read_jax_native(path: str) -> dict:
    """A checkpoint of the JAX package as a file of the reference's form:
    ``{"model_state": <the port's state dict>, "epoch", "step"}``.  A
    BatchNorm family model (its tree has ``s1``) converts with its
    ``batch_stats`` (:func:`resnet_state_from_jax`), any other through
    :func:`params_from_jax`; the optimizer state is not read.  A tree that
    does not convert raises ``ValueError`` naming the file."""
    with open(path, "rb") as f:
        blob = _PlainUnpickler(f).load()
    try:
        params = flax_tree(blob["model_state"])
        if "s1" in params:
            stats = (flax_tree(blob["batch_stats"])
                     if blob.get("batch_stats") is not None else None)
            state = resnet_state_from_jax(params, stats)
        else:
            state = params_from_jax(params)
    except (KeyError, ValueError, TypeError) as e:
        raise ValueError(f"checkpoint {path!r} of the JAX package does not "
                         f"convert to the port's model: {e!r}") from e
    return {"model_state": state, "epoch": blob.get("epoch"),
            "step": blob.get("step", 0)}


def read_checkpoint(path: str):
    """A file to load parameters from: a checkpoint of the JAX package
    through :func:`read_jax_native`, any other through :func:`read_file`."""
    return read_jax_native(path) if is_jax_native(path) else read_file(path)


def read_file(path: str):
    """``torch.load`` of a checkpoint file onto the CPU; a file of the JAX
    package is refused with a ``ValueError`` naming it (its parameters load
    through :func:`read_checkpoint`, its optimizer state nowhere)."""
    if is_jax_native(path):
        raise ValueError(
            f"{path} is a checkpoint of the JAX package (flax msgpack bytes "
            "in a pickle), whose optimizer state the port cannot read: "
            "load its parameters as a checkpoint file, or resume from a "
            "checkpoint the port wrote")
    return torch.load(path, map_location="cpu", weights_only=False)


def read_reference(path: str, blob=None) -> Tuple[Dict[str, torch.Tensor],
                                                  Optional[int]]:
    """The state dict of a ``.pyth`` file (``model_state``, ``state_dict``
    or ``model`` of a dict, else the file itself), keys as written, and its
    ``epoch`` if it has one (JAX ``load_reference_state_dict``).  ``blob``
    is the file's content where the caller has read it already."""
    if blob is None:
        blob = read_file(path)
    epoch = None
    if isinstance(blob, dict) and "model_state" in blob:
        state, epoch = blob["model_state"], blob.get("epoch")
    elif isinstance(blob, dict) and "state_dict" in blob:
        state = blob["state_dict"]
    elif (isinstance(blob, dict) and isinstance(blob.get("model"), dict)
          and torch.is_tensor(next(iter(blob["model"].values()), None))):
        state = blob["model"]
    else:
        state = blob
    return {k: torch.as_tensor(v) for k, v in state.items()}, epoch


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The model state of a reference ``.pyth`` checkpoint
    (``{"model_state": ..., ...}``, reference ``lib/utils/checkpoint.py``),
    with the ``module.``/``model.`` prefixes stripped."""
    return strip_prefixes(read_reference(path)[0])


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


def resize_time_embed(state: Dict[str, torch.Tensor],
                      own: Mapping[str, torch.Tensor]) -> None:
    """Nearest-resize, in place, a checkpoint ``time_embed`` [1, T', D]
    whose frame count differs from the model's [1, T, D] to T rows,
    ``floor(arange(T) * T' / T)`` (JAX ``_resize_time_embed``; reference
    ``lib/utils/checkpoint.py:360-365``): a 96-frame finetune from an
    8-frame pretraining keeps the pretrained temporal positions."""
    for key, tv in own.items():
        if key.split(".")[-1] != "time_embed" or key not in state:
            continue
        cv = state[key]
        if (cv.ndim == 3 and tv.ndim == 3 and cv.shape[1] != tv.shape[1]
                and cv.shape[0] == tv.shape[0]
                and cv.shape[2] == tv.shape[2]):
            idx = np.floor(np.arange(tv.shape[1])
                           * (cv.shape[1] / tv.shape[1])).astype(np.int64)
            state[key] = cv[:, torch.from_numpy(idx)]
            logger.info("Nearest-resized %s time axis %d -> %d at load",
                        key, cv.shape[1], tv.shape[1])


def merge_shape_filtered(model: torch.nn.Module,
                         state: Dict[str, torch.Tensor],
                         keys: Optional[Iterable[str]] = None
                         ) -> Tuple[List[str], List[tuple], List[str]]:
    """Load the tensors of ``state`` whose name and shape match a tensor of
    ``model`` (of ``keys`` only, where given), after resizing
    ``time_embed``; every other tensor of the model keeps its value.
    torch's ``load_state_dict`` raises on a shape mismatch even with
    ``strict=False``, so the mismatches are filtered out first.  Returns
    the model keys not in ``state``, the ``(key, file shape, model shape)``
    of the mismatches, and the keys of ``state`` left unused."""
    own = model.state_dict()
    if keys is not None:
        own = {k: own[k] for k in keys}
    resize_time_embed(state, own)
    keep, missing, skipped = {}, [], []
    for key, tv in own.items():
        cv = state.get(key)
        if cv is None:
            missing.append(key)
        elif tuple(cv.shape) != tuple(tv.shape):
            skipped.append((key, tuple(cv.shape), tuple(tv.shape)))
        else:
            keep[key] = cv
    model.load_state_dict(keep, strict=False)
    return missing, skipped, sorted(set(state) - set(own))


def load_reference_params(model: torch.nn.Module, path: str,
                          clear_patterns: Iterable[str] = (), blob=None
                          ) -> Optional[int]:
    """Load a full model's ``.pyth`` (the reference's or the port's) into
    ``model`` by JAX ``load_reference_params``: keys containing a pattern
    of ``clear_patterns`` (``TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN``) are
    dropped first; a tensor the file lacks (``head_cls``, or ``head_v`` and
    ``head_n``, of a finetune loaded from a pretraining file) or holds at
    another shape keeps its
    init; each case is logged.  ``blob`` is the file's content where the
    caller has read it already.  Returns the file's ``epoch`` (None if it
    has none)."""
    state, epoch = read_reference(path, blob)
    for pattern in clear_patterns or ():
        dropped = [k for k in state if pattern in k]
        for k in dropped:
            del state[k]
        if dropped:
            logger.info("Cleared %d keys matching %r", len(dropped), pattern)
    missing, skipped, unused = merge_shape_filtered(model,
                                                    strip_prefixes(state))
    if missing:
        logger.info("Keys kept at init (not in checkpoint): %s",
                    sorted(missing)[:20])
    if skipped:
        logger.info("Keys skipped for shape mismatch: %s", skipped[:20])
    if unused:
        logger.info("Checkpoint keys unused: %s", unused[:20])
    return epoch


def inflate_mvit_in1k(state: Mapping[str, torch.Tensor], time_kernel: int
                      ) -> Dict[str, torch.Tensor]:
    """Image MViT-v2 -> video: the stem and the pool kernels [D, C, kh, kw]
    repeated over a new time axis of ``time_kernel`` (JAX
    ``converter.py:261-285 inflate_mvit_in1k``; reference
    ``lib/models/helpers.py:126-145``)."""
    return {k: (v.unsqueeze(2).repeat(1, 1, time_kernel, 1, 1)
                if "pool_" in k or "patch_embed.proj.weight" in k else v)
            for k, v in state.items()}


def imagenet_vit_to_timesformer(state: Mapping[str, torch.Tensor]
                                ) -> Dict[str, torch.Tensor]:
    """A timm ImageNet ViT's encoder as TimeSformer tensors (JAX
    ``converter.py:288-328 convert_imagenet_vit``): each block's
    ``temporal_attn`` copied from its ``attn``, ``temporal_norm1`` from
    ``norm1``, ``temporal_fc`` zero; ``head.*`` dropped; ``time_embed``
    absent, so it keeps its init."""
    out = {k: v for k, v in state.items()
           if not k.startswith("head") and k.split(".")[0] in
           TIMESFORMER_ENCODER}
    depth = 1 + max((int(k.split(".")[1]) for k in out
                     if k.startswith("blocks.")), default=-1)
    for i in range(depth):
        pre = f"blocks.{i}."
        if pre + "temporal_attn.qkv.weight" not in out:
            for part in ("qkv.weight", "qkv.bias", "proj.weight",
                         "proj.bias"):
                if pre + "attn." + part in state:
                    out[pre + "temporal_attn." + part] = state[
                        pre + "attn." + part]
        if pre + "temporal_norm1.weight" not in out:
            for part in ("weight", "bias"):
                out[pre + "temporal_norm1." + part] = state[
                    pre + "norm1." + part]
        if pre + "temporal_fc.weight" not in out:
            d = state[pre + "mlp.fc2.bias"].shape[0]
            out[pre + "temporal_fc.weight"] = torch.zeros(d, d)
            out[pre + "temporal_fc.bias"] = torch.zeros(d)
    return out


def encoder_keys(model: torch.nn.Module) -> List[str]:
    """The video encoder's tensors: ``video_encoder.*`` of an MViT model,
    the TimeSformer's root tensors (``patch_embed``, ``blocks``, ``norm``,
    ``cls_token``, ``pos_embed``, ``time_embed``) otherwise."""
    keys = list(model.state_dict())
    mvit = [k for k in keys if k.startswith("video_encoder.")]
    return mvit or [k for k in keys
                    if k.split(".")[0] in TIMESFORMER_ENCODER]


def load_pretrained_encoder(model: torch.nn.Module, cfg) -> bool:
    """Initialise the video encoder from ``TIMESFORMER.PRETRAINED_MODEL``
    where ``MODEL.PRETRAINED`` is set (JAX ``utils/checkpoint.py:307-375``;
    the reference's build-time ``load_pretrained``), shape-filtered: a
    released ProcedureVRL file (``video_encoder.*``), an MViT checkpoint
    (an image one, with a 4-D stem, inflated over ``MVIT.PATCH_KERNEL[0]``
    frames), a TimeSformer video checkpoint, or an ImageNet ViT (see
    :func:`imagenet_vit_to_timesformer`).  A missing file warns and keeps
    the random init.  Returns whether a file was loaded."""
    path = cfg.TIMESFORMER.PRETRAINED_MODEL
    if not cfg.MODEL.PRETRAINED or not path:
        return False
    if not os.path.exists(path):
        logger.warning("Pretrained model %s not found; keeping random init.",
                       path)
        return False
    state = strip_prefixes(read_reference(path)[0])
    if any(k.startswith("video_encoder.") for k in state):
        enc = {k[len("video_encoder."):]: v for k, v in state.items()
               if k.startswith("video_encoder.")}
    elif cfg.MODEL.MODEL_NAME == "MViT":
        stem = state.get("patch_embed.proj.weight")
        if stem is not None and stem.ndim == 4:
            # JAX inflates with no ``rel_pos_lens`` (checkpoint.py:340-344),
            # so a rel-pos table of another length than the model's is
            # dropped by the shape filter below and keeps its init
            state = inflate_mvit_in1k(state, cfg.MVIT.PATCH_KERNEL[0])
        enc = state
    elif "blocks.0.temporal_attn.qkv.weight" in state:
        enc = state
    else:
        enc = imagenet_vit_to_timesformer(state)
    keys = encoder_keys(model)
    prefix = "video_encoder." if keys[0].startswith("video_encoder.") else ""
    missing, skipped, _ = merge_shape_filtered(
        model, {prefix + k: v for k, v in enc.items()}, keys)
    kept = sorted(missing + [k for k, *_ in skipped])
    if kept:
        logger.info("Pretrained-encoder keys kept at init: %s", kept[:20])
    logger.info("Initialized encoder from %s (%d tensors)", path, len(enc))
    return True
