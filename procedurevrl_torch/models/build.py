"""Model builder (TimeSformer-B, MViT-v2 and the BatchNorm video family)
and step-bank loading
(counterpart of ``procedurevrl_tpu/models/build.py``; reference
``lib/models/build.py``).

``build_model(cfg, device)`` returns ``(model, label_emb)``: the model with
float32 parameters drawn from ``cfg.RNG_SEED`` (on the CPU, then moved),
in eval mode on ``device``, and the L2-normalised step bank as a float32
tensor on the same device, or None where the model matches no bank (a
finetuning config names ``DEV.TEST_LANG_EMB`` only for its width; JAX
``build.py:140-141``).  A pretraining config (``TRAIN.LABEL_EMB`` set)
builds the order transformer and, with ``MODEL.TEXT_MODEL clip_vit_b_16``,
the CLIP text tower; ``MODEL.NUM_SEG > 0`` builds the order transformer
for forecasting; ``DEV.MATCH_LANG_EMB False`` (and no ``TRAIN.LABEL_EMB``)
a ``MODEL.NUM_CLASSES`` finetuning head, or under ``TRAIN.DATASET
Epickitchens`` the verb and noun heads (JAX ``build.py:_common_kwargs``).
``TPU.REMAT`` checkpoints the encoder's blocks, TimeSformer's under the
policy of ``TPU.REMAT_SAVE_ATTN`` / ``_QKV`` / ``_TEMPORAL``, MViT's under
JAX's fixed one (``ops/remat.py``).
Under ``DEV.LOAD_DUMMY_DATA`` a missing bank file is replaced by a seeded
``NUM_CLASSES x 512`` random bank, as the JAX package's ``build_model`` does.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np
import torch

from procedurevrl_torch.utils.device import resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def load_embedding_bank(path: str) -> np.ndarray:
    """A step-candidate embedding bank, e.g. ``data/clip_step_emb_coin.pth``
    (778 x 512 CLIP text embeddings), as float32 numpy; ``.npy``/``.npz``
    files load too."""
    if path.endswith(".npy"):
        arr = np.load(path)
    elif path.endswith(".npz"):
        arr = np.load(path)["emb"]
    else:
        t = torch.load(path, map_location="cpu", weights_only=False)
        arr = t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(t)
    return np.asarray(arr, dtype=np.float32)


def normalize_bank(arr: np.ndarray) -> np.ndarray:
    """L2-normalise rows (the reference normalises the bank once on device
    transfer, ``lib/models/vit.py:435-440``)."""
    return arr / np.linalg.norm(arr, axis=1, keepdims=True)


def compute_dtype(cfg) -> torch.dtype:
    if cfg.TPU.COMPUTE_DTYPE not in _DTYPES:
        raise ValueError(f"TPU.COMPUTE_DTYPE {cfg.TPU.COMPUTE_DTYPE!r}: "
                         f"expected one of {sorted(_DTYPES)}")
    return _DTYPES[cfg.TPU.COMPUTE_DTYPE]


def _match_lang(cfg) -> bool:
    return bool(cfg.DEV.MATCH_LANG_EMB or cfg.TRAIN.LABEL_EMB != "")


def _head_kwargs(cfg) -> dict:
    """The head, order-transformer and text-tower arguments both encoders
    share (JAX ``build.py:_common_kwargs``)."""
    return dict(
        num_classes=cfg.MODEL.NUM_CLASSES,
        temp=cfg.DEV.TEMP,
        match_lang_emb=_match_lang(cfg),
        order_pretrain=cfg.DEV.ORDER_PRETRAIN_ENABLED,
        order_max_len=cfg.DEV.ORDER_PRETRAIN_MAX_LEN,
        order_tfm_layers=cfg.DEV.ORDER_TFM_LAYERS,
        order_recog_batch=cfg.DEV.ORDER_RECOG_BATCH,
        num_seg=cfg.MODEL.NUM_SEG,
        with_text_model=cfg.MODEL.TEXT_MODEL == "clip_vit_b_16",
        text_layers=cfg.DEV.TEXT_LAYERS,
        compute_dtype=compute_dtype(cfg),
        epic_heads=(cfg.TRAIN.DATASET == "Epickitchens"
                    and not _match_lang(cfg)))


def _build_timesformer(cfg) -> torch.nn.Module:
    """TimeSformer-B (reference ``lib/models/vit.py:473-506``) on the
    attention route that ``TPU.USE_PALLAS_ATTENTION`` and the environment's
    knobs select, read here once."""
    from procedurevrl_torch.models.procedurevrl import ProcedureVRL
    from procedurevrl_torch.ops.attention_route import AttentionRoute

    return ProcedureVRL(
        img_size=cfg.DATA.TRAIN_CROP_SIZE, patch_size=16, embed_dim=768,
        depth=cfg.TIMESFORMER.DEPTH, num_heads=12,
        num_frames=cfg.DATA.NUM_FRAMES,
        attention_type=cfg.TIMESFORMER.ATTENTION_TYPE,
        drop_path_rate=cfg.MODEL.DROP_PATH, remat=cfg.TPU.REMAT,
        route=AttentionRoute.from_env(cfg.TPU.USE_PALLAS_ATTENTION),
        remat_save_attn=cfg.TPU.REMAT_SAVE_ATTN,
        remat_save_qkv=cfg.TPU.REMAT_SAVE_QKV,
        remat_save_temporal=cfg.TPU.REMAT_SAVE_TEMPORAL,
        **_head_kwargs(cfg))


def _build_mvit(cfg) -> torch.nn.Module:
    """MViT-v2 (reference ``lib/models/mvit.py:231-264``)."""
    from procedurevrl_torch.models.mvit import MViTConfig
    from procedurevrl_torch.models.procedurevrl import ProcedureVRLMViT

    return ProcedureVRLMViT(MViTConfig.from_cfg(cfg), remat=cfg.TPU.REMAT,
                            **_head_kwargs(cfg))


def _build_resnet_family(name: str):
    """SlowFast, ResNet (C2D / I3D / Slow) or X3D (JAX
    ``build.py:112-130``; reference ``video_model_builder.py:152,424,623``)
    from the ``RESNET``, ``SLOWFAST``, ``X3D``, ``NONLOCAL`` and ``BN``
    groups."""

    def build(cfg) -> torch.nn.Module:
        from procedurevrl_torch.models import resnet_video as rv

        return rv.MODELS[name](rv.ResNetFamilyConfig.from_cfg(cfg),
                               compute_dtype(cfg))

    return build


# MODEL.MODEL_NAME -> builder
MODELS = {"vit_base_patch16_224_develop": _build_timesformer,
          "MViT": _build_mvit,
          "SlowFast": _build_resnet_family("SlowFast"),
          "ResNet": _build_resnet_family("ResNet"),
          "X3D": _build_resnet_family("X3D")}


def build_model(cfg, device: Union[str, torch.device, None] = None
                ) -> Tuple[torch.nn.Module, Optional[torch.Tensor]]:
    """The model of ``cfg.MODEL.MODEL_NAME``: ProcedureVRL on TimeSformer-B
    or MViT-v2, or a model of the BatchNorm video family (SlowFast, ResNet,
    X3D).  ``device`` defaults to the card."""
    device = resolve_device(device)
    if cfg.MODEL.MODEL_NAME not in MODELS:
        raise NotImplementedError(
            f"model {cfg.MODEL.MODEL_NAME} is not ported yet")
    model = MODELS[cfg.MODEL.MODEL_NAME](cfg)
    model.reset_parameters(torch.Generator().manual_seed(cfg.RNG_SEED))
    model = model.to(device).eval()
    return model, step_bank(cfg, model.match_lang_emb, device)


def step_bank(cfg, match_lang_emb: bool,
              device: Union[str, torch.device, None] = None
              ) -> Optional[torch.Tensor]:
    """The L2-normalised step bank of ``TRAIN.LABEL_EMB`` (or
    ``DEV.TEST_LANG_EMB``) on ``device`` for a model that matches one, else
    None."""
    emb_path = cfg.TRAIN.LABEL_EMB or cfg.DEV.TEST_LANG_EMB
    if not (match_lang_emb and emb_path):
        return None
    if os.path.exists(emb_path):
        bank = normalize_bank(load_embedding_bank(emb_path))
    elif cfg.DEV.LOAD_DUMMY_DATA:
        rng = np.random.RandomState(0)
        bank = normalize_bank(
            rng.randn(cfg.MODEL.NUM_CLASSES, 512).astype(np.float32))
    else:
        raise FileNotFoundError(f"Step bank not found: {emb_path}")
    return torch.from_numpy(bank).to(resolve_device(device))
