"""Model builder and step-bank loading (counterpart of
``procedurevrl_tpu/models/build.py``; reference ``lib/models/build.py``).

``build_model(cfg, device)`` returns ``(model, label_emb)``: the model with
float32 parameters drawn from ``cfg.RNG_SEED`` (on the CPU, then moved),
in eval mode on ``device``, and the L2-normalised step bank as a float32
tensor on the same device (or None when the config matches no bank).
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


def build_model(cfg, device: Union[str, torch.device, None] = None
                ) -> Tuple[torch.nn.Module, Optional[torch.Tensor]]:
    """TimeSformer-B ProcedureVRL for ``cfg`` (reference
    ``lib/models/vit.py:473-506``).  ``device`` defaults to the card."""
    from procedurevrl_torch.models.procedurevrl import ProcedureVRL

    device = resolve_device(device)
    if cfg.MODEL.MODEL_NAME != "vit_base_patch16_224_develop":
        raise NotImplementedError(
            f"model {cfg.MODEL.MODEL_NAME} is not ported yet")
    match_lang = bool(cfg.DEV.MATCH_LANG_EMB or cfg.TRAIN.LABEL_EMB != "")
    model = ProcedureVRL(
        img_size=cfg.DATA.TRAIN_CROP_SIZE, patch_size=16, embed_dim=768,
        depth=cfg.TIMESFORMER.DEPTH, num_heads=12,
        num_frames=cfg.DATA.NUM_FRAMES,
        attention_type=cfg.TIMESFORMER.ATTENTION_TYPE,
        drop_path_rate=cfg.MODEL.DROP_PATH, temp=cfg.DEV.TEMP,
        match_lang_emb=match_lang, order_pretrain=cfg.DEV.ORDER_PRETRAIN_ENABLED,
        num_seg=cfg.MODEL.NUM_SEG, compute_dtype=compute_dtype(cfg),
    )
    model.reset_parameters(torch.Generator().manual_seed(cfg.RNG_SEED))
    model = model.to(device).eval()

    label_emb = None
    emb_path = cfg.TRAIN.LABEL_EMB or cfg.DEV.TEST_LANG_EMB
    if emb_path:
        if os.path.exists(emb_path):
            bank = normalize_bank(load_embedding_bank(emb_path))
        elif cfg.DEV.LOAD_DUMMY_DATA:
            rng = np.random.RandomState(0)
            bank = normalize_bank(
                rng.randn(cfg.MODEL.NUM_CLASSES, 512).astype(np.float32))
        else:
            raise FileNotFoundError(f"Step bank not found: {emb_path}")
        label_emb = torch.from_numpy(bank).to(device)
    return model, label_emb
