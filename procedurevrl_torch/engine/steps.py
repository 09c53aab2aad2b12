"""Eval step (counterpart of ``procedurevrl_tpu/engine/steps.py``).

The train step comes with slice 2.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


def normalize_frames(frames: torch.Tensor, cfg) -> torch.Tensor:
    """uint8 frames -> ``(x / 255 - mean) / std`` in float32, on the frames'
    device; float frames pass through (already normalised)."""
    if frames.dtype != torch.uint8:
        return frames
    mean = torch.tensor(cfg.DATA.MEAN, dtype=torch.float32, device=frames.device)
    std = torch.tensor(cfg.DATA.STD, dtype=torch.float32, device=frames.device)
    return (frames.float() / 255.0 - mean) / std


def make_eval_step(model: torch.nn.Module, cfg,
                   label_emb: Optional[torch.Tensor]
                   ) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """Eval forward: ``eval_step({"frames": [B, T, H, W, 3]})`` returns the
    post-softmax predictions [B, K] (reference ``lib/models/vit.py:355-357``)
    on the model's device."""

    def eval_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.inference_mode():
            return model(normalize_frames(batch["frames"], cfg),
                         label_emb=label_emb, train=False)

    return eval_step
