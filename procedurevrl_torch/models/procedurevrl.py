"""ProcedureVRL: the video encoder with its 512-d projection head
(counterpart of ``procedurevrl_tpu/models/procedurevrl.py``; reference
``lib/models/vit.py:183-358``).

Slice 1 ports the zero-shot step-classification branch: encode the clip,
project to the step-bank width, L2-normalise, match against the
L2-normalised step bank divided by the temperature, softmax.  The encoder
is the base class, so the state dict carries the reference ``.pyth`` keys
(``patch_embed.*``, ``blocks.*``, ``norm.*``, ``cls_token``, ``pos_embed``,
``time_embed``, ``head.*``).  The order-pretraining, forecasting and
finetuning branches come with slice 2 (training).
"""

from __future__ import annotations

from typing import Optional

import torch

from procedurevrl_torch.models.layers import Linear, init_linear
from procedurevrl_torch.models.timesformer import TimeSformer

_SLICE2 = ("not ported yet: order pretraining, forecasting and finetuning "
           "come with slice 2 (training)")


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    # torch x.norm(dim=1, keepdim=True) of the reference: no epsilon
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class ProcedureVRL(TimeSformer):
    """TimeSformer encoder + ``head`` projection, zero-shot classification.

    ``forward(x, label_emb)``: ``x`` [B, T, H, W, 3] normalised frames (cast
    to the compute dtype here), ``label_emb`` [K, label_dim] L2-normalised
    step bank; returns post-softmax float32 predictions [B, K]."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 num_frames: int = 8,
                 attention_type: str = "divided_space_time",
                 drop_path_rate: float = 0.1, label_dim: int = 512,
                 temp: float = 0.02, match_lang_emb: bool = True,
                 order_pretrain: bool = False, num_seg: int = 0,
                 compute_dtype: torch.dtype = torch.float32):
        if not match_lang_emb or order_pretrain or num_seg > 0:
            raise NotImplementedError(_SLICE2)
        super().__init__(img_size=img_size, patch_size=patch_size,
                         embed_dim=embed_dim, depth=depth, num_heads=num_heads,
                         num_frames=num_frames, attention_type=attention_type,
                         drop_path_rate=drop_path_rate)
        self.temp = temp
        self.compute_dtype = compute_dtype
        self.head = Linear(embed_dim, label_dim)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        super().reset_parameters(generator)
        init_linear(self.head, generator)

    def forward(self, x: torch.Tensor, label_emb: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        if train:
            raise NotImplementedError(_SLICE2)
        if label_emb is None:
            raise ValueError("match_lang_emb requires a step bank")
        feat = super().forward(x.to(self.compute_dtype))  # [B, D]
        emb = _l2norm(self.head(feat))
        # products of compute-dtype values, accumulated in fp32
        logits = emb.float() @ label_emb.to(emb.dtype).float().t() / self.temp
        return torch.softmax(logits, dim=-1)
