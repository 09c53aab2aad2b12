"""Frozen CLIP ViT-B/16 text tower (counterpart of
``procedurevrl_tpu/models/clip_text.py``; reference ``lib/models/vit.py:256-261``
and ``:425-433``): ``clip_model.encode_text``.

Token embedding + positional embedding, 12 pre-LN causal blocks with
QuickGELU, final LayerNorm, readout at the EOT token (the largest id of each
sequence), projection into the 512-d joint space.  Parameter names are
OpenAI CLIP's (``token_embedding.weight``, ``positional_embedding``,
``transformer.resblocks.{i}.attn.in_proj_weight``, ``ln_final.*``,
``text_projection``).  The tower is frozen: its parameters do not require
grad, and the model calls it under ``torch.no_grad()``.  Its causal
attention is plain PyTorch, as XLA computes it in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from procedurevrl_torch.models.layers import LayerNormFp32, ResidualAttentionBlock


class Transformer(nn.Module):
    """``transformer.resblocks.{i}`` of the CLIP checkpoint."""

    def __init__(self, width: int, heads: int, layers: int):
        super().__init__()
        self.resblocks = nn.ModuleList([
            ResidualAttentionBlock(width, heads, causal=True)
            for _ in range(layers)])


class CLIPTextEncoder(nn.Module):
    """``forward(text_ids [B, context_length])`` -> ``[B, embed_dim]`` in
    the compute dtype."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 width: int = 512, heads: int = 8, layers: int = 12,
                 embed_dim: int = 512,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            torch.empty(context_length, width))
        self.transformer = Transformer(width, heads, layers)
        self.ln_final = LayerNormFp32(width)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))
        self.requires_grad_(False)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """The JAX package's random init: normal(0.02) token embedding,
        normal(0.01) positions, normal(width^-0.5) projection, trunc-normal
        scales of its blocks replaced by normal(0.02)."""
        width = self.positional_embedding.shape[1]
        with torch.no_grad():
            self.token_embedding.weight.normal_(0.0, 0.02, generator=generator)
            self.positional_embedding.normal_(0.0, 0.01, generator=generator)
            self.text_projection.normal_(0.0, width ** -0.5,
                                         generator=generator)
        for blk in self.transformer.resblocks:
            blk.reset_parameters(generator, 0.02, 0.02, 0.02)
        nn.init.ones_(self.ln_final.weight)
        nn.init.zeros_(self.ln_final.bias)

    def forward(self, text_ids: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = F.embedding(text_ids, self.token_embedding.weight).to(dt)
        x = x + self.positional_embedding.to(dt)
        for blk in self.transformer.resblocks:
            x = blk(x)
        x = self.ln_final(x)
        eot = text_ids.argmax(dim=-1)
        feats = x[torch.arange(x.shape[0], device=x.device), eot]
        # products of compute-dtype values, accumulated in fp32
        return (feats.float() @ self.text_projection.to(dt).float()).to(dt)
