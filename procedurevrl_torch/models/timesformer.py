"""TimeSformer video encoder (counterpart of
``procedurevrl_tpu/models/timesformer.py``; reference
``lib/models/vit.py:94-423``).

The token layout is the JAX package's: time-major, with the frame tokens
resident as ``[B*T, N, D]`` (the spatial layout; the temporal view
``[B, T, N, D]`` is a free reshape) and the CLS token as a separate
``[B, 1, D]`` stream.  The attention groups, and so every value, are those
of the reference's patch-major layout.  Input is channels-last video
``[B, T, H, W, C]``; compute runs in the input's dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from procedurevrl_torch.models.layers import (
    Attention, DropPath, LayerNormFp32, Linear, Mlp, init_linear,
)
from procedurevrl_torch.ops.common import (
    interpolate_nearest_1d, interpolate_nearest_2d, trunc_normal_init,
)


class PatchEmbed(nn.Module):
    """16x16/16 patch embedding as patchify + one product (reference
    ``lib/models/vit.py:160-180``); the weight keeps the reference Conv2d
    shape ``proj.weight [D, C, p, p]``."""

    def __init__(self, patch_size: int = 16, in_chans: int = 3,
                 embed_dim: int = 768):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B', H, W, C] -> [B', N, D], row-major patches."""
        b, h, w, c = x.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        patches = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(b, gh * gw, p * p * c)
        # [D, C, p, p] -> [D, p*p*C], matching the channel-minor patch vector
        kernel = self.proj.weight.permute(0, 2, 3, 1).reshape(-1, p * p * c)
        return nn.functional.linear(patches, kernel.to(x.dtype),
                                    self.proj.bias.to(x.dtype))


class DividedSTBlock(nn.Module):
    """Divided space-time block (reference ``lib/models/vit.py:94-158``) on
    the split ``(cls [B, 1, D], xt [B*T, N, D])`` streams."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.0,
                 norm_eps: float = 1e-6):
        super().__init__()
        self.norm1 = LayerNormFp32(dim, eps=norm_eps)
        self.attn = Attention(dim, num_heads, qkv_bias)
        self.norm2 = LayerNormFp32(dim, eps=norm_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)
        self.drop_path = DropPath(drop_path_rate)
        self.temporal_norm1 = LayerNormFp32(dim, eps=norm_eps)
        self.temporal_attn = Attention(dim, num_heads, qkv_bias)
        self.temporal_fc = Linear(dim, dim)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)
        self.temporal_attn.reset_parameters(generator)
        init_linear(self.temporal_fc, generator)

    def forward(self, x: Tuple[torch.Tensor, torch.Tensor], T: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        dp = self.drop_path
        cls, xt = x
        B = cls.shape[0]
        BT, N, D = xt.shape

        # temporal attention over T per patch location
        xt4 = xt.view(B, T, N, D)
        res = dp(self.temporal_attn(self.temporal_norm1(xt4), time_axis=True))
        xt = xt + self.temporal_fc(res).view(BT, N, D)

        # spatial attention over [cls] + N per frame, the CLS replicated
        # per frame and its outputs averaged over T
        cls_rep = self.norm1(cls)[:, None].expand(B, T, 1, D).reshape(BT, 1, D)
        res_frames, res_cls = dp(self.attn(self.norm1(xt), cls_stream=cls_rep))
        cls = cls + res_cls.view(B, T, D).mean(dim=1, keepdim=True)
        xt = xt + res_frames

        mlp_cls, mlp_xt = dp((self.mlp(self.norm2(cls)),
                              self.mlp(self.norm2(xt))))
        return cls + mlp_cls, xt + mlp_xt


class TimeSformer(nn.Module):
    """TimeSformer-B encoder (reference ``lib/models/vit.py:183-423``):
    ``[B, T, H, W, 3]`` video -> CLS feature ``[B, D]``."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 num_frames: int = 8,
                 attention_type: str = "divided_space_time",
                 drop_path_rate: float = 0.1, norm_eps: float = 1e-6):
        super().__init__()
        if attention_type != "divided_space_time":
            raise NotImplementedError(
                f"{attention_type} attention is not ported yet")
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        num_patches = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(patch_size, 3, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, num_patches + 1, embed_dim))
        self.time_embed = nn.Parameter(torch.zeros(1, num_frames, embed_dim))
        self.blocks = nn.ModuleList([
            DividedSTBlock(embed_dim, num_heads, mlp_ratio, qkv_bias,
                           drop_path_rate * i / max(depth - 1, 1), norm_eps)
            for i in range(depth)
        ])
        self.norm = LayerNormFp32(embed_dim, eps=norm_eps)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """Random init of the JAX package: trunc-normal(0.02) for the
        embeddings, the patch kernel and every linear weight; zero biases;
        unit LayerNorm scales."""
        trunc_normal_init(self.patch_embed.proj.weight, 0.02, generator)
        nn.init.zeros_(self.patch_embed.proj.bias)
        for p in (self.cls_token, self.pos_embed, self.time_embed):
            trunc_normal_init(p, 0.02, generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def _pos_embed(self, n_tok: int, gw: int) -> torch.Tensor:
        """Position embedding, nearest-resized when the patch grid differs
        from the one it was trained at (reference ``vit.py:375-388``)."""
        pe = self.pos_embed
        if n_tok + 1 == pe.shape[1]:
            return pe
        d = pe.shape[-1]
        side = int(round((pe.shape[1] - 1) ** 0.5))
        other = pe[:, 1:].reshape(1, side, side, d)
        other = interpolate_nearest_2d(other, (n_tok // gw, gw), dims=(1, 2))
        return torch.cat([pe[:, :1], other.reshape(1, n_tok, d)], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, H, W, C = x.shape
        D = self.embed_dim
        gw = W // self.patch_size
        dt = x.dtype
        tokens = self.patch_embed(x.reshape(B * T, H, W, C))  # [B*T, N, D]
        n_tok = tokens.shape[1]
        cls = self.cls_token.to(dt).expand(B * T, 1, D)
        tokens = torch.cat([cls, tokens], dim=1) + self._pos_embed(n_tok, gw).to(dt)
        te = interpolate_nearest_1d(self.time_embed, T, dim=1)
        # every CLS row is cls_token + its position embedding: one per sample
        cls = tokens[:B, :1]
        spatial = tokens[:, 1:].reshape(B, T, n_tok, D) + te.to(dt)[:, :, None]
        state: Tuple[torch.Tensor, torch.Tensor] = (
            cls, spatial.reshape(B * T, n_tok, D))
        for blk in self.blocks:
            state = blk(state, T)
        return self.norm(state[0])[:, 0]
