"""TimeSformer video encoder (counterpart of
``procedurevrl_tpu/models/timesformer.py``; reference
``lib/models/vit.py:94-423``).

The token layout is the JAX package's: time-major, with the frame tokens
resident as ``[B*T, N, D]`` (the spatial layout; the temporal view
``[B, T, N, D]`` is a free reshape) and the CLS token as a separate
``[B, 1, D]`` stream.  The attention groups, and so every value, are those
of the reference's patch-major layout.  Input is channels-last video
``[B, T, H, W, C]``; compute runs in the input's dtype.

Two attention types, as the JAX package runs them: ``divided_space_time``
(the default; temporal pass through K2, spatial pass through K1, or K3 on
``SPATIAL_FUSED_QKV=0``) and ``space_only`` (each frame's ``[1 + N, D]``
tokens, its own CLS first, attend within the frame through K4; no time
embedding; the CLS outputs are averaged over the frames before the final
norm).  ``joint_space_time`` is refused: the JAX package fails on it.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from procedurevrl_torch.models.layers import (
    Attention, DropPath, LayerNormFp32, Linear, Mlp, gelu_stored_from_env,
    init_linear,
)
from procedurevrl_torch.ops import remat
from procedurevrl_torch.ops.attention_route import DEFAULT_ROUTE, AttentionRoute
from procedurevrl_torch.ops.common import (
    interpolate_nearest_1d, interpolate_nearest_2d, trunc_normal_init,
)

# stochastic-depth keep masks of a block: temporal [B], spatial [B*T], MLP [B]
Keep = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


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
                 norm_eps: float = 1e-6,
                 route: AttentionRoute = DEFAULT_ROUTE,
                 gelu_stored: bool = False):
        super().__init__()
        self.norm1 = LayerNormFp32(dim, eps=norm_eps)
        self.attn = Attention(dim, num_heads, qkv_bias, route=route)
        self.norm2 = LayerNormFp32(dim, eps=norm_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, gelu_stored)
        self.drop_path = DropPath(drop_path_rate)
        self.temporal_norm1 = LayerNormFp32(dim, eps=norm_eps)
        self.temporal_attn = Attention(dim, num_heads, qkv_bias, route=route)
        self.temporal_fc = Linear(dim, dim)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)
        self.temporal_attn.reset_parameters(generator)
        init_linear(self.temporal_fc, generator)

    def draw_masks(self, B: int, T: int, device: torch.device,
                   generator: Optional[torch.Generator]) -> Optional[Keep]:
        """Stochastic-depth keep masks of one forward (None when the block
        drops nothing): per sample for the temporal residual and the MLP,
        per (sample, frame) for the spatial residual, whose CLS and frame
        streams share it (JAX ``timesformer.py:153-161``)."""
        dp = self.drop_path
        masks = (dp.draw(B, device, generator), dp.draw(B * T, device, generator),
                 dp.draw(B, device, generator))
        return None if masks[0] is None else masks

    def forward(self, x: Tuple[torch.Tensor, torch.Tensor], T: int,
                keep: Optional[Keep] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        dp = self.drop_path
        keep_t, keep_s, keep_m = keep if keep is not None else (None,) * 3
        cls, xt = x
        B = cls.shape[0]
        BT, N, D = xt.shape

        # temporal attention over T per patch location
        xt4 = xt.view(B, T, N, D)
        res = dp(self.temporal_attn(self.temporal_norm1(xt4), time_axis=True),
                 keep_t)
        xt = xt + self.temporal_fc(res).view(BT, N, D)

        # spatial attention over [cls] + N per frame, the CLS replicated
        # per frame and its outputs averaged over T
        cls_rep = self.norm1(cls)[:, None].expand(B, T, 1, D).reshape(BT, 1, D)
        res_frames, res_cls = dp(self.attn(self.norm1(xt), cls_stream=cls_rep),
                                 keep_s)
        cls = cls + res_cls.view(B, T, D).mean(dim=1, keepdim=True)
        xt = xt + res_frames

        mlp_cls, mlp_xt = dp((self.mlp(self.norm2(cls)),
                              self.mlp(self.norm2(xt))), keep_m)
        return cls + mlp_cls, xt + mlp_xt


class SpaceOnlyBlock(nn.Module):
    """The block of ``space_only`` attention (JAX ``DividedSTBlock`` with
    ``attention_type="space_only"``, ``timesformer.py:110-113``): pre-norm
    self-attention and MLP on ``[B*T, 1 + N, D]``, each frame on its own."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.0,
                 norm_eps: float = 1e-6,
                 route: AttentionRoute = DEFAULT_ROUTE,
                 gelu_stored: bool = False):
        super().__init__()
        self.norm1 = LayerNormFp32(dim, eps=norm_eps)
        self.attn = Attention(dim, num_heads, qkv_bias, route=route)
        self.norm2 = LayerNormFp32(dim, eps=norm_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, gelu_stored)
        self.drop_path = DropPath(drop_path_rate)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def draw_masks(self, B: int, T: int, device: torch.device,
                   generator: Optional[torch.Generator]
                   ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Stochastic-depth keep masks of the attention and MLP residuals,
        each per (sample, frame), the lead of the ``[B*T, ...]`` stream, as
        JAX's ``DropPath`` draws them on it (None when nothing drops)."""
        dp = self.drop_path
        masks = (dp.draw(B * T, device, generator),
                 dp.draw(B * T, device, generator))
        return None if masks[0] is None else masks

    def forward(self, x: torch.Tensor, T: int,
                keep: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        keep_a, keep_m = keep if keep is not None else (None, None)
        x = x + self.drop_path(self.attn(self.norm1(x)), keep_a)
        return x + self.drop_path(self.mlp(self.norm2(x)), keep_m)


def remat_names(save_attn: bool = True, save_qkv: bool = False,
                save_temporal: bool = False) -> Tuple[str, ...]:
    """The names a TimeSformer block keeps across its recomputation (JAX
    ``models/timesformer.py:267-291``): ``TPU.REMAT_SAVE_ATTN`` the
    attention kernels' outputs and the stored GELU derivative,
    ``REMAT_SAVE_QKV`` the qkv projections, ``REMAT_SAVE_TEMPORAL`` the
    plain temporal pass's output (``ops/remat.py``); none of them, the
    whole block recomputed."""
    names: Tuple[str, ...] = ()
    if save_attn:
        names += ("flash_attn_out", "gelu_grad")
    if save_qkv:
        names += ("qkv_out",)
    if save_temporal:
        names += ("temporal_out",)
    return names


class TimeSformer(nn.Module):
    """TimeSformer-B encoder (reference ``lib/models/vit.py:183-423``):
    ``[B, T, H, W, 3]`` video -> CLS feature ``[B, D]``, with
    ``divided_space_time`` or ``space_only`` attention (module docstring).

    In train mode each block draws its stochastic-depth masks from the
    ``generator`` given to ``forward`` (on the input's device).  With
    ``remat`` (``TPU.REMAT``) each block runs under
    ``torch.utils.checkpoint`` when gradients are recorded, with JAX's
    selective policy: the values :func:`remat_names` names for the three
    ``remat_save_*`` switches are kept from the forward and everything else
    in the block is recomputed for the backward (by default the attention
    kernels run once a step, their outputs and K1's probabilities kept).
    The masks are drawn before the block, so the recomputation reapplies
    them.  ``route`` picks the attention paths and kernels
    (``ops/attention_route.py``) and ``gelu_stored`` the MLPs' GELU
    (``GELU_STORED``); by default the environment's knobs, read here
    once."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 num_frames: int = 8,
                 attention_type: str = "divided_space_time",
                 drop_path_rate: float = 0.1, norm_eps: float = 1e-6,
                 remat: bool = False, route: Optional[AttentionRoute] = None,
                 remat_save_attn: bool = True, remat_save_qkv: bool = False,
                 remat_save_temporal: bool = False,
                 gelu_stored: Optional[bool] = None):
        super().__init__()
        if route is None:
            route = AttentionRoute.from_env()
        if gelu_stored is None:
            gelu_stored = gelu_stored_from_env()
        if attention_type == "joint_space_time":
            raise NotImplementedError(
                "joint_space_time attention: the JAX reference fails on it "
                "(its block, procedurevrl_tpu/models/timesformer.py:110, "
                "receives the divided (cls, xt) tuple), so there is nothing "
                "to hold a port to")
        if attention_type not in ("divided_space_time", "space_only"):
            raise ValueError(f"unknown attention type {attention_type!r}")
        self.attention_type = attention_type
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.remat = remat
        self.remat_names = remat_names(remat_save_attn, remat_save_qkv,
                                       remat_save_temporal)
        num_patches = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(patch_size, 3, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, num_patches + 1, embed_dim))
        space_only = attention_type == "space_only"
        if not space_only:
            self.time_embed = nn.Parameter(torch.zeros(1, num_frames,
                                                       embed_dim))
        block = SpaceOnlyBlock if space_only else DividedSTBlock
        self.blocks = nn.ModuleList([
            block(embed_dim, num_heads, mlp_ratio, qkv_bias,
                  drop_path_rate * i / max(depth - 1, 1), norm_eps, route,
                  gelu_stored)
            for i in range(depth)
        ])
        self.norm = LayerNormFp32(embed_dim, eps=norm_eps)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """Random init of the JAX package: trunc-normal(0.02) for the
        embeddings, the patch kernel and every linear weight; zero biases;
        unit LayerNorm scales."""
        trunc_normal_init(self.patch_embed.proj.weight, 0.02, generator)
        nn.init.zeros_(self.patch_embed.proj.bias)
        for name in ("cls_token", "pos_embed", "time_embed"):
            if hasattr(self, name):
                trunc_normal_init(getattr(self, name), 0.02, generator)
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

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, H, W, C = x.shape
        D = self.embed_dim
        gw = W // self.patch_size
        dt = x.dtype
        tokens = self.patch_embed(x.reshape(B * T, H, W, C))  # [B*T, N, D]
        n_tok = tokens.shape[1]
        cls = self.cls_token.to(dt).expand(B * T, 1, D)
        tokens = torch.cat([cls, tokens], dim=1) + self._pos_embed(n_tok, gw).to(dt)
        if self.attention_type == "space_only":
            # [B*T, 1 + N, D]: every frame with its own CLS
            state: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]] = tokens
        else:
            te = interpolate_nearest_1d(self.time_embed, T, dim=1)
            # every CLS row is cls_token + its position embedding: one per
            # sample
            cls = tokens[:B, :1]
            spatial = (tokens[:, 1:].reshape(B, T, n_tok, D)
                       + te.to(dt)[:, :, None])
            state = (cls, spatial.reshape(B * T, n_tok, D))
        recompute = self.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            keep = blk.draw_masks(B, T, x.device, generator)
            if recompute:
                state = checkpoint(blk, state, T, keep,
                                   **remat.checkpoint_kwargs(self.remat_names))
            else:
                state = blk(state, T, keep)
        if self.attention_type == "space_only":
            # the frames' CLS rows averaged over T; LayerNorm is per token,
            # so this is JAX's norm(mean_T(tokens))[:, 0]
            return self.norm(state.view(B, T, n_tok + 1, D)[:, :, 0]
                             .mean(dim=1))
        return self.norm(state[0])[:, 0]
