"""Shared building blocks: fp32 LayerNorm, MLP, attention, stochastic depth
(counterpart of ``procedurevrl_tpu/models/layers.py``), and the CLIP-style
residual block that the text tower and the order transformer share.

Parameters are float32 and named as in the reference ``.pyth`` checkpoints
(``weight``/``bias`` of ``nn.Linear`` and ``nn.LayerNorm``); products run
in the dtype of the activations, with the weights cast at each product.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from procedurevrl_torch.ops.attention import mhsa, mhsa_cls, mhsa_temporal
from procedurevrl_torch.ops.attention_route import DEFAULT_ROUTE, AttentionRoute
from procedurevrl_torch.ops.common import (
    gelu_exact, layer_norm_fp32, quick_gelu, trunc_normal_init,
)


class LayerNormFp32(nn.LayerNorm):
    """LayerNorm in float32 whatever the compute dtype; output in the
    input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_fp32(x, self.weight, self.bias, self.eps)


class Linear(nn.Linear):
    """``nn.Linear`` whose float32 weights are cast to the input dtype at
    the product (flax ``Dense(dtype=...)`` semantics)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


def init_linear(layer: nn.Linear, generator: Optional[torch.Generator]
                ) -> None:
    """timm ViT init: trunc-normal(0.02) weights, zero bias."""
    trunc_normal_init(layer.weight, 0.02, generator)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)


class Mlp(nn.Module):
    """Transformer MLP with exact GELU (reference ``lib/models/vit.py:44-60``)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden_dim)
        self.fc2 = Linear(hidden_dim, out_dim)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        init_linear(self.fc1, generator)
        init_linear(self.fc2, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu_exact(self.fc1(x)))


class Attention(nn.Module):
    """Fused-qkv self-attention (reference ``lib/models/vit.py:62-92``).

    Three dispatches, as the JAX module: with ``cls_stream`` the spatial
    pass with a separate CLS stream (kernel K1, or K3), with ``time_axis``
    the temporal pass over axis 1 of ``[B, T, N, C]`` (kernel K2), otherwise
    attention over axis 1 of ``[B, N, C]`` (kernel K4 where the route asks
    for Pallas and the shape rule holds; ``causal`` adds the causal mask).
    ``route`` picks the kernels (``ops/attention_route.py``)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 causal: bool = False, route: AttentionRoute = DEFAULT_ROUTE):
        super().__init__()
        self.num_heads = num_heads
        self.causal = causal
        self.route = route
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        init_linear(self.qkv, generator)
        init_linear(self.proj, generator)

    def forward(self, x: torch.Tensor, cls_stream: Optional[torch.Tensor] = None,
                time_axis: bool = False,
                key_padding_mask: Optional[torch.Tensor] = None):
        args = (self.qkv.weight, self.qkv.bias, self.proj.weight,
                self.proj.bias, self.num_heads)
        if cls_stream is not None:
            return mhsa_cls(x, cls_stream, *args, route=self.route)
        if time_axis:
            return mhsa_temporal(x, *args, route=self.route)
        return mhsa(x, *args, key_padding_mask=key_padding_mask,
                    causal=self.causal, use_pallas=self.route.use_pallas,
                    min_len=self.route.min_len,
                    shift=self.route.spatial_shift)


Streams = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


class DropPath(nn.Module):
    """Per-sample stochastic depth.

    :meth:`draw` gives the keep mask ``[lead]`` (None in eval mode or at
    rate 0), drawn from a generator on the tensors' device; ``forward``
    applies it, so a block that is recomputed for its backward reapplies
    the same mask.  A tuple input applies ONE per-sample mask to every
    element (leading dims must be multiples of ``lead``): the CLS and frame
    streams of a block drop together, as when they were one tensor."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def draw(self, lead: int, device: torch.device,
             generator: Optional[torch.Generator] = None
             ) -> Optional[torch.Tensor]:
        if not self.training or self.rate == 0.0:
            return None
        if generator is not None and generator.device != torch.device(device):
            raise ValueError(f"DropPath: a generator on {generator.device} "
                             f"cannot draw a mask on {device}")
        return torch.rand(lead, generator=generator, device=device) < (
            1.0 - self.rate)

    def forward(self, x: Streams, keep: Optional[torch.Tensor] = None
                ) -> Streams:
        if keep is None:
            return x
        rate_keep = 1.0 - self.rate
        lead = keep.shape[0]
        elems = x if isinstance(x, tuple) else (x,)
        if any(e.shape[0] % lead for e in elems):
            raise ValueError("DropPath: leading dims must be multiples of "
                             f"{lead}")

        def apply(e: torch.Tensor) -> torch.Tensor:
            f = e.reshape((lead, e.shape[0] // lead) + e.shape[1:])
            m = keep.view((lead,) + (1,) * (f.dim() - 1))
            return torch.where(m, f / rate_keep,
                               torch.zeros_like(f)).reshape(e.shape)

        out = tuple(apply(e) for e in elems)
        return out if isinstance(x, tuple) else out[0]


class MultiheadSelfAttention(nn.Module):
    """Fused-qkv self-attention with ``nn.MultiheadAttention``'s parameter
    names (``in_proj_weight [3C, C]``, ``in_proj_bias``, ``out_proj``), as
    the CLIP-style blocks of the reference checkpoints name them."""

    def __init__(self, dim: int, num_heads: int, causal: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.causal = causal
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        return mhsa(x, self.in_proj_weight, self.in_proj_bias,
                    self.out_proj.weight, self.out_proj.bias, self.num_heads,
                    key_padding_mask=key_padding_mask, causal=self.causal)


class QuickGeluMlp(nn.Module):
    """CLIP MLP: ``c_fc`` -> QuickGELU -> ``c_proj``."""

    def __init__(self, dim: int):
        super().__init__()
        self.c_fc = Linear(dim, 4 * dim)
        self.c_proj = Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    """CLIP-style pre-LN block (reference ``lib/models/tfm_model.py:32-53``):
    fp32 LayerNorms, fused-qkv attention (``causal`` for the CLIP text
    tower, a key padding mask for the order transformer), QuickGELU MLP."""

    def __init__(self, d_model: int, n_head: int, causal: bool = False):
        super().__init__()
        self.attn = MultiheadSelfAttention(d_model, n_head, causal)
        self.ln_1 = LayerNormFp32(d_model)
        self.mlp = QuickGeluMlp(d_model)
        self.ln_2 = LayerNormFp32(d_model)

    def reset_parameters(self, generator: Optional[torch.Generator],
                         attn_std: float, proj_std: float, fc_std: float
                         ) -> None:
        """Normal weights of the given scales, zero biases, unit LN scales."""
        with torch.no_grad():
            for w, std in ((self.attn.in_proj_weight, attn_std),
                           (self.attn.out_proj.weight, proj_std),
                           (self.mlp.c_fc.weight, fc_std),
                           (self.mlp.c_proj.weight, proj_std)):
                w.normal_(0.0, std, generator=generator)
            for b in (self.attn.in_proj_bias, self.attn.out_proj.bias,
                      self.mlp.c_fc.bias, self.mlp.c_proj.bias):
                b.zero_()
        for ln in (self.ln_1, self.ln_2):
            nn.init.ones_(ln.weight)
            nn.init.zeros_(ln.bias)

    def forward(self, x: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), key_padding_mask=pad_mask)
        return x + self.mlp(self.ln_2(x))
