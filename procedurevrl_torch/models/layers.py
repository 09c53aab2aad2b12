"""Shared building blocks: fp32 LayerNorm, MLP, attention, stochastic depth
(counterpart of ``procedurevrl_tpu/models/layers.py``).

Parameters are float32 and named as in the reference ``.pyth`` checkpoints
(``weight``/``bias`` of ``nn.Linear`` and ``nn.LayerNorm``); products run
in the dtype of the activations, with the weights cast at each product.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from procedurevrl_torch.ops.attention import mhsa_cls, mhsa_temporal, mhsa_xla
from procedurevrl_torch.ops.common import (
    gelu_exact, layer_norm_fp32, trunc_normal_init,
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
    pass with a separate CLS stream (kernel K1), with ``time_axis`` the
    temporal pass over axis 1 of ``[B, T, N, C]`` (kernel K2), otherwise
    plain attention over axis 1 of ``[B, N, C]``."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
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
            return mhsa_cls(x, cls_stream, *args)
        if time_axis:
            return mhsa_temporal(x, *args)
        return mhsa_xla(x, *args, key_padding_mask=key_padding_mask)


Streams = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


class DropPath(nn.Module):
    """Per-sample stochastic depth; the identity in eval mode.

    A tuple input draws ONE per-sample mask and applies it to every element
    (leading dims must be multiples of the smallest one): the CLS and frame
    streams of a block drop together, as when they were one tensor.  Draws
    come from the ``generator`` passed to ``forward``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: Streams,
                generator: Optional[torch.Generator] = None) -> Streams:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        elems = x if isinstance(x, tuple) else (x,)
        lead = min(e.shape[0] for e in elems)
        if any(e.shape[0] % lead for e in elems):
            raise ValueError("DropPath: leading dims must be multiples of "
                             f"{lead}")
        mask = torch.rand(lead, generator=generator,
                          device=elems[0].device) < keep

        def apply(e: torch.Tensor) -> torch.Tensor:
            f = e.reshape((lead, e.shape[0] // lead) + e.shape[1:])
            m = mask.view((lead,) + (1,) * (f.dim() - 1))
            return torch.where(m, f / keep, torch.zeros_like(f)).reshape(e.shape)

        out = tuple(apply(e) for e in elems)
        return out if isinstance(x, tuple) else out[0]
