"""Multi-head self-attention paths (counterpart of
``procedurevrl_tpu/ops/attention.py``).

Weights are in PyTorch layout (``qkv_w [3C, C]``, ``proj_w [C, C]``) and
are cast to the activation dtype at each product, as the JAX package casts
``kernel.astype(self.dtype)``.  The fused qkv projection keeps the standard
``[q | k | v]`` column order with heads interleaved inside each third.

- ``attention_core`` / ``mhsa_xla``: plain attention with a row-max
  softmax, as the JAX package's XLA paths.
- ``mhsa_cls``: the spatial pass with the CLS as a separate stream, through
  kernel K1 (``ops/spatial_attention.py``).
- ``mhsa_temporal``: the temporal pass on the ``[B, T, N, C]`` view,
  through kernel K2 (``ops/temporal_attention.py``).
Both kernels use the clamp shift ``exp(min(s, 80))`` of the JAX package's
Pallas kernels, which equals the row-max softmax while logits stay below 80.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from procedurevrl_torch.ops import spatial_attention as k1
from procedurevrl_torch.ops import temporal_attention as k2


def _linear(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor]) -> torch.Tensor:
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float,
                   key_padding_mask: Optional[torch.Tensor] = None,
                   causal: bool = False) -> torch.Tensor:
    """softmax(q k^T * scale) v on q, k, v [B, H, N, d]; logits and softmax
    in fp32, probabilities cast to the value dtype before the PV product.
    ``key_padding_mask`` [B, N] is True where a key is masked out."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    neg = torch.finfo(torch.float32).min
    if key_padding_mask is not None:
        s = s.masked_fill(key_padding_mask[:, None, None, :], neg)
    if causal:
        n = s.shape[-1]
        tri = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~tri, neg)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return o.to(v.dtype)


def mhsa_xla(x: torch.Tensor, qkv_w: torch.Tensor,
             qkv_b: Optional[torch.Tensor], proj_w: torch.Tensor,
             proj_b: torch.Tensor, num_heads: int,
             key_padding_mask: Optional[torch.Tensor] = None,
             causal: bool = False) -> torch.Tensor:
    """Fused-projection self-attention on x [B, N, C] (plain path)."""
    b, n, c = x.shape
    d = c // num_heads
    qkv = _linear(x, qkv_w, qkv_b).view(b, n, 3, num_heads, d)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(dim=2))  # [B, H, N, d]
    o = attention_core(q, k, v, d ** -0.5, key_padding_mask, causal)
    return _linear(o.transpose(1, 2).reshape(b, n, c), proj_w, proj_b)


def mhsa_cls(x: torch.Tensor, cls_x: torch.Tensor, qkv_w: torch.Tensor,
             qkv_b: Optional[torch.Tensor], proj_w: torch.Tensor,
             proj_b: torch.Tensor, num_heads: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spatial self-attention with the CLS token as a separate stream.

    x [BT, N, C] frame tokens, cls_x [BT, 1, C]; every query attends over
    [cls; frames].  Returns (frame_out [BT, N, C], cls_out [BT, 1, C])."""
    d = x.shape[-1] // num_heads
    qkv = _linear(x, qkv_w, qkv_b)
    qkv_c = _linear(cls_x, qkv_w, qkv_b)
    out, out_c = k1.spatial_attention(qkv, qkv_c, num_heads, d ** -0.5)
    return _linear(out, proj_w, proj_b), _linear(out_c, proj_w, proj_b)


def mhsa_temporal(x: torch.Tensor, qkv_w: torch.Tensor,
                  qkv_b: Optional[torch.Tensor], proj_w: torch.Tensor,
                  proj_b: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Self-attention over axis 1 of the time-major stream x [B, T, N, C]."""
    d = x.shape[-1] // num_heads
    qkv = _linear(x, qkv_w, qkv_b)  # [B, T, N, 3C], read in place by K2
    out = k2.temporal_attention(qkv, num_heads, d ** -0.5)
    return _linear(out, proj_w, proj_b)
