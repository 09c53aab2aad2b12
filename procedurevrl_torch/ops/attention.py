"""Multi-head self-attention paths (counterpart of
``procedurevrl_tpu/ops/attention.py``).

Weights are in PyTorch layout (``qkv_w [3C, C]``, ``proj_w [C, C]``) and
are cast to the activation dtype at each product, as the JAX package casts
``kernel.astype(self.dtype)``.  The fused qkv projection keeps the standard
``[q | k | v]`` column order with heads interleaved inside each third.

- ``attention_core`` / ``mhsa_xla``: plain attention with a row-max
  softmax, as the JAX package's XLA paths.
- ``mhsa``: the dispatcher of the JAX package's ``mhsa``.  Asked for
  Pallas (``use_pallas``, which only TimeSformer's ``Attention`` passes, as
  in JAX: the CLIP tower and the order transformer keep the default False),
  unmasked, non-causal sequences of ``min_len``..1024 tokens take kernel K4
  (``ops/flash_attention.py``, K4f, + K4b under grad), as TimeSformer's
  ``space_only`` blocks do at N = 197.
- ``mhsa_cls``: the spatial pass with the CLS as a separate stream, through
  kernel K1 (``ops/spatial_attention.py``: K1f, or K1sp + K1b under grad;
  K1p, K1br and K1bd on the knob routes of ``ops/attention_route.py``), or,
  with ``SPATIAL_FUSED_QKV=0``, through K3 (``ops/flash_attention.py``) on
  the q, k, v thirds of the projection.
- ``mhsa_temporal``: the temporal pass on the ``[B, T, N, C]`` view,
  through kernel K2 (``ops/temporal_attention.py``: K2f, + K2b under grad;
  K2v3f and K2v3b on ``TEMPORAL_BATCHED``).
Every kernel takes the softmax shift of the JAX package's Pallas kernels,
``SPATIAL_SHIFT`` for K1, K3 and K4 and ``TEMPORAL_SHIFT`` for K2 (read
into the route at build): ``clamp`` (default) ``exp(min(s, 80))``, which
equals the row-max softmax while logits stay below 80, ``max`` the row-max
softmax, ``none`` ``exp(s)``; a pass on the plain path takes the row-max
softmax whatever the knobs say, as JAX's XLA paths do.

Whether a pass takes its kernel is the JAX package's shape rule, decided
before any launch (:func:`takes_k1`, :func:`takes_k2`, :func:`takes_k4`);
otherwise it runs the plain row-max path, as JAX runs its XLA path.  K1
carries frames of up to 207 tokens (N + 1 <= 208) on its own kernels and
longer ones, to JAX's 1024, on the key-tiled pair of
``ops/flash_attention.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from procedurevrl_torch.ops import flash_attention as fa
from procedurevrl_torch.ops import remat
from procedurevrl_torch.ops import spatial_attention as k1
from procedurevrl_torch.ops import temporal_attention as k2
from procedurevrl_torch.ops.attention_route import (
    DEFAULT_ROUTE, AttentionRoute,
)

# The JAX package's shape rules, copied (``pallas_attention.py:46``, :158-175,
# :1586-1612; its frame limit :1566 is ``k2.MAX_T``): the bounds model the
# TPU's VMEM and lane tiling, and the port keeps them so that each pass
# takes the path JAX takes.
MAX_FUSED_LEN = 1024


def heads_per_block(d: int, num_heads: int) -> int:
    """Heads per 128-lane block of the JAX spatial kernel, 0 when the
    shape has none."""
    hpb = 1
    while (d * hpb) % 128 != 0 and hpb < num_heads:
        hpb += 1
    if (d * hpb) % 128 != 0 or num_heads % hpb != 0:
        return 0
    return hpb


def temporal_geometry(n: int, d: int, num_heads: int, t: int,
                      itemsize: int, batched: bool) -> Tuple[int, int, int]:
    """(heads per block, lane width, n tile) of the JAX temporal kernel,
    (0, 0, 0) when none fits its VMEM budget (``batched``: the v3 pair's
    extra scratch)."""
    budget = 10 * 2 ** 20
    extra = 14 if batched else 0
    for nt in (min(n, 256), 128, 64):
        if nt > n:
            continue
        for hpb in (1, 2, 4, 8):
            if num_heads % hpb or (d * hpb) % 128 or t * hpb > 128:
                continue
            w = d * hpb
            if (8 * 2 * itemsize + extra) * t * nt * w <= budget:
                return hpb, w, nt
    return 0, 0, 0


def takes_k1(n: int, c: int, num_heads: int, route: AttentionRoute) -> bool:
    """Whether the spatial pass over N frame tokens takes K1 (JAX
    ``ops/attention.py:184-188``)."""
    return (route.use_pallas and route.min_len <= n <= MAX_FUSED_LEN
            and heads_per_block(c // num_heads, num_heads) > 0)


def takes_k4(n: int, c: int, num_heads: int, use_pallas: bool, min_len: int,
             masked: bool, causal: bool) -> bool:
    """Whether self-attention over N tokens takes K4 (JAX
    ``ops/attention.py:309-315``): asked for Pallas, no key mask, not
    causal, ``min_len <= N <= 1024`` and a heads-per-block geometry."""
    return (use_pallas and not masked and not causal
            and min_len <= n <= MAX_FUSED_LEN
            and heads_per_block(c // num_heads, num_heads) > 0)


def takes_k2(t: int, n: int, c: int, num_heads: int, itemsize: int,
             route: AttentionRoute) -> bool:
    """Whether the temporal pass over T frames takes K2 (JAX
    ``ops/attention.py:247-258``)."""
    return (route.use_pallas and route.temporal_pallas
            and t <= k2.MAX_T
            and temporal_geometry(n, c // num_heads, num_heads, t,
                                  itemsize, route.temporal_batched)[0] > 0)


def _linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
            name: Optional[str] = None) -> torch.Tensor:
    """x w^T + b, the weights cast to x's dtype; with ``name`` the product
    carries that checkpoint name (``ops/remat.py``)."""
    w, b = w.to(x.dtype), None if b is None else b.to(x.dtype)
    if name is None:
        return F.linear(x, w, b)
    with remat.named(name):
        return F.linear(x, w, b)


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


def _attend_xla(x: torch.Tensor, qkv_w: torch.Tensor,
                qkv_b: Optional[torch.Tensor], num_heads: int,
                key_padding_mask: Optional[torch.Tensor] = None,
                causal: bool = False) -> torch.Tensor:
    """The plain path up to the output projection: x [B, N, C] -> the
    attention output [B, N, C]."""
    b, n, c = x.shape
    d = c // num_heads
    qkv = _linear(x, qkv_w, qkv_b).view(b, n, 3, num_heads, d)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(dim=2))  # [B, H, N, d]
    o = attention_core(q, k, v, d ** -0.5, key_padding_mask, causal)
    return o.transpose(1, 2).reshape(b, n, c)


def mhsa_xla(x: torch.Tensor, qkv_w: torch.Tensor,
             qkv_b: Optional[torch.Tensor], proj_w: torch.Tensor,
             proj_b: torch.Tensor, num_heads: int,
             key_padding_mask: Optional[torch.Tensor] = None,
             causal: bool = False) -> torch.Tensor:
    """Fused-projection self-attention on x [B, N, C] (plain path)."""
    return _linear(_attend_xla(x, qkv_w, qkv_b, num_heads, key_padding_mask,
                               causal), proj_w, proj_b)


def mhsa(x: torch.Tensor, qkv_w: torch.Tensor, qkv_b: Optional[torch.Tensor],
         proj_w: torch.Tensor, proj_b: torch.Tensor, num_heads: int,
         key_padding_mask: Optional[torch.Tensor] = None,
         causal: bool = False, use_pallas: bool = False,
         min_len: int = 128, shift: str = "clamp") -> torch.Tensor:
    """Self-attention on x [B, N, C] with an optional key padding mask
    ([B, N], True = masked out) and causal mask.  Where :func:`takes_k4`
    holds (``use_pallas`` and ``min_len`` as ``TPU.USE_PALLAS_ATTENTION``
    and ``PALLAS_MIN_LEN`` give them), K4 on the q, k, v thirds of one
    projection (JAX ``ops/attention.py:316-327``) under the softmax shift
    ``shift`` (``SPATIAL_SHIFT``); else :func:`mhsa_xla`."""
    b, n, c = x.shape
    if not takes_k4(n, c, num_heads, use_pallas, min_len,
                    key_padding_mask is not None, causal):
        return mhsa_xla(x, qkv_w, qkv_b, proj_w, proj_b, num_heads,
                        key_padding_mask, causal)
    q, k, v = _linear(x, qkv_w, qkv_b, "qkv_out").split(c, dim=-1)
    out = fa.flash_attention_autograd(q, k, v, num_heads,
                                      (c // num_heads) ** -0.5, shift)
    return _linear(out, proj_w, proj_b)


def mhsa_cls(x: torch.Tensor, cls_x: torch.Tensor, qkv_w: torch.Tensor,
             qkv_b: Optional[torch.Tensor], proj_w: torch.Tensor,
             proj_b: torch.Tensor, num_heads: int,
             route: AttentionRoute = DEFAULT_ROUTE
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spatial self-attention with the CLS token as a separate stream.

    x [BT, N, C] frame tokens, cls_x [BT, 1, C]; every query attends over
    [cls; frames].  Returns (frame_out [BT, N, C], cls_out [BT, 1, C]).
    Where :func:`takes_k1` fails, [cls; frames] goes through
    :func:`mhsa_xla` (JAX ``ops/attention.py:220-223``).  With
    ``route.fused_qkv`` False (``SPATIAL_FUSED_QKV=0``), K3 on the q, k, v
    thirds of the projections, as JAX's ``_qkv_project`` +
    ``flash_attention_cls`` (:212-217)."""
    c = x.shape[-1]
    if not takes_k1(x.shape[1], c, num_heads, route):
        out = mhsa_xla(torch.cat([cls_x, x], dim=1), qkv_w, qkv_b, proj_w,
                       proj_b, num_heads)
        return out[:, 1:], out[:, :1]
    scale = (c // num_heads) ** -0.5
    qkv = _linear(x, qkv_w, qkv_b, "qkv_out")
    qkv_c = _linear(cls_x, qkv_w, qkv_b, "qkv_out")
    if route.fused_qkv:
        out, out_c = k1.spatial_attention_autograd(qkv, qkv_c, num_heads,
                                                   scale, route)
    else:
        out, out_c = fa.flash_attention_cls_autograd(
            *qkv.split(c, dim=-1), *qkv_c.split(c, dim=-1), num_heads, scale,
            route.spatial_shift)
    return _linear(out, proj_w, proj_b), _linear(out_c, proj_w, proj_b)


def mhsa_temporal(x: torch.Tensor, qkv_w: torch.Tensor,
                  qkv_b: Optional[torch.Tensor], proj_w: torch.Tensor,
                  proj_b: torch.Tensor, num_heads: int,
                  route: AttentionRoute = DEFAULT_ROUTE) -> torch.Tensor:
    """Self-attention over axis 1 of the time-major stream x [B, T, N, C].
    Where :func:`takes_k2` fails, the plain path on the [B*N, T, C]
    transpose, one explicit (T, N) transpose each way (JAX
    ``ops/attention.py:282-285``); its output projection, the pass's last
    product, is named ``temporal_out`` (JAX :291, ``ops/remat.py``)."""
    b, t, n, c = x.shape
    if not takes_k2(t, n, c, num_heads, x.element_size(), route):
        xt = x.transpose(1, 2).reshape(b * n, t, c)
        o = _attend_xla(xt, qkv_w, qkv_b, num_heads)
        o = o.view(b, n, t, c).transpose(1, 2).contiguous()
        return _linear(o, proj_w, proj_b, "temporal_out")
    d = c // num_heads
    qkv = _linear(x, qkv_w, qkv_b)  # [B, T, N, 3C], read in place by K2
    out = k2.temporal_attention_autograd(qkv, num_heads, d ** -0.5, route)
    return _linear(out, proj_w, proj_b)
