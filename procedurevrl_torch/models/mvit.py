"""MViT-v2 video encoder (counterpart of ``procedurevrl_tpu/models/mvit.py``;
reference ``lib/models/slowfast_mvit/mvit.py``, ``attention.py``).

Channels-last and head-last throughout, as the JAX package: tokens are
``[B, L, C]`` with the CLS token first, q/k/v stay ``[B, L, H*d]`` from the
qkv projection to the output projection, and the pooling runs on
``[B, T, H, W, C]`` grids (copied to ``[B, C, T, H, W]`` for
``F.conv3d`` and the pools).  Pooled attention with the
decomposed relative-position bias goes through the port's kernels K5
(head-last) and K6 (head-split), routed per block as the JAX model routes
them; the CLS query row and blocks too small for the kernels run in plain
PyTorch.  Parameters carry the reference ``.pyth`` names
(``patch_embed.proj.*``, ``cls_token``, ``blocks.{i}.attn.pool_q.weight``,
``blocks.{i}.attn.rel_pos_h`` ...), which ``convert_mvit`` of the JAX
package reads.

The JAX package's switches that select a kernel are copied, because they
are its only routes to them; :meth:`MViTRoute.from_env` reads them once,
when :meth:`MViTConfig.from_cfg` runs, so a built model's route is fixed
and every block carries the same :class:`MViTRoute`:

- ``TPU.USE_PALLAS_ATTENTION`` (config, default True): False sends every
  block to the plain logits path (JAX ``mvit.py:751-757``).
- ``MVIT_POOL`` = ``conv`` (default), ``kernel`` or ``taps``: with
  ``kernel`` the stride-1 3x3x3 pools go through the port's K8
  (``ops/depthwise_pool.py``), with ``taps`` through its plain tap
  formulas (the JAX ablation); strided pools, and any pool while the
  process is one of a distributed group of more than one, stay on
  ``conv3d`` (JAX ``mvit.py:285-292``, which also needs one device).
- ``MVIT_KT`` (boolean, default off): wide-key blocks that ``hl_supported``
  rejects go to K7 where ``kt_supported`` holds, else to K6 (JAX
  ``mvit.py:656-693``).
- ``MVIT_DELTA`` (boolean, default off): the K5 and K6 backwards take
  D_i = g_i . o_i from the saved output, K5bd and K6bd (JAX
  ``pallas_mvit_attention.py:531-547``).
- ``MVIT_SAVE_PROBS`` (boolean, default off): the K6 blocks save their
  probabilities in the forward (K6sp) and the backward reads them (K6bs);
  it takes precedence over ``MVIT_DELTA`` there, and K5 has no such form
  (:517-528, :616-645).

- ``MVIT_HL`` (default on; exactly ``0`` turns it off, as JAX compares
  the string): off sends every fused block to K6, the head-split kernel,
  even the blocks K5 takes and, under ``MVIT_KT``, K7 (JAX
  ``mvit.py:657``, :663).

``MVIT_SHIFT`` (``max|clamp|none``, read at build; anything else raises
``ValueError``): the softmax shift of K5 and K6, the only kernels JAX reads
it in (``clamp`` exp(min(s, 80)), ``max`` the row max, ``none`` exp(s));
K7 always takes the row max and the plain path the row-max softmax, as in
JAX.

Three TPU layout knobs are refused: setting ``MVIT_RELV2`` (other than
empty or ``0``), ``MVIT_SAVE_REL`` or ``MVIT_MAXPOOL=taps`` raises
``ValueError`` at build.  In JAX each builds the same function another way
(the bias operand from one stacked GEMM, ``mvit.py:408-480``; that operand
kept across remat, :644-652; the max pools as a chain of ``maximum`` over
taps, :221, which also splits a tie's gradient) and each stays off there as
a measured loss on the TPU; no config sets one.  Refusing tells a user who
sets one that the port runs the default program.

``MVIT_MXU_DSUM`` (JAX ``pallas_mvit_attention.py:143``) is not copied: it
only changes how the TPU kernel forms its fp32 row sum, on the MXU or the
VPU, and selects no kernel and no route, as ``SPATIAL_MXU_DSUM`` does (not
copied either).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from procedurevrl_torch.models.layers import (
    DropPath, LayerNormFp32, Linear, Mlp, gelu_stored_from_env, init_linear,
)
from procedurevrl_torch.ops import depthwise_pool as dpool
from procedurevrl_torch.ops import remat
from procedurevrl_torch.ops import mvit_attention as mattn
from procedurevrl_torch.ops.attention_route import read_shift
from procedurevrl_torch.ops.common import (
    grouped_layer_norm_fp32, layer_norm_fp32, trunc_normal_init,
)
from procedurevrl_torch.parallel.collectives import in_group
from procedurevrl_torch.utils.env import env_flag

Thw = Tuple[int, int, int]
POOL_ROUTES = ("conv", "kernel", "taps")
# what a block keeps across its recomputation (JAX models/mvit.py:958-962,
# ops/remat.py); JAX's fifth name, "mvit_rel", exists only under
# MVIT_SAVE_REL, which the port refuses
REMAT_NAMES = ("flash_attn_out", "flash_attn_lse", "flash_attn_probs",
               "gelu_grad")


def pool_route_from_env() -> str:
    """``MVIT_POOL`` (JAX ``mvit.py:285``): unset or empty is ``conv``;
    a value outside :data:`POOL_ROUTES` raises."""
    route = os.environ.get("MVIT_POOL", "") or "conv"
    if route not in POOL_ROUTES:
        raise ValueError(f"MVIT_POOL={route!r} is not one of {POOL_ROUTES}")
    return route


@dataclass(frozen=True)
class MViTRoute:
    pool: str = "conv"          # MVIT_POOL
    kt: bool = False            # MVIT_KT
    use_pallas: bool = True     # TPU.USE_PALLAS_ATTENTION
    delta: bool = False         # MVIT_DELTA
    save_probs: bool = False    # MVIT_SAVE_PROBS
    shift: str = "clamp"        # MVIT_SHIFT
    hl: bool = True             # MVIT_HL

    @classmethod
    def from_env(cls, use_pallas: bool = True) -> "MViTRoute":
        """The route the environment selects (``use_pallas`` from the
        config); a malformed or refused knob raises ``ValueError``."""
        refused = [name for name, on in (
            ("MVIT_RELV2", os.environ.get("MVIT_RELV2", "0") not in ("", "0")),
            ("MVIT_SAVE_REL", env_flag("MVIT_SAVE_REL", False)),
            ("MVIT_MAXPOOL", os.environ.get("MVIT_MAXPOOL") == "taps")) if on]
        if refused:
            raise ValueError(f"{', '.join(refused)}: TPU layout knob(s) the "
                             "port does not build; unset them")
        return cls(pool=pool_route_from_env(), kt=env_flag("MVIT_KT", False),
                   use_pallas=bool(use_pallas),
                   delta=env_flag("MVIT_DELTA", False),
                   save_probs=env_flag("MVIT_SAVE_PROBS", False),
                   shift=read_shift("MVIT_SHIFT"),
                   hl=os.environ.get("MVIT_HL", "1") != "0")


DEFAULT_ROUTE = MViTRoute()


def round_width(width, multiplier, min_width=1, divisor=1) -> int:
    """reference ``lib/models/slowfast_mvit/utils.py:7-19``."""
    if not multiplier:
        return width
    width *= multiplier
    min_width = min_width or divisor
    width_out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if width_out < 0.9 * width:
        width_out += divisor
    return int(width_out)


@dataclass(frozen=True)
class MViTConfig:
    """Static architecture resolved from the config tree (JAX
    ``MViTConfig``, reference ``mvit.py:41-246``)."""

    spatial_size: int = 224
    temporal_size: int = 16
    in_chans: int = 3
    embed_dim: int = 96
    num_heads: int = 1
    depth: int = 16
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_path_rate: float = 0.0
    mode: str = "conv"
    cls_embed_on: bool = True
    use_mean_pooling: bool = False
    use_abs_pos: bool = False
    sep_pos_embed: bool = False
    rel_pos_spatial: bool = True
    rel_pos_temporal: bool = True
    residual_pooling: bool = True
    dim_mul_in_att: bool = True
    patch_kernel: Tuple[int, int, int] = (3, 7, 7)
    patch_stride: Tuple[int, int, int] = (2, 4, 4)
    patch_padding: Tuple[int, int, int] = (1, 3, 3)
    dim_mul: Tuple = ()      # ((block, mult), ...)
    head_mul: Tuple = ()
    pool_q_stride: Tuple = ()   # ((block, st, sh, sw), ...)
    pool_kv_stride: Tuple = ()
    pool_kv_stride_adaptive: Optional[Tuple] = None
    pool_kvq_kernel: Optional[Tuple] = None
    norm_stem: bool = False
    route: MViTRoute = DEFAULT_ROUTE

    @classmethod
    def from_cfg(cls, cfg) -> "MViTConfig":
        """The configuration of ``cfg`` on the route the environment's
        knobs select; a malformed knob raises ``ValueError``, one the port
        cannot honour ``NotImplementedError``."""
        route = MViTRoute.from_env(cfg.TPU.USE_PALLAS_ATTENTION)
        m = cfg.MVIT
        opt = lambda v: None if v is None else tuple(v)
        return cls(
            spatial_size=cfg.DATA.TRAIN_CROP_SIZE,
            temporal_size=cfg.DATA.NUM_FRAMES,
            in_chans=cfg.DATA.INPUT_CHANNEL_NUM[0],
            embed_dim=m.EMBED_DIM, num_heads=m.NUM_HEADS, depth=m.DEPTH,
            mlp_ratio=m.MLP_RATIO, qkv_bias=m.QKV_BIAS,
            drop_path_rate=m.DROPPATH_RATE, mode=m.MODE,
            cls_embed_on=m.CLS_EMBED_ON, use_mean_pooling=m.USE_MEAN_POOLING,
            use_abs_pos=m.USE_ABS_POS, sep_pos_embed=m.SEP_POS_EMBED,
            rel_pos_spatial=m.REL_POS_SPATIAL,
            rel_pos_temporal=m.REL_POS_TEMPORAL,
            residual_pooling=m.RESIDUAL_POOLING,
            dim_mul_in_att=m.DIM_MUL_IN_ATT,
            patch_kernel=tuple(m.PATCH_KERNEL),
            patch_stride=tuple(m.PATCH_STRIDE),
            patch_padding=tuple(m.PATCH_PADDING),
            dim_mul=tuple(tuple(e) for e in m.DIM_MUL),
            head_mul=tuple(tuple(e) for e in m.HEAD_MUL),
            pool_q_stride=tuple(tuple(e) for e in m.POOL_Q_STRIDE),
            pool_kv_stride=tuple(tuple(e) for e in m.POOL_KV_STRIDE),
            pool_kv_stride_adaptive=opt(m.POOL_KV_STRIDE_ADAPTIVE),
            pool_kvq_kernel=opt(m.POOL_KVQ_KERNEL),
            norm_stem=m.NORM_STEM,
            route=route,
        )

    def block_schedule(self):
        """Per-block dims, heads, pool kernels and strides and input grid,
        the static plan of reference ``mvit.py:141-246``; returns (plan,
        patch grid, final width)."""
        depth = self.depth
        dim_mul = np.ones(depth + 1)
        head_mul = np.ones(depth + 1)
        for blk, mult in self.dim_mul:
            dim_mul[blk] = mult
        for blk, mult in self.head_mul:
            head_mul[blk] = mult

        pool_q = [[] for _ in range(depth)]
        pool_kv = [[] for _ in range(depth)]
        stride_q = [[] for _ in range(depth)]
        stride_kv = [[] for _ in range(depth)]
        for entry in self.pool_q_stride:
            i = entry[0]
            stride_q[i] = list(entry[1:])
            pool_q[i] = (list(self.pool_kvq_kernel)
                         if self.pool_kvq_kernel is not None
                         else [s + 1 if s > 1 else s for s in entry[1:]])
        kv_entries = list(self.pool_kv_stride)
        if self.pool_kv_stride_adaptive is not None:
            _stride_kv = list(self.pool_kv_stride_adaptive)
            kv_entries = []
            for i in range(depth):
                if len(stride_q[i]) > 0:
                    _stride_kv = [max(_stride_kv[d] // stride_q[i][d], 1)
                                  for d in range(len(_stride_kv))]
                kv_entries.append([i] + _stride_kv)
        for entry in kv_entries:
            i = entry[0]
            stride_kv[i] = list(entry[1:])
            pool_kv[i] = (list(self.pool_kvq_kernel)
                          if self.pool_kvq_kernel is not None
                          else [s + 1 if s > 1 else s for s in entry[1:]])

        patch_dims = [self.temporal_size // self.patch_stride[0],
                      self.spatial_size // self.patch_stride[1],
                      self.spatial_size // self.patch_stride[2]]
        input_size = list(patch_dims)
        plan = []
        embed_dim = self.embed_dim
        num_heads = self.num_heads
        for i in range(depth):
            num_heads = round_width(num_heads, head_mul[i])
            if self.dim_mul_in_att:
                dim_out = round_width(embed_dim, dim_mul[i],
                                      divisor=round_width(num_heads,
                                                          head_mul[i]))
            else:
                dim_out = round_width(embed_dim, dim_mul[i + 1],
                                      divisor=round_width(num_heads,
                                                          head_mul[i + 1]))
            plan.append(dict(
                dim=embed_dim, dim_out=dim_out, num_heads=num_heads,
                kernel_q=tuple(pool_q[i]), kernel_kv=tuple(pool_kv[i]),
                stride_q=tuple(stride_q[i]), stride_kv=tuple(stride_kv[i]),
                input_size=tuple(input_size)))
            if len(stride_q[i]) > 0:
                input_size = [s // st for s, st in zip(input_size, stride_q[i])]
            embed_dim = dim_out
        return plan, patch_dims, embed_dim


# ---------------------------------------------------------------- pooling


def _to_ncdhw(grid: torch.Tensor) -> torch.Tensor:
    """[B, T, H, W, C] -> a contiguous [B, C, T, H, W].  The copy is
    deliberate: handed the channels-last view instead, the bf16 depthwise
    ``conv3d`` backward of PyTorch's CPU build returns garbage weight
    gradients (``tests/test_torch_mvit.py``)."""
    return grid.permute(0, 4, 1, 2, 3).contiguous()


def _to_ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


def _max_pool_3d(grid: torch.Tensor, kernel, stride, padding) -> torch.Tensor:
    """torch MaxPool3d(ceil_mode=False) on [B, T, H, W, C]; the padding is
    -inf, as ``reduce_window`` pads in the JAX package."""
    return _to_ndhwc(F.max_pool3d(_to_ncdhw(grid), tuple(kernel),
                                  tuple(stride), tuple(padding)))


def _avg_pool_3d(grid: torch.Tensor, kernel, stride, padding) -> torch.Tensor:
    """torch AvgPool3d(count_include_pad=True) on [B, T, H, W, C], as a
    zero pad and an unpadded pool (``F.avg_pool3d`` refuses a grid shorter
    than the kernel even when the padding makes up for it)."""
    pt, ph, pw = padding
    x = F.pad(_to_ncdhw(grid), (pw, pw, ph, ph, pt, pt))
    return _to_ndhwc(F.avg_pool3d(x, tuple(kernel), tuple(stride)))


def _pooled_thw(thw, kernel, stride) -> Thw:
    """Output grid of a padded pool (pad = k // 2, ceil_mode=False)."""
    return tuple((d + 2 * (k // 2) - k) // s + 1
                 for d, k, s in zip(thw, kernel, stride))


class DepthwisePool3D(nn.Module):
    """The 'conv' pooling mode: a depthwise 3-D conv over the head
    channels, one kernel shared by the heads (reference
    ``attention.py:236-276``).  The parameter keeps the reference shape
    ``weight [d, 1, kt, kh, kw]``; the forward repeats it once per head
    along the output channels of ``conv3d(groups=C)`` on the head-last
    channel axis, and autograd sums the per-head gradients into it, as the
    JAX package's tile does.  With ``route`` ``kernel`` or ``taps``
    (``MVIT_POOL``), a stride-1 3x3x3 pool goes through
    :func:`~procedurevrl_torch.ops.depthwise_pool.depthwise_pool3d` with
    the same weight as the tap table ``w27[dt*9 + dh*3 + dw, h*d + c] =
    weight[c, 0, dt, dh, dw]``."""

    def __init__(self, head_dim: int, kernel, stride, heads: int,
                 route: str = "conv"):
        super().__init__()
        if route not in POOL_ROUTES:
            raise ValueError(f"pool route {route!r} is not one of "
                             f"{POOL_ROUTES}")
        self.kernel, self.stride, self.heads = tuple(kernel), tuple(stride), heads
        self.route = route
        self.weight = nn.Parameter(torch.zeros(head_dim, 1, *self.kernel))

    def takes_pool_op(self) -> bool:
        """Whether this pool goes through ``depthwise_pool3d`` (JAX
        ``mvit.py:285-292``)."""
        return (self.route in ("kernel", "taps") and self.stride[1] == 1
                and not in_group()
                and dpool.supported(self.kernel, self.stride))

    def forward(self, grid: torch.Tensor) -> torch.Tensor:
        """[B, T, H, W, heads*d] -> pooled [B, T', H', W', heads*d]."""
        if self.takes_pool_op():
            w27 = self.weight.to(grid.dtype).permute(2, 3, 4, 1, 0).reshape(
                dpool.KTAPS, -1).repeat(1, self.heads)
            return dpool.depthwise_pool3d(grid, w27, self.stride[1],
                                          self.route == "kernel")
        w = self.weight.to(grid.dtype).repeat(self.heads, 1, 1, 1, 1)
        return _to_ndhwc(F.conv3d(_to_ncdhw(grid), w, None, self.stride,
                                  tuple(k // 2 for k in self.kernel),
                                  groups=w.shape[0]))


class GroupedLayerNorm(nn.Module):
    """Per-head LayerNorm of the head-last layout with the reference's
    shared ``[head_dim]`` parameters (JAX ``_GroupedLN``)."""

    def __init__(self, head_dim: int, heads: int, eps: float = 1e-6):
        super().__init__()
        self.heads, self.eps = heads, eps
        self.weight = nn.Parameter(torch.ones(head_dim))
        self.bias = nn.Parameter(torch.zeros(head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.heads == 1:
            return layer_norm_fp32(x, self.weight, self.bias, self.eps)
        return grouped_layer_norm_fp32(x, self.weight, self.bias, self.heads,
                                       self.eps)


# ------------------------------------------------- relative position bias


def _rel_dist_table(q_size: int, k_size: int) -> np.ndarray:
    """Static relative-distance index matrix (reference
    ``attention.py:76-91``)."""
    q_ratio = max(k_size / q_size, 1.0)
    k_ratio = max(q_size / k_size, 1.0)
    dist = (np.arange(q_size)[:, None] * q_ratio
            - np.arange(k_size)[None, :] * k_ratio)
    dist += (k_size - 1) * k_ratio
    return dist.astype(np.int64)


def _interp_rel_pos(rel_pos: torch.Tensor, d: int) -> torch.Tensor:
    """Linear resize of a rel-pos table to length d (torch
    ``F.interpolate(mode='linear', align_corners=False)``, reference
    ``attention.py:51-66``), index arithmetic in float32 as the JAX
    package computes it."""
    ori = rel_pos.shape[0]
    if ori == d:
        return rel_pos
    pos = ((torch.arange(d, dtype=torch.float32, device=rel_pos.device) + 0.5)
           * ori / d - 0.5)
    lo = torch.clamp(torch.floor(pos), 0, ori - 1).long()
    hi = torch.clamp(lo + 1, 0, ori - 1)
    frac = torch.clamp(pos - lo, 0.0, 1.0)[:, None]
    return rel_pos[lo] * (1 - frac) + rel_pos[hi] * frac


def _rel_table(rel_pos: torch.Tensor, q_size: int, k_size: int
               ) -> torch.Tensor:
    """[q_size, k_size, d]: the (resized) table gathered by distance."""
    table = _interp_rel_pos(rel_pos, int(2 * max(q_size, k_size) - 1))
    idx = torch.from_numpy(_rel_dist_table(q_size, k_size)).to(table.device)
    return table[idx]


def _rel_term(r_q: torch.Tensor, rel_pos: torch.Tensor, axis: str,
              q_size: int, k_size: int, out_dtype=torch.float32
              ) -> torch.Tensor:
    """One per-axis bias term of the body queries ``r_q [B, t, h, w, H, d]``
    (``axis`` "t", "h" or "w"): [B, t, h, w, H, k_axis], products of
    compute-dtype values accumulated in fp32 (reference
    ``attention.py:93-110,140-150``), rounded once to ``out_dtype``: the
    fused path takes the compute dtype (what the JAX package casts the
    fp32 result to), the logits path fp32."""
    table = _rel_table(rel_pos, q_size, k_size).to(r_q.dtype)
    if out_dtype == r_q.dtype:
        return torch.einsum(f"bthwyc,{axis}kc->bthwyk", r_q, table)
    return torch.einsum(f"bthwyc,{axis}kc->bthwyk", r_q.float(), table.float())


def _body_queries(q: torch.Tensor, sp: int, q_shape) -> torch.Tensor:
    """q [B, H, qN(+1), d] -> body queries [B, t, h, w, H, d]."""
    B, H, _, d = q.shape
    return q[:, :, sp:].reshape(B, H, *q_shape, d).permute(0, 2, 3, 4, 1, 5)


def _with_body(attn: torch.Tensor, body: torch.Tensor, sp: int
               ) -> torch.Tensor:
    B, H = attn.shape[:2]
    body = body.reshape(B, H, body.shape[2] * body.shape[3] * body.shape[4],
                        -1)
    if not sp:
        return body
    return torch.cat([attn[:, :, :1, :],
                      torch.cat([attn[:, :, 1:, :1], body], dim=3)], dim=2)


def add_rel_pos_spatial(attn, q, has_cls: bool, q_shape, k_shape, rel_pos_h,
                        rel_pos_w) -> torch.Tensor:
    """Decomposed spatial rel-pos on the logits (reference
    ``attention.py:67-117``): attn [B, H, qN, kN], q [B, H, qN, d]."""
    sp = 1 if has_cls else 0
    B, H = q.shape[:2]
    r_q = _body_queries(q, sp, q_shape)
    rel_h = _rel_term(r_q, rel_pos_h, "h", q_shape[1], k_shape[1])
    rel_w = _rel_term(r_q, rel_pos_w, "w", q_shape[2], k_shape[2])
    body = attn[:, :, sp:, sp:].reshape(B, H, *q_shape, *k_shape)
    body = (body + rel_h.permute(0, 4, 1, 2, 3, 5)[..., None, :, None]
            + rel_w.permute(0, 4, 1, 2, 3, 5)[..., None, None, :])
    return _with_body(attn, body, sp)


def add_rel_pos_temporal(attn, q, has_cls: bool, q_shape, k_shape,
                         rel_pos_t) -> torch.Tensor:
    """Temporal rel-pos on the logits (reference ``attention.py:120-159``)."""
    sp = 1 if has_cls else 0
    B, H = q.shape[:2]
    rel = _rel_term(_body_queries(q, sp, q_shape), rel_pos_t, "t",
                    q_shape[0], k_shape[0])
    body = attn[:, :, sp:, sp:].reshape(B, H, *q_shape, *k_shape)
    body = body + rel.permute(0, 4, 1, 2, 3, 5)[..., :, None, None]
    return _with_body(attn, body, sp)


# ------------------------------------------------------ attention, block


def _pools(kernel, stride) -> bool:
    return bool(kernel) and not (np.prod(kernel) == 1 and np.prod(stride) == 1)


class MultiScaleAttention(nn.Module):
    """Pooled multi-scale attention (reference ``attention.py:162-442``;
    the shipped configs use mode='conv', pool_first=False, fused qkv).

    With ``route.use_pallas``, blocks with rel-pos on both axes, a CLS
    token, qN >= ``MIN_FUSED_QN`` and kN <= ``MAX_FUSED_KN`` take the
    kernels, as the reference routes them; the rest run the plain logits
    path.  ``route`` also picks the conv pools' path and the kernels."""

    def __init__(self, dim: int, dim_out: int, input_size: Thw,
                 num_heads: int = 8, qkv_bias: bool = False,
                 kernel_q=(), kernel_kv=(), stride_q=(), stride_kv=(),
                 mode: str = "conv", has_cls_embed: bool = True,
                 rel_pos_spatial: bool = False,
                 rel_pos_temporal: bool = False,
                 residual_pooling: bool = False,
                 route: MViTRoute = DEFAULT_ROUTE):
        super().__init__()
        if mode not in ("conv", "max", "avg"):
            raise NotImplementedError(f"MViT pooling mode {mode!r}")
        self.num_heads = num_heads
        self.dim_out = dim_out
        self.mode = mode
        self.has_cls_embed = has_cls_embed
        self.residual_pooling = residual_pooling
        self.route = route
        self.pool_geometry = {"q": (tuple(kernel_q), tuple(stride_q)),
                              "k": (tuple(kernel_kv), tuple(stride_kv)),
                              "v": (tuple(kernel_kv), tuple(stride_kv))}
        head_dim = dim_out // num_heads
        self.qkv = Linear(dim, 3 * dim_out, bias=qkv_bias)
        self.proj = Linear(dim_out, dim_out)
        for name, (kernel, stride) in self.pool_geometry.items():
            if mode == "conv" and _pools(kernel, stride):
                setattr(self, f"pool_{name}",
                        DepthwisePool3D(head_dim, kernel, stride, num_heads,
                                        route.pool))
                setattr(self, f"norm_{name}",
                        GroupedLayerNorm(head_dim, num_heads))
        self.rel_pos_h = self.rel_pos_w = self.rel_pos_t = None
        if rel_pos_spatial:
            size = input_size[1]
            q_size = size // stride_q[1] if stride_q else size
            kv_size = size // stride_kv[1] if stride_kv else size
            rel_sp_dim = 2 * max(q_size, kv_size) - 1
            self.rel_pos_h = nn.Parameter(torch.zeros(rel_sp_dim, head_dim))
            self.rel_pos_w = nn.Parameter(torch.zeros(rel_sp_dim, head_dim))
        if rel_pos_temporal:
            self.rel_pos_t = nn.Parameter(
                torch.zeros(2 * input_size[0] - 1, head_dim))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        init_linear(self.qkv, generator)
        init_linear(self.proj, generator)
        for name in self.pool_geometry:
            pool = getattr(self, f"pool_{name}", None)
            if pool is not None:
                trunc_normal_init(pool.weight, 0.02, generator)
        for rel in (self.rel_pos_h, self.rel_pos_w, self.rel_pos_t):
            if rel is not None:
                trunc_normal_init(rel, 0.02, generator)

    def _pool(self, name: str, x: torch.Tensor, thw: Thw
              ) -> Tuple[torch.Tensor, Thw]:
        """attention_pool (reference ``attention.py:14-48``) on the
        head-last [B, L, heads*d]: pools the body tokens, re-attaches the
        CLS token, then the per-head norm (mode 'conv')."""
        kernel, stride = self.pool_geometry[name]
        if not _pools(kernel, stride):
            return x, thw
        B, _, C = x.shape
        cls_tok = None
        if self.has_cls_embed:
            cls_tok, x = x[:, :1], x[:, 1:]
        grid = x.reshape(B, *thw, C)
        if self.mode == "conv":
            grid = getattr(self, f"pool_{name}")(grid)
        elif self.mode == "max":
            grid = _max_pool_3d(grid, kernel, stride, [k // 2 for k in kernel])
        else:
            grid = _avg_pool_3d(grid, kernel, stride, [k // 2 for k in kernel])
        new_thw = _pooled_thw(thw, kernel, stride)
        x = grid.reshape(B, int(np.prod(new_thw)), C)
        if cls_tok is not None:
            x = torch.cat([cls_tok, x], dim=1)
        if self.mode == "conv":
            x = getattr(self, f"norm_{name}")(x)
        return x, new_thw

    def _fused_attention(self, q, k, v, q_shape: Thw, k_shape: Thw,
                         scale: float) -> torch.Tensor:
        """Body queries through K5 (head-last), or where the reference's
        ``hl_supported`` fails, or ``route.hl`` is off, through K7 (with
        ``route.kt``, ``route.hl`` and ``kt_supported``) or K6 (head-split),
        each entry on the backward
        ``route.delta`` / ``route.save_probs`` select; the CLS query row in
        plain PyTorch; returns [B, 1 + qN, C]."""
        B, _, C = q.shape
        H = self.num_heads
        d = C // H
        qc, qb = q[:, :1], q[:, 1:]
        kc, kb = k[:, :1], k[:, 1:]
        vc, vb = v[:, :1], v[:, 1:]
        qn = int(np.prod(q_shape))
        r_q = qb.reshape(B, *q_shape, H, d)
        # [rel_t | rel_h | rel_w] per head, head-major along the last axis
        # (JAX mvit.py:608-653), cast to the compute dtype
        terms = [_rel_term(r_q, rel_pos, axis, qs, ks, q.dtype)
                 for rel_pos, axis, qs, ks in (
                     (self.rel_pos_t, "t", q_shape[0], k_shape[0]),
                     (self.rel_pos_h, "h", q_shape[1], k_shape[1]),
                     (self.rel_pos_w, "w", q_shape[2], k_shape[2]))]
        rel = torch.cat(terms, dim=-1).reshape(B, qn, -1)
        body = [t.contiguous() for t in (qb, kb, vb, kc, vc, rel)]
        route = self.route
        if route.hl and mattn.hl_supported(kb.shape[1], C, H):
            out_body = mattn.mvit_attention_hl(*body, k_shape, H, scale,
                                               route.delta, route.shift)
        elif route.kt and route.hl and mattn.kt_supported(C, H):
            out_body = mattn.mvit_attention_kt(*body, k_shape, H, scale)
        else:
            fold = lambda t: t.reshape(B, t.shape[1], H, -1).transpose(
                1, 2).reshape(B * H, t.shape[1], -1).contiguous()
            out_body = mattn.mvit_attention(*map(fold, body), k_shape, scale,
                                            route.delta, route.save_probs,
                                            route.shift)
            out_body = out_body.reshape(B, H, qn, d).transpose(1, 2).reshape(
                B, qn, C)
        # the CLS query: one row over the cls-first key set, no bias, a
        # row-max softmax (JAX mvit.py:697-706)
        qc5 = (qc * scale).reshape(B, 1, H, d)
        k5 = k.reshape(B, k.shape[1], H, d)
        v5 = v.reshape(B, v.shape[1], H, d)
        lc = torch.einsum("bqyd,bkyd->byqk", qc5.float(), k5.float())
        pc = torch.softmax(lc, dim=-1).to(v.dtype)
        out_c = torch.einsum("byqk,bkyd->bqyd", pc.float(), v5.float()).to(
            v.dtype).reshape(B, 1, C)
        return torch.cat([out_c, out_body], dim=1)

    def _plain_attention(self, q, k, v, q_shape: Thw, k_shape: Thw,
                         scale: float) -> torch.Tensor:
        """The logits path for blocks the kernels do not take (JAX
        ``mvit.py:764-788``): row-max softmax over [B, H, qN, kN]."""
        B = q.shape[0]
        H = self.num_heads
        split = lambda t: t.reshape(B, t.shape[1], H, -1).transpose(1, 2)
        qh, kh, vh = split(q), split(k), split(v)
        attn = torch.einsum("bhqd,bhkd->bhqk", (qh * scale).float(),
                            kh.float())
        if self.rel_pos_h is not None:
            attn = add_rel_pos_spatial(attn, qh, self.has_cls_embed, q_shape,
                                       k_shape, self.rel_pos_h, self.rel_pos_w)
        if self.rel_pos_t is not None:
            attn = add_rel_pos_temporal(attn, qh, self.has_cls_embed, q_shape,
                                        k_shape, self.rel_pos_t)
        attn = torch.softmax(attn, dim=-1).to(vh.dtype)
        out = torch.einsum("bhqk,bhkd->bqhd", attn.float(), vh.float())
        return out.to(vh.dtype).reshape(B, qh.shape[2], -1)

    def forward(self, x: torch.Tensor, thw: Thw) -> Tuple[torch.Tensor, Thw]:
        scale = (self.dim_out // self.num_heads) ** -0.5
        q, k, v = self.qkv(x).chunk(3, dim=-1)  # [B, N, C] each, head-last
        q, q_shape = self._pool("q", q, thw)
        k, k_shape = self._pool("k", k, thw)
        v, _ = self._pool("v", v, thw)
        use_fused = (self.route.use_pallas and self.rel_pos_h is not None
                     and self.rel_pos_t is not None and self.has_cls_embed
                     and int(np.prod(q_shape)) >= mattn.MIN_FUSED_QN
                     and int(np.prod(k_shape)) <= mattn.MAX_FUSED_KN)
        attend = self._fused_attention if use_fused else self._plain_attention
        out = attend(q, k, v, q_shape, k_shape, scale)
        if self.residual_pooling:
            # residual Q connection (reference :431-435)
            if self.has_cls_embed:
                out = torch.cat([out[:, :1], out[:, 1:] + q[:, 1:]], dim=1)
            else:
                out = out + q
        return self.proj(out), q_shape


class MultiScaleBlock(nn.Module):
    """reference ``attention.py:445-568``.  Stochastic depth masks are drawn
    per sample by :meth:`draw_masks`, before the block, so a block that is
    recomputed for its backward reapplies them."""

    def __init__(self, dim: int, dim_out: int, num_heads: int,
                 input_size: Thw, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, drop_path_rate: float = 0.0,
                 kernel_q=(), kernel_kv=(), stride_q=(), stride_kv=(),
                 mode: str = "conv", has_cls_embed: bool = True,
                 rel_pos_spatial: bool = False,
                 rel_pos_temporal: bool = False,
                 residual_pooling: bool = False,
                 dim_mul_in_att: bool = False,
                 route: MViTRoute = DEFAULT_ROUTE,
                 gelu_stored: bool = False):
        super().__init__()
        self.dim, self.dim_out = dim, dim_out
        self.dim_mul_in_att = dim_mul_in_att
        self.has_cls_embed = has_cls_embed
        self.stride_q = tuple(stride_q)
        att_dim = dim_out if dim_mul_in_att else dim
        self.norm1 = LayerNormFp32(dim, eps=1e-6)
        self.attn = MultiScaleAttention(
            dim, att_dim, input_size, num_heads, qkv_bias, kernel_q,
            kernel_kv, stride_q, stride_kv, mode, has_cls_embed,
            rel_pos_spatial, rel_pos_temporal, residual_pooling, route)
        self.drop_path = DropPath(drop_path_rate)
        self.norm2 = LayerNormFp32(att_dim, eps=1e-6)
        self.mlp = Mlp(att_dim, int(att_dim * mlp_ratio), dim_out,
                       gelu_stored)
        self.proj = Linear(dim, dim_out) if dim != dim_out else None

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)
        if self.proj is not None:
            init_linear(self.proj, generator)

    def draw_masks(self, B: int, device, generator):
        keep = (self.drop_path.draw(B, device, generator),
                self.drop_path.draw(B, device, generator))
        return None if keep[0] is None else keep

    def forward(self, x: torch.Tensor, thw: Thw, keep=None) -> torch.Tensor:
        keep_attn, keep_mlp = keep if keep is not None else (None, None)
        x_norm = self.norm1(x)
        x_block, _ = self.attn(x_norm, thw)
        if self.dim_mul_in_att and self.proj is not None:
            x = self.proj(x_norm)
        if self.stride_q and np.prod(self.stride_q) > 1:
            # pooled skip: MaxPool3d with kernel s + 1 where s > 1
            kernel = [s + 1 if s > 1 else s for s in self.stride_q]
            cls_tok, skip = (x[:, :1], x[:, 1:]) if self.has_cls_embed else (
                None, x)
            B, _, C = skip.shape
            grid = _max_pool_3d(skip.reshape(B, *thw, C), kernel,
                                self.stride_q, [k // 2 for k in kernel])
            skip = grid.reshape(B, -1, C)
            x = skip if cls_tok is None else torch.cat([cls_tok, skip], dim=1)
        x = x + self.drop_path(x_block, keep_attn)
        x_norm2 = self.norm2(x)
        x_mlp = self.mlp(x_norm2)
        if not self.dim_mul_in_att and self.proj is not None:
            x = self.proj(x_norm2)
        return x + self.drop_path(x_mlp, keep_mlp)


class PatchEmbed3D(nn.Module):
    """The 3-D conv stem (reference ``stem_helper.py:290-321``) on
    channels-last video; the bias is added after the conv in the compute
    dtype, as in the JAX package."""

    def __init__(self, in_chans: int, embed_dim: int, kernel, stride,
                 padding):
        super().__init__()
        self.proj = nn.Conv3d(in_chans, embed_dim, tuple(kernel),
                              tuple(stride), tuple(padding))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, H, W, C] -> [B, T', H', W', D]."""
        p = self.proj
        y = F.conv3d(_to_ncdhw(x), p.weight.to(x.dtype), None, p.stride,
                     p.padding)
        return _to_ndhwc(y) + p.bias.to(x.dtype)


class MViTEncoder(nn.Module):
    """MViT-v2 encoder (reference ``mvit.py:30-406``): video
    ``[B, T, H, W, 3]`` in the compute dtype -> the CLS feature
    ``[B, D_final]``.

    With ``remat`` (``TPU.REMAT``) each block runs under
    ``torch.utils.checkpoint`` when gradients are recorded, with JAX's
    fixed MViT policy (:data:`REMAT_NAMES`; JAX ``models/mvit.py:953-963``
    reads no ``REMAT_SAVE_*`` knob): the attention kernels' outputs, their
    row statistics and probabilities and the stored GELU derivative are
    kept, the rest of the block (the pools included) is recomputed for the
    backward.  ``gelu_stored`` picks the MLPs' GELU (``GELU_STORED``, read
    here once by default)."""

    def __init__(self, cfg: MViTConfig, remat: bool = False,
                 gelu_stored: Optional[bool] = None):
        super().__init__()
        if cfg.norm_stem or cfg.use_mean_pooling or not cfg.cls_embed_on:
            raise NotImplementedError(
                "MViT NORM_STEM, USE_MEAN_POOLING and a model without the CLS "
                "token are not ported (no shipped configuration sets them)")
        self.cfg = cfg
        self.remat = remat
        if gelu_stored is None:
            gelu_stored = gelu_stored_from_env()
        plan, patch_dims, final_dim = cfg.block_schedule()
        self.plan, self.patch_dims = plan, tuple(patch_dims)
        D = cfg.embed_dim
        self.patch_embed = PatchEmbed3D(cfg.in_chans, D, cfg.patch_kernel,
                                        cfg.patch_stride, cfg.patch_padding)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        n_sp = patch_dims[1] * patch_dims[2]
        if cfg.use_abs_pos and cfg.sep_pos_embed:
            self.pos_embed_spatial = nn.Parameter(torch.zeros(1, n_sp, D))
            self.pos_embed_temporal = nn.Parameter(
                torch.zeros(1, patch_dims[0], D))
            self.pos_embed_class = nn.Parameter(torch.zeros(1, 1, D))
        elif cfg.use_abs_pos:
            self.pos_embed = nn.Parameter(
                torch.zeros(1, patch_dims[0] * n_sp + 1, D))
        dpr = np.linspace(0, cfg.drop_path_rate, cfg.depth)
        self.blocks = nn.ModuleList([
            MultiScaleBlock(
                dim=spec["dim"], dim_out=spec["dim_out"],
                num_heads=spec["num_heads"], input_size=spec["input_size"],
                mlp_ratio=cfg.mlp_ratio, qkv_bias=cfg.qkv_bias,
                drop_path_rate=float(dpr[i]), kernel_q=spec["kernel_q"],
                kernel_kv=spec["kernel_kv"], stride_q=spec["stride_q"],
                stride_kv=spec["stride_kv"], mode=cfg.mode,
                has_cls_embed=cfg.cls_embed_on,
                rel_pos_spatial=cfg.rel_pos_spatial,
                rel_pos_temporal=cfg.rel_pos_temporal,
                residual_pooling=cfg.residual_pooling,
                dim_mul_in_att=cfg.dim_mul_in_att,
                route=cfg.route, gelu_stored=gelu_stored)
            for i, spec in enumerate(plan)])
        self.norm = LayerNormFp32(final_dim, eps=1e-6)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """Random init of the JAX package: trunc-normal(0.02) for the stem
        kernel, the CLS token, the position embeddings, the pool kernels,
        the rel-pos tables and every linear weight; zero biases; unit norm
        scales."""
        trunc_normal_init(self.patch_embed.proj.weight, 0.02, generator)
        nn.init.zeros_(self.patch_embed.proj.bias)
        for name in ("cls_token", "pos_embed", "pos_embed_spatial",
                     "pos_embed_temporal", "pos_embed_class"):
            p = getattr(self, name, None)
            if p is not None:
                trunc_normal_init(p, 0.02, generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        for m in self.modules():
            if isinstance(m, (nn.LayerNorm, GroupedLayerNorm)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def _abs_pos(self) -> torch.Tensor:
        if not self.cfg.sep_pos_embed:
            return self.pos_embed
        t, hw = self.patch_dims[0], self.pos_embed_spatial.shape[1]
        pe = (self.pos_embed_spatial.repeat(1, t, 1)
              + self.pos_embed_temporal.repeat_interleave(hw, dim=1))
        return torch.cat([self.pos_embed_class, pe], dim=1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c = self.cfg
        B = x.shape[0]
        grid = self.patch_embed(x)
        if list(grid.shape[1:4]) != list(self.patch_dims):
            raise ValueError(f"stem grid {tuple(grid.shape[1:4])} is not the "
                             f"configured {self.patch_dims}")
        tokens = grid.reshape(B, -1, c.embed_dim)
        tokens = torch.cat([self.cls_token.to(x.dtype).expand(
            B, 1, c.embed_dim), tokens], dim=1)
        if c.use_abs_pos:
            tokens = tokens + self._abs_pos().to(x.dtype)
        recompute = self.remat and torch.is_grad_enabled()
        for spec, blk in zip(self.plan, self.blocks):
            thw = tuple(spec["input_size"])
            keep = blk.draw_masks(B, x.device, generator)
            if recompute:
                tokens = checkpoint(blk, tokens, thw, keep,
                                    **remat.checkpoint_kwargs(REMAT_NAMES))
            else:
                tokens = blk(tokens, thw, keep)
        return self.norm(tokens)[:, 0]
