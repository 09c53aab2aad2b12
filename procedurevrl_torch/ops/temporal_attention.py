"""K2: temporal attention of the divided space-time block, read in place
from the time-major stream (``csrc/temporal_attention.cu``).

Replaces the TPU kernels of ``procedurevrl_tpu/ops/pallas_attention.py``:
``_temporal_fwd_kernel`` (K2f, the forward of ``flash_attention_temporal``)
and ``_temporal_bwd_kernel`` (K2b, its backward), and on
``TEMPORAL_BATCHED=1`` ``_temporal_fwd_kernel_v3`` (K2v3f) and
``_temporal_bwd_kernel_v3`` (K2v3b).  The JAX forwards also write "compact"
probabilities laid out for the TPU's matrix unit, which only their
backwards read.  K2f writes none: K2b recomputes them from q and k with the
forward's own device function (they are 8 x 8 per position and head), so
K2f is the same kernel in evaluation and training.  The v3 pair keeps the
TPU's residual: K2v3f writes p ``[B, N, H, T, T]`` in the value dtype under
grad (and nothing in evaluation), and K2v3b reads it.

Each wrapper launches its CUDA kernel for a CUDA tensor and takes the plain
version only for a CPU tensor.  K2f, K2b and K2v3f take the softmax shift
``TEMPORAL_SHIFT`` as ``shift`` (``clamp`` exp(min(s, 80)), ``max`` exp(s
- m) with m the max over the row's T keys, JAX ``_compact_exp``'s per-head
max, ``none`` exp(s)); K2v3b reads p and takes none.
:func:`temporal_attention_autograd` is what
the model calls: under grad it goes through :class:`TemporalAttention` (K2f
forward, K2b backward), or :class:`TemporalAttentionV3` on the batched
route.  In bf16, K2f and K2b run on one persistent kernel that the TMA
unit feeds and drains (16-byte aligned tensors; frames and positions past
the edges are its zero fill), and share their tensor-core arithmetic with
K2v3, so K2f's output is K2v3f's bit for bit; fp32 runs scalar kernels.
K2's kernels take head dim 64; every other head dim runs on the
key-tiled pair of ``ops/flash_attention.py`` on either route (its forward
saves the row sums l and its backward recomputes p, where K2v3 saves p: a
storage difference of the same function), chosen on the shape before any
launch.  Bounds, design and the H100 numbers: see the source note and
``PERF.md``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from procedurevrl_torch.ops import _build
from procedurevrl_torch.ops import flash_attention as fa
from procedurevrl_torch.ops import remat
from procedurevrl_torch.ops.attention_route import (
    DEFAULT_ROUTE, AttentionRoute, shift_code, shifted_exp,
)

KERNEL = "temporal_attention_fwd"
KERNEL_BWD = "temporal_attention_bwd"
KERNEL_V3 = "temporal_attention_v3_fwd"
KERNEL_V3_BWD = "temporal_attention_v3_bwd"
HEAD_DIM = 64  # the head dim of K2's own kernels
MAX_T = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _split(qkv: torch.Tensor, num_heads: int):
    """q, k, v [B, T, N, H, d] of the fused stream."""
    b, t, n, c3 = qkv.shape
    return qkv.view(b, t, n, 3, num_heads, c3 // 3 // num_heads).unbind(dim=3)


def _probs(q: torch.Tensor, k: torch.Tensor, scale: float,
           dtype: torch.dtype, shift: str = "clamp") -> torch.Tensor:
    """fp32 logits and softmax over T under ``shift`` (``TEMPORAL_SHIFT``;
    JAX ``_compact_exp``'s per-head max is the row max over the T keys),
    cast to ``dtype``: [B, N, H, T, T]."""
    s = torch.einsum("btnhd,bsnhd->bnhts", q.float(), k.float()) * scale
    p = shifted_exp(s, shift)
    return (p / p.sum(dim=-1, keepdim=True)).to(dtype)


def temporal_attention_v3_fwd_plain(qkv: torch.Tensor, num_heads: int,
                                    scale: float, shift: str = "clamp"
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2v3f (K2f's arithmetic).

    qkv [B, T, N, 3C] -> (out [B, T, N, C], p [B, N, H, T, T]): for every
    (b, n, head) the T queries attend over the T keys; logits and softmax
    in fp32 under the shift (clamp, max or none), probabilities cast to the
    value dtype before the fp32-accumulated PV product."""
    b, t, n, c3 = qkv.shape
    q, k, v = _split(qkv, num_heads)
    p = _probs(q, k, scale, v.dtype, shift)
    o = torch.einsum("bnhts,bsnhd->btnhd", p.float(), v.float())
    return o.to(qkv.dtype).reshape(b, t, n, c3 // 3), p.contiguous()


def temporal_attention_plain(qkv: torch.Tensor, num_heads: int,
                             scale: float, shift: str = "clamp"
                             ) -> torch.Tensor:
    """Plain PyTorch version of K2f: the output of
    :func:`temporal_attention_v3_fwd_plain`."""
    return temporal_attention_v3_fwd_plain(qkv, num_heads, scale, shift)[0]


def temporal_attention_v3_bwd_plain(qkv: torch.Tensor, probs: torch.Tensor,
                                    g: torch.Tensor, num_heads: int,
                                    scale: float) -> torch.Tensor:
    """Plain PyTorch version of K2v3b, the backward written out from the
    saved p [B, N, H, T(query), T(key)] (value dtype).

    qkv [B, T, N, 3C], g [B, T, N, C] -> dqkv [B, T, N, 3C]: dp = g v^T in
    fp32; ds = p (dp - rowsum(dp p)) cast to the value dtype;
    dq = scale ds k, dk = scale ds^T q, dv = p^T g.  Like the kernel it is
    the softmax jacobian, ignoring the clamp (exact under ``max`` and
    ``none``)."""
    b, t, n, c3 = qkv.shape
    dt = qkv.dtype
    q, k, v = _split(qkv, num_heads)
    p = probs.float()
    gf = g.view(b, t, n, num_heads, -1).float()
    dp = torch.einsum("btnhd,bsnhd->bnhts", gf, v.float())
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).float()
    dq = torch.einsum("bnhts,bsnhd->btnhd", ds, k.float()) * scale
    dk = torch.einsum("bnhts,btnhd->bsnhd", ds, q.float()) * scale
    dv = torch.einsum("bnhts,btnhd->bsnhd", p, gf)
    return torch.stack([dq, dk, dv], dim=3).to(dt).reshape(b, t, n, c3)


def temporal_attention_bwd_plain(qkv: torch.Tensor, g: torch.Tensor,
                                 num_heads: int, scale: float,
                                 shift: str = "clamp") -> torch.Tensor:
    """Plain PyTorch version of K2b: K2v3b's backward on p recomputed as
    the forward computes it."""
    q, k, _ = _split(qkv, num_heads)
    return temporal_attention_v3_bwd_plain(
        qkv, _probs(q, k, scale, qkv.dtype, shift), g, num_heads, scale)


def _check(qkv: torch.Tensor, num_heads: int) -> None:
    if qkv.dim() != 4 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"temporal_attention: qkv {tuple(qkv.shape)} is not "
                         f"[B, T, N, 3C] for {num_heads} heads")


def _check_kernel(tensors, num_heads: int) -> None:
    """What both K2 kernels need of their CUDA inputs."""
    qkv = tensors[0]
    if qkv.device.type != "cuda":
        raise ValueError(f"temporal_attention: no kernel for device "
                         f"{qkv.device}")
    t, c3 = qkv.shape[1], qkv.shape[3]
    if qkv.dtype not in _DTYPES:
        raise ValueError(f"temporal_attention: dtype {qkv.dtype} not "
                         "supported")
    if c3 // 3 // num_heads != HEAD_DIM or not 1 <= t <= MAX_T:
        raise ValueError(f"temporal_attention: kernel needs head dim "
                         f"{HEAD_DIM} and 1 <= T <= {MAX_T}")
    for x in tensors:
        if x.device != qkv.device or x.dtype != qkv.dtype:
            raise ValueError("temporal_attention: inputs differ in dtype or "
                             "device")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("temporal_attention: inputs must be contiguous "
                             "and 16-byte aligned")


def _launch(fn: str, qkv: torch.Tensor, *args) -> None:
    lib = _build.load("temporal_attention")
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    _build.check(rc, fn)
    _build.count_launch(fn)


def temporal_attention(qkv: torch.Tensor, num_heads: int,
                       scale: float, shift: str = "clamp") -> torch.Tensor:
    """K2f: attention over axis 1 of qkv [B, T, N, 3C] (float32 or
    bfloat16, contiguous, head dim 64, T <= 16) -> [B, T, N, C], under the
    softmax shift ``shift`` (``TEMPORAL_SHIFT``: clamp, max, none)."""
    _check(qkv, num_heads)
    code = shift_code(shift)
    if qkv.device.type == "cpu":
        return temporal_attention_plain(qkv, num_heads, scale, shift)
    _check_kernel((qkv,), num_heads)
    b, t, n, c3 = qkv.shape
    out = torch.empty((b, t, n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    _launch(KERNEL, qkv, qkv.data_ptr(), out.data_ptr(), b, t, n, num_heads,
            _DTYPES[qkv.dtype], code, float(scale))
    return out


def temporal_attention_bwd(qkv: torch.Tensor, g: torch.Tensor,
                           num_heads: int, scale: float,
                           shift: str = "clamp") -> torch.Tensor:
    """K2b: dqkv [B, T, N, 3C] from qkv and the output gradient
    g [B, T, N, C], p recomputed under the forward's shift."""
    _check(qkv, num_heads)
    code = shift_code(shift)
    b, t, n, c3 = qkv.shape
    if g.shape != (b, t, n, c3 // 3):
        raise ValueError(f"temporal_attention_bwd: gradient {tuple(g.shape)} "
                         f"does not fit qkv {tuple(qkv.shape)}")
    if qkv.device.type == "cpu":
        return temporal_attention_bwd_plain(qkv, g, num_heads, scale, shift)
    _check_kernel((qkv, g), num_heads)
    dqkv = torch.empty_like(qkv)
    _launch(KERNEL_BWD, qkv, qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), b,
            t, n, num_heads, _DTYPES[qkv.dtype], code, float(scale))
    return dqkv


def temporal_attention_v3(qkv: torch.Tensor, num_heads: int, scale: float,
                          shift: str = "clamp", save_probs: bool = True
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K2v3f: (out [B, T, N, C], p [B, N, H, T, T] or None without
    ``save_probs``) from qkv [B, T, N, 3C] (float32 or bfloat16, T <= 16,
    contiguous, head dim 64), under the softmax shift ``shift``."""
    _check(qkv, num_heads)
    code = shift_code(shift)
    if qkv.device.type == "cpu":
        out, p = temporal_attention_v3_fwd_plain(qkv, num_heads, scale, shift)
        return out, p if save_probs else None
    _check_kernel((qkv,), num_heads)
    b, t, n, c3 = qkv.shape
    out = torch.empty((b, t, n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    probs = (torch.empty((b, n, num_heads, t, t), dtype=qkv.dtype,
                         device=qkv.device) if save_probs else None)
    _launch(KERNEL_V3, qkv, qkv.data_ptr(), out.data_ptr(),
            None if probs is None else probs.data_ptr(), b, t, n, num_heads,
            _DTYPES[qkv.dtype], code, float(scale))
    return out, probs


def temporal_attention_v3_bwd(qkv: torch.Tensor, probs: torch.Tensor,
                              g: torch.Tensor, num_heads: int,
                              scale: float) -> torch.Tensor:
    """K2v3b: dqkv [B, T, N, 3C] from qkv, K2v3f's p [B, N, H, T, T] and
    the output gradient g [B, T, N, C]."""
    _check(qkv, num_heads)
    b, t, n, c3 = qkv.shape
    if g.shape != (b, t, n, c3 // 3):
        raise ValueError(f"temporal_attention_v3_bwd: gradient "
                         f"{tuple(g.shape)} does not fit qkv "
                         f"{tuple(qkv.shape)}")
    if probs.shape != (b, n, num_heads, t, t):
        raise ValueError(f"temporal_attention_v3_bwd: probs "
                         f"{tuple(probs.shape)} is not "
                         f"[{b}, {n}, {num_heads}, {t}, {t}]")
    if qkv.device.type == "cpu":
        return temporal_attention_v3_bwd_plain(qkv, probs, g, num_heads, scale)
    _check_kernel((qkv, probs, g), num_heads)
    dqkv = torch.empty_like(qkv)
    _launch(KERNEL_V3_BWD, qkv, qkv.data_ptr(), probs.data_ptr(),
            g.data_ptr(), dqkv.data_ptr(), b, t, n, num_heads,
            _DTYPES[qkv.dtype], float(scale))
    return dqkv


class TemporalAttention(torch.autograd.Function):
    """K2 under autograd: K2f forward (saves qkv), K2b backward, both under
    ``shift``."""

    @staticmethod
    def forward(ctx, qkv, num_heads: int, scale: float, shift: str = "clamp"):
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.scale, ctx.shift = num_heads, scale, shift
        return remat.kept("flash_attn_out", temporal_attention, qkv,
                          num_heads, scale, shift)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return (temporal_attention_bwd(qkv, g.contiguous(), ctx.num_heads,
                                       ctx.scale, ctx.shift), None, None, None)


class TemporalAttentionV3(torch.autograd.Function):
    """K2 under autograd on ``TEMPORAL_BATCHED=1``: K2v3f forward (saves qkv
    and p), K2v3b backward."""

    @staticmethod
    def forward(ctx, qkv, num_heads: int, scale: float, shift: str = "clamp"):
        out, probs = remat.kept("flash_attn_out", temporal_attention_v3, qkv,
                                num_heads, scale, shift=shift)
        ctx.save_for_backward(qkv, probs)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, probs = ctx.saved_tensors
        return (temporal_attention_v3_bwd(qkv, probs, g.contiguous(),
                                          ctx.num_heads, ctx.scale),
                None, None, None)


def temporal_attention_autograd(qkv: torch.Tensor, num_heads: int,
                                scale: float,
                                route: AttentionRoute = DEFAULT_ROUTE
                                ) -> torch.Tensor:
    """The model's entry: when grad is enabled and qkv requires it,
    :class:`TemporalAttention` (K2f + K2b), or :class:`TemporalAttentionV3`
    (K2v3f + K2v3b) with ``route.temporal_batched``; otherwise K2f, or
    K2v3f without its store (JAX takes the v3 forward for the primal too).
    A head dim other than 64 takes the key-tiled pair on either route.
    Every kernel takes ``route.temporal_shift``."""
    shift = route.temporal_shift
    if qkv.shape[3] // 3 // num_heads != HEAD_DIM:
        return fa.flash_attention_temporal_autograd(qkv, num_heads, scale,
                                                    shift)
    grad = torch.is_grad_enabled() and qkv.requires_grad
    if route.temporal_batched:
        if grad:
            return TemporalAttentionV3.apply(qkv, num_heads, scale, shift)
        return temporal_attention_v3(qkv, num_heads, scale, shift,
                                     save_probs=False)[0]
    if grad:
        return TemporalAttention.apply(qkv, num_heads, scale, shift)
    return temporal_attention(qkv, num_heads, scale, shift)
