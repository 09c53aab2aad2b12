"""K1: spatial attention of the divided space-time block, with the CLS token
as a separate stream (``csrc/spatial_attention.cu``).

Replaces the TPU kernels of ``procedurevrl_tpu/ops/pallas_attention.py``:
``_fwd_cls_qkv_kernel`` (K1f, the forward), ``_fwd_cls_qkv_kernel_sp``
(K1sp, the forward under grad that also saves the probabilities),
``_bwd_cls_qkv_kernel_sp`` (K1b, the backward from them), ``_pipe_kernel``
(K1p, the pipelined forward of ``SPATIAL_PIPE=1``), ``_bwd_cls_qkv_kernel``
(K1br, the backward that recomputes the probabilities) and
``_bwd_cls_qkv_kernel_sp_delta`` (K1bd, the saved-probability backward with
delta_i = g_i . o_i, ``SPATIAL_DELTA=1``), the pieces of
``flash_attention_cls_qkv``.  The JAX kernels take their qkv columns in a
per-head-group window order that exists only for the TPU's 128-lane tiles;
the port keeps the standard ``[q | k | v]`` column order of the projection.

The saved probabilities are ``[BT, H, L, LS]`` in the value dtype: L = N + 1
rows and columns in the order [patches; CLS], LS = L rounded up to 8 (rows
16-byte aligned), columns L..LS-1 zero.

Each wrapper launches its CUDA kernel for a CUDA tensor and takes the plain
version only for a CPU tensor.  :func:`spatial_attention_autograd` is what
the model calls, on the route of ``ops/attention_route.py`` and under its
``SPATIAL_SHIFT`` (every forward and K1br take ``shift``: ``clamp``
exp(min(s, 80)), ``max`` exp(s - rowmax), ``none`` exp(s); K1b and K1bd
read p and take none): under grad
through :class:`SpatialAttention` (K1sp + K1b, the default),
:class:`SpatialAttentionDelta` (K1sp + K1bd) or
:class:`SpatialAttentionRecompute` (K1f or K1p + K1br), otherwise straight
to K1f or K1p; frames of more than 207 tokens, and every head dim other
than 64, go to the key-tiled pair of ``ops/flash_attention.py`` on every
route (:func:`on_pair`), which recomputes the probabilities where the JAX
package saves them (a storage difference of the same function).  Bounds,
design and the H100 numbers: see the source note and ``PERF.md``.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch

from procedurevrl_torch.ops import _build
from procedurevrl_torch.ops import flash_attention as fa
from procedurevrl_torch.ops.attention_route import (
    DEFAULT_ROUTE, AttentionRoute, shift_code, shifted_exp,
)

KERNEL = "spatial_attention_fwd"
KERNEL_PROBS = "spatial_attention_fwd_probs"
KERNEL_BWD = "spatial_attention_bwd"
KERNEL_PIPE = "spatial_attention_fwd_pipe"
KERNEL_BWD_RECOMPUTE = "spatial_attention_bwd_recompute"
KERNEL_BWD_DELTA = "spatial_attention_bwd_delta"
HEAD_DIM = 64  # the head dim of K1's own kernels
# n + 1 tokens per frame, every K1 kernel (the backward's shared-memory
# tile); longer frames, and other head dims, take the key-tiled pair of
# ops/flash_attention.py on every route
MAX_LEN = 208
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The bf16 forward's ring (K1f, K1sp and K1p: ``fwd_shape`` and
# ``fwd_depth`` of the source), written out here so that the CPU tests hold
# the rule at every shape the kernels take
MAX_SMEM = 232448  # the shared memory of one CTA on an H100, bytes
MAX_DEPTH = 8      # stages of a ring, at most
FWD_DEPTH = 2      # the stages K1f and K1sp ask for


def probs_stride(seq_len: int) -> int:
    """Row stride of the saved probabilities: ``seq_len`` rounded up to 8."""
    return (seq_len + 7) // 8 * 8


def fwd_geometry(n: int, save_probs: bool) -> Tuple[int, int, int, int]:
    """(LP, warpgroups, stage bytes, extra bytes) of the bf16 forward at
    N tokens per frame (+ CLS): the padded length LP (64 to L = 64, else
    ``MAX_LEN``), the computing warpgroups of a CTA (one 64-row query tile
    each at LP = 64, two sharing four tiles at 208; a copying warpgroup
    beside them), one ring stage (q, k and v of an item, LP x 64 bf16 each) and
    the bytes beside the ring: for K1sp the p staging tiles (64 x LP bf16
    per warpgroup), and the ring's full and empty mbarriers (8 bytes each,
    ``MAX_DEPTH`` of each)."""
    lp = 64 if n + 1 <= 64 else MAX_LEN
    wgs = 1 if lp == 64 else 2
    staging = wgs * 64 * lp * 2 if save_probs else 0
    return lp, wgs, 3 * lp * HEAD_DIM * 2, staging + 2 * MAX_DEPTH * 8


def ring_depth(n: int, nbuf: int, save_probs: bool = False) -> int:
    """The stages the bf16 forward runs for a request of ``nbuf`` (K1p's
    ``SPATIAL_PIPE_NBUF``; K1f and K1sp ask for ``FWD_DEPTH``): at least 1,
    at most what fits beside the staging tiles in ``MAX_SMEM`` and
    ``MAX_DEPTH``; 0 where K1's kernels take no such frame."""
    if not 1 <= n < MAX_LEN:
        return 0
    _, _, stage, extra = fwd_geometry(n, save_probs)
    return min(max(nbuf, 1), (MAX_SMEM - extra) // stage, MAX_DEPTH)


def _split_heads(qkv: torch.Tensor, qkv_c: torch.Tensor, num_heads: int):
    """q, k, v [BT, L, H, d] of the [patches; CLS] sequence."""
    bt, n, c3 = qkv.shape
    d = c3 // 3 // num_heads
    x = torch.cat([qkv, qkv_c], dim=1).view(bt, n + 1, 3, num_heads, d)
    return x.unbind(dim=2)


def _probs(q: torch.Tensor, k: torch.Tensor, scale: float, dtype: torch.dtype,
           shift: str = "clamp") -> torch.Tensor:
    """fp32 logits and softmax under ``shift`` (``SPATIAL_SHIFT``), cast to
    ``dtype``: [BT, H, L, L]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = shifted_exp(s, shift)
    return (p / p.sum(dim=-1, keepdim=True)).to(dtype)


def spatial_attention_fwd_probs_plain(qkv: torch.Tensor, qkv_c: torch.Tensor,
                                      num_heads: int, scale: float,
                                      shift: str = "clamp"
                                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """Plain PyTorch version of K1sp (same arithmetic as K1f).

    qkv [BT, N, 3C], qkv_c [BT, 1, 3C] -> (out [BT, N, C], out_c [BT, 1, C],
    probs [BT, H, N + 1, LS]).  Every query of [patches; CLS] attends over
    the same N+1 keys; logits and softmax in fp32 under the shift (clamp,
    max or none), probabilities cast to the value dtype before the
    fp32-accumulated PV product."""
    bt, n, c3 = qkv.shape
    c = c3 // 3
    q, k, v = _split_heads(qkv, qkv_c, num_heads)
    p = _probs(q, k, scale, v.dtype, shift)
    o = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    o = o.to(qkv.dtype).reshape(bt, n + 1, c)
    pad = probs_stride(n + 1) - (n + 1)
    probs = torch.nn.functional.pad(p, (0, pad))
    return o[:, :n].contiguous(), o[:, n:].contiguous(), probs


def spatial_attention_plain(qkv: torch.Tensor, qkv_c: torch.Tensor,
                            num_heads: int, scale: float,
                            shift: str = "clamp"
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1f: the outputs of
    :func:`spatial_attention_fwd_probs_plain`."""
    out, out_c, _ = spatial_attention_fwd_probs_plain(qkv, qkv_c, num_heads,
                                                      scale, shift)
    return out, out_c


def spatial_attention_pipe_plain(qkv: torch.Tensor, qkv_c: torch.Tensor,
                                 num_heads: int, scale: float,
                                 shift: str = "clamp"
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1p, whose contract and numerics are K1f's
    (the pipeline only reorders the copies)."""
    return spatial_attention_plain(qkv, qkv_c, num_heads, scale, shift)


def _bwd_from_probs(qkv: torch.Tensor, qkv_c: torch.Tensor, p: torch.Tensor,
                    g: torch.Tensor, gc: torch.Tensor, num_heads: int,
                    scale: float, delta: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward written out from p [BT, H, L, L] (value dtype): dv =
    p^T g; dp = g v^T in fp32; ds = p (dp - D) in fp32, cast to the value
    dtype, with D the jacobian row sums rowsum(dp p) or the given delta
    [BT, H, L, 1]; dq = scale ds k, dk = scale ds^T q.  Returns (dqkv
    [BT, N, 3C], dqkv_c [BT, 1, 3C]) in ``[q | k | v]`` columns.  Like the
    kernels it is the softmax jacobian, ignoring the clamp (exact under
    ``max`` and ``none``)."""
    bt, n, c3 = qkv.shape
    L = n + 1
    dt = qkv.dtype
    q, k, v = (t.float() for t in _split_heads(qkv, qkv_c, num_heads))
    gf = torch.cat([g, gc], dim=1).view(bt, L, num_heads, -1).float()
    p = p.float()
    dv = torch.einsum("bhij,bihd->bjhd", p, gf)
    dp = torch.einsum("bihd,bjhd->bhij", gf, v)
    d = (dp * p).sum(dim=-1, keepdim=True) if delta is None else delta
    ds = (p * (dp - d)).to(dt).float()
    dq = torch.einsum("bhij,bjhd->bihd", ds, k) * scale
    dk = torch.einsum("bhij,bihd->bjhd", ds, q) * scale
    dx = torch.stack([dq, dk, dv], dim=2).to(dt).reshape(bt, L, c3)
    return dx[:, :n].contiguous(), dx[:, n:].contiguous()


def spatial_attention_bwd_plain(qkv: torch.Tensor, qkv_c: torch.Tensor,
                                probs: torch.Tensor, g: torch.Tensor,
                                gc: torch.Tensor, num_heads: int, scale: float
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1b: the backward from the saved
    probabilities p (value dtype) and the output gradients g [BT, N, C],
    gc [BT, 1, C], with D_i = rowsum(dp p) (see :func:`_bwd_from_probs`)."""
    L = qkv.shape[1] + 1
    return _bwd_from_probs(qkv, qkv_c, probs[..., :L], g, gc, num_heads, scale)


def spatial_attention_bwd_recompute_plain(qkv: torch.Tensor,
                                          qkv_c: torch.Tensor,
                                          g: torch.Tensor, gc: torch.Tensor,
                                          num_heads: int, scale: float,
                                          shift: str = "clamp"
                                          ) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Plain PyTorch version of K1br: K1b on the probabilities recomputed
    as the forward computes them (fp32 logits and the shift's softmax, cast
    to the value dtype)."""
    q, k, _ = _split_heads(qkv, qkv_c, num_heads)
    return _bwd_from_probs(qkv, qkv_c, _probs(q, k, scale, qkv.dtype, shift),
                           g, gc, num_heads, scale)


def spatial_attention_bwd_delta_plain(qkv: torch.Tensor, qkv_c: torch.Tensor,
                                      probs: torch.Tensor, out: torch.Tensor,
                                      out_c: torch.Tensor, g: torch.Tensor,
                                      gc: torch.Tensor, num_heads: int,
                                      scale: float
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1bd: K1b with D_i replaced by
    delta_i = sum_d g_id o_id in fp32, o the forward's outputs
    out [BT, N, C], out_c [BT, 1, C] (JAX ``pallas_attention.py:1108-1111``)."""
    bt, n, _ = qkv.shape
    L = n + 1
    gf = torch.cat([g, gc], dim=1).view(bt, L, num_heads, -1).float()
    of = torch.cat([out, out_c], dim=1).view(bt, L, num_heads, -1).float()
    delta = (gf * of).sum(dim=-1).transpose(1, 2)[..., None]  # [BT, H, L, 1]
    return _bwd_from_probs(qkv, qkv_c, probs[..., :L], g, gc, num_heads,
                           scale, delta)


def _check(qkv: torch.Tensor, qkv_c: torch.Tensor, num_heads: int) -> None:
    if qkv.dim() != 3 or qkv_c.dim() != 3:
        raise ValueError("spatial_attention: qkv must be [BT, N, 3C] and "
                         "qkv_c [BT, 1, 3C]")
    bt, n, c3 = qkv.shape
    if c3 % (3 * num_heads) or qkv_c.shape != (bt, 1, c3):
        raise ValueError(f"spatial_attention: shapes {tuple(qkv.shape)} / "
                         f"{tuple(qkv_c.shape)} do not fit {num_heads} heads")
    if qkv.dtype != qkv_c.dtype or qkv.device != qkv_c.device:
        raise ValueError("spatial_attention: qkv and qkv_c differ in dtype "
                         "or device")


def _check_rows(name: str, qkv: torch.Tensor, x: torch.Tensor,
                x_c: torch.Tensor) -> None:
    """x [BT, N, C], x_c [BT, 1, C] beside qkv [BT, N, 3C]."""
    bt, n, c3 = qkv.shape
    if x.shape != (bt, n, c3 // 3) or x_c.shape != (bt, 1, c3 // 3):
        raise ValueError(f"{name}: {tuple(x.shape)} / {tuple(x_c.shape)} do "
                         f"not fit qkv {tuple(qkv.shape)}")


def _check_probs(name: str, qkv: torch.Tensor, probs: torch.Tensor,
                 num_heads: int) -> None:
    bt, n, _ = qkv.shape
    L = n + 1
    if probs.shape != (bt, num_heads, L, probs_stride(L)):
        raise ValueError(f"{name}: probs {tuple(probs.shape)} is not "
                         f"[{bt}, {num_heads}, {L}, {probs_stride(L)}]")


def _check_kernel(tensors, num_heads: int, max_len: int) -> None:
    """What every K1 kernel needs of its CUDA inputs."""
    qkv = tensors[0]
    if qkv.device.type != "cuda":
        raise ValueError(f"spatial_attention: no kernel for device "
                         f"{qkv.device}")
    bt, n, c3 = qkv.shape
    if qkv.dtype not in _DTYPES:
        raise ValueError(f"spatial_attention: dtype {qkv.dtype} not supported")
    if c3 // 3 // num_heads != HEAD_DIM or n + 1 > max_len:
        raise ValueError(f"spatial_attention: kernel needs head dim "
                         f"{HEAD_DIM} and N + 1 <= {max_len}")
    for t in tensors:
        if t.device != qkv.device or t.dtype != qkv.dtype:
            raise ValueError("spatial_attention: inputs differ in dtype or "
                             "device")
        if not t.is_contiguous():
            raise ValueError("spatial_attention: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("spatial_attention: inputs must be 16-byte "
                             "aligned")


def _launch(fn: str, kernel: str, qkv: torch.Tensor, *args) -> None:
    lib = _build.load("spatial_attention")
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    _build.check(rc, kernel)
    _build.count_launch(kernel)


def _outputs(qkv: torch.Tensor):
    bt, n, c3 = qkv.shape
    c = c3 // 3
    return (torch.empty((bt, n, c), dtype=qkv.dtype, device=qkv.device),
            torch.empty((bt, 1, c), dtype=qkv.dtype, device=qkv.device))


def spatial_attention(qkv: torch.Tensor, qkv_c: torch.Tensor, num_heads: int,
                      scale: float, shift: str = "clamp"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1f: CLS-split spatial attention on the fused qkv projection.

    qkv [BT, N, 3C], qkv_c [BT, 1, 3C] (float32 or bfloat16, contiguous,
    head dim 64, N + 1 <= 208) -> (frame_out [BT, N, C], cls_out [BT, 1, C]),
    under the softmax shift ``shift`` (``SPATIAL_SHIFT``: clamp, max, none).
    """
    _check(qkv, qkv_c, num_heads)
    code = shift_code(shift)
    if qkv.device.type == "cpu":
        return spatial_attention_plain(qkv, qkv_c, num_heads, scale, shift)
    _check_kernel((qkv, qkv_c), num_heads, MAX_LEN)
    bt, n, _ = qkv.shape
    out, out_c = _outputs(qkv)
    _launch(KERNEL, KERNEL, qkv, qkv.data_ptr(), qkv_c.data_ptr(),
            out.data_ptr(), out_c.data_ptr(), bt, n, num_heads,
            _DTYPES[qkv.dtype], code, float(scale))
    return out, out_c


def pipe_depth(n: int, dtype: torch.dtype, nbuf: int) -> int:
    """The ring depth K1p runs at N tokens per frame (+ CLS) for a
    requested ``nbuf``: at least 1, at most what fits in shared memory (the
    kernel's own rule, asked of the built library; needs the card; in bf16
    it is :func:`ring_depth`)."""
    return _build.load("spatial_attention").spatial_attention_pipe_depth(
        n, _DTYPES[dtype], nbuf)


def spatial_attention_pipe(qkv: torch.Tensor, qkv_c: torch.Tensor,
                           num_heads: int, scale: float, nbuf: int = 3,
                           shift: str = "clamp"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1p: K1f's contract through persistent CTAs and a cp.async ring
    that asks for ``nbuf`` stages (``SPATIAL_PIPE_NBUF``; in bf16 K1f's
    kernel with that ring, so its outputs equal K1f's bit for bit)."""
    _check(qkv, qkv_c, num_heads)
    code = shift_code(shift)
    if nbuf < 1:
        raise ValueError(f"spatial_attention_pipe: nbuf {nbuf} < 1")
    if qkv.device.type == "cpu":
        return spatial_attention_pipe_plain(qkv, qkv_c, num_heads, scale,
                                            shift)
    _check_kernel((qkv, qkv_c), num_heads, MAX_LEN)
    bt, n, _ = qkv.shape
    out, out_c = _outputs(qkv)
    _launch(KERNEL_PIPE, KERNEL_PIPE, qkv, qkv.data_ptr(), qkv_c.data_ptr(),
            out.data_ptr(), out_c.data_ptr(), bt, n, num_heads,
            _DTYPES[qkv.dtype], int(nbuf), code, float(scale))
    return out, out_c


def spatial_attention_fwd_probs(qkv: torch.Tensor, qkv_c: torch.Tensor,
                                num_heads: int, scale: float,
                                shift: str = "clamp"
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """K1sp: K1f that also returns the probabilities [BT, H, N + 1, LS]."""
    _check(qkv, qkv_c, num_heads)
    code = shift_code(shift)
    if qkv.device.type == "cpu":
        return spatial_attention_fwd_probs_plain(qkv, qkv_c, num_heads, scale,
                                                 shift)
    _check_kernel((qkv, qkv_c), num_heads, MAX_LEN)
    bt, n, _ = qkv.shape
    out, out_c = _outputs(qkv)
    probs = torch.empty((bt, num_heads, n + 1, probs_stride(n + 1)),
                        dtype=qkv.dtype, device=qkv.device)
    _launch(KERNEL_PROBS, KERNEL_PROBS, qkv, qkv.data_ptr(), qkv_c.data_ptr(),
            out.data_ptr(), out_c.data_ptr(), probs.data_ptr(), bt, n,
            num_heads, _DTYPES[qkv.dtype], code, float(scale))
    return out, out_c, probs


def spatial_attention_bwd(qkv: torch.Tensor, qkv_c: torch.Tensor,
                          probs: torch.Tensor, g: torch.Tensor,
                          gc: torch.Tensor, num_heads: int, scale: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1b: (dqkv [BT, N, 3C], dqkv_c [BT, 1, 3C]) from the K1sp
    probabilities and the output gradients g [BT, N, C], gc [BT, 1, C]
    (N + 1 <= 208 on the card)."""
    _check(qkv, qkv_c, num_heads)
    _check_probs("spatial_attention_bwd", qkv, probs, num_heads)
    _check_rows("spatial_attention_bwd: gradients", qkv, g, gc)
    if qkv.device.type == "cpu":
        return spatial_attention_bwd_plain(qkv, qkv_c, probs, g, gc,
                                           num_heads, scale)
    _check_kernel((qkv, qkv_c, probs, g, gc), num_heads, MAX_LEN)
    bt, n, _ = qkv.shape
    dqkv = torch.empty_like(qkv)
    dqkv_c = torch.empty_like(qkv_c)
    _launch(KERNEL_BWD, KERNEL_BWD, qkv, qkv.data_ptr(), qkv_c.data_ptr(),
            probs.data_ptr(), g.data_ptr(), gc.data_ptr(), dqkv.data_ptr(),
            dqkv_c.data_ptr(), bt, n, num_heads, _DTYPES[qkv.dtype],
            float(scale))
    return dqkv, dqkv_c


def spatial_attention_bwd_recompute(qkv: torch.Tensor, qkv_c: torch.Tensor,
                                    g: torch.Tensor, gc: torch.Tensor,
                                    num_heads: int, scale: float,
                                    shift: str = "clamp"
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1br: K1b's outputs with the probabilities recomputed from qkv
    under the forward's shift (N + 1 <= 208 on the card)."""
    _check(qkv, qkv_c, num_heads)
    _check_rows("spatial_attention_bwd_recompute: gradients", qkv, g, gc)
    code = shift_code(shift)
    if qkv.device.type == "cpu":
        return spatial_attention_bwd_recompute_plain(qkv, qkv_c, g, gc,
                                                     num_heads, scale, shift)
    _check_kernel((qkv, qkv_c, g, gc), num_heads, MAX_LEN)
    bt, n, _ = qkv.shape
    dqkv = torch.empty_like(qkv)
    dqkv_c = torch.empty_like(qkv_c)
    # the fp32 path keeps its recomputed rows in device memory
    scratch = (torch.empty((bt, num_heads, n + 1, probs_stride(n + 1)),
                           dtype=torch.float32, device=qkv.device)
               if qkv.dtype == torch.float32 else None)
    _launch(KERNEL_BWD_RECOMPUTE, KERNEL_BWD_RECOMPUTE, qkv, qkv.data_ptr(),
            qkv_c.data_ptr(), g.data_ptr(), gc.data_ptr(), dqkv.data_ptr(),
            dqkv_c.data_ptr(), None if scratch is None else scratch.data_ptr(),
            bt, n, num_heads, _DTYPES[qkv.dtype], code, float(scale))
    return dqkv, dqkv_c


def spatial_attention_bwd_delta(qkv: torch.Tensor, qkv_c: torch.Tensor,
                                probs: torch.Tensor, out: torch.Tensor,
                                out_c: torch.Tensor, g: torch.Tensor,
                                gc: torch.Tensor, num_heads: int, scale: float
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1bd: K1b with delta_i = g_i . o_i from the forward's outputs
    out [BT, N, C], out_c [BT, 1, C] (N + 1 <= 208 on the card)."""
    _check(qkv, qkv_c, num_heads)
    _check_probs("spatial_attention_bwd_delta", qkv, probs, num_heads)
    _check_rows("spatial_attention_bwd_delta: outputs", qkv, out, out_c)
    _check_rows("spatial_attention_bwd_delta: gradients", qkv, g, gc)
    if qkv.device.type == "cpu":
        return spatial_attention_bwd_delta_plain(qkv, qkv_c, probs, out, out_c,
                                                 g, gc, num_heads, scale)
    _check_kernel((qkv, qkv_c, probs, out, out_c, g, gc), num_heads,
                  MAX_LEN)
    bt, n, _ = qkv.shape
    dqkv = torch.empty_like(qkv)
    dqkv_c = torch.empty_like(qkv_c)
    _launch(KERNEL_BWD_DELTA, KERNEL_BWD_DELTA, qkv, qkv.data_ptr(),
            qkv_c.data_ptr(), probs.data_ptr(), out.data_ptr(),
            out_c.data_ptr(), g.data_ptr(), gc.data_ptr(), dqkv.data_ptr(),
            dqkv_c.data_ptr(), bt, n, num_heads, _DTYPES[qkv.dtype],
            float(scale))
    return dqkv, dqkv_c


def _output_grads(qkv, qkv_c, g, gc):
    """The incoming gradients, zeros for an unused output, contiguous."""
    g = torch.zeros_like(qkv[..., :qkv.shape[-1] // 3]) if g is None else g
    gc = (torch.zeros_like(qkv_c[..., :qkv_c.shape[-1] // 3]) if gc is None
          else gc)
    return g.contiguous(), gc.contiguous()


class SpatialAttention(torch.autograd.Function):
    """K1 under autograd: K1sp forward (saves qkv, qkv_c and the
    probabilities), K1b backward."""

    @staticmethod
    def forward(ctx, qkv, qkv_c, num_heads: int, scale: float,
                shift: str = "clamp"):
        out, out_c, probs = spatial_attention_fwd_probs(qkv, qkv_c, num_heads,
                                                        scale, shift)
        ctx.save_for_backward(qkv, qkv_c, probs)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out, out_c

    @staticmethod
    def backward(ctx, g, gc):
        qkv, qkv_c, probs = ctx.saved_tensors
        dqkv, dqkv_c = spatial_attention_bwd(
            qkv, qkv_c, probs, *_output_grads(qkv, qkv_c, g, gc),
            ctx.num_heads, ctx.scale)
        return dqkv, dqkv_c, None, None, None


class SpatialAttentionDelta(torch.autograd.Function):
    """K1 under autograd on ``SPATIAL_DELTA=1``: K1sp forward (saves qkv,
    qkv_c, the probabilities and its outputs), K1bd backward."""

    @staticmethod
    def forward(ctx, qkv, qkv_c, num_heads: int, scale: float,
                shift: str = "clamp"):
        out, out_c, probs = spatial_attention_fwd_probs(qkv, qkv_c, num_heads,
                                                        scale, shift)
        ctx.save_for_backward(qkv, qkv_c, probs, out, out_c)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out, out_c

    @staticmethod
    def backward(ctx, g, gc):
        qkv, qkv_c, probs, out, out_c = ctx.saved_tensors
        dqkv, dqkv_c = spatial_attention_bwd_delta(
            qkv, qkv_c, probs, out, out_c, *_output_grads(qkv, qkv_c, g, gc),
            ctx.num_heads, ctx.scale)
        return dqkv, dqkv_c, None, None, None


class SpatialAttentionRecompute(torch.autograd.Function):
    """K1 under autograd on ``SPATIAL_SAVE_PROBS=0``: the forward K1f, or
    K1p when ``nbuf`` is given (``SPATIAL_PIPE=1``), saves qkv and qkv_c
    only; the backward K1br recomputes the probabilities under the same
    shift."""

    @staticmethod
    def forward(ctx, qkv, qkv_c, num_heads: int, scale: float,
                nbuf: Optional[int], shift: str = "clamp"):
        out, out_c = (spatial_attention(qkv, qkv_c, num_heads, scale,
                                        shift=shift)
                      if nbuf is None else
                      spatial_attention_pipe(qkv, qkv_c, num_heads, scale,
                                             nbuf, shift=shift))
        ctx.save_for_backward(qkv, qkv_c)
        ctx.num_heads, ctx.scale, ctx.shift = num_heads, scale, shift
        return out, out_c

    @staticmethod
    def backward(ctx, g, gc):
        qkv, qkv_c = ctx.saved_tensors
        dqkv, dqkv_c = spatial_attention_bwd_recompute(
            qkv, qkv_c, *_output_grads(qkv, qkv_c, g, gc), ctx.num_heads,
            ctx.scale, ctx.shift)
        return dqkv, dqkv_c, None, None, None, None


_warned_pipe_vs_saveprobs = False


def on_pair(n: int, head_dim: int) -> bool:
    """Whether K1's function over N frame tokens of head dim ``head_dim``
    runs on the key-tiled pair (K1's own kernels take N + 1 <= ``MAX_LEN``
    at head dim ``HEAD_DIM`` only), decided on the shape before any
    launch."""
    return n + 1 > MAX_LEN or head_dim != HEAD_DIM


def spatial_attention_autograd(qkv: torch.Tensor, qkv_c: torch.Tensor,
                               num_heads: int, scale: float,
                               route: AttentionRoute = DEFAULT_ROUTE
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The model's entry, routed as JAX ``_facq_fwd`` / ``_facq_bwd``
    (``pallas_attention.py:1190-1234``, one device).  Under grad (an input
    requires it): with ``route.save_probs`` K1sp and K1b, or K1bd with
    ``route.delta``; without, K1f (K1p with ``route.pipe``) and K1br.  No
    grad: K1f, or K1p with ``route.pipe``.  ``save_probs`` with ``pipe``
    under grad takes K1sp and warns once, as JAX does.  Where K1's kernels
    have no geometry (:func:`on_pair`: N + 1 > 208, or a head dim other
    than 64) every route takes the key-tiled pair on the fused layout
    (``ops/flash_attention.py``: its forward for K1f, K1sp and K1p, its
    recompute backward for K1b, K1br and K1bd), chosen on the shape before
    any launch.  Every kernel takes ``route.spatial_shift``."""
    global _warned_pipe_vs_saveprobs
    shift = route.spatial_shift
    if on_pair(qkv.shape[1], qkv.shape[2] // 3 // num_heads):
        return fa.flash_attention_qkv_autograd(qkv, qkv_c, num_heads, scale,
                                               shift)
    if not (torch.is_grad_enabled()
            and (qkv.requires_grad or qkv_c.requires_grad)):
        if route.pipe:
            return spatial_attention_pipe(qkv, qkv_c, num_heads, scale,
                                          route.pipe_nbuf, shift=shift)
        return spatial_attention(qkv, qkv_c, num_heads, scale, shift=shift)
    if route.save_probs:
        if route.pipe and not _warned_pipe_vs_saveprobs:
            warnings.warn("SPATIAL_SAVE_PROBS=1 takes precedence over "
                          "SPATIAL_PIPE=1 on differentiated forwards; the "
                          "pipelined kernel K1p runs only without grad")
            _warned_pipe_vs_saveprobs = True
        if route.delta:
            return SpatialAttentionDelta.apply(qkv, qkv_c, num_heads, scale,
                                               shift)
        return SpatialAttention.apply(qkv, qkv_c, num_heads, scale, shift)
    return SpatialAttentionRecompute.apply(
        qkv, qkv_c, num_heads, scale, route.pipe_nbuf if route.pipe else None,
        shift)
