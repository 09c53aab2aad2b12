"""K1 forward: spatial attention of the divided space-time block, with the
CLS token as a separate stream (``csrc/spatial_attention.cu``).

Replaces the TPU kernel ``procedurevrl_tpu/ops/pallas_attention.py:
_fwd_cls_qkv_kernel``, the forward of ``flash_attention_cls_qkv``.  The
JAX kernel takes its qkv columns in a per-head-group window order that
exists only for the TPU's 128-lane tiles; the port keeps the standard
``[q | k | v]`` column order of the projection.

:func:`spatial_attention` launches the CUDA kernel for a CUDA tensor and
takes :func:`spatial_attention_plain` only for a CPU tensor.  Bound, design
and the H100 numbers: see the source note and ``PERF.md``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from procedurevrl_torch.ops import _build

KERNEL = "spatial_attention_fwd"
HEAD_DIM = 64
MAX_LEN = 256  # n + 1 tokens per frame
CLAMP_HI = 80.0  # softmax shift: exp(min(s, 80)), exact for s < 80
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def spatial_attention_plain(qkv: torch.Tensor, qkv_c: torch.Tensor,
                            num_heads: int, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (same arithmetic).

    qkv [BT, N, 3C], qkv_c [BT, 1, 3C] -> (out [BT, N, C], out_c [BT, 1, C]).
    Every query of [patches; CLS] attends over the same N+1 keys; logits
    and softmax in fp32 with the clamp shift, probabilities cast to the
    value dtype before the fp32-accumulated PV product."""
    bt, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    x = torch.cat([qkv, qkv_c], dim=1).view(bt, n + 1, 3, num_heads, d)
    q, k, v = x.unbind(dim=2)  # [BT, L, H, d]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(torch.clamp(s, max=CLAMP_HI))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o.to(qkv.dtype).reshape(bt, n + 1, c)
    return o[:, :n].contiguous(), o[:, n:].contiguous()


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


def spatial_attention(qkv: torch.Tensor, qkv_c: torch.Tensor, num_heads: int,
                      scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """CLS-split spatial attention on the fused qkv projection.

    qkv [BT, N, 3C], qkv_c [BT, 1, 3C] (float32 or bfloat16, contiguous,
    head dim 64, N + 1 <= 256) -> (frame_out [BT, N, C], cls_out [BT, 1, C]).
    """
    _check(qkv, qkv_c, num_heads)
    if qkv.device.type == "cpu":
        return spatial_attention_plain(qkv, qkv_c, num_heads, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"spatial_attention: no kernel for device "
                         f"{qkv.device}")
    bt, n, c3 = qkv.shape
    c = c3 // 3
    if qkv.dtype not in _DTYPES:
        raise ValueError(f"spatial_attention: dtype {qkv.dtype} not supported")
    if c // num_heads != HEAD_DIM or n + 1 > MAX_LEN:
        raise ValueError(f"spatial_attention: kernel needs head dim "
                         f"{HEAD_DIM} and N + 1 <= {MAX_LEN}")
    if not (qkv.is_contiguous() and qkv_c.is_contiguous()):
        raise ValueError("spatial_attention: inputs must be contiguous")
    if qkv.data_ptr() % 16 or qkv_c.data_ptr() % 16:
        raise ValueError("spatial_attention: inputs must be 16-byte aligned")
    out = torch.empty((bt, n, c), dtype=qkv.dtype, device=qkv.device)
    out_c = torch.empty((bt, 1, c), dtype=qkv.dtype, device=qkv.device)
    lib = _build.load("spatial_attention")
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.spatial_attention_fwd(
            qkv.data_ptr(), qkv_c.data_ptr(), out.data_ptr(), out_c.data_ptr(),
            bt, n, num_heads, _DTYPES[qkv.dtype], float(scale), stream)
    _build.check(rc, KERNEL)
    _build.count_launch(KERNEL)
    return out, out_c
