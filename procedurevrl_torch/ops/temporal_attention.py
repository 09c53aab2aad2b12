"""K2 forward: temporal attention of the divided space-time block, read in
place from the time-major stream (``csrc/temporal_attention.cu``).

Replaces the TPU kernel ``procedurevrl_tpu/ops/pallas_attention.py:
_temporal_fwd_kernel``, the forward of ``flash_attention_temporal``.  The
JAX kernel also writes "compact" probabilities laid out for the TPU's
matrix unit, which only its backward reads; this forward writes none.

:func:`temporal_attention` launches the CUDA kernel for a CUDA tensor and
takes :func:`temporal_attention_plain` only for a CPU tensor.  Bound, design
and the H100 numbers: see the source note and ``PERF.md``.
"""

from __future__ import annotations

import torch

from procedurevrl_torch.ops import _build

KERNEL = "temporal_attention_fwd"
HEAD_DIM = 64
MAX_T = 16
CLAMP_HI = 80.0  # softmax shift: exp(min(s, 80)), exact for s < 80
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def temporal_attention_plain(qkv: torch.Tensor, num_heads: int,
                             scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arithmetic).

    qkv [B, T, N, 3C] -> [B, T, N, C]: for every (b, n, head) the T queries
    attend over the T keys; logits and softmax in fp32 with the clamp
    shift, probabilities cast to the value dtype before the
    fp32-accumulated PV product."""
    b, t, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    q, k, v = qkv.view(b, t, n, 3, num_heads, d).unbind(dim=3)
    s = torch.einsum("btnhd,bsnhd->bnhts", q.float(), k.float()) * scale
    p = torch.exp(torch.clamp(s, max=CLAMP_HI))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bnhts,bsnhd->btnhd", p.to(v.dtype).float(), v.float())
    return o.to(qkv.dtype).reshape(b, t, n, c)


def temporal_attention(qkv: torch.Tensor, num_heads: int,
                       scale: float) -> torch.Tensor:
    """Attention over axis 1 of qkv [B, T, N, 3C] (float32 or bfloat16,
    contiguous, head dim 64, T <= 16) -> [B, T, N, C]."""
    if qkv.dim() != 4 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"temporal_attention: qkv {tuple(qkv.shape)} is not "
                         f"[B, T, N, 3C] for {num_heads} heads")
    if qkv.device.type == "cpu":
        return temporal_attention_plain(qkv, num_heads, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"temporal_attention: no kernel for device "
                         f"{qkv.device}")
    b, t, n, c3 = qkv.shape
    c = c3 // 3
    if qkv.dtype not in _DTYPES:
        raise ValueError(f"temporal_attention: dtype {qkv.dtype} not "
                         "supported")
    if c // num_heads != HEAD_DIM or not 1 <= t <= MAX_T:
        raise ValueError(f"temporal_attention: kernel needs head dim "
                         f"{HEAD_DIM} and 1 <= T <= {MAX_T}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("temporal_attention: qkv must be contiguous and "
                         "16-byte aligned")
    out = torch.empty((b, t, n, c), dtype=qkv.dtype, device=qkv.device)
    lib = _build.load("temporal_attention")
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.temporal_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), b, t, n, num_heads,
            _DTYPES[qkv.dtype], float(scale), stream)
    _build.check(rc, KERNEL)
    _build.count_launch(KERNEL)
    return out
