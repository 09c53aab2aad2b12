"""K3 and K4: whole-sequence softmax attention, and the long range of K1, on
one key-tiled CUDA kernel pair (``csrc/flash_attention.cu``).

Replaces the TPU kernels of ``procedurevrl_tpu/ops/pallas_attention.py``:
``_fwd_kernel`` / ``_bwd_kernel`` (K4f / K4b, ``flash_attention_headfused``:
unmasked, non-causal attention on ``[B, N, H*d]``) and ``_fwd_cls_kernel`` /
``_bwd_cls_kernel`` (K3f / K3b, ``flash_attention_cls``: the same with a
separate CLS stream ``[B, 1, H*d]``, every query attending over [frames;
cls]).  Every entry takes the softmax shift (``SPATIAL_SHIFT``, for K2's
function ``TEMPORAL_SHIFT``) as ``shift``: ``clamp`` (default) e =
exp(min(s, 80)), ``max`` e = exp(s - m) with m the row max, which the
forward keeps as it sweeps the key tiles (an online max: o and l are
rescaled when a tile raises it), ``none`` e = exp(s).  The forward rounds e
to the value dtype before the P V product and divides by l = sum_j e_j
after it, where the TPU kernels round p = e / l: one rounding of each
probability either way, and the same numbers in float32.  The backward
recomputes the probabilities, as the TPU kernels do, from the row
statistic that the forward saves under grad (fp32 ``[B, H, L]``, L = N + 1
with the CLS; l, or under ``max`` lse = m + log l, so that p = exp(s -
lse)): a residual the TPU kernels do not keep.

The same pair carries K1's function (``ops/spatial_attention.py``) for
208 < N + 1 <= 1025 and for every head dim other than 64, where K1's
kernels have no geometry: q, k and v are then the column thirds of the
fused ``qkv [BT, N, 3C]`` and ``qkv_c [BT, 1, 3C]``, read in place, and the
gradients are written into the thirds of one ``dqkv``.  It carries K2's
function (``ops/temporal_attention.py``) for head dims other than 64: the
time-major ``qkv [B, T, N, 3C]`` is read in place as B*N sequences of T
rows, N of them side by side in each row of the ``[B, T, N*3C]`` view.
Its launches count under their own names (``KERNEL_QKV``,
``KERNEL_QKV_BWD``, ``KERNEL_T``, ``KERNEL_T_BWD``), so a run shows which
caller took the pair.

q, k and v may be strided views (the thirds of one projection): each must
have unit column stride and evenly spaced rows of one row stride, 16-byte
aligned.  Each wrapper launches its kernel for a CUDA tensor and raises on
anything the kernel does not take (dtype other than float32 / bfloat16,
more than ``MAX_LEN`` tokens, a layout it cannot address); it takes the
plain version only for a CPU tensor.  Every head dim runs; the source
chooses the kernels: in bf16 a multiple of 8 up to 256 runs on the
tensor-core (``wgmma``) kernels, on the narrowest of the tile widths 32,
64, 96, 128, 192 and 256 that holds it (zero past column d; 192 and 256 in
two column groups), its backward on one fused kernel (7 products per
query-key pair) where a slice fits one CTA (tile widths up to 64, at most
256 tokens at 64) and on a query-major and a key-major pass (9 products)
elsewhere; float32 at every head dim, and bf16 at the others, runs on the
scalar kernels in column groups of up to 256.  The autograd entries
(``*_autograd``) take the forward that saves l and the kernel backward
under grad, the forward alone otherwise.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from procedurevrl_torch.ops import _build
from procedurevrl_torch.ops.attention_route import shift_code, shifted_exp

KERNEL = "flash_attention_fwd"               # K4f
KERNEL_BWD = "flash_attention_bwd"           # K4b
KERNEL_CLS = "flash_attention_cls_fwd"       # K3f
KERNEL_CLS_BWD = "flash_attention_cls_bwd"   # K3b
KERNEL_QKV = "flash_attention_qkv_fwd"       # K1's long range, forward
KERNEL_QKV_BWD = "flash_attention_qkv_bwd"   # K1's long range, backward
KERNEL_T = "flash_attention_temporal_fwd"    # K2's function, head dim != 64
KERNEL_T_BWD = "flash_attention_temporal_bwd"
MAX_LEN = 1024          # frame tokens (JAX MAX_FUSED_LEN); + 1 for the CLS
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

Cls = Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


# ---------------------------------------------------------------- plain

def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, L, H*d] -> [B, H, L, d] in float32."""
    b, n, c = x.shape
    return x.reshape(b, n, num_heads, c // num_heads).transpose(1, 2).float()


def _merge(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, H, L, d] -> [B, L, H*d] in ``dtype``."""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d).to(dtype)


def _logits(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """fp32 q k^T * scale on [B, H, L, d] operands."""
    return torch.einsum("bhqd,bhkd->bhqk", q, k) * scale


def _attend(q, k, v, num_heads: int, scale: float, shift: str = "clamp"):
    """(out [B, L, C], the row statistic [B, H, L]) of [B, L, C] inputs:
    fp32 logits and the softmax under ``shift`` (JAX ``_fwd_kernel`` /
    ``_softmax_probs``); e = exp(min(s, 80)) (``max``: exp(s - m) with m
    the row max, ``none``: exp(s)) cast to the value dtype before the fp32
    P V product, divided by l after it, as the kernel rounds (the TPU kernel
    rounds e / l: in float32 the two agree).  The statistic is l, under
    ``max`` lse = m + log l, as the kernel saves it."""
    s = _logits(_heads(q, num_heads), _heads(k, num_heads), scale)
    e = shifted_exp(s, shift)
    l = e.sum(dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", e.to(v.dtype).float(),
                     _heads(v, num_heads)) / l[..., None]
    stat = s.amax(dim=-1) + torch.log(l) if shift == "max" else l
    return _merge(o, v.dtype), stat


def _attend_bwd(q, k, v, g, num_heads: int, scale: float,
                shift: str = "clamp"):
    """dq, dk, dv [B, L, C] of :func:`_attend`, the TPU kernel's recompute
    arithmetic (``_bwd_kernel``, ``_ds_chain``): p in fp32 under the shift;
    dv = p^T g with p cast to the value dtype; dp = g v^T; ds = p (dp -
    rowsum(dp p)), cast to the value dtype; dq = scale ds k, dk = scale ds^T
    q, fp32 sums."""
    dt = q.dtype
    qh, kh, vh, gh = (_heads(t, num_heads) for t in (q, k, v, g))
    e = shifted_exp(_logits(qh, kh, scale), shift)
    p = e / e.sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhij,bhid->bhjd", p.to(dt).float(), gh)
    dp = torch.einsum("bhid,bhjd->bhij", gh, vh)
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).float()
    dq = torch.einsum("bhij,bhjd->bhid", ds, kh) * scale
    dk = torch.einsum("bhij,bhid->bhjd", ds, qh) * scale
    return _merge(dq, dt), _merge(dk, dt), _merge(dv, dt)


def _with_cls(x: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """[frames; cls] along the token axis."""
    return torch.cat([x, xc], dim=1)


def _split_cls(x: torch.Tensor, n: int):
    return x[:, :n].contiguous(), x[:, n:].contiguous()


def flash_attention_fwd_plain(q, k, v, num_heads: int, scale: float,
                              shift: str = "clamp"):
    """Plain PyTorch version of K4f under grad: (out [B, N, C], l [B, H,
    N] fp32; lse under ``max``)."""
    return _attend(q, k, v, num_heads, scale, shift)


def flash_attention_plain(q, k, v, num_heads: int, scale: float,
                          shift: str = "clamp") -> torch.Tensor:
    """Plain PyTorch version of K4f: softmax(q k^T * scale) v per head of
    q, k, v [B, N, H*d], under the shift (default the clamp exp(min(s,
    80)))."""
    return _attend(q, k, v, num_heads, scale, shift)[0]


def flash_attention_bwd_plain(q, k, v, g, num_heads: int, scale: float,
                              shift: str = "clamp"):
    """Plain PyTorch version of K4b: (dq, dk, dv) from the output gradient
    g [B, N, C], the probabilities recomputed from q and k."""
    return _attend_bwd(q, k, v, g, num_heads, scale, shift)


def flash_attention_cls_fwd_plain(q, k, v, qc, kc, vc, num_heads: int,
                                  scale: float, shift: str = "clamp"):
    """Plain PyTorch version of K3f under grad: (out [B, N, C], outc [B, 1,
    C], l [B, H, N + 1]), the rows and l in the order [frames; cls]."""
    n = q.shape[1]
    o, l = _attend(_with_cls(q, qc), _with_cls(k, kc), _with_cls(v, vc),
                   num_heads, scale, shift)
    return (*_split_cls(o, n), l)


def flash_attention_cls_plain(q, k, v, qc, kc, vc, num_heads: int,
                              scale: float, shift: str = "clamp"):
    """Plain PyTorch version of K3f: frame queries q [B, N, C] and the CLS
    query qc [B, 1, C] attend over keys [k; kc] and values [v; vc];
    returns (out [B, N, C], outc [B, 1, C])."""
    return flash_attention_cls_fwd_plain(q, k, v, qc, kc, vc, num_heads,
                                         scale, shift)[:2]


def flash_attention_cls_bwd_plain(q, k, v, qc, kc, vc, g, gc,
                                  num_heads: int, scale: float,
                                  shift: str = "clamp"):
    """Plain PyTorch version of K3b: (dq, dk, dv, dqc, dkc, dvc) from the
    output gradients g [B, N, C], gc [B, 1, C]."""
    n = q.shape[1]
    grads = _attend_bwd(_with_cls(q, qc), _with_cls(k, kc), _with_cls(v, vc),
                        _with_cls(g, gc), num_heads, scale, shift)
    frames, cls = zip(*(_split_cls(x, n) for x in grads))
    return (*frames, *cls)


def _thirds(x: torch.Tensor):
    """q, k, v: the column thirds of a fused projection, as views."""
    return x.split(x.shape[-1] // 3, dim=-1)


def flash_attention_qkv_fwd_plain(qkv, qkv_c, num_heads: int, scale: float,
                                  shift: str = "clamp"):
    """Plain PyTorch version of the pair's forward in K1's layout: (out [BT,
    N, C], out_c [BT, 1, C], l [BT, H, N + 1])."""
    return flash_attention_cls_fwd_plain(*_thirds(qkv), *_thirds(qkv_c),
                                         num_heads, scale, shift)


def flash_attention_qkv_bwd_plain(qkv, qkv_c, g, gc, num_heads: int,
                                  scale: float, shift: str = "clamp"):
    """Plain PyTorch version of the pair's backward in K1's layout: (dqkv
    [BT, N, 3C], dqkv_c [BT, 1, 3C])."""
    d = flash_attention_cls_bwd_plain(*_thirds(qkv), *_thirds(qkv_c), g, gc,
                                      num_heads, scale, shift)
    return torch.cat(d[:3], dim=-1), torch.cat(d[3:], dim=-1)


def _time_major(x: torch.Tensor) -> torch.Tensor:
    """[B, T, N, c] -> [B*N, T, c]: one sequence of T rows per position."""
    b, t, n, c = x.shape
    return x.transpose(1, 2).reshape(b * n, t, c)


def _from_time_major(x: torch.Tensor, b: int) -> torch.Tensor:
    """[B*N, T, c] -> [B, T, N, c]."""
    bn, t, c = x.shape
    return x.reshape(b, bn // b, t, c).transpose(1, 2)


def flash_attention_temporal_fwd_plain(qkv, num_heads: int, scale: float,
                                       shift: str = "clamp"):
    """Plain PyTorch version of the pair's forward in K2's layout: (out [B,
    T, N, C], l [B*N, H, T]) of the time-major qkv [B, T, N, 3C], attention
    over the T frames of each position."""
    q, k, v = (_time_major(t) for t in _thirds(qkv))
    out, rowsum = _attend(q, k, v, num_heads, scale, shift)
    return _from_time_major(out, qkv.shape[0]).contiguous(), rowsum


def flash_attention_temporal_bwd_plain(qkv, g, num_heads: int, scale: float,
                                       shift: str = "clamp"):
    """Plain PyTorch version of the pair's backward in K2's layout: dqkv
    [B, T, N, 3C] from the output gradient g [B, T, N, C]."""
    q, k, v = (_time_major(t) for t in _thirds(qkv))
    grads = _attend_bwd(q, k, v, _time_major(g), num_heads, scale, shift)
    return torch.cat([_from_time_major(x, qkv.shape[0]) for x in grads],
                     dim=-1)


# --------------------------------------------------------------- kernels

def _row_stride(t: torch.Tensor, name: str) -> int:
    """The row stride of t [B, n, C] (its batch stride when n is 1): rows
    evenly spaced with unit column stride, 16-byte aligned."""
    b, n, _ = t.shape
    ld = t.stride(1) if n > 1 else t.stride(0)
    if t.stride(2) != 1 or (b > 1 and t.stride(0) != n * ld):
        raise ValueError(f"flash_attention: {name} must have unit column "
                         f"stride and rows of one stride (strides "
                         f"{t.stride()})")
    if (ld * t.element_size()) % 16 or t.data_ptr() % 16:
        raise ValueError(f"flash_attention: the rows of {name} must be "
                         "16-byte aligned")
    return ld


def _group_stride(tensors: Sequence[torch.Tensor], name: str) -> int:
    strides = {_row_stride(t, name) for t in tensors}
    if len(strides) != 1:
        raise ValueError(f"flash_attention: {name} must share one row "
                         f"stride, got {sorted(strides)}")
    return strides.pop()


def _check(q, k, v, cls: Cls, num_heads: int) -> None:
    """Shapes, dtype and device of the inputs (any device)."""
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention: q, k, v must be [B, N, C] of one "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, c = q.shape
    if c % num_heads:
        raise ValueError(f"flash_attention: width {c} does not fit "
                         f"{num_heads} heads")
    tensors = [q, k, v]
    if cls is not None:
        if any(t.shape != (b, 1, c) for t in cls):
            raise ValueError("flash_attention: qc, kc, vc must be [B, 1, C]")
        tensors += list(cls)
    if any(t.dtype != q.dtype or t.device != q.device for t in tensors):
        raise ValueError("flash_attention: inputs differ in dtype or device")


def _check_kernel(q, num_heads: int) -> None:
    """What the kernel needs beyond :func:`_check`."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported")
    b, n, c = q.shape
    if n > MAX_LEN:
        raise ValueError(f"flash_attention: the kernel takes N <= {MAX_LEN} "
                         f"tokens (+ the CLS), not {n}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(fn: str, kernel: str, q: torch.Tensor, *args) -> None:
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    _build.check(rc, kernel)
    _build.count_launch(kernel)


def _empty_rowsum(q: torch.Tensor, num_heads: int, cls: Cls) -> torch.Tensor:
    b, n, _ = q.shape
    return torch.empty((b, num_heads, n + (cls is not None)),
                       dtype=torch.float32, device=q.device)


def _fwd(kernel: str, q, k, v, cls: Cls, out, outc, rowsum,
         num_heads: int, scale: float, shift: str) -> None:
    """Launch the forward into out (and outc, rowsum where given) under the
    softmax shift ``shift``."""
    _check_kernel(q, num_heads)
    b, n, c = q.shape
    qc, kc, vc = cls if cls is not None else (None,) * 3
    ld_in = _group_stride((q, k, v), "q, k, v")
    ldc_in = 0 if cls is None else _group_stride(cls, "qc, kc, vc")
    ld_o = _row_stride(out, "out")
    ldc_o = 0 if outc is None else _row_stride(outc, "outc")
    _launch("flash_attention_fwd", kernel, q, _ptr(q), _ptr(k), _ptr(v),
            _ptr(qc), _ptr(kc), _ptr(vc), _ptr(out), _ptr(outc),
            _ptr(rowsum), b, 1, n, num_heads, c // num_heads, ld_in, ldc_in,
            ld_o, ldc_o, _DTYPES[q.dtype], shift_code(shift), float(scale))


def _bwd(kernel: str, q, k, v, cls: Cls, g, gc, rowsum, grads, grads_c,
         num_heads: int, scale: float, shift: str) -> None:
    """Launch the backward into grads = (dq, dk, dv) and grads_c = (dqc,
    dkc, dvc) (None without the CLS), from the statistic the forward under
    the same shift saved."""
    _check_kernel(q, num_heads)
    b, n, c = q.shape
    if rowsum.shape != (b, num_heads, n + (cls is not None)) or (
            rowsum.dtype != torch.float32 or not rowsum.is_contiguous()):
        raise ValueError(f"flash_attention: rowsum {tuple(rowsum.shape)} "
                         f"{rowsum.dtype} is not the forward's")
    qc, kc, vc = cls if cls is not None else (None,) * 3
    dqc, dkc, dvc = grads_c if grads_c is not None else (None,) * 3
    ld_in = _group_stride((q, k, v), "q, k, v")
    ldc_in = 0 if cls is None else _group_stride(cls, "qc, kc, vc")
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"flash_attention: g {tuple(g.shape)} {g.dtype} "
                         f"does not fit q {tuple(q.shape)} {q.dtype}")
    ld_g = _row_stride(g, "g")
    ldc_g = 0 if gc is None else _row_stride(gc, "gc")
    ld_d = _group_stride(grads, "dq, dk, dv")
    ldc_d = 0 if grads_c is None else _group_stride(grads_c, "dqc, dkc, dvc")
    delta = torch.empty_like(rowsum)
    _launch("flash_attention_bwd", kernel, q, _ptr(q), _ptr(k), _ptr(v),
            _ptr(qc), _ptr(kc), _ptr(vc), _ptr(g), _ptr(gc), _ptr(rowsum),
            _ptr(delta), *(_ptr(t) for t in grads),
            _ptr(dqc), _ptr(dkc), _ptr(dvc), b, 1, n, num_heads,
            c // num_heads, ld_in, ldc_in, ld_g, ldc_g, ld_d, ldc_d,
            _DTYPES[q.dtype], shift_code(shift), float(scale))


def _new(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def flash_attention_fwd(q, k, v, num_heads: int, scale: float,
                        shift: str = "clamp"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4f under grad: (out [B, N, C], l [B, H, N] fp32, lse under
    ``max``) of q, k, v [B, N, H*d]."""
    _check(q, k, v, None, num_heads)
    shift_code(shift)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, num_heads, scale, shift)
    out, rowsum = _new(q), _empty_rowsum(q, num_heads, None)
    _fwd(KERNEL, q, k, v, None, out, None, rowsum, num_heads, scale, shift)
    return out, rowsum


def flash_attention(q, k, v, num_heads: int, scale: float,
                    shift: str = "clamp") -> torch.Tensor:
    """K4f: softmax(q k^T * scale) v per head, under the softmax shift
    ``shift`` (``SPATIAL_SHIFT``: clamp, max, none), of q, k, v [B, N, H*d]
    (N <= 1024 on the card)."""
    _check(q, k, v, None, num_heads)
    shift_code(shift)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, num_heads, scale, shift)
    out = _new(q)
    _fwd(KERNEL, q, k, v, None, out, None, None, num_heads, scale, shift)
    return out


def flash_attention_bwd(q, k, v, g, rowsum, num_heads: int, scale: float,
                        shift: str = "clamp"):
    """K4b: (dq, dk, dv) from the output gradient g [B, N, C] and the
    forward's l or lse (a CPU tensor takes the plain version, which
    recomputes it)."""
    _check(q, k, v, None, num_heads)
    shift_code(shift)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, g, num_heads, scale, shift)
    grads = (_new(q), _new(q), _new(q))
    _bwd(KERNEL_BWD, q, k, v, None, g, None, rowsum, grads, None, num_heads,
         scale, shift)
    return grads


def flash_attention_cls_fwd(q, k, v, qc, kc, vc, num_heads: int,
                            scale: float, shift: str = "clamp"):
    """K3f under grad: (out [B, N, C], outc [B, 1, C], l [B, H, N + 1])."""
    cls = (qc, kc, vc)
    _check(q, k, v, cls, num_heads)
    shift_code(shift)
    if q.device.type == "cpu":
        return flash_attention_cls_fwd_plain(q, k, v, *cls, num_heads, scale,
                                             shift)
    out, outc = _new(q), _new(qc)
    rowsum = _empty_rowsum(q, num_heads, cls)
    _fwd(KERNEL_CLS, q, k, v, cls, out, outc, rowsum, num_heads, scale, shift)
    return out, outc, rowsum


def flash_attention_cls(q, k, v, qc, kc, vc, num_heads: int, scale: float,
                        shift: str = "clamp"):
    """K3f: frame queries q [B, N, C] and the CLS query qc [B, 1, C] over
    keys [k; kc], values [v; vc]; (out [B, N, C], outc [B, 1, C])."""
    cls = (qc, kc, vc)
    _check(q, k, v, cls, num_heads)
    shift_code(shift)
    if q.device.type == "cpu":
        return flash_attention_cls_plain(q, k, v, *cls, num_heads, scale,
                                         shift)
    out, outc = _new(q), _new(qc)
    _fwd(KERNEL_CLS, q, k, v, cls, out, outc, None, num_heads, scale, shift)
    return out, outc


def flash_attention_cls_bwd(q, k, v, qc, kc, vc, g, gc, rowsum,
                            num_heads: int, scale: float,
                            shift: str = "clamp"):
    """K3b: (dq, dk, dv, dqc, dkc, dvc) from g [B, N, C], gc [B, 1, C] and
    the forward's l or lse."""
    cls = (qc, kc, vc)
    _check(q, k, v, cls, num_heads)
    shift_code(shift)
    if q.device.type == "cpu":
        return flash_attention_cls_bwd_plain(q, k, v, *cls, g, gc, num_heads,
                                             scale, shift)
    grads, grads_c = (_new(q), _new(q), _new(q)), (_new(qc), _new(qc), _new(qc))
    _bwd(KERNEL_CLS_BWD, q, k, v, cls, g, gc, rowsum, grads, grads_c,
         num_heads, scale, shift)
    return (*grads, *grads_c)


def _check_qkv(qkv, qkv_c, num_heads: int) -> None:
    if qkv.dim() != 3 or qkv.shape[-1] % 3 or qkv_c.shape != (
            qkv.shape[0], 1, qkv.shape[-1]):
        raise ValueError(f"flash_attention_qkv: qkv {tuple(qkv.shape)} / "
                         f"qkv_c {tuple(qkv_c.shape)} are not [BT, N, 3C] / "
                         "[BT, 1, 3C]")


def flash_attention_qkv_fwd(qkv, qkv_c, num_heads: int, scale: float,
                            with_rowsum: bool = True, shift: str = "clamp"):
    """K1's function on the pair (208 < N + 1 <= 1025): (out [BT, N, C],
    out_c [BT, 1, C], l [BT, H, N + 1] (lse under ``max``) or None) of the
    fused qkv [BT, N, 3C] and qkv_c [BT, 1, 3C], read in place."""
    _check_qkv(qkv, qkv_c, num_heads)
    shift_code(shift)
    if qkv.device.type == "cpu":
        out, out_c, rowsum = flash_attention_qkv_fwd_plain(qkv, qkv_c,
                                                           num_heads, scale,
                                                           shift)
        return out, out_c, rowsum if with_rowsum else None
    q, k, v = _thirds(qkv)
    cls = _thirds(qkv_c)
    _check(q, k, v, cls, num_heads)
    out, out_c = _new(q), _new(cls[0])
    rowsum = _empty_rowsum(q, num_heads, cls) if with_rowsum else None
    _fwd(KERNEL_QKV, q, k, v, cls, out, out_c, rowsum, num_heads, scale,
         shift)
    return out, out_c, rowsum


def flash_attention_qkv_bwd(qkv, qkv_c, g, gc, rowsum, num_heads: int,
                            scale: float, shift: str = "clamp"):
    """The backward of :func:`flash_attention_qkv_fwd`: (dqkv [BT, N, 3C],
    dqkv_c [BT, 1, 3C]) from g [BT, N, C], gc [BT, 1, C] and its l."""
    _check_qkv(qkv, qkv_c, num_heads)
    shift_code(shift)
    if qkv.device.type == "cpu":
        return flash_attention_qkv_bwd_plain(qkv, qkv_c, g, gc, num_heads,
                                             scale, shift)
    q, k, v = _thirds(qkv)
    cls = _thirds(qkv_c)
    _check(q, k, v, cls, num_heads)
    dqkv, dqkv_c = _new(qkv), _new(qkv_c)
    _bwd(KERNEL_QKV_BWD, q, k, v, cls, g, gc, rowsum, _thirds(dqkv),
         _thirds(dqkv_c), num_heads, scale, shift)
    return dqkv, dqkv_c


def _check_temporal(qkv, num_heads: int) -> None:
    if qkv.dim() != 4 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"flash_attention_temporal: qkv {tuple(qkv.shape)} "
                         f"is not [B, T, N, 3C] for {num_heads} heads")


def _temporal_layout(qkv, num_heads: int) -> Tuple[int, int, int, int]:
    """(B*N sequences, N side by side, T rows, head dim) of the kernel's
    view of a contiguous, 16-byte aligned CUDA qkv [B, T, N, 3C]."""
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device "
                         f"{qkv.device}")
    if qkv.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {qkv.dtype} not supported")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("flash_attention_temporal: qkv must be contiguous "
                         "and 16-byte aligned")
    b, t, n, c3 = qkv.shape
    d = c3 // 3 // num_heads
    if t > MAX_LEN:
        raise ValueError(f"flash_attention: the kernel takes at most "
                         f"{MAX_LEN} frames, not {t}")
    return b * n, n, t, d


def flash_attention_temporal_fwd(qkv, num_heads: int, scale: float,
                                 with_rowsum: bool = True,
                                 shift: str = "clamp"):
    """K2's function on the pair (head dims other than 64): (out [B, T, N,
    C], l [B*N, H, T] (lse under ``max``) or None) of the time-major qkv
    [B, T, N, 3C], read in place."""
    _check_temporal(qkv, num_heads)
    code = shift_code(shift)
    if qkv.device.type == "cpu":
        out, rowsum = flash_attention_temporal_fwd_plain(qkv, num_heads,
                                                         scale, shift)
        return out, rowsum if with_rowsum else None
    seqs, n, t, d = _temporal_layout(qkv, num_heads)
    b, _, _, c3 = qkv.shape
    c, e = c3 // 3, qkv.element_size()
    out = torch.empty((b, t, n, c), dtype=qkv.dtype, device=qkv.device)
    rowsum = (torch.empty((seqs, num_heads, t), dtype=torch.float32,
                          device=qkv.device) if with_rowsum else None)
    base = qkv.data_ptr()
    _launch("flash_attention_fwd", KERNEL_T, qkv, base, base + c * e,
            base + 2 * c * e, None, None, None, out.data_ptr(), None,
            _ptr(rowsum), seqs, n, t, num_heads, d, n * c3, 0, n * c, 0,
            _DTYPES[qkv.dtype], code, float(scale))
    return out, rowsum


def flash_attention_temporal_bwd(qkv, g, rowsum, num_heads: int,
                                 scale: float, shift: str = "clamp"):
    """The backward of :func:`flash_attention_temporal_fwd`: dqkv [B, T, N,
    3C] from g [B, T, N, C] and its l (a CPU tensor takes the plain
    version, which recomputes l)."""
    _check_temporal(qkv, num_heads)
    code = shift_code(shift)
    b, t, n, c3 = qkv.shape
    if g.shape != (b, t, n, c3 // 3) or g.dtype != qkv.dtype:
        raise ValueError(f"flash_attention_temporal: g {tuple(g.shape)} "
                         f"does not fit qkv {tuple(qkv.shape)}")
    if qkv.device.type == "cpu":
        return flash_attention_temporal_bwd_plain(qkv, g, num_heads, scale,
                                                  shift)
    seqs, n, t, d = _temporal_layout(qkv, num_heads)
    if rowsum.shape != (seqs, num_heads, t) or (
            rowsum.dtype != torch.float32 or not rowsum.is_contiguous()):
        raise ValueError(f"flash_attention_temporal: rowsum "
                         f"{tuple(rowsum.shape)} {rowsum.dtype} is not the "
                         "forward's")
    if not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError("flash_attention_temporal: g must be contiguous and "
                         "16-byte aligned")
    c, e = c3 // 3, qkv.element_size()
    dqkv = torch.empty_like(qkv)
    delta = torch.empty_like(rowsum)
    base, dbase = qkv.data_ptr(), dqkv.data_ptr()
    _launch("flash_attention_bwd", KERNEL_T_BWD, qkv, base, base + c * e,
            base + 2 * c * e, None, None, None, g.data_ptr(), None,
            rowsum.data_ptr(), delta.data_ptr(), dbase, dbase + c * e,
            dbase + 2 * c * e, None, None, None, seqs, n, t, num_heads, d,
            n * c3, 0, n * c, 0, n * c3, 0, _DTYPES[qkv.dtype], code,
            float(scale))
    return dqkv


# -------------------------------------------------------------- autograd

def _grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _output_grad(g: Optional[torch.Tensor], like: torch.Tensor):
    """The incoming gradient, zeros for an unused output, contiguous."""
    return torch.zeros_like(like) if g is None else g.contiguous()


class FlashAttention(torch.autograd.Function):
    """K4 under autograd: K4f saving q, k, v and l (lse under ``max``);
    K4b."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, scale: float,
                shift: str = "clamp"):
        out, rowsum = flash_attention_fwd(q, k, v, num_heads, scale, shift)
        ctx.save_for_backward(q, k, v, rowsum)
        ctx.num_heads, ctx.scale, ctx.shift = num_heads, scale, shift
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, rowsum = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, _output_grad(g, q), rowsum,
                                         ctx.num_heads, ctx.scale, ctx.shift)
        return dq, dk, dv, None, None, None


class FlashAttentionCls(torch.autograd.Function):
    """K3 under autograd: K3f saving q, k, v, qc, kc, vc and l; K3b."""

    @staticmethod
    def forward(ctx, q, k, v, qc, kc, vc, num_heads: int, scale: float,
                shift: str = "clamp"):
        out, outc, rowsum = flash_attention_cls_fwd(q, k, v, qc, kc, vc,
                                                    num_heads, scale, shift)
        ctx.save_for_backward(q, k, v, qc, kc, vc, rowsum)
        ctx.num_heads, ctx.scale, ctx.shift = num_heads, scale, shift
        return out, outc

    @staticmethod
    def backward(ctx, g, gc):
        q, k, v, qc, kc, vc, rowsum = ctx.saved_tensors
        grads = flash_attention_cls_bwd(
            q, k, v, qc, kc, vc, _output_grad(g, q), _output_grad(gc, qc),
            rowsum, ctx.num_heads, ctx.scale, ctx.shift)
        return (*grads, None, None, None)


class FlashAttentionQKV(torch.autograd.Function):
    """K1's long range under autograd: the pair's forward on the fused qkv
    saving qkv, qkv_c and l; its backward into one dqkv."""

    @staticmethod
    def forward(ctx, qkv, qkv_c, num_heads: int, scale: float,
                shift: str = "clamp"):
        out, out_c, rowsum = flash_attention_qkv_fwd(qkv, qkv_c, num_heads,
                                                     scale, shift=shift)
        ctx.save_for_backward(qkv, qkv_c, rowsum)
        ctx.num_heads, ctx.scale, ctx.shift = num_heads, scale, shift
        return out, out_c

    @staticmethod
    def backward(ctx, g, gc):
        qkv, qkv_c, rowsum = ctx.saved_tensors
        c = qkv.shape[-1] // 3
        dqkv, dqkv_c = flash_attention_qkv_bwd(
            qkv, qkv_c, _output_grad(g, qkv[..., :c]),
            _output_grad(gc, qkv_c[..., :c]), rowsum, ctx.num_heads,
            ctx.scale, ctx.shift)
        return dqkv, dqkv_c, None, None, None


class FlashAttentionTemporal(torch.autograd.Function):
    """K2's function on the pair under autograd: the forward saving qkv and
    l, the recompute backward into one dqkv."""

    @staticmethod
    def forward(ctx, qkv, num_heads: int, scale: float, shift: str = "clamp"):
        out, rowsum = flash_attention_temporal_fwd(qkv, num_heads, scale,
                                                   shift=shift)
        ctx.save_for_backward(qkv, rowsum)
        ctx.num_heads, ctx.scale, ctx.shift = num_heads, scale, shift
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, rowsum = ctx.saved_tensors
        return (flash_attention_temporal_bwd(qkv, g.contiguous(), rowsum,
                                             ctx.num_heads, ctx.scale,
                                             ctx.shift),
                None, None, None)


def flash_attention_autograd(q, k, v, num_heads: int, scale: float,
                             shift: str = "clamp") -> torch.Tensor:
    """The model's entry for K4 (JAX ``flash_attention_headfused``), under
    ``SPATIAL_SHIFT``'s ``shift``."""
    if _grad(q, k, v):
        return FlashAttention.apply(q, k, v, num_heads, scale, shift)
    return flash_attention(q, k, v, num_heads, scale, shift)


def flash_attention_cls_autograd(q, k, v, qc, kc, vc, num_heads: int,
                                 scale: float, shift: str = "clamp"):
    """The model's entry for K3 (JAX ``flash_attention_cls``)."""
    if _grad(q, k, v, qc, kc, vc):
        return FlashAttentionCls.apply(q, k, v, qc, kc, vc, num_heads, scale,
                                       shift)
    return flash_attention_cls(q, k, v, qc, kc, vc, num_heads, scale, shift)


def flash_attention_qkv_autograd(qkv, qkv_c, num_heads: int, scale: float,
                                 shift: str = "clamp"):
    """The entry of K1's long range (``spatial_attention_autograd`` for
    208 < N + 1 <= 1025)."""
    if _grad(qkv, qkv_c):
        return FlashAttentionQKV.apply(qkv, qkv_c, num_heads, scale, shift)
    return flash_attention_qkv_fwd(qkv, qkv_c, num_heads, scale,
                                   with_rowsum=False, shift=shift)[:2]


def flash_attention_temporal_autograd(qkv, num_heads: int, scale: float,
                                      shift: str = "clamp"):
    """The entry of K2's function on the pair (``temporal_attention_autograd``
    for head dims other than 64), under ``TEMPORAL_SHIFT``'s ``shift``."""
    if _grad(qkv):
        return FlashAttentionTemporal.apply(qkv, num_heads, scale, shift)
    return flash_attention_temporal_fwd(qkv, num_heads, scale,
                                        with_rowsum=False, shift=shift)[0]
