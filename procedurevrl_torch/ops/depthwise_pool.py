"""K8: MViT's depthwise 3x3x3 attention pool (``csrc/depthwise_pool.cu``).

Replaces the TPU kernels of ``procedurevrl_tpu/ops/pallas_pool.py``:
``_fwd_kernel`` (K8f, via ``_pool_call``), which the stride-1 backward also
runs on the output gradient with the tap table reversed for dx, and
``_dw_kernel`` (K8dw, via ``_dw_call``), the stride-1 weight gradient.

Contract: ``x5 [B, T, H, W, C]`` channels-last, ``w27 [27, C]`` the
row-flattened (dt, dh, dw) tap table in the dtype of x (the head-shared
weight tiled over the heads), kernel 3x3x3, zero pad 1, stride (1, s, s)
with s in {1, 2, 4, 8}; out ``[B, T, H', W', C]`` with ``H' = (H-1)//s + 1``.
Every product is taken in fp32 and the sum rounded once to the dtype of x.
The weight gradient is fp32 ``[27, C]``.

The kernels read x through its token-row stride (``x5.stride(3)``, with
``stride(2) = W * stride(3)`` and ``stride(1) = H * stride(2)``) and any
batch stride, so the model hands them a view of its fused qkv product
without a copy.  Each CTA walks t over a window of the input staged in
shared memory: a band of output rows, a tile of strips of ``SW`` output
columns and a slice of ``CS`` channels, sized by :func:`pool_plan`.  Each
wrapper launches its kernel for a CUDA tensor and takes the plain version
only for a CPU tensor.  :func:`depthwise_pool3d`
is the model's entry (JAX ``depthwise_pool3d``), through
:class:`DepthwisePool3DFunction`, which differentiates as JAX ``_dp_bwd``
does: at s == 1 with the kernel, dx is K8f on the output gradient with
``w27.flip(0)`` and dw is K8dw; otherwise the plain tap formulas
:func:`taps_dx` / :func:`taps_dw`.  ``use_kernel=False`` is the port of the
JAX package's tap ablation (``MVIT_POOL=taps``): the plain tap forward and
the tap formulas for the backward, on any device.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from procedurevrl_torch.ops import _build

KERNEL = "depthwise_pool3d_fwd"     # K8f
KERNEL_DX = "depthwise_pool3d_dx"   # K8f on g with the taps reversed
KERNEL_DW = "depthwise_pool3d_dw"   # K8dw
KTAPS = 27
STRIDES = (1, 2, 4, 8)
VEC = 8               # channel and stride multiple (16 bytes of bf16)
# the kernels' tiling (``csrc/depthwise_pool.cu``): a thread owns 2 channels
# (K8f) or 1 (K8dw) of a strip of SW output columns; a CTA a slice of CS
# channels, at most MAX_THREADS threads and SMEM_MAX bytes of shared memory
SW = 7
CS = 32
FWD_LANES = CS // 2           # K8f threads across a slice (2 channels each)
MAX_THREADS = 512
SMEM_MAX = 232448
MAX_BOX = 256                 # a TMA box's extent along each dimension
BAR_BYTES = 128               # the ring's mbarriers
W_BYTES = KTAPS * CS * 4      # K8f's fp32 weights in shared memory
FWD_SLOTS, DW_SLOTS = 3, 4    # ring slots of K8f and of K8dw
# the planner aims a CTA at this many threads and its ring at this many
# bytes, so that two CTAs share an SM
TARGET_THREADS = 256
RING_BYTES = 112 * 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (dt, dh, dw) of tap row r = dt*9 + dh*3 + dw
_TAPS = tuple((dt, dh, dw) for dt in range(3) for dh in range(3)
              for dw in range(3))


def out_hw(d: int, s: int) -> int:
    """Output length of one padded pooled axis (pad 1, kernel 3)."""
    return (d - 1) // s + 1


def supported(kernel, stride) -> bool:
    """Whether this pool geometry has the kernel and tap paths (JAX
    ``pallas_pool.supported``)."""
    return (tuple(kernel) == (3, 3, 3) and len(stride) == 3
            and stride[0] == 1 and stride[1] == stride[2]
            and stride[1] in STRIDES)


def _tap_ranges(dims, strides, out_dims, taps):
    """Per axis (start, count, lo_pad, hi_pad) of one tap over the output
    positions it reaches, or None if it reaches none (JAX
    ``pallas_pool._tap_ranges``)."""
    out = []
    for d, s, o, k in zip(dims, strides, out_dims, taps):
        # input index feeding output j is s*j + k - 1
        lo = max(0, (1 - k + s - 1) // s)
        hi = min(o - 1, (d - k) // s)
        if hi < lo:
            return None
        out.append((s * lo + k - 1, hi - lo + 1, lo, o - 1 - hi))
    return out


def _strided(rng, strides):
    """Index of the input taps of ``rng`` on the (T, H, W) axes."""
    return tuple(slice(start, start + (n - 1) * s + 1, s)
                 for (start, n, _, _), s in zip(rng, strides))


def _dense(rng):
    """Index of the output positions of ``rng`` on the (T, H, W) axes."""
    return tuple(slice(lo, lo + n) for _, n, lo, _ in rng)


# ----------------------------------------------------------- plain versions


def depthwise_pool3d_taps(x5: torch.Tensor, w27: torch.Tensor,
                          stride: Sequence[int]) -> torch.Tensor:
    """Plain version of K8f: the pool as 27 shifted strided slices, summed
    in fp32 in tap order and rounded once (JAX ``depthwise_pool3d_taps``)."""
    B, T, H, W, C = x5.shape
    dims, strides = (T, H, W), tuple(stride)
    out_dims = tuple(out_hw(d, s) for d, s in zip(dims, strides))
    acc = torch.zeros((B, *out_dims, C), dtype=torch.float32,
                      device=x5.device)
    wf = w27.float()
    for r, taps in enumerate(_TAPS):
        rng = _tap_ranges(dims, strides, out_dims, taps)
        if rng is None:
            continue
        acc[(slice(None), *_dense(rng))] += (
            x5[(slice(None), *_strided(rng, strides))].float() * wf[r])
    return acc.to(x5.dtype)


def taps_dx(g5: torch.Tensor, w27: torch.Tensor, stride: Sequence[int],
            in_dims: Sequence[int]) -> torch.Tensor:
    """The transposed pool: dx as the sum over taps of g * w scattered to
    the input positions each tap read, in fp32, rounded once to the dtype
    of g (JAX ``_taps_dx``)."""
    B, C = g5.shape[0], g5.shape[-1]
    dims, strides = tuple(in_dims), tuple(stride)
    out_dims = tuple(g5.shape[1:4])
    dx = torch.zeros((B, *dims, C), dtype=torch.float32, device=g5.device)
    wf = w27.float()
    for r, taps in enumerate(_TAPS):
        rng = _tap_ranges(dims, strides, out_dims, taps)
        if rng is None:
            continue
        dx[(slice(None), *_strided(rng, strides))] += (
            g5[(slice(None), *_dense(rng))].float() * wf[r])
    return dx.to(g5.dtype)


def taps_dw(x5: torch.Tensor, g5: torch.Tensor,
            stride: Sequence[int]) -> torch.Tensor:
    """Plain version of K8dw (any stride): fp32 ``[27, C]``, row r the sum
    over every output position of the tap-r input times g (JAX
    ``_taps_dw``)."""
    B, T, H, W, C = x5.shape
    dims, strides = (T, H, W), tuple(stride)
    out_dims = tuple(g5.shape[1:4])
    rows = []
    for taps in _TAPS:
        rng = _tap_ranges(dims, strides, out_dims, taps)
        if rng is None:
            rows.append(torch.zeros(C, dtype=torch.float32, device=x5.device))
            continue
        xs = x5[(slice(None), *_strided(rng, strides))].float()
        gs = g5[(slice(None), *_dense(rng))].float()
        rows.append((xs * gs).sum(dim=(0, 1, 2, 3)))
    return torch.stack(rows, dim=0)


# ------------------------------------------------------------ the tiling


class PoolPlan(NamedTuple):
    """A launch's CTA tile: ``band`` output rows by ``strips`` strips of SW
    output columns by CS channels; ``bands``, ``tiles``, ``slices`` CTAs
    along H', W' and C (per batch element); ``lanes`` threads across the
    CS channels (FWD_LANES for K8f, CS for K8dw)."""
    band: int
    strips: int
    bands: int
    tiles: int
    slices: int
    lanes: int

    @property
    def threads(self) -> int:
        return _threads(self.band, self.strips, self.lanes)

    @property
    def parts(self) -> int:
        """K8dw partials per batch element (one per band and tile)."""
        return self.bands * self.tiles


def _odd(n: int) -> int:
    return n | 1


def _threads(band: int, strips: int, lanes: int) -> int:
    return -(-band * strips * lanes // 32) * 32


def _r128(n: int) -> int:
    return -(-n // 128) * 128


def _boxes(band: int, strips: int, s: int) -> Tuple[int, int, int]:
    """(rows, columns) of a CTA's staged x box and the columns of its g
    box, each column count odd (``make_geo`` in the source)."""
    return ((band - 1) * s + 3, _odd((strips * SW - 1) * s + 3),
            _odd(strips * SW))


def smem_bytes(band: int, strips: int, s: int, esize: int,
               dw: bool = False) -> int:
    """Shared memory of a K8f (or K8dw) CTA of ``band`` x ``strips`` at
    stride s, as ``smem_of`` in the source computes it."""
    rows, pitch, gpitch = _boxes(band, strips, s)
    slot = _r128(rows * pitch * CS * esize)
    if not dw:
        return BAR_BYTES + W_BYTES + FWD_SLOTS * slot
    slot += _r128(band * gpitch * CS * esize)
    red = _threads(band, strips, CS) // 32 * KTAPS * CS * 4
    return BAR_BYTES + max(DW_SLOTS * slot, red)


def _fits(band: int, strips: int, s: int, esize: int, dw: bool,
          limit: int) -> bool:
    """Whether a CTA of ``band`` x ``strips`` takes at most ``limit`` bytes
    of shared memory and its boxes stay within MAX_BOX."""
    return (max(_boxes(band, strips, s)) <= MAX_BOX
            and smem_bytes(band, strips, s, esize, dw) <= limit)


def pool_plan(h: int, w: int, c: int, s: int, esize: int,
              dw: bool = False) -> PoolPlan:
    """The CTA tile of a launch on an [*, *, h, w, c] input at stride s
    with elements of ``esize`` bytes: the strips of a row split evenly over
    the fewest tiles that keep a band of one row within MAX_THREADS and
    RING_BYTES, then the rows split evenly over the fewest bands of at most
    TARGET_THREADS threads (at least one row) within RING_BYTES."""
    ho, wo = out_hw(h, s), out_hw(w, s)
    lanes = CS if dw else FWD_LANES
    nstrip = -(-wo // SW)
    tiles = 1
    while True:
        strips = -(-nstrip // tiles)
        if strips == 1 or (strips * lanes <= MAX_THREADS and _fits(
                1, strips, s, esize, dw, RING_BYTES)):
            break
        tiles += 1
    tiles = -(-nstrip // strips)
    band = max(1, min(ho, TARGET_THREADS // (lanes * strips)))
    while band > 1 and not _fits(band, strips, s, esize, dw, RING_BYTES):
        band -= 1
    bands = -(-ho // band)
    return PoolPlan(-(-ho // bands), strips, bands, tiles, -(-c // CS), lanes)


def plan_cover(plan: PoolPlan, ho: int, wo: int, c: int) -> torch.Tensor:
    """How many times the kernels write each ``[ho, wo, c]`` output of one
    batch element under ``plan``: ``blockIdx.x`` decoded as the kernels
    decode it (tile fastest, then band, then slice), ``threadIdx.x`` as
    lane in the slice, then strip, then row, each thread writing CS /
    lanes channels of the SW columns of its strip that lie inside."""
    cta = torch.arange(plan.bands * plan.tiles * plan.slices)
    tile, band = cta % plan.tiles, cta // plan.tiles % plan.bands
    slice_ = cta // (plan.tiles * plan.bands)
    thread = torch.arange(plan.threads)
    lane, q = thread % plan.lanes, thread // plan.lanes
    per = CS // plan.lanes
    row = band[:, None] * plan.band + q // plan.strips          # [cta, thread]
    w0 = tile[:, None] * plan.strips * SW + q % plan.strips * SW
    ch = slice_[:, None] * CS + lane * per
    owns = (q < plan.band * plan.strips) & (row < ho) & (w0 < wo) & (ch < c)
    col = w0[..., None, None] + torch.arange(SW)[:, None]        # [.., k, e]
    chan = ch[..., None, None] + torch.arange(per)
    index = (row[..., None, None] * wo + col) * c + chan
    keep = (owns[..., None, None] & (col < wo)).expand_as(index)
    cover = torch.zeros(ho * wo * c, dtype=torch.int64)
    cover.index_add_(0, index[keep], torch.ones_like(index[keep]))
    return cover.view(ho, wo, c)


# ------------------------------------------------------------ the kernels


def _geometry(x5: torch.Tensor) -> Tuple[int, int]:
    """(token-row stride, batch stride) of x5 in elements; raises unless
    the (T, H, W) positions are evenly spaced rows of C channels.  The
    stride of an axis of length 1 is never stepped, so it says nothing:
    the row stride comes from the innermost longer axis (C with none), and
    a single batch element's stride is taken as T*H*W rows."""
    B, T, H, W, C = x5.shape
    spans = {3: 1, 2: W, 1: H * W}  # positions one step of each axis spans
    longer = [a for a in (3, 2, 1) if x5.shape[a] > 1]
    row = x5.stride(longer[0]) // spans[longer[0]] if longer else C
    if (x5.stride(4) != 1 or row < C
            or any(x5.stride(a) != spans[a] * row for a in longer)):
        raise ValueError(f"depthwise_pool3d: strides {x5.stride()} of "
                         f"{tuple(x5.shape)} are not evenly spaced "
                         f"channels-last token rows")
    return row, x5.stride(0) if B > 1 else T * H * W * row


def _check_kernel(x5: torch.Tensor, other: torch.Tensor) -> Tuple[int, int]:
    if x5.dim() != 5:
        raise ValueError("depthwise_pool3d: x must be [B, T, H, W, C]")
    if x5.device.type != "cuda" or other.device != x5.device:
        raise ValueError(f"depthwise_pool3d: no kernel for device {x5.device}")
    if x5.dtype not in _DTYPES or other.dtype != x5.dtype:
        raise ValueError(f"depthwise_pool3d: dtypes {x5.dtype} / "
                         f"{other.dtype} not supported")
    if not other.is_contiguous():
        raise ValueError("depthwise_pool3d: w27 and g must be contiguous")
    row, batch = _geometry(x5)
    if x5.shape[4] % VEC or row % VEC or batch % VEC:
        raise ValueError(f"depthwise_pool3d: channels and strides must be "
                         f"multiples of {VEC}")
    for t in (x5, other):
        if t.data_ptr() % 16:
            raise ValueError("depthwise_pool3d: inputs must be 16-byte "
                             "aligned")
    return row, batch


def _launch(fn: str, kernel: str, x5: torch.Tensor, *args) -> None:
    lib = _build.load("depthwise_pool")
    with torch.cuda.device(x5.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    _build.check(rc, kernel)
    _build.count_launch(kernel)


def _pool_kernel(kernel: str, x5, w27, s: int,
                 flip: bool = False) -> torch.Tensor:
    """K8f's launch; ``flip`` reads the tap table reversed."""
    row, batch = _check_kernel(x5, w27)
    B, T, H, W, C = x5.shape
    plan = pool_plan(H, W, C, s, x5.element_size())
    out = torch.empty((B, T, out_hw(H, s), out_hw(W, s), C), dtype=x5.dtype,
                      device=x5.device)
    _launch("depthwise_pool3d_fwd", kernel, x5, x5.data_ptr(), w27.data_ptr(),
            out.data_ptr(), B, T, H, W, C, s, plan.band, plan.strips, row,
            batch, int(flip), _DTYPES[x5.dtype])
    return out


def _check(x5: torch.Tensor, w27: torch.Tensor, s: int) -> None:
    if x5.dim() != 5 or w27.shape != (KTAPS, x5.shape[-1]):
        raise ValueError(f"depthwise_pool3d: x {tuple(x5.shape)} and w27 "
                         f"{tuple(w27.shape)} are not [B, T, H, W, C] and "
                         f"[27, C]")
    if s not in STRIDES:
        raise ValueError(f"depthwise_pool3d: stride {s} not in {STRIDES}")


def depthwise_pool3d_fwd(x5: torch.Tensor, w27: torch.Tensor,
                         s: int) -> torch.Tensor:
    """K8f: the pool at stride (1, s, s); x5 float32 or bfloat16 with
    evenly spaced token rows, w27 contiguous in the dtype of x5."""
    _check(x5, w27, s)
    if x5.device.type == "cpu":
        return depthwise_pool3d_taps(x5, w27, (1, s, s))
    return _pool_kernel(KERNEL, x5, w27, s)


def depthwise_pool3d_dx(g5: torch.Tensor, w27: torch.Tensor) -> torch.Tensor:
    """dx of the stride-1 pool: K8f on the output gradient with the tap
    table reversed (JAX ``_dp_bwd``: ``_pool_call(g, w27[::-1], 1)``); the
    kernel reads w27's rows in reverse order, so no flipped copy is made."""
    _check(g5, w27, 1)
    if g5.device.type == "cpu":
        return depthwise_pool3d_taps(g5, w27.flip(0), (1, 1, 1))
    return _pool_kernel(KERNEL_DX, g5, w27, 1, flip=True)


def depthwise_pool3d_dw(x5: torch.Tensor, g5: torch.Tensor) -> torch.Tensor:
    """K8dw: the stride-1 weight gradient, fp32 ``[27, C]``; g5 contiguous
    ``[B, T, H, W, C]`` in the dtype of x5.  Deterministic: one fp32
    partial per (batch element, band, tile) of the plan, then a second pass
    that adds them in a fixed order."""
    if x5.dim() != 5 or g5.shape != x5.shape:
        raise ValueError(f"depthwise_pool3d_dw: x {tuple(x5.shape)} and g "
                         f"{tuple(g5.shape)} differ")
    if x5.device.type == "cpu":
        return taps_dw(x5, g5, (1, 1, 1))
    row, batch = _check_kernel(x5, g5)
    B, T, H, W, C = x5.shape
    plan = pool_plan(H, W, C, 1, x5.element_size(), dw=True)
    partial = torch.empty((B * plan.parts, KTAPS, C), dtype=torch.float32,
                          device=x5.device)
    dw = torch.empty((KTAPS, C), dtype=torch.float32, device=x5.device)
    _launch("depthwise_pool3d_dw", KERNEL_DW, x5, x5.data_ptr(),
            g5.data_ptr(), partial.data_ptr(), dw.data_ptr(), B, T, H, W, C,
            plan.band, plan.strips, row, batch, _DTYPES[x5.dtype])
    return dw


class DepthwisePool3DFunction(torch.autograd.Function):
    """The pool under autograd (JAX ``depthwise_pool3d`` with ``_dp_fwd`` /
    ``_dp_bwd``); dx and dw come back in the dtypes of x and w27."""

    @staticmethod
    def forward(ctx, x5, w27, s: int, use_kernel: bool):
        ctx.save_for_backward(x5, w27)
        ctx.s, ctx.use_kernel = s, use_kernel
        if use_kernel:
            return depthwise_pool3d_fwd(x5, w27, s)
        return depthwise_pool3d_taps(x5, w27, (1, s, s))

    @staticmethod
    def backward(ctx, g5):
        x5, w27 = ctx.saved_tensors
        s = ctx.s
        if s == 1 and ctx.use_kernel:
            g = g5.to(x5.dtype).contiguous()
            dx = depthwise_pool3d_dx(g, w27)
            dw = depthwise_pool3d_dw(x5, g)
        else:
            dx = taps_dx(g5, w27, (1, s, s), x5.shape[1:4])
            dw = taps_dw(x5, g5, (1, s, s))
        return dx.to(x5.dtype), dw.to(w27.dtype), None, None


def depthwise_pool3d(x5: torch.Tensor, w27: torch.Tensor, s: int,
                     use_kernel: bool = True) -> torch.Tensor:
    """The model's entry: :class:`DepthwisePool3DFunction` (which records
    no backward when no gradient is wanted)."""
    _check(x5, w27, s)
    return DepthwisePool3DFunction.apply(x5, w27, s, use_kernel)
