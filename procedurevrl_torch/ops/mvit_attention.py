"""K5 / K6 / K7: MViT pooled attention with the decomposed
relative-position bias (``csrc/mvit_attention.cu``).

Replaces the TPU kernels of ``procedurevrl_tpu/ops/pallas_mvit_attention.py``
on the default single-device path: ``_fwd_hl_kernel`` (K5f) and
``_bwd_hl_kernel`` (K5b), the head-last ``flash_attention_mvit_hl``, and
``_fwd_kernel`` (K6f) and ``_bwd_kernel`` (K6b), the head-split
``flash_attention_mvit`` that the model takes for wide key sets.  Both
compute the same function on different layouts, so one CUDA kernel serves
both: the head-last call passes the token-row stride H*d, the head-split
call d.  The kernels take every head dim d (MViT-v2-S has 96, MViT-v2-L
72): the bf16 tensor-core kernels the multiples of 8 up to
``MAX_HEAD_DIM`` (:func:`on_tensor_cores`), padded to a tile width of 64,
96 or 128 with zero columns; scalar kernels float32 at every d and bf16 at
the other head dims, in column groups of 128.

Contract (head-split; the head-last layout holds the same per (b, h)):
q [BH, qN, d] body queries; k, v [BH, kN, d] body keys and values,
row-major over the pooled key grid ``k_shape = (kt, kh, kw)``; kc, vc
[BH, 1, d] the cls key and value, key column kN, which takes no bias;
rel [BH, qN, kt + kh + kw] the per-axis bias tables in the order
[t | h | w].  ``s = (q.k) scale + (rel_t + rel_h) + rel_w`` in fp32, the
softmax ``p = e / l`` over the kN + 1 columns under the shift
``MVIT_SHIFT`` (each wrapper's ``shift``): ``clamp`` (default) e =
exp(min(s, 80)), ``max`` e = exp(s - m) with m the row max, ``none`` e =
exp(s); ``o = bf16(p) v`` accumulated in fp32 (the bf16 tensor-core kernel,
one sweep over the keys, and every forward under ``max`` round e instead:
``o = (bf16(e) v) / l``, :func:`rounds_e`; the plain versions round where
the kernels do).  The forward also returns the fp32 row statistic ([B, H,
qN]), the backward's residual: the row sums ``l``, under ``max`` lse = m +
log l (K7f's kernel, the row-max switch; K6sp's first sweep then finds m
and l, its second forms p with the final m); the backward is the TPU
kernel's (``ds = p (dp - rowsum(dp p))``, cast to the input dtype before
the dq, dk and d(rel) products; dk, dv summed over every query in fp32),
under ``none`` from p = exp(s) / l; under ``max`` K5b / K6b and K5bd /
K6bd are K7b's ``ROWMAX`` variant, p = exp(s - lse) and D = rowsum(g o)
from the saved output, which equals JAX's rowsum(dp p).  The CLS query row
is not part of it: the model computes it.

Each wrapper launches the kernel for a CUDA tensor and takes the plain
version only for a CPU tensor.  :func:`mvit_attention_hl` and
:func:`mvit_attention` are the model's entries: under grad they go through
:class:`MViTAttention` (forward kernel, then backward kernel), otherwise
straight to the forward.  K5b and K6b each run two CUDA kernels (a
query-major and a key-major pass, the latter over ``key_splits`` query
chunks with a reduction where its key tiles alone do not fill the card);
a wrapper call counts as one launch.

The knob variants (JAX ``pallas_mvit_attention.py:517-547``, read by the
model from ``MVIT_DELTA`` / ``MVIT_SAVE_PROBS``): K5bd (``_bwd_hl_kernel_delta``)
and K6bd (``_bwd_kernel_delta``) are K5b / K6b with ``D_i = sum_d g_id o_id``
from the saved forward output in place of ``rowsum(dp p)``;
:class:`MViTAttentionDelta` saves o beside the row sums.  K6sp
(``_fwd_kernel_saveprobs``) is K6f that also writes ``bf16(p)``, probs
[BH, qN, LP] with LP = kN + 1 rounded up to 8 (columns 0..kN-1 the body
keys, kN the cls key, the rest zero), and K6bs (``_bwd_kernel_saveprobs``)
is the backward from them, which forms no logits: ``ds = p (dp - rowsum(dp
p))`` with p the saved value; :class:`MViTAttentionSaved` saves p.  The
head-last K5 has no saved-probability form.

K7 (``_fwd_hl_kt_kernel`` / ``_bwd_hl_kt_kernel``, the JAX model's route
for wide-key blocks under ``MVIT_KT=1`` where ``kt_supported`` holds) has
K5's head-last contract with another softmax: the row max, not the clamp.
``p = exp(s - m)`` with m the row max over the kN + 1 columns, ``o =
bf16(p) v / l`` (the unnormalised p rounded), and the forward returns the
fp32 log-sum-exp ``lse = m + log l`` ([B, H, qN]) instead of l.  The
backward rebuilds ``p = exp(s - lse)`` and takes ``D = rowsum(g o)`` from
the saved output; the TPU kernel's products there are fp32 (dv from the
fp32 p), which the plain version follows.  The two softmaxes agree unless
a row's largest logit reaches 80.  :func:`mvit_attention_kt` is the
model's entry, through :class:`MViTAttentionKT` under grad.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from procedurevrl_torch.ops import _build
from procedurevrl_torch.ops.attention_route import shift_code, shifted_exp

KERNEL_HL = "mvit_attention_hl_fwd"      # K5f
KERNEL_HL_BWD = "mvit_attention_hl_bwd"  # K5b
KERNEL = "mvit_attention_fwd"            # K6f
KERNEL_BWD = "mvit_attention_bwd"        # K6b
KERNEL_KT = "mvit_attention_kt_fwd"      # K7f
KERNEL_KT_BWD = "mvit_attention_kt_bwd"  # K7b
KERNEL_HL_BWD_DELTA = "mvit_attention_hl_bwd_delta"  # K5bd
KERNEL_BWD_DELTA = "mvit_attention_bwd_delta"        # K6bd
KERNEL_PROBS = "mvit_attention_fwd_probs"            # K6sp
KERNEL_BWD_PROBS = "mvit_attention_bwd_probs"        # K6bs
# the widest head dim of the bf16 tensor-core kernels (the source's MAX_D)
MAX_HEAD_DIM = 128
MAX_KCAT = 48
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the backward's variants, the ``enum Bwd`` of the source
RECOMPUTE, ROWMAX, DELTA, SAVED = 0, 1, 2, 3
BM = 64   # query rows per tile of the bf16 backward
KM = 128  # keys of a key-major CTA of the bf16 backward (two warpgroups)
# key-major CTAs the split aims for: two per SM, two waves of the one
# resident CTA per SM of MViT-v2-S's widths
CTAS_PER_SM = 2

# The reference's routing, copied so that the port takes the same kernel
# for each block as the JAX model (``pallas_mvit_attention.py:72-80,
# 667-691``): a block runs fused when qN >= MIN_FUSED_QN and kN <=
# MAX_FUSED_KN, head-last when ``hl_supported``, else head-split.  The
# thresholds model the TPU's VMEM budget and mean nothing of their own on
# the card; a later PR may route by what suits the card instead.
MIN_FUSED_QN = 64
MAX_FUSED_KN = 2048

Grads = Tuple[torch.Tensor, ...]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _hl_geometry(kp: int, C: int, H: int, d: int):
    """(head group, width, query tile) of the TPU head-last kernel, or None
    when none fits its VMEM (copy of the reference's budget model)."""
    hgs = [H] + [h for h in (8, 4, 2) if h < H and H % h == 0
                 and (h * d) % 128 == 0]
    for tq in (512, 256, 128):
        for hg in hgs:
            w = hg * d
            acc = 2 * kp * w * 4
            kv = 2 * kp * w * 2
            qg = 2 * 3 * tq * w * 2
            rel = 2 * 3 * tq * hg * 32 * 4
            stack = (14 * tq * kp + 4 * kp * w) * 4
            if acc + kv + qg + rel + stack <= 15 * 2 ** 20:
                return hg, w, tq
    return None


def hl_supported(kn: int, C: int, H: int) -> bool:
    """Whether the reference routes a block with kN keys, width C and H
    heads to the head-last kernel (K5) rather than the head-split one (K6)."""
    return _hl_geometry(_round_up(kn + 1, 128), C, H, C // H) is not None


def _hl_kt_geometry(C: int, H: int, d: int):
    """(head group, width, (query tile, key chunk) forward, the same
    backward) of the TPU key-tiled kernel, or None (copy of the
    reference's calibrated table; the tiles model the TPU's VMEM and serve
    the routing only)."""
    w = H * d
    if w % 128 and w != C:
        return None
    if w <= 384:
        return H, w, (256, 512), (128, 128)
    return None


def kt_supported(C: int, H: int) -> bool:
    """Whether the reference routes a wide-key block of width C and H heads
    to K7 under ``MVIT_KT=1`` (else to K6)."""
    return _hl_kt_geometry(C, H, C // H) is not None


# ----------------------------------------------------------- plain versions


def _axis_index(k_shape: Sequence[int], device) -> Tuple[torch.Tensor, ...]:
    """Columns of rel [t | h | w] that each body key (t', h', w') reads."""
    kt, kh, kw = k_shape
    j = torch.arange(kt * kh * kw, device=device)
    return j // (kh * kw), kt + (j // kw) % kh, kt + kh + j % kw


def _logits(q, k, kc, rel, k_shape, scale: float) -> torch.Tensor:
    """fp32 logits [G, qN, kN + 1] of the head-split layout, cls last."""
    kk = torch.cat([k, kc], dim=1)
    s = torch.einsum("gid,gjd->gij", q.float(), kk.float()) * scale
    it, ih, iw = _axis_index(k_shape, q.device)
    r = rel.float()
    bias = (r[..., it] + r[..., ih]) + r[..., iw]
    kn = k.shape[1]
    return torch.cat([s[..., :kn] + bias, s[..., kn:]], dim=-1)


def _fwd_core(q, k, v, kc, vc, rel, k_shape, scale, shift: str = "clamp"):
    """(out, the fp32 row statistic, p) of the head-split layout under the
    softmax shift (``MVIT_SHIFT``; JAX ``_probs``): e = exp(min(s, 80)),
    exp(s - m) with m the row max (``max``) or exp(s) (``none``); the output
    rounded where the kernel of this dtype and head dim rounds: e before P V
    and l after (:func:`rounds_e`, and every forward under ``max``), else p
    = e / l; the statistic l, under ``max`` lse = m + log l; p = e / l in
    the input dtype."""
    s = _logits(q, k, kc, rel, k_shape, scale)
    e = shifted_exp(s, shift)
    l = e.sum(dim=-1)
    p = (e / l[..., None]).to(v.dtype)
    vv = torch.cat([v, vc], dim=1).float()
    if rounds_e(v.dtype, v.shape[-1]) or shift == "max":
        o = torch.einsum("gij,gjd->gid", e.to(v.dtype).float(), vv)
        o = o / l[..., None]
    else:
        o = torch.einsum("gij,gjd->gid", p.float(), vv)
    stat = (s.amax(dim=-1).detach() + torch.log(l) if shift == "max"
            else l)
    return o.to(q.dtype), stat, p


def _probs(q, k, kc, rel, rowsum, k_shape, scale,
           shift: str = "clamp") -> torch.Tensor:
    """fp32 p from the forward's row statistic: exp(min(s, 80)) / l
    (``none``: exp(s) / l), under ``max`` exp(s - lse)."""
    s = _logits(q, k, kc, rel, k_shape, scale)
    if shift == "max":
        return torch.exp(s - rowsum[..., None])
    return shifted_exp(s, shift) / rowsum[..., None]


def _bwd_core(q, k, v, kc, vc, rel, pf, g, k_shape, scale, out=None):
    """The backward from fp32 probabilities pf [G, qN, kN + 1]: D =
    rowsum(dp pf), or ``sum_d g o`` from the saved output ``out``."""
    dt = q.dtype
    kn = k.shape[1]
    kt, kh, kw = k_shape
    kk = torch.cat([k, kc], dim=1).float()
    vv = torch.cat([v, vc], dim=1).float()
    gf = g.float()
    dv = torch.einsum("gij,gid->gjd", pf.to(dt).float(), gf)
    dp = torch.einsum("gid,gjd->gij", gf, vv)
    delta = ((dp * pf).sum(dim=-1, keepdim=True) if out is None
             else (gf * out.float()).sum(dim=-1, keepdim=True))
    ds = pf * (dp - delta)
    ds_c = ds.to(dt).float()
    dq = (torch.einsum("gij,gjd->gid", ds_c, kk) * scale).to(dt)
    dk = torch.einsum("gij,gid->gjd", ds_c, q.float()) * scale
    body = ds_c[..., :kn].reshape(*ds_c.shape[:2], kt, kh, kw)
    drel = torch.cat([body.sum(dim=(3, 4)), body.sum(dim=(2, 4)),
                      body.sum(dim=(2, 3))], dim=-1).to(rel.dtype)
    return (dq, dk[:, :kn].to(dt), dv[:, :kn].to(dt), dk[:, kn:].to(dt),
            dv[:, kn:].to(dt), drel)


def _split(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, L, H*c] -> [B*H, L, c]."""
    b, n, c = x.shape
    return x.reshape(b, n, heads, c // heads).transpose(1, 2).reshape(
        b * heads, n, c // heads)


def _merge(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B*H, L, c] -> [B, L, H*c]."""
    bh, n, c = x.shape
    return x.reshape(bh // heads, heads, n, c).transpose(1, 2).reshape(
        bh // heads, n, heads * c)


def mvit_attention_fwd_plain(q, k, v, kc, vc, rel, k_shape, scale,
                             shift: str = "clamp"
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K6f: (out [BH, qN, d], rowsum [BH, 1, qN];
    lse under ``max``)."""
    o, l, _ = _fwd_core(q, k, v, kc, vc, rel, k_shape, scale, shift)
    return o, l[:, None]


def mvit_attention_plain(q, k, v, kc, vc, rel, k_shape, scale,
                         shift: str = "clamp") -> torch.Tensor:
    """The output of :func:`mvit_attention_fwd_plain` (the function of JAX
    ``flash_attention_mvit``)."""
    return _fwd_core(q, k, v, kc, vc, rel, k_shape, scale, shift)[0]


def mvit_attention_bwd_plain(q, k, v, kc, vc, rel, rowsum, g, k_shape,
                             scale, shift: str = "clamp", out=None) -> Grads:
    """Plain PyTorch version of K6b, the backward written out: (dq, dk, dv,
    dkc, dvc, drel) from the forward's row statistic and the output
    gradient; D = rowsum(dp p), or sum_d g o where the forward's output
    ``out`` is given (the kernel's D under ``max``)."""
    pf = _probs(q, k, kc, rel, rowsum[:, 0], k_shape, scale, shift)
    return _bwd_core(q, k, v, kc, vc, rel, pf, g, k_shape, scale, out)


def mvit_attention_bwd_delta_plain(q, k, v, kc, vc, rel, rowsum, out, g,
                                   k_shape, scale,
                                   shift: str = "clamp") -> Grads:
    """Plain PyTorch version of K6bd: K6b with D = sum_d g o from the
    forward's output ``out``."""
    pf = _probs(q, k, kc, rel, rowsum[:, 0], k_shape, scale, shift)
    return _bwd_core(q, k, v, kc, vc, rel, pf, g, k_shape, scale, out)


def probs_stride(kn: int) -> int:
    """Row stride LP of K6sp's probabilities: kN + 1 rounded up to 8."""
    return _round_up(kn + 1, 8)


def mvit_attention_fwd_probs_plain(q, k, v, kc, vc, rel, k_shape, scale,
                                   shift: str = "clamp"
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Plain PyTorch version of K6sp: K6f's (out, rowsum) and the
    probabilities bf16(p) it multiplies with, [BH, qN, LP] in the input
    dtype, zero past column kN."""
    o, l, p = _fwd_core(q, k, v, kc, vc, rel, k_shape, scale, shift)
    pad = probs_stride(k.shape[1]) - p.shape[-1]
    return o, l[:, None], torch.nn.functional.pad(p, (0, pad))


def mvit_attention_bwd_probs_plain(q, k, v, kc, vc, rel, probs, g, k_shape,
                                   scale) -> Grads:
    """Plain PyTorch version of K6bs, the backward from K6sp's saved
    probabilities (their kN + 1 valid columns) in place of recomputed
    ones."""
    pf = probs[..., :k.shape[1] + 1].float()
    return _bwd_core(q, k, v, kc, vc, rel, pf, g, k_shape, scale)


def mvit_attention_hl_fwd_plain(q, k, v, kc, vc, rel, k_shape, num_heads,
                                scale, shift: str = "clamp"
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5f on the head-last layout: q [B, qN, C],
    k, v [B, kN, C], kc, vc [B, 1, C], rel [B, qN, H*kcat] -> (out
    [B, qN, C], rowsum [B, H, qN]; lse under ``max``)."""
    h = num_heads
    o, l, _ = _fwd_core(_split(q, h), _split(k, h), _split(v, h),
                        _split(kc, h), _split(vc, h), _split(rel, h), k_shape,
                        scale, shift)
    return _merge(o, h), l.reshape(q.shape[0], h, -1)


def mvit_attention_hl_plain(q, k, v, kc, vc, rel, k_shape, num_heads,
                            scale, shift: str = "clamp") -> torch.Tensor:
    """The output of :func:`mvit_attention_hl_fwd_plain` (the function of
    JAX ``flash_attention_mvit_hl``)."""
    return mvit_attention_hl_fwd_plain(q, k, v, kc, vc, rel, k_shape,
                                       num_heads, scale, shift)[0]


def mvit_attention_hl_bwd_plain(q, k, v, kc, vc, rel, rowsum, g, k_shape,
                                num_heads, scale, shift: str = "clamp",
                                out=None) -> Grads:
    """Plain PyTorch version of K5b on the head-last layout (D from ``out``
    where it is given, as :func:`mvit_attention_bwd_plain`)."""
    return _hl_bwd(q, k, v, kc, vc, rel, rowsum, out, g, k_shape, num_heads,
                   scale, shift)


def mvit_attention_hl_bwd_delta_plain(q, k, v, kc, vc, rel, rowsum, out, g,
                                      k_shape, num_heads, scale,
                                      shift: str = "clamp") -> Grads:
    """Plain PyTorch version of K5bd: K5b with D = sum_d g o from the
    forward's output ``out`` [B, qN, C]."""
    return _hl_bwd(q, k, v, kc, vc, rel, rowsum, out, g, k_shape, num_heads,
                   scale, shift)


def _hl_bwd(q, k, v, kc, vc, rel, rowsum, out, g, k_shape, h, scale,
            shift: str = "clamp") -> Grads:
    sq, sk, skc, srel = _split(q, h), _split(k, h), _split(kc, h), _split(rel, h)
    pf = _probs(sq, sk, skc, srel, rowsum.reshape(-1, rowsum.shape[-1]),
                k_shape, scale, shift)
    grads = _bwd_core(sq, sk, _split(v, h), skc, _split(vc, h), srel, pf,
                      _split(g, h), k_shape, scale,
                      None if out is None else _split(out, h))
    return tuple(_merge(x, h) for x in grads)


def _kt_bwd_core(q, k, v, kc, vc, rel, out, lse, g, k_shape, scale):
    dt = q.dtype
    kn = k.shape[1]
    kt, kh, kw = k_shape
    p = torch.exp(_logits(q, k, kc, rel, k_shape, scale) - lse[..., None])
    kk = torch.cat([k, kc], dim=1).float()
    vv = torch.cat([v, vc], dim=1).float()
    gf = g.float()
    delta = (gf * out.float()).sum(dim=-1, keepdim=True)
    dv = torch.einsum("gij,gid->gjd", p, gf)
    ds = p * (torch.einsum("gid,gjd->gij", gf, vv) - delta)
    dq = (torch.einsum("gij,gjd->gid", ds, kk) * scale).to(dt)
    dk = torch.einsum("gij,gid->gjd", ds, q.float()) * scale
    body = ds[..., :kn].reshape(*ds.shape[:2], kt, kh, kw)
    drel = torch.cat([body.sum(dim=(3, 4)), body.sum(dim=(2, 4)),
                      body.sum(dim=(2, 3))], dim=-1).to(rel.dtype)
    return (dq, dk[:, :kn].to(dt), dv[:, :kn].to(dt), dk[:, kn:].to(dt),
            dv[:, kn:].to(dt), drel)


def mvit_attention_kt_fwd_plain(q, k, v, kc, vc, rel, k_shape, num_heads,
                                scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K7f on the head-last layout (the shapes of
    K5f) -> (out [B, qN, C], lse [B, H, qN] fp32)."""
    return mvit_attention_hl_fwd_plain(q, k, v, kc, vc, rel, k_shape,
                                       num_heads, scale, "max")


def mvit_attention_kt_plain(q, k, v, kc, vc, rel, k_shape, num_heads,
                            scale) -> torch.Tensor:
    """The output of :func:`mvit_attention_kt_fwd_plain` (the function of
    JAX ``flash_attention_mvit_hl_kt``); autograd differentiates it."""
    return mvit_attention_kt_fwd_plain(q, k, v, kc, vc, rel, k_shape,
                                       num_heads, scale)[0]


def mvit_attention_kt_bwd_plain(q, k, v, kc, vc, rel, out, lse, g, k_shape,
                                num_heads, scale) -> Grads:
    """Plain PyTorch version of K7b, the TPU kernel's backward written out
    in fp32 (``pallas_mvit_attention.py:1083-1150``): (dq, dk, dv, dkc,
    dvc, drel) from the forward's output and lse and the output gradient."""
    h = num_heads
    grads = _kt_bwd_core(_split(q, h), _split(k, h), _split(v, h),
                         _split(kc, h), _split(vc, h), _split(rel, h),
                         _split(out, h), lse.reshape(-1, lse.shape[-1]),
                         _split(g, h), k_shape, scale)
    return tuple(_merge(x, h) for x in grads)


def mvit_attention_kt_bwd_rounded_plain(q, k, v, kc, vc, rel, out, lse, g,
                                        k_shape, num_heads, scale) -> Grads:
    """K7b's function with the kernel's rounding: p = exp(s - lse) in fp32,
    D = sum_d g o, and p and ds cast to the input dtype before the products
    (``_bwd_core``, as K5bd rounds), where
    :func:`mvit_attention_kt_bwd_plain` keeps the TPU kernel's fp32
    products.  The two agree in float32."""
    h = num_heads
    sq, sk, skc, srel = _split(q, h), _split(k, h), _split(kc, h), _split(rel, h)
    pf = torch.exp(_logits(sq, sk, skc, srel, k_shape, scale)
                   - lse.reshape(-1, lse.shape[-1])[..., None])
    grads = _bwd_core(sq, sk, _split(v, h), skc, _split(vc, h), srel, pf,
                      _split(g, h), k_shape, scale, _split(out, h))
    return tuple(_merge(x, h) for x in grads)


# ------------------------------------------------------------ the kernels


def _check(q, k, v, kc, vc, rel, k_shape, heads: int) -> None:
    if q.dim() != 3 or k.shape != v.shape or kc.shape != vc.shape:
        raise ValueError("mvit_attention: q [B, qN, C], k and v [B, kN, C], "
                         "kc and vc [B, 1, C]")
    b, qn, c = q.shape
    kcat = sum(k_shape)
    if (k.shape[0] != b or k.shape[2] != c or kc.shape != (b, 1, c)
            or k.shape[1] != k_shape[0] * k_shape[1] * k_shape[2]
            or rel.shape != (b, qn, heads * kcat) or c % heads):
        raise ValueError(
            f"mvit_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"kc {tuple(kc.shape)}, rel {tuple(rel.shape)} do not fit "
            f"k_shape {tuple(k_shape)} and {heads} heads")
    for t in (k, v, kc, vc, rel):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("mvit_attention: inputs differ in dtype or device")


def on_tensor_cores(d: int) -> bool:
    """Whether the bf16 tensor-core kernels take head dim ``d`` (the
    source's ``on_tensor_cores``): a multiple of 8 up to ``MAX_HEAD_DIM``."""
    return d % 8 == 0 and 8 <= d <= MAX_HEAD_DIM


def rounds_e(dtype: torch.dtype, d: int) -> bool:
    """Whether the K5/K6 forward of this dtype and head dim rounds the
    unnormalised e = exp(min(s, 80)) to the input dtype before P V and
    divides by l after (the bf16 tensor-core kernel, one sweep over the
    keys), rather than p = e / l (the scalar kernels, two sweeps; in float32
    nothing is rounded either way)."""
    return dtype == torch.bfloat16 and on_tensor_cores(d)


def _check_kernel(tensors, heads: int, k_shape) -> None:
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"mvit_attention: no kernel for device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"mvit_attention: dtype {q.dtype} not supported")
    if sum(k_shape) > MAX_KCAT:
        raise ValueError(f"mvit_attention: the kernels take kt + kh + kw <= "
                         f"{MAX_KCAT}, not k_shape {tuple(k_shape)}")
    for t in tensors:
        if t.device != q.device:
            raise ValueError("mvit_attention: inputs on different devices")
        if not t.is_contiguous():
            raise ValueError("mvit_attention: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("mvit_attention: inputs must be 16-byte aligned")


def _launch(fn: str, kernel: str, q: torch.Tensor, *args) -> None:
    lib = _build.load("mvit_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    _build.check(rc, kernel)
    _build.count_launch(kernel)


def _fwd_kernel(fn, kernel, q, k, v, kc, vc, rel, k_shape, b, heads, scale,
                shift=None):
    """Launch entry point ``fn`` (under ``shift`` where it takes one): (out,
    the fp32 row statistic [b, heads, qN]: l for K5/K6 under clamp and
    none, lse under max and for K7)."""
    _check_kernel((q, k, v, kc, vc, rel), heads, k_shape)
    out = torch.empty_like(q)
    stats = torch.empty((b, heads, q.shape[1]), dtype=torch.float32,
                        device=q.device)
    code = () if shift is None else (shift_code(shift),)
    _launch(fn, kernel, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kc.data_ptr(), vc.data_ptr(), rel.data_ptr(), out.data_ptr(),
            stats.data_ptr(), b, heads, q.shape[1], k.shape[1], *k_shape,
            q.shape[2] // heads, _DTYPES[q.dtype], *code, float(scale))
    return out, stats


def key_splits(bh: int, qn: int, kn: int, sms: int) -> int:
    """Query chunks of the bf16 key-major pass: enough that its CTAs (tiles
    of ``KM`` keys x chunks x BH) reach ``CTAS_PER_SM`` per SM of a card
    with ``sms`` SMs, at most one per query tile.  MViT-v2-S at 18 clips on
    an H100 (132 SMs): 4 at block 0 (4 key tiles x 18 slices), 2 at block 2
    (4 x 36), 1 at every later block (4 x 72 or 13 x 72 already fill it)
    and at block 1 (13 x 36)."""
    ctas = -(-(kn + 1) // KM) * bh
    want = -(-CTAS_PER_SM * sms // ctas)
    return max(1, min(want, -(-qn // BM)))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _bwd_buffers(q, k, kc, rel, b, heads, splits):
    """delta, the gradients (dq, dk, dv, dkc, dvc, drel) and the key-major
    workspace (None with one chunk) of one backward call."""
    dev = q.device
    delta = torch.empty((b, heads, q.shape[1]), dtype=torch.float32,
                        device=dev)
    grads = tuple(torch.empty_like(t) for t in (q, k, k, kc, kc, rel))
    work = (torch.empty((2, splits, b * heads, k.shape[1] + 1,
                         q.shape[2] // heads), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    return delta, grads, work


def _splits(q, k, b, heads) -> int:
    if q.dtype != torch.bfloat16 or not on_tensor_cores(q.shape[2] // heads):
        return 1
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return key_splits(b * heads, q.shape[1], k.shape[1], sms)


def _bwd_kernel(variant, kernel, q, k, v, kc, vc, rel, g, k_shape, b, heads,
                scale, out=None, stats=None, probs=None, splits=None,
                shift: str = "clamp") -> Grads:
    """Launch the backward of ``variant`` with the forward's residuals
    (``stats``: l for K5b/K6b and K5bd/K6bd, lse for K7b; ``out`` for K7b
    and K5bd/K6bd; ``probs`` for K6bs), ``splits`` query chunks of the
    key-major pass (default :func:`key_splits`) and the shift of
    RECOMPUTE's and DELTA's p (clamp or none)."""
    saved = tuple(t for t in (out, stats, probs) if t is not None)
    _check_kernel((q, k, v, kc, vc, rel, g, *saved), heads, k_shape)
    splits = _splits(q, k, b, heads) if splits is None else splits
    delta, grads, work = _bwd_buffers(q, k, kc, rel, b, heads, splits)
    _launch("mvit_attention_bwd", kernel, q, variant, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), kc.data_ptr(), vc.data_ptr(),
            rel.data_ptr(), _ptr(out), _ptr(stats), _ptr(probs), g.data_ptr(),
            delta.data_ptr(), *(t.data_ptr() for t in grads), _ptr(work), b,
            heads, q.shape[1], k.shape[1], *k_shape, q.shape[2] // heads,
            splits, _DTYPES[q.dtype], shift_code(shift), float(scale))
    return grads


def _shifted_bwd(variant, kernel, q, k, v, kc, vc, rel, rowsum, out, g,
                 k_shape, b, heads, scale, shift: str) -> Grads:
    """K5b / K6b (``variant`` RECOMPUTE) or K5bd / K6bd (DELTA) under the
    forward's shift: under clamp and none the variant with p = exp(min(s,
    80)) / l or exp(s) / l; under max both take ROWMAX, K7b's arithmetic: p
    = exp(s - lse) from the max forward's lse and D = sum_d g o from its
    output ``out``."""
    if shift == "max":
        if out is None:
            raise ValueError("mvit_attention: under MVIT_SHIFT=max the "
                             "backward takes D from the forward's output")
        return _bwd_kernel(ROWMAX, kernel, q, k, v, kc, vc, rel, g, k_shape,
                           b, heads, scale, out=out, stats=rowsum)
    return _bwd_kernel(variant, kernel, q, k, v, kc, vc, rel, g, k_shape, b,
                       heads, scale, out=out if variant == DELTA else None,
                       stats=rowsum, shift=shift)


def _check_bwd(q, rowsum, g, heads: int) -> None:
    if rowsum.shape != (q.shape[0], heads, q.shape[1]) or g.shape != q.shape:
        raise ValueError(f"mvit_attention_bwd: rowsum {tuple(rowsum.shape)} / "
                         f"g {tuple(g.shape)} do not fit q {tuple(q.shape)}")
    if rowsum.dtype != torch.float32:
        raise ValueError("mvit_attention_bwd: rowsum / lse must be float32")


def _check_out(q, out) -> None:
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError(f"mvit_attention: out {tuple(out.shape)} does not "
                         f"fit q {tuple(q.shape)}")


def mvit_attention_hl_fwd(q, k, v, kc, vc, rel, k_shape, num_heads, scale,
                          shift: str = "clamp"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5f: head-last pooled attention, q [B, qN, H*d] (float32 or
    bfloat16, contiguous) -> (out [B, qN, H*d], rowsum [B, H, qN] fp32),
    under the softmax shift ``shift`` (``MVIT_SHIFT``: clamp, max, none;
    under max the statistic is lse, K7f's kernel)."""
    k_shape = tuple(k_shape)
    _check(q, k, v, kc, vc, rel, k_shape, num_heads)
    shift_code(shift)
    if q.device.type == "cpu":
        return mvit_attention_hl_fwd_plain(q, k, v, kc, vc, rel, k_shape,
                                           num_heads, scale, shift)
    return _fwd_kernel("mvit_attention_fwd", KERNEL_HL, q, k, v, kc, vc, rel,
                       k_shape, q.shape[0], num_heads, scale, shift)


def mvit_attention_hl_bwd(q, k, v, kc, vc, rel, rowsum, g, k_shape,
                          num_heads, scale, shift: str = "clamp",
                          out=None) -> Grads:
    """K5b: (dq, dk, dv, dkc, dvc, drel) of the head-last layout from the
    K5f row statistic and the output gradient g [B, qN, H*d], under the
    forward's shift (under max from the forward's output ``out`` too,
    :func:`_shifted_bwd`)."""
    k_shape = tuple(k_shape)
    _check(q, k, v, kc, vc, rel, k_shape, num_heads)
    _check_bwd(q, rowsum, g, num_heads)
    shift_code(shift)
    if q.device.type == "cpu":
        return mvit_attention_hl_bwd_plain(q, k, v, kc, vc, rel, rowsum, g,
                                           k_shape, num_heads, scale, shift,
                                           out)
    return _shifted_bwd(RECOMPUTE, KERNEL_HL_BWD, q, k, v, kc, vc, rel,
                        rowsum, out, g, k_shape, q.shape[0], num_heads, scale,
                        shift)


def mvit_attention_hl_bwd_delta(q, k, v, kc, vc, rel, rowsum, out, g,
                                k_shape, num_heads, scale,
                                shift: str = "clamp") -> Grads:
    """K5bd: K5b from the K5f row statistic and output ``out`` [B, qN,
    H*d], with D = sum_d g o."""
    k_shape = tuple(k_shape)
    _check(q, k, v, kc, vc, rel, k_shape, num_heads)
    _check_bwd(q, rowsum, g, num_heads)
    _check_out(q, out)
    shift_code(shift)
    if q.device.type == "cpu":
        return mvit_attention_hl_bwd_delta_plain(q, k, v, kc, vc, rel, rowsum,
                                                 out, g, k_shape, num_heads,
                                                 scale, shift)
    return _shifted_bwd(DELTA, KERNEL_HL_BWD_DELTA, q, k, v, kc, vc, rel,
                        rowsum, out, g, k_shape, q.shape[0], num_heads, scale,
                        shift)


def mvit_attention_fwd(q, k, v, kc, vc, rel, k_shape, scale,
                       shift: str = "clamp"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6f: head-split pooled attention, q [BH, qN, d] -> (out
    [BH, qN, d], rowsum [BH, 1, qN] fp32; lse under max)."""
    k_shape = tuple(k_shape)
    _check(q, k, v, kc, vc, rel, k_shape, 1)
    shift_code(shift)
    if q.device.type == "cpu":
        return mvit_attention_fwd_plain(q, k, v, kc, vc, rel, k_shape, scale,
                                        shift)
    return _fwd_kernel("mvit_attention_fwd", KERNEL, q, k, v, kc, vc, rel,
                       k_shape, q.shape[0], 1, scale, shift)


def mvit_attention_bwd(q, k, v, kc, vc, rel, rowsum, g, k_shape, scale,
                       shift: str = "clamp", out=None) -> Grads:
    """K6b: the backward of :func:`mvit_attention_fwd` under its shift
    (under max from its output ``out`` too)."""
    k_shape = tuple(k_shape)
    _check(q, k, v, kc, vc, rel, k_shape, 1)
    _check_bwd(q, rowsum, g, 1)
    shift_code(shift)
    if q.device.type == "cpu":
        return mvit_attention_bwd_plain(q, k, v, kc, vc, rel, rowsum, g,
                                        k_shape, scale, shift, out)
    return _shifted_bwd(RECOMPUTE, KERNEL_BWD, q, k, v, kc, vc, rel, rowsum,
                        out, g, k_shape, q.shape[0], 1, scale, shift)


def mvit_attention_bwd_delta(q, k, v, kc, vc, rel, rowsum, out, g, k_shape,
                             scale, shift: str = "clamp") -> Grads:
    """K6bd: K6b from the K6f row statistic and output ``out`` [BH, qN,
    d], with D = sum_d g o."""
    k_shape = tuple(k_shape)
    _check(q, k, v, kc, vc, rel, k_shape, 1)
    _check_bwd(q, rowsum, g, 1)
    _check_out(q, out)
    shift_code(shift)
    if q.device.type == "cpu":
        return mvit_attention_bwd_delta_plain(q, k, v, kc, vc, rel, rowsum,
                                              out, g, k_shape, scale, shift)
    return _shifted_bwd(DELTA, KERNEL_BWD_DELTA, q, k, v, kc, vc, rel, rowsum,
                        out, g, k_shape, q.shape[0], 1, scale, shift)


def mvit_attention_fwd_probs(q, k, v, kc, vc, rel, k_shape, scale,
                             shift: str = "clamp"
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """K6sp: K6f that also writes the probabilities it multiplies with ->
    (out [BH, qN, d], rowsum [BH, 1, qN] fp32 (lse under max), probs
    [BH, qN, LP] in the input dtype, LP = :func:`probs_stride`, zero past
    column kN)."""
    k_shape = tuple(k_shape)
    _check(q, k, v, kc, vc, rel, k_shape, 1)
    code = shift_code(shift)
    if q.device.type == "cpu":
        return mvit_attention_fwd_probs_plain(q, k, v, kc, vc, rel, k_shape,
                                              scale, shift)
    _check_kernel((q, k, v, kc, vc, rel), 1, k_shape)
    b, qn = q.shape[:2]
    out = torch.empty_like(q)
    rowsum = torch.empty((b, 1, qn), dtype=torch.float32, device=q.device)
    probs = torch.empty((b, qn, probs_stride(k.shape[1])), dtype=q.dtype,
                        device=q.device)
    _launch("mvit_attention_fwd_probs", KERNEL_PROBS, q, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), kc.data_ptr(), vc.data_ptr(),
            rel.data_ptr(), out.data_ptr(), rowsum.data_ptr(),
            probs.data_ptr(), b, 1, qn, k.shape[1], *k_shape,
            q.shape[2], _DTYPES[q.dtype], code, float(scale))
    return out, rowsum, probs


def mvit_attention_bwd_probs(q, k, v, kc, vc, rel, probs, g, k_shape, scale
                             ) -> Grads:
    """K6bs: the gradients of K6 from K6sp's probabilities [BH, qN, LP] and
    the output gradient g [BH, qN, d]; forms no logits."""
    k_shape = tuple(k_shape)
    _check(q, k, v, kc, vc, rel, k_shape, 1)
    want = (q.shape[0], q.shape[1], probs_stride(k.shape[1]))
    if probs.shape != want or probs.dtype != q.dtype or g.shape != q.shape:
        raise ValueError(f"mvit_attention_bwd_probs: probs "
                         f"{tuple(probs.shape)} / g {tuple(g.shape)} do not "
                         f"fit q {tuple(q.shape)} (probs {want} in {q.dtype})")
    if q.device.type == "cpu":
        return mvit_attention_bwd_probs_plain(q, k, v, kc, vc, rel, probs, g,
                                              k_shape, scale)
    return _bwd_kernel(SAVED, KERNEL_BWD_PROBS, q, k, v, kc, vc, rel, g,
                       k_shape, q.shape[0], 1, scale, probs=probs)


def mvit_attention_kt_fwd(q, k, v, kc, vc, rel, k_shape, num_heads, scale
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7f: key-tiled head-last pooled attention with the row-max softmax,
    q [B, qN, H*d] (float32 or bfloat16, contiguous) -> (out
    [B, qN, H*d], lse [B, H, qN] fp32)."""
    k_shape = tuple(k_shape)
    _check(q, k, v, kc, vc, rel, k_shape, num_heads)
    if q.device.type == "cpu":
        return mvit_attention_kt_fwd_plain(q, k, v, kc, vc, rel, k_shape,
                                           num_heads, scale)
    return _fwd_kernel("mvit_attention_kt_fwd", KERNEL_KT, q, k, v, kc, vc,
                       rel, k_shape, q.shape[0], num_heads, scale)


def mvit_attention_kt_bwd(q, k, v, kc, vc, rel, out, lse, g, k_shape,
                          num_heads, scale) -> Grads:
    """K7b: (dq, dk, dv, dkc, dvc, drel) of the head-last layout from the
    K7f output and lse and the output gradient g [B, qN, H*d]."""
    k_shape = tuple(k_shape)
    _check(q, k, v, kc, vc, rel, k_shape, num_heads)
    _check_bwd(q, lse, g, num_heads)
    _check_out(q, out)
    if q.device.type == "cpu":
        return mvit_attention_kt_bwd_plain(q, k, v, kc, vc, rel, out, lse, g,
                                           k_shape, num_heads, scale)
    return _bwd_kernel(ROWMAX, KERNEL_KT_BWD, q, k, v, kc, vc, rel, g,
                       k_shape, q.shape[0], num_heads, scale, out=out,
                       stats=lse)


def _forward(q, k, v, kc, vc, rel, k_shape, num_heads, scale, shift):
    """K6f (``num_heads`` None) or K5f: (out, rowsum)."""
    if num_heads is None:
        return mvit_attention_fwd(q, k, v, kc, vc, rel, k_shape, scale, shift)
    return mvit_attention_hl_fwd(q, k, v, kc, vc, rel, k_shape, num_heads,
                                 scale, shift)


class MViTAttention(torch.autograd.Function):
    """K5 (``num_heads`` > 0, head-last) or K6 (``num_heads`` None,
    head-split) under autograd: the forward kernel (saves its inputs and
    the row statistic, and under ``max`` the output, whose D the backward
    takes), the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, kc, vc, rel, k_shape, num_heads, scale,
                shift: str = "clamp"):
        out, rowsum = _forward(q, k, v, kc, vc, rel, k_shape, num_heads,
                               scale, shift)
        kept = (out,) if shift == "max" else ()
        ctx.save_for_backward(q, k, v, kc, vc, rel, rowsum, *kept)
        ctx.k_shape, ctx.num_heads, ctx.scale = k_shape, num_heads, scale
        ctx.shift = shift
        return out

    @staticmethod
    def backward(ctx, g):
        # saved_tensors unpacks once: twice fails under activation
        # checkpointing
        saved = ctx.saved_tensors
        *inputs, rowsum = saved[:7]
        out = saved[7] if ctx.shift == "max" else None
        g = g.contiguous()
        if ctx.num_heads is None:
            grads = mvit_attention_bwd(*inputs, rowsum, g, ctx.k_shape,
                                       ctx.scale, ctx.shift, out)
        else:
            grads = mvit_attention_hl_bwd(*inputs, rowsum, g, ctx.k_shape,
                                          ctx.num_heads, ctx.scale, ctx.shift,
                                          out)
        return (*grads, None, None, None, None)


class MViTAttentionDelta(torch.autograd.Function):
    """K5 or K6 on ``MVIT_DELTA=1``: the forward kernel (saves its inputs,
    the row statistic and the output, as JAX ``_vjp_fwd`` / ``_vjp_hl_fwd``
    keep o), the delta backward K5bd / K6bd."""

    @staticmethod
    def forward(ctx, q, k, v, kc, vc, rel, k_shape, num_heads, scale,
                shift: str = "clamp"):
        out, rowsum = _forward(q, k, v, kc, vc, rel, k_shape, num_heads,
                               scale, shift)
        ctx.save_for_backward(q, k, v, kc, vc, rel, rowsum, out)
        ctx.k_shape, ctx.num_heads, ctx.scale = k_shape, num_heads, scale
        ctx.shift = shift
        return out

    @staticmethod
    def backward(ctx, g):
        *inputs, rowsum, out = ctx.saved_tensors
        g = g.contiguous()
        if ctx.num_heads is None:
            grads = mvit_attention_bwd_delta(*inputs, rowsum, out, g,
                                             ctx.k_shape, ctx.scale,
                                             ctx.shift)
        else:
            grads = mvit_attention_hl_bwd_delta(*inputs, rowsum, out, g,
                                                ctx.k_shape, ctx.num_heads,
                                                ctx.scale, ctx.shift)
        return (*grads, None, None, None, None)


class MViTAttentionSaved(torch.autograd.Function):
    """K6 on ``MVIT_SAVE_PROBS=1``: K6sp (saves its inputs and the
    probabilities), the backward K6bs."""

    @staticmethod
    def forward(ctx, q, k, v, kc, vc, rel, k_shape, scale,
                shift: str = "clamp"):
        out, _, probs = mvit_attention_fwd_probs(q, k, v, kc, vc, rel,
                                                 k_shape, scale, shift)
        ctx.save_for_backward(q, k, v, kc, vc, rel, probs)
        ctx.k_shape, ctx.scale = k_shape, scale
        return out

    @staticmethod
    def backward(ctx, g):
        *inputs, probs = ctx.saved_tensors
        grads = mvit_attention_bwd_probs(*inputs, probs, g.contiguous(),
                                         ctx.k_shape, ctx.scale)
        return (*grads, None, None, None)


def _needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def mvit_attention_hl(q, k, v, kc, vc, rel, k_shape, num_heads, scale,
                      delta: bool = False,
                      shift: str = "clamp") -> torch.Tensor:
    """The model's head-last entry (K5) under ``MVIT_SHIFT``'s ``shift``:
    under grad :class:`MViTAttention`, or :class:`MViTAttentionDelta` with
    ``delta``; else the forward kernel alone."""
    if _needs_grad((q, k, v, kc, vc, rel)):
        fn = MViTAttentionDelta if delta else MViTAttention
        return fn.apply(q, k, v, kc, vc, rel, tuple(k_shape), num_heads, scale,
                        shift)
    return mvit_attention_hl_fwd(q, k, v, kc, vc, rel, k_shape, num_heads,
                                 scale, shift)[0]


def mvit_attention(q, k, v, kc, vc, rel, k_shape, scale, delta: bool = False,
                   save_probs: bool = False,
                   shift: str = "clamp") -> torch.Tensor:
    """The model's head-split entry (K6), as :func:`mvit_attention_hl`; under
    grad with ``save_probs`` :class:`MViTAttentionSaved`, which takes
    precedence over ``delta`` (JAX ``_vjp_fwd``)."""
    if _needs_grad((q, k, v, kc, vc, rel)):
        if save_probs:
            return MViTAttentionSaved.apply(q, k, v, kc, vc, rel,
                                            tuple(k_shape), scale, shift)
        fn = MViTAttentionDelta if delta else MViTAttention
        return fn.apply(q, k, v, kc, vc, rel, tuple(k_shape), None, scale,
                        shift)
    return mvit_attention_fwd(q, k, v, kc, vc, rel, k_shape, scale, shift)[0]


class MViTAttentionKT(torch.autograd.Function):
    """K7 under autograd: the forward kernel (saves its inputs, the output
    and lse, as JAX ``_vjp_hl_kt_fwd``), the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, kc, vc, rel, k_shape, num_heads, scale):
        out, lse = mvit_attention_kt_fwd(q, k, v, kc, vc, rel, k_shape,
                                         num_heads, scale)
        ctx.save_for_backward(q, k, v, kc, vc, rel, out, lse)
        ctx.k_shape, ctx.num_heads, ctx.scale = k_shape, num_heads, scale
        return out

    @staticmethod
    def backward(ctx, g):
        *inputs, out, lse = ctx.saved_tensors
        grads = mvit_attention_kt_bwd(*inputs, out, lse, g.contiguous(),
                                      ctx.k_shape, ctx.num_heads, ctx.scale)
        return (*grads, None, None, None)


def mvit_attention_kt(q, k, v, kc, vc, rel, k_shape, num_heads, scale
                      ) -> torch.Tensor:
    """The model's key-tiled entry (K7), as :func:`mvit_attention_hl`."""
    if _needs_grad((q, k, v, kc, vc, rel)):
        return MViTAttentionKT.apply(q, k, v, kc, vc, rel, tuple(k_shape),
                                     num_heads, scale)
    return mvit_attention_kt_fwd(q, k, v, kc, vc, rel, k_shape, num_heads,
                                 scale)[0]
