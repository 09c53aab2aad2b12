"""Show that ``chip_smoke.py``'s limits reject kernels with planted faults:
K5f/K6f and K7f missing key columns, K8f missing a halo plane, K8dw
missing a batch, K1br and K1p without the CLS key, K1bd with delta forced
to 0, K2v3f without the last key frame (at 8 and at 16 frames), K5bd /
K6bd with D forced to 0, K6sp storing p without the cls column and K6bs
reading p without it, the key-tiled pair (``flash_attention.cu``, K3f /
K4f and K3b / K4b) with a forward that drops the CLS key or the last key
tile, and a backward that drops the jacobian row sums D, leaves the CLS
row of dk and dv unwritten or leaves the last key tile out of dq; the
pair's scalar kernels (the head dims past its tensor-core kernels') with
the second column group of the output unwritten (d = 320) or logits that
read past the head dim (d = 12), the MViT scalar kernels with the second
column group of dk and dv unwritten (d = 136), and the MViT backward pair (K5b / K6b and its
variants) with a key-major pass whose last query chunk never reaches the
sum of the chunks, or that leaves the cls key's row of dk and dv
unwritten; the pair on K2's time-major layout with each clip's rows
starting one frame early (``row_of``'s branch for sequences side by side),
and K5f / K6f at head dim 72 staging q and k without zeros past column 72
of their 96-wide tiles.

    python -m procedurevrl_torch.tools.mutation_check [--only CHECK ...]
        [--jobs N]

For each fault in :data:`MUTANTS` this copies the package and
``chip_smoke.py`` into a temporary directory (``--jobs`` copies at once,
each printed whole when done), plants the fault in the copy of its CUDA
source, builds it, and holds the mutated kernel at two or three
shapes against its plain version, with ``chip_smoke.py``'s limit and, for
comparison, with the looser ``BF16_TOL``.  The inputs are those of
``chip_smoke.py``'s kernel phases: K5f at block 0 (B 18, qN 25088, kN 392)
and K6f at block 1 (B*H 36, qN 6272, kN 1568), out against
``MVIT_FWD_TOL`` and the row sums against ``ROWSUM_TOL``, each of which
must reject; K7f at blocks 1 and 3 (kN 1568, so the last key tile is
ragged), out against ``MVIT_FWD_TOL`` and lse against ``LSE_TOL``; K8f at
blocks 0 and 4 against ``POOL_TOL``; K8dw at blocks 0 and 4 against the
fp32 limit scaled by the largest gradient; K1br, K1bd and K1p at the
TimeSformer-B training and eval shapes (BT 144 and 128, N 196, 12 heads),
the gradients against the bf16 limit scaled by the largest gradient and
K1p against ``K1K2_FWD_TOL``, with K1br held bit for bit against K1b on
K1sp's probabilities and K1p against K1f, as ``chip_smoke.py`` holds them;
K2v3f at the training and eval shapes (B 18 and 16, T 8 and 16, N 196),
out and p against ``K1K2_FWD_TOL``; K5bd at block 0 and K6bd at block 1,
the gradients against ``MVIT_GRAD_TOL`` scaled by each gradient's own
largest magnitude; K6sp and K6bs at blocks 1 and 3 (B*H 36 and 72, kN
1568) and at the small kN 27 geometry with logits above 80 (the cls column
inside a row of 8), p against ``PROBS_TOL`` and the gradients against
``MVIT_GRAD_TOL``; K3f and K3b at L = 197 (the TimeSformer-B training
batch, 196 frame tokens + CLS) and L = 1025 (1024 + CLS, where the last key
tile holds only the CLS), out and l against ``FLASH_FWD_TOL`` /
``ROWSUM_TOL`` and the gradients against ``MVIT_GRAD_TOL``; K5b at block 0
(its key-major pass split over 4 query chunks on an H100) and at block 4
over 3 chunks, and K6b at block 1 (one chunk), the gradients against
``MVIT_GRAD_TOL``; the pair on K2's layout at head dim 32 (24 heads of a
width of 768, ``chip_smoke.py`` phase 25's shapes: B 18 and 16, T 8, N
196), out and l against ``BF16_TOL`` (as K2f at these inputs) /
``ROWSUM_TOL`` and dqkv against
``MVIT_GRAD_TOL``; K5f at block 0 (B 18, 2 heads of 72) and K6f at block 1
(B*H 72) of phase 26's MViT-v2-S at width 144, out against
``MVIT_FWD_TOL`` and the row sums against ``ROWSUM_TOL``; K3 at d = 320
in 2 heads (the column-group fault) and at d = 12 in 32 heads (the ragged
one), 16 frames of 196 tokens + CLS, bf16 and float32, out and l against ``FLASH_FWD_TOL`` (float32 ``FP32_TOL``) /
``ROWSUM_TOL`` and the gradients against ``MVIT_GRAD_TOL`` (float32 the
scaled ``FP32_TOL``); K5b at d = 136 (block 4's key grid, 4 clips of 2
heads), bf16 and float32, against ``MVIT_GRAD_TOL``.  For K7, K8, K1, K2 and the backward kernels the mutant
counts as rejected at a shape when a check of that shape fails, as
``chip_smoke.py`` then fails.  Each check also runs once on the unmodified
sources first, which no strict limit may reject.  For every comparison it
prints the least atol, as a multiple of the reference's largest magnitude,
that the kernel would pass with, which places a limit between the sound
kernels and the mutants.  Exits non-zero unless the limits pass every
sound kernel and reject every mutant at every shape.  Needs a CUDA card;
the repository's own sources are not modified.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# the keep-mask of the exponentials in the K5/K6 tensor-core logits
# (``logits8<true>``): columns 0..kN-1 are body keys, column kN the cls key
_MASK = "s[e] = col + (e & 1) <= kn ? exp2f"
# the keep-mask of K7's logits (``logits8<false>``) and its loop over key
# tiles
_KT_MASK = "s[e] = col + (e & 1) <= kn ? fmaf(qk[e], scale, b[e]) : MASKED;"
_KT_TILES = "for (int j0 = 0; j0 < kcols; j0 += BN) {"
# K8f's bounds check of the input plane t + dt - 1, and K8dw's last position
_POOL_PLANE = "if (ti < 0 || ti > g.t - 1) continue;"
_DW_END = "min(p0 + per_block, g.npos)"
# K1br's recomputed probability tile, K1p's ring slot, K1bd's delta rows and
# K2v3f's key mask
_BR_TILE = "softmax_tile<LP>(q_s, k_s, mt, L, scale, e, i0, i1);"
_PIPE_SLOT = "const uint16_t* q_s = reinterpret_cast<const uint16_t*>(slot);"
_DELTA = "if (half) d1 = acc; else d0 = acc;"
_V3_KEYS = "const bool key = 2 * tig + e < frames;"
_V3_KEYS16 = "const bool key1 = 8 + 2 * tig + (e & 1) < frames;"
# the D rows of the delta backwards (K5bd, K6bd; K7b shares them), K6sp's
# store of a p fragment pair, and the tile of saved p K6bs stages
_D_ROWS = "dd_s[threadIdx.x] = acc;"
_P_STORE = "const uint32_t w0 = pa[2 * u], w1 = pa[2 * u + 1];"
_P_TILE = "if (i0 + r < g.qn && j0 + c < g.pld) {"
# the key-tiled pair: the forward's key mask and its walk over the key
# tiles, the backward's sum of D (shared by the fused kernel and the
# query-major pass), its dq products (the query-major pass's and the fused
# kernel's) and the rows of dk and dv it writes; the scalar kernels'
# forward store (column groups) and dot product (head dims past the tensor
# cores')
_FA_EXP = "key_in(g, vs, kt, acc_row(e), acc_col(j, e))"
_FA_CHUNK = "if (!active || (g.pk > 1 && t != qt)) continue;\n    const uint16_t* k_s"
_FA_D = ("d0 += dp[4 * j] * p[4 * j] + dp[4 * j + 1] * p[4 * j + 1];\n"
         "    d1 += dp[4 * j + 2] * p[4 * j + 2] + dp[4 * j + 3] * p[4 * j + 3];")
_FA_KROW = ("const Row R = slice_row(g, vs, kt * BM + acc_row(2 * half));\n"
            "    if (!R.ok) continue;")
_FA_DQ = "accumulate<G, W>(acc_q, s, k_s + 8 * c0, first, g, kt);"
_FA_DQ_FUSED = "for (int kk = klo; kk < khi; ++kk)"
_FA_GROUP = "if (c0 + lane + 32 * u < g.d) store1(oi + lane + 32 * u, o[u] / l);"
_FA_DOT = "for (int e = 0; e < d; ++e) s = fmaf(load1(a + e), load1(b + e), s);"
# the MViT scalar key-major pass's store of dk and dv (column groups)
_MV_GROUP = "if (c0 + lane + 32 * u >= g.d) continue;\n    store1(kd"
# the MViT backward's key-major pass: the reduction of its query chunks,
# and the rows it writes (the cls key is row kN)
_SPLIT_SUM = "for (int s = 0; s < splits; ++s) {"
_MV_KROW = "const int j = j0 + acc_row(2 * half);\n    if (j > g.kn) continue;"
# the pair's row address of a sequence with others side by side (K2's
# layout), and the zero fill past the head dim of the MViT forwards'
# staged q and k tiles
_FA_SEQ_ROW = "((unsigned)s / (unsigned)g.seqs) * g.n + j) * ld"
_MV_Q_FILL = "if (r0 + r < n && e < d) {"
_MV_K_FILL = "if (j <= kn && e < d) {"


@dataclass(frozen=True)
class Mutant:
    source: str   # file under csrc/
    anchor: str   # text planted over, found once in the source
    line: str     # what replaces it
    check: str    # the check run in the copy (a key of CHECKS)
    more: tuple = ()  # further (anchor, line) edits of the same source


MUTANTS = {
    "cls column skipped": Mutant(
        "mvit_attention.cu", _MASK, "s[e] = col + (e & 1) < kn ? exp2f",
        "mvit"),
    # the last body key lies in the ragged last key tile at both shapes
    "last body key skipped": Mutant(
        "mvit_attention.cu", _MASK,
        "s[e] = (col + (e & 1) <= kn && col + (e & 1) != kn - 1) ? exp2f",
        "mvit"),
    "K7f cls column skipped": Mutant(
        "mvit_attention.cu", _KT_MASK,
        "s[e] = col + (e & 1) < kn ? fmaf(qk[e], scale, b[e]) : MASKED;",
        "kt"),
    # kN + 1 = 1569 keys: the last tile holds keys 1536..1567 and the cls
    "K7f ragged last key tile skipped": Mutant(
        "mvit_attention.cu", _KT_TILES,
        "for (int j0 = 0; j0 + BN <= kcols; j0 += BN) {", "kt"),
    # output plane T-2 loses its taps on plane T-1
    "K8f halo plane T-1 skipped": Mutant(
        "depthwise_pool.cu", _POOL_PLANE,
        "if (ti < 0 || ti > g.t - 1 || (dt == 2 && ti == g.t - 1)) continue;",
        "pool"),
    "K8dw last batch dropped": Mutant(
        "depthwise_pool.cu", _DW_END,
        "min(p0 + per_block, g.npos - g.npos / g.b)", "pool_dw"),
    # keys < L - 1: the CLS key (row n of the tile) leaves the softmax
    "K1br cls key left out of the recomputed tile": Mutant(
        "spatial_attention.cu", _BR_TILE,
        "softmax_tile<LP>(q_s, k_s, mt, L - 1, scale, e, i0, i1);", "k1br"),
    # the CLS key's rows of the staged k and v tiles zeroed before the item
    # computes
    "K1p cls key left out": Mutant(
        "spatial_attention.cu", _PIPE_SLOT,
        _PIPE_SLOT + " __syncthreads(); if (threadIdx.x < 16) "
        "reinterpret_cast<uint4*>(const_cast<uint16_t*>(q_s) + "
        "((threadIdx.x < 8 ? LP : 2 * LP) + n) * MMA_STRIDE)[threadIdx.x % 8]"
        " = make_uint4(0u, 0u, 0u, 0u); __syncthreads();", "k1p"),
    "K1bd delta forced to 0": Mutant(
        "spatial_attention.cu", _DELTA, "if (half) d1 = 0.f; else d0 = 0.f;",
        "k1bd"),
    "K2v3f last key frame left out": Mutant(
        "temporal_attention.cu", _V3_KEYS,
        "const bool key = 2 * tig + e < frames - 1;", "k2v3"),
    "K2v3f last key frame left out at 16 frames": Mutant(
        "temporal_attention.cu", _V3_KEYS16,
        "const bool key1 = 8 + 2 * tig + (e & 1) < frames - 1;", "k2v3_16"),
    "K5bd / K6bd delta forced to 0": Mutant(
        "mvit_attention.cu", _D_ROWS, "dd_s[threadIdx.x] = 0.f;", "delta"),
    # a stored word holds columns (c, c + 1), c even: the cls column kN is
    # its low half where kN is even, its high half where kN is odd
    "K6sp cls column left out of the stored p": Mutant(
        "mvit_attention.cu", _P_STORE,
        "const uint32_t m = c == g.kn ? 0xffff0000u : c + 1 == g.kn ? "
        "0x0000ffffu : ~0u; const uint32_t w0 = pa[2 * u] & m, "
        "w1 = pa[2 * u + 1] & m;", "k6sp"),
    # the 16-byte chunk of 8 columns that holds kN is loaded with its
    # element kN % 8 zeroed; every other chunk is staged as before
    "K6bs cls column left out of the staged p": Mutant(
        "mvit_attention.cu", _P_TILE,
        "if (i0 + r < g.qn && j0 + c == g.kn / 8 * 8) { uint4 w = "
        "*reinterpret_cast<const uint4*>(p + (size_t)(i0 + r) * g.pld + j0 "
        "+ c); reinterpret_cast<uint16_t*>(&w)[g.kn % 8] = 0; "
        "*reinterpret_cast<uint4*>(t) = w; } else "
        "if (i0 + r < g.qn && j0 + c < g.pld) {", "k6bs"),
    # the CLS is key n of [frames; cls]; the clamp exp of a key tile that
    # holds it is the masked one, shared with the query-major backward
    "K3f / K4f cls key left out": Mutant(
        "flash_attention.cu", _FA_EXP,
        "(key_in(g, vs, kt, acc_row(e), acc_col(j, e)) && "
        "!(g.L > g.n && kt * BM + acc_col(j, e) == g.n))", "flash_fwd"),
    "K3f / K4f last key tile left out": Mutant(
        "flash_attention.cu", _FA_CHUNK,
        "if (!active || (g.pk > 1 && t != qt) || t == g.tiles - 1) continue;"
        "\n    const uint16_t* k_s", "flash_fwd"),
    # the fused kernel's phase D and the query-major pass's sweep A share
    # the sum of D; the two kernels share the store of dk and dv
    "K3b / K4b jacobian row sums D forced to 0": Mutant(
        "flash_attention.cu", _FA_D, "(void)p;  // D stays 0\n    (void)dp;",
        "flash_bwd"),
    "K3b / K4b cls row of dk and dv left unwritten": Mutant(
        "flash_attention.cu", _FA_KROW,
        "const Row R = slice_row(g, vs, kt * BM + acc_row(2 * half));\n"
        "    if (!R.ok || R.j >= g.n) continue;", "flash_bwd"),
    # dq never sums the products of the last key tile: the fused kernel's
    # phase Q (L = 197) and the query-major pass's sweep B (L = 1025)
    "K3b / K4b last key tile left out of dq": Mutant(
        "flash_attention.cu", _FA_DQ,
        "if (kt + 1 < g.tiles || kt == 0) " + _FA_DQ, "flash_bwd",
        ((_FA_DQ_FUSED, "for (int kk = klo; kk < (g.pk == 1 && khi > 4 * "
          "(g.tiles - 1) ? 4 * (g.tiles - 1) : khi); ++kk)"),)),
    # d = 320 runs in column groups of 256 and 64: group 1's columns of o
    # are never written
    "pair's second column group left unwritten": Mutant(
        "flash_attention.cu", _FA_GROUP, "if (c0 == 0 && c0 + lane + 32 * u "
        "< g.d) store1(oi + lane + 32 * u, o[u] / l);", "flash_groups"),
    # d = 12: the logits read 16 columns, 4 of them the next head's
    "pair reads past the head dim": Mutant(
        "flash_attention.cu", _FA_DOT,
        "for (int e = 0; e < ((d + 7) & ~7); ++e) s = fmaf(load1(a + e), "
        "load1(b + e), s);", "flash_ragged"),
    # d = 136 runs in column groups of 128 and 8: group 1's columns of dk
    # and dv are never written
    "MViT's second column group of dk and dv left unwritten": Mutant(
        "mvit_attention.cu", _MV_GROUP,
        "if (c0 > 0 || c0 + lane + 32 * u >= g.d) continue;\n    store1(kd",
        "mvit_odd"),
    # the last query chunk's partial dk and dv never reach the sum
    "K5b / K6b key-major query chunk left out of the reduction": Mutant(
        "mvit_attention.cu", _SPLIT_SUM, "for (int s = 0; s + 1 < splits; ++s) {",
        "mvit_split"),
    "K5b / K6b cls row of dk and dv left unwritten": Mutant(
        "mvit_attention.cu", _MV_KROW,
        "const int j = j0 + acc_row(2 * half);\n    if (j >= g.kn) continue;",
        "mvit_bwd"),
    # clip b's rows start at b (T - 1) frames: sequences of later clips read
    # and write frames of the clip before
    "K2 layout on the pair: a clip's rows one frame early": Mutant(
        "flash_attention.cu", _FA_SEQ_ROW,
        "((unsigned)s / (unsigned)g.seqs) * (g.n - 1) + j) * ld",
        "flash_temporal"),
    # q and k columns 72..95 read from the next head (or row) into the
    # logits in place of zeros
    "K5f / K6f q and k not zeroed past the head dim": Mutant(
        "mvit_attention.cu", _MV_Q_FILL, "if (r0 + r < n) {", "mvit_d72",
        ((_MV_K_FILL, "if (j <= kn) {"),)),
}


# what the kernel under check is: "mutant", or "sound" for the unmodified
# sources
_WHO = "mutant"


def _needed_atol(torch, got, want, rtol) -> tuple:
    """The least atol, as a multiple of the reference's largest magnitude,
    at which ``got`` passes ``want`` with this rtol; and that magnitude."""
    got, want = got.float(), want.float()
    top = want.abs().max().item()
    over = ((got - want).abs() - rtol * want.abs()).max().item()
    return max(over, 0.0) / max(top, 1e-30), top


def _judge(cs, torch, label, pairs, need_all: bool, twins=()) -> bool:
    """Compare each (name, got, want, limit) with its limit and with
    ``BF16_TOL``, and each (name, got tensors, twin tensors) bit for bit;
    returns whether the checks reject the kernel at this shape (every
    limit if ``need_all``, else any check)."""
    caught = []
    for name, got, twin in twins:
        hit = not all(torch.equal(a, b) for a, b in zip(got, twin))
        print(f"  {_WHO} {label} {name} (bit for bit): "
              f"{'rejected' if hit else 'let through'}")
        caught.append(hit)
    for name, got, want, strict, *also in pairs:
        k, top = _needed_atol(torch, got, want, strict["rtol"])
        print(f"  {_WHO} {label} {name}: passes from atol {k:.3e} x "
              f"max|ref| ({top:.3e}) at rtol {strict['rtol']}")
        for limit, tol in (("strict", strict), ("bf16", cs.BF16_TOL), *also):
            try:
                cs.compare(torch, f"  {_WHO} {label} {name} ({limit})", got,
                           want, tol)
                hit = False
            except SystemExit:
                hit = True
            print(f"  -> {'rejected' if hit else 'let through'}")
            if limit == "strict":
                caught.append(hit)
    return all(caught) if need_all and _WHO == "mutant" else any(caught)


def _check_mvit(cs, torch, gen):
    from procedurevrl_torch.ops import mvit_attention as k5

    scale = 96 ** -0.5
    for label, head_last, b, heads, qn, k_shape in (
            ("block 0", True, 18, 1, 25088, (8, 7, 7)),
            ("block 1", False, 36, 1, 6272, (8, 14, 14))):
        x = cs.mvit_inputs(torch, gen, b, heads, qn, k_shape, torch.bfloat16)
        if head_last:
            out, rs = k5.mvit_attention_hl_fwd(*x[:6], k_shape, heads, scale)
            ref, ref_rs = k5.mvit_attention_hl_fwd_plain(*x[:6], k_shape,
                                                         heads, scale)
        else:
            out, rs = k5.mvit_attention_fwd(*x[:6], k_shape, scale)
            ref, ref_rs = k5.mvit_attention_fwd_plain(*x[:6], k_shape, scale)
        print(f"{label}: |out| mean {ref.float().abs().mean().item():.3e}, "
              f"max {ref.float().abs().max().item():.3e}")
        yield _judge(cs, torch, label, [("out", out, ref, cs.MVIT_FWD_TOL),
                                        ("rowsum", rs, ref_rs,
                                         cs.ROWSUM_TOL)], True)


def _check_kt(cs, torch, gen):
    from procedurevrl_torch.ops import mvit_attention as k5

    scale = 96 ** -0.5
    for label, heads, qn in (("block 1", 2, 6272), ("block 3", 4, 1568)):
        k_shape = (8, 14, 14)
        x = cs.mvit_inputs(torch, gen, 18, heads, qn, k_shape,
                           torch.bfloat16)
        out, lse = k5.mvit_attention_kt_fwd(*x[:6], k_shape, heads, scale)
        ref, ref_lse = k5.mvit_attention_kt_fwd_plain(*x[:6], k_shape, heads,
                                                      scale)
        print(f"{label}: |out| mean {ref.float().abs().mean().item():.3e}")
        yield _judge(cs, torch, label, [("out", out, ref, cs.MVIT_FWD_TOL),
                                        ("lse", lse, ref_lse, cs.LSE_TOL)],
                     False)


POOL_SHAPES = (("block 0", (8, 56, 56), 96), ("block 4", (8, 14, 14), 384))


def _check_pool(cs, torch, gen):
    from procedurevrl_torch.ops import depthwise_pool as k8

    for label, thw, c in POOL_SHAPES:
        x, w, _ = cs.pool_inputs(torch, gen, 18, thw, c, torch.bfloat16)
        yield _judge(cs, torch, label, [
            ("out", k8.depthwise_pool3d_fwd(x, w, 1),
             k8.depthwise_pool3d_taps(x, w, (1, 1, 1)), cs.POOL_TOL)], False)


def _check_pool_dw(cs, torch, gen):
    from procedurevrl_torch.ops import depthwise_pool as k8

    for label, thw, c in POOL_SHAPES:
        x, _, g = cs.pool_inputs(torch, gen, 18, thw, c, torch.bfloat16)
        ref = k8.taps_dw(x, g, (1, 1, 1))
        yield _judge(cs, torch, label, [
            ("dw", k8.depthwise_pool3d_dw(x, g), ref,
             cs.grad_tol(cs.FP32_TOL, ref))], False)


K1_SHAPES = (("training", 144), ("eval", 128))


def _check_k1br(cs, torch, gen):
    from procedurevrl_torch.ops import spatial_attention as k1

    for label, bt in K1_SHAPES:
        x = cs.k1_inputs(torch, gen, bt, 196, 12, torch.bfloat16)
        got = k1.spatial_attention_bwd_recompute(*x, 12, 0.125)
        want = k1.spatial_attention_bwd_recompute_plain(*x, 12, 0.125)
        _, _, probs = k1.spatial_attention_fwd_probs(*x[:2], 12, 0.125)
        twin = k1.spatial_attention_bwd(*x[:2], probs, *x[2:], 12, 0.125)
        print(f"{label}: |dqkv| max {want[0].float().abs().max().item():.3e}")
        yield _judge(cs, torch, label,
                     [(name, a, r, cs.grad_tol(cs.BF16_TOL, r))
                      for name, a, r in zip(("dqkv", "dqkv_c"), got, want)],
                     False, [("against K1b(K1sp probs)", got, twin)])


def _check_k1bd(cs, torch, gen):
    from procedurevrl_torch.ops import spatial_attention as k1

    for label, bt in K1_SHAPES:
        x = cs.k1_inputs(torch, gen, bt, 196, 12, torch.bfloat16)
        out, out_c, probs = k1.spatial_attention_fwd_probs(*x[:2], 12, 0.125)
        args = (*x[:2], probs, out, out_c, *x[2:], 12, 0.125)
        got = k1.spatial_attention_bwd_delta(*args)
        want = k1.spatial_attention_bwd_delta_plain(*args)
        print(f"{label}: |dqkv| max {want[0].float().abs().max().item():.3e}")
        yield _judge(cs, torch, label,
                     [(name, a, r, cs.grad_tol(cs.BF16_TOL, r))
                      for name, a, r in zip(("dqkv", "dqkv_c"), got, want)],
                     False)


def _check_k1p(cs, torch, gen):
    from procedurevrl_torch.ops import spatial_attention as k1

    for label, bt in K1_SHAPES:
        qkv, qkv_c, _, _ = cs.k1_inputs(torch, gen, bt, 196, 12,
                                        torch.bfloat16, sd=0.5)
        got = k1.spatial_attention_pipe(qkv, qkv_c, 12, 0.125)
        want = k1.spatial_attention_pipe_plain(qkv, qkv_c, 12, 0.125)
        twin = k1.spatial_attention(qkv, qkv_c, 12, 0.125)
        print(f"{label}: |out| mean {want[0].float().abs().mean().item():.3e}")
        yield _judge(cs, torch, label,
                     [(name, a, r, cs.K1K2_FWD_TOL)
                      for name, a, r in zip(("frames", "cls"), got, want)],
                     False, [("against K1f", got, twin)])


def _check_k2v3(cs, torch, gen):
    from procedurevrl_torch.ops import temporal_attention as k2

    for label, b in (("training", 18), ("eval", 16)):
        qkv = torch.randn(b, 8, 196, 3 * 768, generator=gen,
                          device="cuda").bfloat16()
        got = k2.temporal_attention_v3(qkv, 12, 0.125)
        want = k2.temporal_attention_v3_fwd_plain(qkv, 12, 0.125)
        print(f"{label}: |out| mean {want[0].float().abs().mean().item():.3e}")
        yield _judge(cs, torch, label,
                     [("out", got[0], want[0], cs.BF16_TOL),
                      ("probs", got[1], want[1], cs.K1K2_FWD_TOL),
                      ("out vs P V of its probs", got[0],
                       cs.v3_pv(torch, qkv, got[1], 12), cs.K1K2_FWD_TOL)],
                     False)


def _check_k2v3_16(cs, torch, gen):
    from procedurevrl_torch.ops import temporal_attention as k2

    for label, b in (("training", 18), ("eval", 16)):
        qkv = torch.randn(b, 16, 196, 3 * 768, generator=gen,
                          device="cuda").bfloat16()
        got = k2.temporal_attention_v3(qkv, 12, 0.125)
        want = k2.temporal_attention_v3_fwd_plain(qkv, 12, 0.125)
        print(f"{label} T = 16: |out| mean "
              f"{want[0].float().abs().mean().item():.3e}")
        yield _judge(cs, torch, label,
                     [("out", got[0], want[0], cs.BF16_TOL),
                      ("probs", got[1], want[1], cs.K1K2_FWD_TOL),
                      ("out vs P V of its probs", got[0],
                       cs.v3_pv(torch, qkv, got[1], 12), cs.K1K2_FWD_TOL)],
                     False)


GRADS = ("dq", "dk", "dv", "dkc", "dvc", "drel")


def _grad_pairs(cs, got, want):
    """The gradients against ``chip_smoke.py``'s limit for them, also
    reported against the bf16 limit scaled with a floor of 1, which the
    older backwards are held to."""
    return [(name, a, r, cs.own_tol(cs.MVIT_GRAD_TOL, r),
             ("BF16_TOL scaled", cs.grad_tol(cs.BF16_TOL, r)))
            for name, a, r in zip(GRADS, got, want)]


def _check_delta(cs, torch, gen):
    from procedurevrl_torch.ops import mvit_attention as k5

    scale = 96 ** -0.5
    for label, head_last, b, qn, k_shape in (
            ("K5bd block 0", True, 18, 25088, (8, 7, 7)),
            ("K6bd block 1", False, 36, 6272, (8, 14, 14))):
        x = cs.mvit_inputs(torch, gen, b, 1, qn, k_shape, torch.bfloat16)
        if head_last:
            out, rs = k5.mvit_attention_hl_fwd_plain(*x[:6], k_shape, 1, scale)
            args = (*x[:6], rs, out, x[6], k_shape, 1, scale)
            got = k5.mvit_attention_hl_bwd_delta(*args)
            want = k5.mvit_attention_hl_bwd_delta_plain(*args)
        else:
            out, rs = k5.mvit_attention_fwd_plain(*x[:6], k_shape, scale)
            args = (*x[:6], rs, out, x[6], k_shape, scale)
            got = k5.mvit_attention_bwd_delta(*args)
            want = k5.mvit_attention_bwd_delta_plain(*args)
        yield _judge(cs, torch, label, _grad_pairs(cs, got, want), False)


# K6 at MViT-v2-S blocks 1 and 3 ((B*H, qN), kN 1568), and at chip_smoke.py's
# small kN 27 geometry with logits above 80, where the cls column sits at
# position 3 of a row of 8
K6_SHAPES = (("block 1", 36, 6272, (8, 14, 14), False),
             ("block 3", 72, 1568, (8, 14, 14), False),
             ("small kN 27 logits > 80", 4, 70, (3, 3, 3), True))


def _check_k6sp(cs, torch, gen):
    from procedurevrl_torch.ops import mvit_attention as k5

    scale = 96 ** -0.5
    for label, b, qn, k_shape, hot in K6_SHAPES:
        x = cs.mvit_inputs(torch, gen, b, 1, qn, k_shape, torch.bfloat16,
                           hot=hot)
        out, _, p = k5.mvit_attention_fwd_probs(*x[:6], k_shape, scale)
        ref, _, ref_p = k5.mvit_attention_fwd_probs_plain(*x[:6], k_shape,
                                                          scale)
        kn = x[1].shape[1]
        print(f"{label}: cls p mean "
              f"{ref_p[..., kn].float().mean().item():.3e}")
        yield _judge(cs, torch, label,
                     [("out", out, ref, cs.MVIT_FWD_TOL),
                      ("probs", p, ref_p, cs.PROBS_TOL,
                       ("MVIT_FWD_TOL", cs.MVIT_FWD_TOL))], False)


def _check_k6bs(cs, torch, gen):
    from procedurevrl_torch.ops import mvit_attention as k5

    scale = 96 ** -0.5
    for label, b, qn, k_shape, hot in K6_SHAPES:
        x = cs.mvit_inputs(torch, gen, b, 1, qn, k_shape, torch.bfloat16,
                           hot=hot)
        _, _, p = k5.mvit_attention_fwd_probs_plain(*x[:6], k_shape, scale)
        args = (*x[:6], p, x[6], k_shape, scale)
        yield _judge(cs, torch, label,
                     _grad_pairs(cs, k5.mvit_attention_bwd_probs(*args),
                                 k5.mvit_attention_bwd_probs_plain(*args)),
                     False)


def _mvit_bwd_case(cs, torch, gen, label, head_last, b, heads, qn, k_shape,
                   splits=None):
    """K5b (``head_last``) or K6b at one shape, the key-major pass over
    ``splits`` query chunks (None: the wrappers' own choice), against its
    plain version."""
    from procedurevrl_torch.ops import mvit_attention as k5

    scale = 96 ** -0.5
    x = cs.mvit_inputs(torch, gen, b, heads, qn, k_shape, torch.bfloat16)
    if head_last:
        rs = k5.mvit_attention_hl_fwd_plain(*x[:6], k_shape, heads, scale)[1]
        want = k5.mvit_attention_hl_bwd_plain(*x[:6], rs, x[6], k_shape, heads,
                                              scale)
    else:
        rs = k5.mvit_attention_fwd_plain(*x[:6], k_shape, scale)[1]
        want = k5.mvit_attention_bwd_plain(*x[:6], rs, x[6], k_shape, scale)
    got = k5._bwd_kernel(k5.RECOMPUTE, "mutation_check", *x[:6], x[6],
                         k_shape, b, heads if head_last else 1, scale,
                         stats=rs, splits=splits)
    return _judge(cs, torch, label, _grad_pairs(cs, got, want), False)


def _check_mvit_split(cs, torch, gen):
    # the key-major pass over several query chunks: block 0 as the wrapper
    # splits it (4 chunks on an H100), block 4 over 3 (the wrapper takes 1)
    yield _mvit_bwd_case(cs, torch, gen, "K5b block 0", True, 18, 1, 25088,
                         (8, 7, 7))
    yield _mvit_bwd_case(cs, torch, gen, "K5b block 4, 3 chunks", True, 18,
                         4, 1568, (8, 7, 7), splits=3)


def _check_mvit_bwd(cs, torch, gen):
    # both ways the key-major pass writes: through the chunk sum (block 0)
    # and straight from one chunk (block 1)
    yield _mvit_bwd_case(cs, torch, gen, "K5b block 0", True, 18, 1, 25088,
                         (8, 7, 7))
    yield _mvit_bwd_case(cs, torch, gen, "K6b block 1", False, 36, 1, 6272,
                         (8, 14, 14))


# K3 at L = 197 (the training batch) and L = 1025 (the last key tile holds
# only the CLS)
FLASH_SHAPES = (("L = 197", 144, 196), ("L = 1025", 16, 1024))


def _check_flash_fwd(cs, torch, gen):
    from procedurevrl_torch.ops import flash_attention as fa

    for label, bt, n in FLASH_SHAPES:
        x, _, _ = cs.flash_inputs(torch, gen, bt, n, 12, torch.bfloat16, True)
        got = fa.flash_attention_cls_fwd(*x, 12, 0.125)
        want = fa.flash_attention_cls_fwd_plain(*x, 12, 0.125)
        print(f"{label}: |out| mean {want[0].float().abs().mean().item():.3e}")
        yield _judge(cs, torch, label,
                     [("out", got[0], want[0], cs.FLASH_FWD_TOL),
                      ("outc", got[1], want[1], cs.FLASH_FWD_TOL),
                      ("l", got[2], want[2], cs.ROWSUM_TOL)], False)


def _check_flash_bwd(cs, torch, gen):
    from procedurevrl_torch.ops import flash_attention as fa

    for label, bt, n in FLASH_SHAPES:
        x, g, gc = cs.flash_inputs(torch, gen, bt, n, 12, torch.bfloat16, True)
        l = fa.flash_attention_cls_fwd_plain(*x, 12, 0.125)[2]
        got = fa.flash_attention_cls_bwd(*x, g, gc, l, 12, 0.125)
        want = fa.flash_attention_cls_bwd_plain(*x, g, gc, 12, 0.125)
        yield _judge(cs, torch, label,
                     [(name, a, r, cs.own_tol(cs.MVIT_GRAD_TOL, r))
                      for name, a, r in zip(("dq", "dk", "dv", "dqc", "dkc",
                                             "dvc"), got, want)], False)


def _check_flash_temporal(cs, torch, gen):
    from procedurevrl_torch.ops import flash_attention as fa

    heads, scale = 24, 32 ** -0.5
    for label, b in (("training", 18), ("eval", 16)):
        qkv = torch.randn(b, 8, 196, 3 * 768, generator=gen,
                          device="cuda").bfloat16()
        g = torch.randn(b, 8, 196, 768, generator=gen, device="cuda").bfloat16()
        out, l = fa.flash_attention_temporal_fwd(qkv, heads, scale)
        ref, ref_l = fa.flash_attention_temporal_fwd_plain(qkv, heads, scale)
        dqkv = fa.flash_attention_temporal_bwd(qkv, g, ref_l, heads, scale)
        want = fa.flash_attention_temporal_bwd_plain(qkv, g, heads, scale)
        yield _judge(cs, torch, label,
                     [("out", out, ref, cs.BF16_TOL),
                      ("l", l, ref_l, cs.ROWSUM_TOL),
                      ("dqkv", dqkv, want, cs.own_tol(cs.MVIT_GRAD_TOL, want))],
                     False)


# the pair at the head dims its scalar kernels take, K3 (with the CLS) at
# L = 197 in bf16 and float32: d = 320 in 2 heads (column groups of 256 and
# 64) and d = 12 in 32 heads (one group, ragged past the head dim)
def _check_flash_groups(cs, torch, gen):
    return _check_flash_odd(cs, torch, gen, 320, 2)


def _check_flash_ragged(cs, torch, gen):
    return _check_flash_odd(cs, torch, gen, 12, 32)


def _check_flash_odd(cs, torch, gen, d, heads):
    from procedurevrl_torch.ops import flash_attention as fa

    c, scale = heads * d, d ** -0.5
    for dtype in (torch.bfloat16, torch.float32):
        r = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
        x = list(r(16, 196, 3 * c).split(c, dim=-1))
        x += list(r(16, 1, 3 * c).split(c, dim=-1))
        g, gc = r(16, 196, c), r(16, 1, c)
        got = fa.flash_attention_cls_fwd(*x, heads, scale)
        want = fa.flash_attention_cls_fwd_plain(*x, heads, scale)
        grads = fa.flash_attention_cls_bwd(*x, g, gc, want[2], heads, scale)
        rgrads = fa.flash_attention_cls_bwd_plain(*x, g, gc, heads, scale)
        fp32 = dtype == torch.float32
        ftol = cs.FP32_TOL if fp32 else cs.FLASH_FWD_TOL
        pairs = [("out", got[0], want[0], ftol),
                 ("outc", got[1], want[1], ftol),
                 ("l", got[2], want[2], cs.ROWSUM_TOL)]
        pairs += [(name, a, ref, cs.grad_tol(cs.FP32_TOL, ref) if fp32
                   else cs.own_tol(cs.MVIT_GRAD_TOL, ref))
                  for name, a, ref in zip(("dq", "dk", "dv", "dqc", "dkc",
                                           "dvc"), grads, rgrads)]
        yield _judge(cs, torch, f"d {d} {str(dtype)[6:]}", pairs, False)


def _check_mvit_odd(cs, torch, gen):
    from procedurevrl_torch.ops import mvit_attention as k5

    # d = 136 (two column groups) at MViT-v2-S block 4's key grid, head-last
    k_shape, scale = (8, 7, 7), 136 ** -0.5
    for dtype in (torch.bfloat16, torch.float32):
        x = cs.mvit_inputs(torch, gen, 4, 2, 1568, k_shape, dtype, d=136)
        rs = k5.mvit_attention_hl_fwd_plain(*x[:6], k_shape, 2, scale)[1]
        args = (*x[:6], rs, x[6], k_shape, 2, scale)
        got = k5.mvit_attention_hl_bwd(*args)
        want = k5.mvit_attention_hl_bwd_plain(*args)
        yield _judge(cs, torch, f"K5b d 136 {str(dtype)[6:]}",
                     _grad_pairs(cs, got, want), False)


def _check_mvit_d72(cs, torch, gen):
    from procedurevrl_torch.ops import mvit_attention as k5

    scale = 72 ** -0.5
    for label, head_last, b, heads, qn, k_shape in cs.MVIT_D72_BLOCKS:
        x = cs.mvit_inputs(torch, gen, b, heads, qn, k_shape, torch.bfloat16,
                           d=72)
        if head_last:
            out, rs = k5.mvit_attention_hl_fwd(*x[:6], k_shape, heads, scale)
            ref, ref_rs = k5.mvit_attention_hl_fwd_plain(*x[:6], k_shape,
                                                         heads, scale)
        else:
            out, rs = k5.mvit_attention_fwd(*x[:6], k_shape, scale)
            ref, ref_rs = k5.mvit_attention_fwd_plain(*x[:6], k_shape, scale)
        yield _judge(cs, torch, label, [("out", out, ref, cs.MVIT_FWD_TOL),
                                        ("rowsum", rs, ref_rs,
                                         cs.ROWSUM_TOL)], False)


CHECKS = {"mvit": _check_mvit, "kt": _check_kt, "pool": _check_pool,
          "pool_dw": _check_pool_dw, "k1br": _check_k1br, "k1bd": _check_k1bd,
          "k1p": _check_k1p, "k2v3": _check_k2v3, "k2v3_16": _check_k2v3_16,
          "delta": _check_delta, "k6sp": _check_k6sp, "k6bs": _check_k6bs,
          "flash_fwd": _check_flash_fwd, "flash_bwd": _check_flash_bwd,
          "mvit_split": _check_mvit_split, "mvit_bwd": _check_mvit_bwd,
          "flash_temporal": _check_flash_temporal,
          "mvit_d72": _check_mvit_d72, "flash_groups": _check_flash_groups,
          "flash_ragged": _check_flash_ragged, "mvit_odd": _check_mvit_odd}
# the sources each check builds
SOURCES = {"mvit": "mvit_attention", "kt": "mvit_attention",
           "pool": "depthwise_pool", "pool_dw": "depthwise_pool",
           "k1br": "spatial_attention", "k1bd": "spatial_attention",
           "k1p": "spatial_attention", "k2v3": "temporal_attention",
           "k2v3_16": "temporal_attention", "delta": "mvit_attention",
           "k6sp": "mvit_attention", "k6bs": "mvit_attention",
           "flash_fwd": "flash_attention", "flash_bwd": "flash_attention",
           "mvit_split": "mvit_attention", "mvit_bwd": "mvit_attention",
           "flash_temporal": "flash_attention", "mvit_d72": "mvit_attention",
           "flash_groups": "flash_attention", "flash_ragged": "flash_attention",
           "mvit_odd": "mvit_attention"}


def check_copy(check: str, sound: bool = False) -> int:
    """In a copy: the (mutated) kernel at each shape against its plain
    version; returns the number of shapes the limits let a mutant through
    at, or, for the unmodified sources, the number they reject it at."""
    global _WHO
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from procedurevrl_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("mutation_check: needs a CUDA device")
    _build.build([SOURCES[check]])
    gen = torch.Generator(device="cuda").manual_seed(5)
    _WHO = "sound" if sound else "mutant"
    return sum(caught == sound for caught in CHECKS[check](cs, torch, gen))


def _run_copy(check: str, edit=None, sound: bool = False):
    """Copy the package and ``chip_smoke.py`` into a temporary directory,
    apply ``edit`` (source file, its (anchor, replacement) pairs) there and
    run ``check`` in the copy; returns its exit code and its output.  The
    libraries this tree has built come along: a copy rebuilds only the
    source it changes."""
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(ROOT / "procedurevrl_torch",
                        Path(tmp) / "procedurevrl_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", tmp)
        built = ROOT / "build" / "torch_kernels"
        if built.is_dir():
            shutil.copytree(built, Path(tmp) / "build" / "torch_kernels",
                            ignore=shutil.ignore_patterns("*.tmp"))
        if edit is not None:
            source, edits = edit
            cu = Path(tmp) / "procedurevrl_torch" / "csrc" / source
            src = cu.read_text()
            for anchor, line in edits:
                if src.count(anchor) != 1:
                    raise SystemExit(f"mutation_check: {anchor!r} not found "
                                     f"once in {source}")
                src = src.replace(anchor, line)
            cu.write_text(src)
        proc = subprocess.run(
            [sys.executable, "-m", "procedurevrl_torch.tools.mutation_check",
             "--in-copy", check] + (["--sound"] if sound else []),
            cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        return proc.returncode, proc.stdout


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--in-copy", choices=sorted(CHECKS),
                        help=argparse.SUPPRESS)
    parser.add_argument("--sound", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--only", nargs="+", choices=sorted(CHECKS),
                        help="run only the mutants of these checks")
    parser.add_argument("--jobs", type=int, default=4,
                        help="copies built and checked at once (default 4)")
    args = parser.parse_args(argv)
    if args.in_copy:
        return 1 if check_copy(args.in_copy, args.sound) else 0
    mutants = {name: m for name, m in MUTANTS.items()
               if args.only is None or m.check in args.only}
    # the unmodified kernels first: a limit that rejects them is no limit;
    # each copy's output is printed whole, in this order
    with ThreadPoolExecutor(max_workers=max(args.jobs, 1)) as pool:
        checks = sorted({m.check for m in mutants.values()})
        rejected = []
        for check, (rc, out) in zip(checks, pool.map(
                lambda c: _run_copy(c, sound=True), checks)):
            print(f"sound: {check}\n{out}", end="", flush=True)
            if rc:
                rejected.append(check)
        failed = []
        for name, (rc, out) in zip(mutants, pool.map(
                lambda m: _run_copy(m.check, (m.source, ((m.anchor, m.line),
                                                         *m.more))),
                mutants.values())):
            print(f"mutant: {name}\n{out}", end="", flush=True)
            if rc:
                failed.append(name)
    print(f"mutation_check: {len(mutants) - len(failed)} of {len(mutants)} "
          f"mutants rejected at every shape"
          + (f"; let through: {failed}" if failed else "")
          + (f"; sound kernels rejected by: {rejected}" if rejected else ""))
    return 1 if failed or rejected else 0


if __name__ == "__main__":
    sys.exit(main())
