"""Show that ``chip_smoke.py``'s limits reject kernels with planted faults:
K5f/K6f and K7f missing key columns, K8f missing a halo plane, K8dw
missing a batch, K1br and K1p without the CLS key, K1bd with delta forced
to 0, K2v3f without the last key frame (at 8 and at 16 frames), K5bd /
K6bd with D forced to 0, K6sp storing p without the cls column and K6bs
reading p without it, the slice 7 pair (``flash_attention.cu``, K3f /
K4f and K3b / K4b) with a forward that drops the CLS key or the last key
tile, and a backward that drops the jacobian row sums D or leaves the CLS
row of dk and dv unwritten, and the MViT backward pair (K5b / K6b and its
variants) with a key-major pass whose last query chunk never reaches the
sum of the chunks, or that leaves the cls key's row of dk and dv
unwritten; the pair on K2's time-major layout with each clip's rows
starting one frame early (``row_of``'s branch for sequences side by side),
and K5f / K6f at head dim 72 staging q and k without zeros past column 72
of their 96-wide tiles.

    python -m procedurevrl_torch.tools.mutation_check

For each fault in :data:`MUTANTS` this copies the package and
``chip_smoke.py`` into a temporary directory, plants the fault in the copy
of its CUDA source, builds it, and holds the mutated kernel at two or three
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
``MVIT_FWD_TOL`` and the row sums against ``ROWSUM_TOL``.  For K7, K8, K1, K2 and the backward kernels the mutant
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
# the slice 7 pair: the forward's clamp of a key chunk and its chunk loop,
# the query-major backward's reduction of D, the key-major pass's store
_FA_EXP = "clamp_exp<KC / 8>(e, col0, g.L, scale);"
_FA_CHUNK = "const int col0 = t * BN + c;\n        if (col0 >= g.L) break;"
_FA_D = "d0 = quad_sum(d0);\n      d1 = quad_sum(d1);"
_FA_KROW = "const int j = j0 + warp * 16 + gid + 8 * half;\n    if (j >= g.L) continue;"
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
    # the CLS is key L - 1 of [frames; cls]
    "K3f / K4f cls key left out": Mutant(
        "flash_attention.cu", _FA_EXP,
        "clamp_exp<KC / 8>(e, col0, g.L - (g.L > g.n), scale);", "flash_fwd"),
    "K3f / K4f last key tile left out": Mutant(
        "flash_attention.cu", _FA_CHUNK,
        "const int col0 = t * BN + c;\n        "
        "if (col0 >= g.L || t == g.tiles - 1) break;", "flash_fwd"),
    "K3b / K4b jacobian row sums D forced to 0": Mutant(
        "flash_attention.cu", _FA_D, "d0 = 0.f;\n      d1 = 0.f;",
        "flash_bwd"),
    "K3b / K4b cls row of dk and dv left unwritten": Mutant(
        "flash_attention.cu", _FA_KROW,
        "const int j = j0 + warp * 16 + gid + 8 * half;\n    "
        "if (j >= g.n) continue;", "flash_bwd"),
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
          "mvit_d72": _check_mvit_d72}
# the sources each check builds
SOURCES = {"mvit": "mvit_attention", "kt": "mvit_attention",
           "pool": "depthwise_pool", "pool_dw": "depthwise_pool",
           "k1br": "spatial_attention", "k1bd": "spatial_attention",
           "k1p": "spatial_attention", "k2v3": "temporal_attention",
           "k2v3_16": "temporal_attention", "delta": "mvit_attention",
           "k6sp": "mvit_attention", "k6bs": "mvit_attention",
           "flash_fwd": "flash_attention", "flash_bwd": "flash_attention",
           "mvit_split": "mvit_attention", "mvit_bwd": "mvit_attention",
           "flash_temporal": "flash_attention", "mvit_d72": "mvit_attention"}


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


def _run_copy(check: str, edit=None, sound: bool = False) -> int:
    """Copy the package and ``chip_smoke.py`` into a temporary directory,
    apply ``edit`` (source file, its (anchor, replacement) pairs) there and
    run
    ``check`` in the copy; returns its exit code."""
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(ROOT / "procedurevrl_torch",
                        Path(tmp) / "procedurevrl_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", tmp)
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
        return subprocess.run(
            [sys.executable, "-m", "procedurevrl_torch.tools.mutation_check",
             "--in-copy", check] + (["--sound"] if sound else []),
            cwd=tmp).returncode


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--in-copy", choices=sorted(CHECKS),
                        help=argparse.SUPPRESS)
    parser.add_argument("--sound", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--only", nargs="+", choices=sorted(CHECKS),
                        help="run only the mutants of these checks")
    args = parser.parse_args(argv)
    if args.in_copy:
        return 1 if check_copy(args.in_copy, args.sound) else 0
    mutants = {name: m for name, m in MUTANTS.items()
               if args.only is None or m.check in args.only}
    # the unmodified kernels first: a limit that rejects them is no limit
    rejected = []
    for check in sorted({m.check for m in mutants.values()}):
        print(f"sound: {check}", flush=True)
        if _run_copy(check, sound=True):
            rejected.append(check)
    failed = []
    for name, m in mutants.items():
        print(f"mutant: {name}", flush=True)
        if _run_copy(m.check, (m.source, ((m.anchor, m.line), *m.more))):
            failed.append(name)
    print(f"mutation_check: {len(mutants) - len(failed)} of {len(mutants)} "
          f"mutants rejected at every shape"
          + (f"; let through: {failed}" if failed else "")
          + (f"; sound kernels rejected by: {rejected}" if rejected else ""))
    return 1 if failed or rejected else 0


if __name__ == "__main__":
    sys.exit(main())
