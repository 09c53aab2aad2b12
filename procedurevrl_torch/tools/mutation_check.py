"""Show that ``chip_smoke.py``'s limits reject kernels with planted faults:
K5f/K6f and K7f missing key columns, K8f missing a halo plane, reading the
halo row below a band as zeros or reading the ring slot of the next plane,
K8dw missing a batch or one CTA's partial, K1br and K1p without the CLS key, K1bd with delta forced
to 0, K2v3f and K2f without the last key frame (at 8 and at 16 frames),
K2b with the last frame's dk unwritten, the K2f / K2b ring with a clip's
last tile read from the next clip or a slot released before its results
are stored (and so before its store has read it), K5bd /
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
of their 96-wide tiles; and the Hopper forwards' rings, staging and
sweep: K1f / K1sp / K1p without the CLS row in the stage, with a stage
released to the copying warpgroup before its products are done, K1sp
with the last p row of an item not flushed or its zero columns past L
staged as ones, K5f / K6f with the cls column left out of the one-sweep
row sums l only, a stage released early, or the expander built for the
next key tile, and K6sp with the last 16-byte piece of each p row not
flushed; K7f on that forward with o not rescaled when a tile raises the
running max, or a ring stage refilled before its warpgroups release it;
and K1's Hopper backward with a ring stage refilled before its empty
barrier, or a key-major pass that drops the last, partial key window; and
the softmax shifts' variants: K1 under max without the row max, the
key-tiled pair under max without the rescale of o, K2 under max with the
max taken over the wrong lanes, K6sp under max with the clamp in its
second sweep, and none with the clamp's min left in (``common.cuh``),
each held by ``chip_smoke.py``'s phase 32 checks at two shapes.

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
blocks 0 and 4 against ``POOL_TOL`` (both shapes tile H in more than one
band, so a band edge is inside the grid); K8dw at blocks 0 and 4 against
the fp32 limit scaled by the largest gradient; K1br, K1bd and K1p at the
TimeSformer-B training and eval shapes (BT 144 and 128, N 196, 12 heads),
the gradients against the bf16 limit scaled by the largest gradient and
K1p against ``K1K2_FWD_TOL``, with K1br held bit for bit against K1b on
K1sp's probabilities and K1p against K1f, as ``chip_smoke.py`` holds them;
K1sp at the same shapes, out and p against ``K1K2_FWD_TOL`` and out bit
for bit against K1f's; K5f / K6f as above but rejected where either limit
rejects (``mvit_sum``);
K2v3f at the training and eval shapes (B 18 and 16, T 8 and 16, N 196),
out and p against ``K1K2_FWD_TOL``; K2f at the same shapes against
``BF16_TOL`` (phase 3's limit) and K2v3f bit for bit, K2b at the training
shape with 8 and 16 frames against the bf16 limit scaled by the largest
gradient and K2v3b fed K2v3f's p bit for bit, both at 3 clips of N 49 (T
8 and 3) and at the training shape, each output from NaN-filled memory; K5bd at block 0 and K6bd at block 1,
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
# the keep-mask of the exponentials of the K5/K6 tensor-core forward
# (``mvit_fwd_wg``): columns 0..kN-1 are body keys, column kN the cls key;
# its row sums, its ring refill and the expander of a stage
_MASK = "if (full_tile || (!past && j0 + acc_col(j, e) <= g.kn))"
_MV_L = "        if (e < 2) l0 += x; else l1 += x;"
_MV_REFILL = "    stage(t + FSTAGES - 1);\n"
_MV_EXPANDER = ("      build_expander_cm(st + 128 * DP, j0, g);\n    }\n"
                "    cp_async_commit();\n  };\n"
                "  for (int t = 0; t + 1 < FSTAGES; ++t) stage(t);")
# K7f (``mvit_fwd_wg`` with KT): the mask of the columns past the cls key,
# and the rescale of o when a tile raises the running max
_KT_MASK = "if (!full_tile && j0 + acc_col(j, e) > g.kn) s[4 * j + e] = MASKED;"
_KT_RESCALE = "if (!SAVE && t > 0) {"
# K8f's dt = 2 taps (an input plane's products for the output plane
# before it), its read of a staged column, and its wait for a landing
# plane; K8dw's store of a CTA's partial and the walk of its second pass
_POOL_PLANE = "pv[k][e] = fmaf(v[e], wt[2][dw][e], pv[k][e]);"
_POOL_READ = "          load_pair(pl + (dh * g.pitch + j) * CS, v);\n"
_POOL_SLOT = "reinterpret_cast<const T*>(ring + slot * g.slot)"
_DW_STORE = "pb[(size_t)r * g.c + P.c0 + cc] = s;"
_DW_PARTS = "for (int k = l; k < nparts; k += RED_LANES)"
# the Hopper backward of K1 (``spatial_bwd_wg_kernel``): K1br's recomputed
# softmax in pass 1, the barrier between its passes, its release of a
# stage and the loop of pass 2 over the key windows; K1p's ring slot, K1bd's delta
# rows and K2v3f's key mask
_BR_SOFTMAX = "      const bool inside = 8 * j + 8 <= L;\n"
_BWD_PASSES = ("    bar_sync(3, BWD_WGS * 128);  // every D_i (and 1 / l_i) "
               "is stored\n")
_BWD_RELEASE = "    if (threadIdx.x == 0) mbar_arrive(empty + slot);\n  }\n}"
_BWD_KEYS = ("    for (int t = wg; t < 4 && 64 * t < L; t += BWD_WGS)\n"
             "      bwd_keys<MODE, S>")
_PIPE_SLOT = ("    const uint16_t* st = ring + slot * STAGE;\n"
              "    uint16_t* p_dst =")
# the bf16 forward's (K1f, K1sp, K1p) copy of an item's rows into its ring
# stage, the ring's refill, and K1sp's staging and bulk store of p
_K1_ROWS = "        if (r < L)\n          cp_async16(st + part * TILE + i * 8,"
_K1_FULL = ("    mbar_wait(full + slot, (k / depth) & 1);  // item k's rows "
            "have landed\n")
_K1_RELEASE = ("    bar_sync(1 + wg, 128);\n    if ((threadIdx.x & 127) == 0) "
               "mbar_arrive(empty + slot);\n  }")
_K1_FLUSH = "      const int rows = min(64, L - t * 64);"
_K1_STAGE_P = ("        *reinterpret_cast<uint32_t*>(p_st + r0 * ls + col) = "
               "pa[kk][2 * u];")
_DELTA = "(half ? d1 : d0) = acc;"
_V3_KEYS = "const bool key = 2 * tig + e < frames;"
_V3_KEYS16 = "const bool key1 = 8 + 2 * tig + (e & 1) < frames;"
# the K2f / K2b ring (``temporal_ring_kernel``): K2b's backward body of an
# item's head, the clip of an item's tile, a computing warp's wait for its
# slot and its release of the previous item's slot
_RING_BWD = ("      v3_bwd_head<FR>(p, q, kt, v, SwzTile{st + 3 * box}, ds_t, "
             "p_t,\n                      geo.scale);\n")
_RING_CLIP = "  return {tile / g.tiles, (tile % g.tiles) * (V3_ROWS / FR),"
_RING_FULL = "    mbar_wait(full + slot, (k / stages) & 1);\n"
_RING_READ = "        bulk_wait_read_all_but_newest();\n"
_RING_RELEASE = "        mbar_arrive(empty + held);\n"
# the D rows of the delta backwards (K5bd, K6bd; K7b shares them), K6sp's
# store of a p fragment pair, and the tile of saved p K6bs stages
_D_ROWS = "dd_s[threadIdx.x] = acc;"
_P_STORE = "pack_bf16x2(s[4 * j + 2 * h] * f, s[4 * j + 2 * h + 1] * f);"
_P_FLUSH = "if (w0 + r < g.qn && col < g.pld)"
_P_TILE = "if (i0 + r < g.qn && j0 + c < g.pld) {"
# the key-tiled pair: the forward's key mask and its walk over the key
# tiles, the backward's sum of D (shared by the fused kernel and the
# query-major pass), its dq products (the query-major pass's and the fused
# kernel's) and the rows of dk and dv it writes; the scalar kernels'
# forward store (column groups) and dot product (head dims past the tensor
# cores')
_FA_EXP = ("key_in(g, vs, kt, acc_row(e), acc_col(j, e))))\n"
           "        x = exp2f(")
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
_MV_Q_FILL = "if (r0 + r < n && c < d) {"
# the softmax shifts (slice 16): K1's row max of a wgmma logit tile, the
# pair's rescale of o when a key tile raises the running max, K2's max over
# a row's quad, the exponentials of the MViT forward under max (K6sp's
# second sweep among them), and the none shift's exponent
_K1_ROW_MAX = ("  nm0 = -quad_max(m0) * scale2;\n"
               "  nm1 = -quad_max(m1) * scale2;\n")
_FA_RESCALE = "  if (!first) {  // o holds the previous tiles' sum"
_K2_QUAD_MAX = ("      na = -quad_max(ma) * scale2;\n"
                "      nb = -quad_max(mb) * scale2;\n")
_MV_MAX_EXP = ("s[4 * j + e] = exp2f((s[4 * j + e] - (e < 2 ? n0 : n1)) "
               "* LOG2E);")
_NONE_ARG = "  else return s * scale2;"
_MV_K_FILL = "if (j <= g.kn && c < g.d) {"


@dataclass(frozen=True)
class Mutant:
    source: str   # file under csrc/
    anchor: str   # text planted over, found once in the source
    line: str     # what replaces it
    check: str    # the check run in the copy (a key of CHECKS)
    more: tuple = ()  # further (anchor, line) edits of the same source


MUTANTS = {
    "cls column skipped": Mutant(
        "mvit_attention.cu", _MASK,
        "if (!past && j0 + acc_col(j, e) < g.kn)", "mvit"),
    # the last body key lies in the ragged last key tile at both shapes
    "last body key skipped": Mutant(
        "mvit_attention.cu", _MASK,
        "if ((full_tile || (!past && j0 + acc_col(j, e) <= g.kn)) && "
        "j0 + acc_col(j, e) != g.kn - 1)", "mvit"),
    # o keeps the cls term, l loses it: out moves by ~1 / kN, l fails
    "K5f / K6f cls column left out of the one-sweep l": Mutant(
        "mvit_attention.cu", _MV_L,
        "        if (j0 + acc_col(j, e) != g.kn) { if (e < 2) l0 += x; "
        "else l1 += x; }", "mvit_sum"),
    # the refill of step t + 3 lands in the stage step t is read from, and
    # step t + 2 is never loaded
    "K5f / K6f ring stage refilled before its warpgroups release it": Mutant(
        "mvit_attention.cu", _MV_REFILL, "    stage(t + FSTAGES);\n", "mvit"),
    "K5f / K6f expander built for the next key tile": Mutant(
        "mvit_attention.cu", _MV_EXPANDER,
        _MV_EXPANDER.replace("j0, g);", "j0 + BN, g);"), "mvit"),
    "K7f cls column skipped": Mutant(
        "mvit_attention.cu", _KT_MASK,
        _KT_MASK.replace("> g.kn", ">= g.kn"), "kt"),
    # kN + 1 = 1569 keys: the last tile holds keys 1536..1567 and the cls
    "K7f ragged last key tile skipped": Mutant(
        "mvit_attention.cu", _KT_MASK,
        "if (!full_tile) s[4 * j + e] = MASKED;", "kt"),
    # l is rescaled when a tile raises the running max, o keeps its old scale
    "K7f o not rescaled when the running max rises": Mutant(
        "mvit_attention.cu", _KT_RESCALE, "if (false) {", "kt"),
    # slice 16: each family's max variant, and the none shift
    "K1 under max: the row max not subtracted": Mutant(
        "spatial_attention.cu", _K1_ROW_MAX,
        "  nm0 = 0.f * quad_max(m0);\n  nm1 = 0.f * quad_max(m1);\n",
        "k1_max"),
    "the pair under max: o not rescaled when the running max rises": Mutant(
        "flash_attention.cu", _FA_RESCALE, "  if (false) {  // o holds",
        "pair_max"),
    "K2 under max: the max taken over the wrong lane class": Mutant(
        "temporal_attention.cu", _K2_QUAD_MAX,
        "      na = -fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, 4)) * "
        "scale2;\n      nb = -fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, "
        "4)) * scale2;\n", "k2_max"),
    "K6sp under max: the second sweep takes the clamp": Mutant(
        "mvit_attention.cu", _MV_MAX_EXP,
        "s[4 * j + e] = SAVE && t >= tiles ? exp2f(fminf(s[4 * j + e], "
        "CLAMP_HI) * LOG2E) : exp2f((s[4 * j + e] - (e < 2 ? n0 : n1)) * "
        "LOG2E);", "k6sp_max"),
    "none with the clamp's min left in place": Mutant(
        "common.cuh", _NONE_ARG,
        "  else return fminf(s * scale2, CLAMP_HI * LOG2E);", "k1_none"),
    "K7f ring stage refilled before its warpgroups release it": Mutant(
        "mvit_attention.cu", _MV_REFILL, "    stage(t + FSTAGES);\n", "kt"),
    # output plane T-2 loses its taps on plane T-1
    "K8f halo plane T-1 skipped": Mutant(
        "depthwise_pool.cu", _POOL_PLANE, "if (ti != g.t - 1) " + _POOL_PLANE,
        "pool"),
    # the last output row of each band loses the halo row below the band
    # (real data but in the last band)
    "K8f halo row below a band read as zeros": Mutant(
        "depthwise_pool.cu", _POOL_READ,
        _POOL_READ + "          if (dh == 2 && P.rr == g.band - 1) "
        "v[0] = v[1] = 0.f;\n", "pool"),
    # every plane is still waited for (no copy outlives the CTA), but read
    # from the slot of the plane that lands next
    "K8f reads the ring slot of the next plane": Mutant(
        "depthwise_pool.cu", _POOL_SLOT,
        "reinterpret_cast<const T*>(ring + (ti + 1) % FWD_SLOTS * g.slot)",
        "pool"),
    "K8dw last batch dropped": Mutant(
        "depthwise_pool.cu", _DW_STORE,
        "pb[(size_t)r * g.c + P.c0 + cc] = P.b == g.b - 1 ? 0.f : s;",
        "pool_dw"),
    "K8dw one CTA's partial left out of the sum": Mutant(
        "depthwise_pool.cu", _DW_PARTS,
        "for (int k = l; k < nparts - 1; k += RED_LANES)", "pool_dw"),
    # keys < L - 1: the CLS key (key n) leaves pass 1's recomputed softmax
    "K1br cls key left out of the recomputed p": Mutant(
        "spatial_attention.cu", _BR_SOFTMAX,
        "      const int L = n;  // the CLS key left out\n" + _BR_SOFTMAX,
        "k1br"),
    # the stage is released to the copying warpgroup after pass 1, so the
    # next item but one lands in it under pass 2's products
    "K1 backward ring stage refilled before its empty barrier": Mutant(
        "spatial_attention.cu", _BWD_PASSES,
        _BWD_PASSES + "    if (threadIdx.x == 0) mbar_arrive(empty + slot);\n",
        "k1br", ((_BWD_RELEASE, "  }\n}"),)),
    # pass 2 stops before the last key window (keys 192..207, the CLS key's
    # row of dk and dv among them)
    "K1 backward key-major pass drops the last partial window": Mutant(
        "spatial_attention.cu", _BWD_KEYS,
        _BWD_KEYS.replace("t < 4", "t < 3"), "k1br"),
    # the CLS key's rows of the staged k and v tiles zeroed before the item
    # computes (row n's eight 16-byte pieces in the core-matrix layout)
    "K1p cls key left out": Mutant(
        "spatial_attention.cu", _PIPE_SLOT,
        _PIPE_SLOT.replace(
            "    uint16_t* p_dst =",
            "    if ((threadIdx.x & 127) < 16) reinterpret_cast<uint4*>("
            "const_cast<uint16_t*>(st) + (1 + ((threadIdx.x & 127) >> 3)) * "
            "TILE)[(((n >> 3) * 8 + (threadIdx.x & 7)) << 3) | (n & 7)] = "
            "make_uint4(0u, 0u, 0u, 0u);\n    fence_async_smem();\n"
            "    bar_sync(1 + wg, 128);\n    uint16_t* p_dst ="), "k1p"),
    # the CLS row (row n of q, k and v) never reaches the stage
    "K1 cls row not copied into the stage": Mutant(
        "spatial_attention.cu", _K1_ROWS,
        _K1_ROWS.replace("if (r < L)", "if (r < n)"), "k1sp"),
    # each warpgroup releases its stage as soon as the item has landed, so
    # the copying warpgroup refills it under the products that read it
    "K1 ring stage refilled before its warpgroups release it": Mutant(
        "spatial_attention.cu", _K1_FULL,
        _K1_FULL + "    if ((threadIdx.x & 127) == 0) mbar_arrive(empty + "
        "slot);\n", "k1p",
        ((_K1_RELEASE, "    bar_sync(1 + wg, 128);\n  }"),)),
    # the last row of a ragged query tile (the CLS query's p row) stays in
    # the staging tile
    "K1sp last p row of the item not flushed": Mutant(
        "spatial_attention.cu", _K1_FLUSH,
        "      const int rows = min(64, L - t * 64) - (t * 64 + 64 > L);",
        "k1sp"),
    # p columns past L (the zero pad of each row) staged as ones
    "K1sp p columns past L not zeroed": Mutant(
        "spatial_attention.cu", _K1_STAGE_P,
        "        *reinterpret_cast<uint32_t*>(p_st + r0 * ls + col) = "
        "col >= L ? 0x3f803f80u : pa[kk][2 * u];", "k1sp"),
    "K1bd delta forced to 0": Mutant(
        "spatial_attention.cu", _DELTA, "(half ? d1 : d0) = 0.f;", "k1bd"),
    "K2v3f last key frame left out": Mutant(
        "temporal_attention.cu", _V3_KEYS,
        "const bool key = 2 * tig + e < frames - 1;", "k2v3"),
    "K2v3f last key frame left out at 16 frames": Mutant(
        "temporal_attention.cu", _V3_KEYS16,
        "const bool key1 = 8 + 2 * tig + (e & 1) < frames - 1;", "k2v3_16"),
    # the shared softmax's key mask, held through K2f (the ring)
    "K2f last key frame left out": Mutant(
        "temporal_attention.cu", _V3_KEYS,
        "const bool key = 2 * tig + e < frames - 1;", "k2f"),
    "K2f last key frame left out at 16 frames": Mutant(
        "temporal_attention.cu", _V3_KEYS16,
        "const bool key1 = 8 + 2 * tig + (e & 1) < frames - 1;", "k2f_16"),
    # the last frame's row of dk (each position's) zeroed in the slot
    # before its store, as if never written
    "K2b last frame's dk left unwritten": Mutant(
        "temporal_attention.cu", _RING_BWD,
        _RING_BWD + "      if (lane < 8 * (V3_ROWS / FR)) *reinterpret_cast"
        "<uint4*>(kt.at((lane >> 3) * FR + geo.frames - 1, (lane & 7) * 8)) "
        "= make_uint4(0u, 0u, 0u, 0u);\n", "k2b"),
    # the clip index rounds up on a clip's last tile: its positions are read
    # from (and written to) the next clip, and the clip's own never written
    "K2 a clip's last tile read from the next clip": Mutant(
        "temporal_attention.cu", _RING_CLIP,
        "  return {(tile + 1) / g.tiles, (tile % g.tiles) * (V3_ROWS / FR),",
        "k2_odd"),
    # the slot goes back to the copying warp as soon as it has landed: the
    # next load into it races the products and the store that read it
    "K2 ring slot released before its store has read it": Mutant(
        "temporal_attention.cu", _RING_FULL,
        _RING_FULL + "    if (lane == 0) mbar_arrive(empty + slot);\n",
        "k2_ring", ((_RING_RELEASE, ""),)),
    "K5bd / K6bd delta forced to 0": Mutant(
        "mvit_attention.cu", _D_ROWS, "dd_s[threadIdx.x] = 0.f;", "delta"),
    # the staged word of columns (c, c + 1), c even, with the cls column
    # kN zeroed (its low half where kN is even, its high half where odd)
    "K6sp cls column left out of the stored p": Mutant(
        "mvit_attention.cu", _P_STORE,
        "pack_bf16x2(j0 + acc_col(j, 0) == g.kn ? 0.f : s[4 * j + 2 * h] * "
        "f, j0 + acc_col(j, 1) == g.kn ? 0.f : s[4 * j + 2 * h + 1] * f);",
        "k6sp"),
    # the last 16-byte piece of each p row (the cls column and the zeros
    # past it) stays in the staging tile
    "K6sp last piece of each p row not flushed": Mutant(
        "mvit_attention.cu", _P_FLUSH,
        "if (w0 + r < g.qn && col + 8 < g.pld)", "k6sp"),
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
        "!(g.L > g.n && kt * BM + acc_col(j, e) == g.n))))\n"
        "        x = exp2f(", "flash_fwd"),
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
        ((_MV_K_FILL, "if (j <= g.kn) {"),)),
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
        hit = not all(cs.same_bits(torch, a, b) for a, b in zip(got, twin))
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


def _check_mvit(cs, torch, gen, need_all=True):
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
                                         cs.ROWSUM_TOL)], need_all)


def _check_mvit_sum(cs, torch, gen):
    """K5f / K6f as ``_check_mvit``, rejected where either limit rejects."""
    return _check_mvit(cs, torch, gen, need_all=False)


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
        plan = k8.pool_plan(thw[1], thw[2], c, 1, 2)
        print(f"{label}: {plan}")
        if plan.bands < 2:
            raise SystemExit(f"mutation_check: {label} is one band of rows; "
                             f"the band-edge fault needs two")
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


def _check_k1sp(cs, torch, gen):
    from procedurevrl_torch.ops import spatial_attention as k1

    for label, bt in K1_SHAPES:
        qkv, qkv_c, _, _ = cs.k1_inputs(torch, gen, bt, 196, 12,
                                        torch.bfloat16, sd=0.5)
        out, out_c, p = k1.spatial_attention_fwd_probs(qkv, qkv_c, 12, 0.125)
        ref, ref_c, ref_p = k1.spatial_attention_fwd_probs_plain(qkv, qkv_c,
                                                                 12, 0.125)
        twin = k1.spatial_attention(qkv, qkv_c, 12, 0.125)
        print(f"{label}: |p| mean {ref_p.float().abs().mean().item():.3e}")
        yield _judge(cs, torch, label,
                     [("frames", out, ref, cs.K1K2_FWD_TOL),
                      ("cls", out_c, ref_c, cs.K1K2_FWD_TOL),
                      ("probs", p, ref_p, cs.K1K2_FWD_TOL)],
                     False, [("against K1f", (out, out_c), twin)])


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


def _poison(torch):
    """Fill freed device memory with NaN, so that an output element a
    kernel leaves unwritten shows."""
    torch.full((64 << 20,), float("nan"), device="cuda")
    torch.cuda.synchronize()


def _k2_pairs(cs, torch, k2, qkv, g, fwd=True, bwd=True):
    """K2f's output and K2b's gradient against their plain versions, at
    ``chip_smoke.py``'s limits, each from NaN-filled memory."""
    pairs = []
    if fwd:
        _poison(torch)
        pairs.append(("out", k2.temporal_attention(qkv, 12, 0.125),
                      k2.temporal_attention_plain(qkv, 12, 0.125),
                      cs.BF16_TOL))
    if bwd:
        _poison(torch)
        got = k2.temporal_attention_bwd(qkv, g, 12, 0.125)
        ref = k2.temporal_attention_bwd_plain(qkv, g, 12, 0.125)
        pairs.append(("dqkv", got, ref, cs.grad_tol(cs.BF16_TOL, ref)))
    return pairs


def _k2_inputs(torch, gen, b, t, n=196):
    qkv = torch.randn(b, t, n, 3 * 768, generator=gen, device="cuda")
    g = torch.randn(b, t, n, 768, generator=gen, device="cuda")
    return qkv.bfloat16(), g.bfloat16()


def _check_k2f(cs, torch, gen, frames=8, shapes=(("training", 18),
                                                 ("eval", 16))):
    """K2f at ``chip_smoke.py`` phase 3's shapes against its plain version
    (``BF16_TOL``) and K2v3f bit for bit."""
    from procedurevrl_torch.ops import temporal_attention as k2

    for label, b in shapes:
        qkv, _ = _k2_inputs(torch, gen, b, frames)
        pairs = _k2_pairs(cs, torch, k2, qkv, None, bwd=False)
        twin = k2.temporal_attention_v3(qkv, 12, 0.125, save_probs=False)[0]
        yield _judge(cs, torch, f"{label} T = {frames}", pairs, False,
                     [("against K2v3f", (pairs[0][1],), (twin,))])


def _check_k2f_16(cs, torch, gen):
    return _check_k2f(cs, torch, gen, 16, (("training", 18),))


def _check_k2b(cs, torch, gen):
    """K2b at the training shape with 8 and 16 frames against its plain
    version (``grad_tol(BF16_TOL)``) and K2v3b fed K2v3f's p bit for
    bit."""
    from procedurevrl_torch.ops import temporal_attention as k2

    for frames in (8, 16):
        qkv, g = _k2_inputs(torch, gen, 18, frames)
        pairs = _k2_pairs(cs, torch, k2, qkv, g, fwd=False)
        probs = k2.temporal_attention_v3(qkv, 12, 0.125)[1]
        twin = k2.temporal_attention_v3_bwd(qkv, probs, g, 12, 0.125)
        yield _judge(cs, torch, f"training T = {frames}", pairs, False,
                     [("against K2v3b(K2v3f p)", (pairs[0][1],), (twin,))])


def _check_k2_odd(cs, torch, gen):
    """K2f and K2b at an odd N (3 clips of 49 positions; 8 and 3 frames)
    against their plain versions."""
    from procedurevrl_torch.ops import temporal_attention as k2

    for frames in (8, 3):
        qkv, g = _k2_inputs(torch, gen, 3, frames, 49)
        yield _judge(cs, torch, f"N = 49 T = {frames}",
                     _k2_pairs(cs, torch, k2, qkv, g), False)


def _check_k2_ring(cs, torch, gen):
    """K2f and K2b at the training shape against their plain versions,
    each a shape of its own."""
    from procedurevrl_torch.ops import temporal_attention as k2

    qkv, g = _k2_inputs(torch, gen, 18, 8)
    yield _judge(cs, torch, "K2f training",
                 _k2_pairs(cs, torch, k2, qkv, g, bwd=False), False)
    yield _judge(cs, torch, "K2b training",
                 _k2_pairs(cs, torch, k2, qkv, g, fwd=False), False)


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


def _check_k1_shift(cs, torch, gen, shift):
    from procedurevrl_torch.ops import spatial_attention as k1

    for label, bt, n in (("training", 144, 196), ("N 48", 4, 48)):
        pairs, twins = cs.k1_shift_checks(torch, gen, k1, shift,
                                          torch.bfloat16, bt, n)
        yield _judge(cs, torch, label, pairs, False, twins)


def _check_k1_max(cs, torch, gen):
    """K1f, K1sp, K1p and K1br under max (the training shape and N 48)."""
    return _check_k1_shift(cs, torch, gen, "max")


def _check_k1_none(cs, torch, gen):
    """The same under none."""
    return _check_k1_shift(cs, torch, gen, "none")


def _check_k2_max(cs, torch, gen):
    """K2f, K2v3f and K2b under max at two positions a tile (T 8)."""
    from procedurevrl_torch.ops import temporal_attention as k2

    for label, b, t, n in (("training", 18, 8, 196), ("N 49", 3, 8, 49)):
        pairs, twins = cs.k2_shift_checks(torch, gen, k2, "max",
                                          torch.bfloat16, b, t, n)
        yield _judge(cs, torch, label, pairs, False, twins)


def _check_pair_max(cs, torch, gen):
    """K4 and K3 under max at the training shapes."""
    from procedurevrl_torch.ops import flash_attention as fa

    for label, n, cls in (("K4", 197, False), ("K3", 196, True)):
        yield _judge(cs, torch, label,
                     cs.pair_shift_checks(torch, gen, fa, "max",
                                          torch.bfloat16, 144, n, cls), False)


def _check_k6sp_max(cs, torch, gen):
    """K6sp under max at block 1 and at the small kN 27 geometry."""
    from procedurevrl_torch.ops import mvit_attention as k5

    for label, b, qn, k_shape in (("block 1", 36, 6272, (8, 14, 14)),
                                  ("kN 27", 4, 70, (3, 3, 3))):
        yield _judge(cs, torch, label,
                     cs.mvit_shift_checks(torch, gen, k5, "max",
                                          torch.bfloat16, "K6sp", False, b, 1,
                                          qn, k_shape, saved=True), False)


CHECKS = {"mvit": _check_mvit, "mvit_sum": _check_mvit_sum,
          "kt": _check_kt, "pool": _check_pool,
          "pool_dw": _check_pool_dw, "k1br": _check_k1br, "k1bd": _check_k1bd,
          "k1p": _check_k1p, "k1sp": _check_k1sp, "k2v3": _check_k2v3,
          "k2v3_16": _check_k2v3_16, "k2f": _check_k2f,
          "k2f_16": _check_k2f_16, "k2b": _check_k2b, "k2_odd": _check_k2_odd,
          "k2_ring": _check_k2_ring,
          "delta": _check_delta, "k6sp": _check_k6sp, "k6bs": _check_k6bs,
          "flash_fwd": _check_flash_fwd, "flash_bwd": _check_flash_bwd,
          "mvit_split": _check_mvit_split, "mvit_bwd": _check_mvit_bwd,
          "flash_temporal": _check_flash_temporal,
          "mvit_d72": _check_mvit_d72, "flash_groups": _check_flash_groups,
          "flash_ragged": _check_flash_ragged, "mvit_odd": _check_mvit_odd,
          "k1_max": _check_k1_max, "k1_none": _check_k1_none,
          "k2_max": _check_k2_max, "pair_max": _check_pair_max,
          "k6sp_max": _check_k6sp_max}
# the sources each check builds
SOURCES = {"mvit": "mvit_attention", "mvit_sum": "mvit_attention",
           "kt": "mvit_attention",
           "pool": "depthwise_pool", "pool_dw": "depthwise_pool",
           "k1br": "spatial_attention", "k1bd": "spatial_attention",
           "k1p": "spatial_attention", "k1sp": "spatial_attention",
           "k2v3": "temporal_attention",
           "k2v3_16": "temporal_attention", "k2f": "temporal_attention",
           "k2f_16": "temporal_attention", "k2b": "temporal_attention",
           "k2_odd": "temporal_attention", "k2_ring": "temporal_attention",
           "delta": "mvit_attention",
           "k6sp": "mvit_attention", "k6bs": "mvit_attention",
           "flash_fwd": "flash_attention", "flash_bwd": "flash_attention",
           "mvit_split": "mvit_attention", "mvit_bwd": "mvit_attention",
           "flash_temporal": "flash_attention", "mvit_d72": "mvit_attention",
           "flash_groups": "flash_attention", "flash_ragged": "flash_attention",
           "mvit_odd": "mvit_attention", "k1_max": "spatial_attention",
           "k1_none": "spatial_attention", "k2_max": "temporal_attention",
           "pair_max": "flash_attention", "k6sp_max": "mvit_attention"}


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
