// Key-tiled softmax attention over one whole sequence per (batch, head),
// unmasked and non-causal, with an optional CLS stream: the forward and its
// recompute backward.  One kernel pair serves four callers, told apart only
// by base pointers and row strides:
//   K4f / K4b  q, k, v [B, N, H*d] (row stride C, or 3C for views of one
//              fused projection), no CLS;
//   K3f / K3b  the same plus qc, kc, vc [B, 1, H*d]: frame queries and the
//              CLS query attend over [frames; cls];
//   K1 long    K3's function on views of the fused qkv [BT, N, 3C] and
//              qkv_c [BT, 1, 3C] (row stride 3C), with dq/dk/dv written into
//              views of one dqkv; the K1 routes take it for 208 < N + 1 and
//              for every head dim other than K1's 64;
//   K2 wide    K2's function (attention over the T frames of each of the N
//              positions of the time-major qkv [B, T, N, 3C]) for head dims
//              other than K2's 64: each row of the [B, T, N*3C] view holds
//              the rows of M = N sequences side by side (`seqs`).
//
// Replaces the TPU kernels of procedurevrl_tpu/ops/pallas_attention.py:
//   K4f  _fwd_kernel      (via _flash_fwd, flash_attention_headfused);
//   K4b  _bwd_kernel      (via _flash_bwd);
//   K3f  _fwd_cls_kernel  (via _flash_cls_fwd, flash_attention_cls);
//   K3b  _bwd_cls_kernel  (via _flash_cls_bwd).
//
// Contract, per (batch b, head h) slice of L = n (+ 1 with the CLS) rows in
// the order [frames; cls] (the CLS is the last key and the last query, as
// the TPU kernels splice it into their padding row):
//   s_ij = (q_i . k_j) * scale in fp32; e_ij = exp(min(s_ij, 80)), the clamp
//   shift of the TPU kernels; l_i = sum_j e_ij; o_i = sum_j p_ij v_j with
//   p = e / l.  The shift is a compile-time switch (enum Shift, common.cuh):
//   under max e = exp(s - m) with m the row max, which the forward keeps
//   online over the key tiles (o and l rescaled by exp(m_old - m_new) when a
//   tile raises it; online_exp) and saves as lse = m + log l in l's place,
//   from which the backward rebuilds p = exp(s - lse); under none e =
//   exp(s).  bf16: e is rounded to bf16 as the A operand of P V and the
//   fp32 sum is divided by l once at the end, as the plain version rounds
//   (the TPU kernel rounds e / l; either way one bf16 rounding of each
//   probability).  The forward may also write l (fp32 [B, H, L]), the
//   backward's residual.
// Backward (the TPU kernel's arithmetic): p = e / l recomputed in fp32 from
// the saved l; dp = g v^T; D_i = sum_j dp_ij p_ij (the jacobian row sums of
// _ds_chain); ds = p (dp - D), rounded to bf16 as an operand; dq = scale
// ds k, dk = scale ds^T q, dv = bf16(p)^T g, all fp32 accumulated.  Like the
// TPU kernel it is the softmax jacobian, ignoring the clamp.
//
// Bounds on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) at the TimeSformer-B
// space_only training shape (B*T = 144, N = 197, C = 768, 12 heads of 64):
// the forward reads q, k, v and writes o, 174 MB (~52 us), 17.2 GFLOP
// (~17 us); the backward reads q, k, v, g and writes dq, dk, dv, 305 MB
// (~91 us), 42.9 GFLOP (~43 us).  Both are bound by bytes; the logits never
// reach device memory.
// Design, bf16 at head dims that are multiples of 8 up to 256 (Hopper
// warpgroup products, wgmma.cuh; every tile in the core-matrix layout):
//   * forward: a CTA holds two warpgroups of 64 query rows each; the key
//     and value tiles are staged once per CTA into a cp.async ring that
//     both read, of four stages at tile widths up to 64 (three tiles load
//     under the current one) and two past it; the clamp needs no running
//     max and no rescale: the loop only adds l += sum e and o += bf16(e) v,
//     and divides once;
//   * products: s = q k^T (and dp = g v^T) from shared memory, m64n64k16;
//     P V, dq += ds k, dk += ds^T q and dv += p^T g with e, ds and p as
//     register A operands and the other tile as an MN-major B; k-steps
//     wholly past the sequence are skipped;
//   * backward, where a slice fits one CTA's shared memory (tile widths up
//     to 64, L <= 256 at 64; fused_smem): one fused kernel, 7 products per
//     (query, key) pair: phase D forms s and dp query-major for D_i; phase
//     K forms s^T and dp^T once more, key-major, sums dk and dv in
//     registers and keeps bf16 ds^T of the whole slice in shared memory
//     (at L = 197, 4 x 208 x 64); phase Q forms dq = ds k from it.  The
//     slice's key and value tiles stay resident, the query and g tiles
//     stream through a two-stage ring;
//   * backward elsewhere (wider tiles, longer slices): a query-major
//     kernel (sweep A over the key tiles sums D_i and stores it, sweep B
//     forms ds and accumulates dq; two warpgroups, a ring of five stages
//     that keeps a slice's key tiles resident to L = 320 at d <= 64) and a
//     persistent key-major kernel (one warpgroup per CTA walks every query
//     tile for its 64 keys, dk and dv in registers, its next item's key /
//     value tiles staged under the current one), 9 products per pair;
//   * no sum crosses CTAs and none runs in a varying order: deterministic,
//     no atomics;
//   * short sequences (L <= 64): a slice packs 128 / lp sequences of lp
//     rows (lp = L rounded up to a power of two, at least 8), so K2's T = 8
//     frames fill 16 sequences per CTA; the softmax is masked to the block
//     diagonal and a warpgroup meets only the key (query) tile of its own
//     rows;
//   * head dims of 192 and 256 run in two column groups (grid y) of 96 or
//     128: each CTA forms s (and dp) over all d columns and accumulates and
//     writes only its group's columns of o (dq, dk, dv); group 0 alone
//     writes l and D.
// The scalar kernels take float32 at every head dim and bf16 at the others
// (d not a multiple of 8, or past 256): one warp per query or key row, fp32
// arithmetic with the bf16 roundings of the tensor-core path, in column
// groups of up to 256 (grid y), group 0 writing l and D.
// A row of e can reach L exp(80) ~ 5.6e37 (finite in fp32), and o's sum of
// e v stays finite while fewer than ~6000 / max|v| logits reach 80.
// Measured at the training shape: PERF.md.  Not done yet: TMA and a
// producer warp, a fused backward for longer slices (ds^T in chunks),
// key tiles narrower than 64 for a ragged last tile.

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using namespace pvrl;

constexpr int BM = 64;        // rows of a warpgroup tile (queries or keys)
constexpr int WARPS = 4;      // warps of a scalar CTA
constexpr int MAX_L = 1025;   // the JAX rule's 1024 tokens (+ the CLS)
constexpr int MAX_TC = 256;   // widest head dim of the tensor-core kernels
constexpr int SGW = 256;      // widest column group of the scalar kernels
constexpr int PACK_ROWS = 128;  // rows of a slice of packed sequences

// Where the rows of each tensor group live.  Sequence s = b * seqs + m
// (b < B, m < seqs) has its row j at base + (b * n + j) * ld + m * (ld /
// seqs): a row of ld elements holds the rows of `seqs` sequences side by
// side (seqs = 1 but for K2's layout).  A CLS tensor [B, 1, *] has its row
// of sequence s at base + s * ldc.  Head h is columns [h * d, h * d + d) of
// a sequence's row.  The tensor-core kernels work on slices: one sequence
// (pk = 1), or pk > 1 short ones packed, sequence vs * pk + r / lp holding
// row r of slice vs as its row r % lp.
struct Geo {
  int n;       // frame rows
  int L;       // n + 1 with the CLS, else n
  int heads;
  int d;       // head dim
  int seqs;    // sequences side by side in a row
  int nseq;    // sequences
  int pk;      // sequences packed into one slice
  int lp_log;  // log2 of a packed sequence's rows lp (pk > 1)
  int lv;      // rows of a slice: L, or PACK_ROWS packed
  int tiles;   // 64-row tiles of a slice
  int slices;  // slices of one head
  size_t ld_in, ldc_in;   // q, k, v / qc, kc, vc
  size_t ld_g, ldc_g;     // out (forward) or g (backward) / their CLS rows
  size_t ld_d, ldc_d;     // dq, dk, dv / dqc, dkc, dvc
};

// row j of [frames; cls] of slice (sequence s, head h); one sequence per
// row (seqs = 1) needs no division
template <typename T>
__device__ __forceinline__ T* row_of(T* x, T* xc, size_t ld, size_t ldc,
                                     const Geo& g, int s, int h, int j) {
  if (j >= g.n) return xc + (size_t)s * ldc + (size_t)h * g.d;
  if (g.seqs == 1) return x + ((size_t)s * g.n + j) * ld + (size_t)h * g.d;
  const unsigned m = (unsigned)s % (unsigned)g.seqs;
  return x + ((size_t)((unsigned)s / (unsigned)g.seqs) * g.n + j) * ld +
         (size_t)m * ((unsigned)ld / (unsigned)g.seqs) + (size_t)h * g.d;
}

// (sequence, row) of row r of slice vs, and whether it exists
struct Row {
  int s, j;
  bool ok;
};
__device__ __forceinline__ Row slice_row(const Geo& g, int vs, int r) {
  if (g.pk == 1) return Row{vs, r, r < g.L};
  const int s = vs * g.pk + (r >> g.lp_log), j = r & ((1 << g.lp_log) - 1);
  return Row{s, j, j < g.L && s < g.nseq};
}

// the fp32 row statistic (l, D) of slice row r: stats [nseq, heads, L]
__device__ __forceinline__ size_t stat_index(const Geo& g, const Row& R,
                                             int h) {
  return ((size_t)R.s * g.heads + h) * g.L + R.j;
}

// ------------------------------------- bf16 (tensor-core, wgmma) kernels

__host__ __device__ constexpr int group_width(int W) {
  return W > 128 ? W / 2 : W;
}

// rows [r0, r0 + 64) of slice vs, head columns [c0, c0 + W), into a
// core-matrix tile of width W; rows past the slice and columns past d zero
template <int W>
__device__ __forceinline__ void stage(uint16_t* dst, const uint16_t* x,
                                      const uint16_t* xc, size_t ld,
                                      size_t ldc, const Geo& g, int vs, int h,
                                      int r0, int c0) {
  for (int idx = threadIdx.x; idx < BM * W / 8; idx += blockDim.x) {
    int r, c;
    chunk_rc<W>(idx, r, c);
    const Row R = slice_row(g, vs, r0 + r);
    uint16_t* t = dst + idx * 8;
    if (R.ok && c0 + c < g.d) {
      cp_async16(t, row_of(x, xc, ld, ldc, g, R.s, h, R.j) + c0 + c);
    } else {
      *reinterpret_cast<uint4*>(t) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// whether key column c of tile kt enters the softmax of a query of row r
// (both within their 64-row tiles): the key exists, and, packed, it belongs
// to the query's sequence (then kt is the query's own tile)
__device__ __forceinline__ bool key_in(const Geo& g, int vs, int kt, int r,
                                       int c) {
  if (g.pk == 1) return kt * BM + c < g.L;
  return (r >> g.lp_log) == (c >> g.lp_log) &&
         slice_row(g, vs, kt * BM + c).ok;
}

// k-step kk (16 rows) of tile t holds rows of the slice
__device__ __forceinline__ bool kstep_in(const Geo& g, int t, int kk) {
  return t * BM + 16 * kk < g.lv;
}

// Issue t = C D^T and s = A B^T (tiles of width W, K-major) as one group
template <int W>
__device__ __forceinline__ void issue_logits_dp(float (&s)[32], float (&t)[32],
                                                const uint16_t* a_s,
                                                const uint16_t* b_s,
                                                const uint16_t* c_s,
                                                const uint16_t* d_s) {
  // defined before the fence: an accumulator a plain instruction defines
  // inside the group would serialize the group's products
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = t[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < W / 16; ++ks)
    wgmma_ss64(s, kmajor<W>(a_s, ks), kmajor<W>(b_s, ks), ks > 0);
#pragma unroll
  for (int ks = 0; ks < W / 16; ++ks)
    wgmma_ss64(t, kmajor<W>(c_s, ks), kmajor<W>(d_s, ks), ks > 0);
  wgmma_commit();
}

// acc (64 x N) = A B (first) or += A B over the k-steps of tile t (64 rows
// of K) that hold slice rows: A the register operand rounded from a 64 x 64
// accumulator, B N columns of an MN-major tile of width TW.  The first
// product overwrites acc, so no plain instruction defines it.
template <int N, int TW>
__device__ __forceinline__ void accumulate(float (&acc)[N / 2],
                                           const float (&x)[32],
                                           const uint16_t* b_s, bool first,
                                           const Geo& g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk > 0 && !kstep_in(g, t, kk)) break;
    uint32_t a[4];
    acc_to_a(a, x, kk);
    wgmma_rs<N>(acc, a, mnmajor<TW>(b_s, kk), kk > 0 || !first);
  }
}

// stages of a ring of tiles: four at tile widths up to 64 (three tiles in
// flight under the current one), two past it (shared memory)
__host__ __device__ constexpr int ring_stages(int W) { return W <= 64 ? 4 : 2; }

template <int W>
constexpr size_t fwd_smem() {
  return (size_t)(2 * BM * W + ring_stages(W) * (BM * W + BM * group_width(W))) *
         2;
}

// The exp under shift SH of a 64 x 64 logit tile s (accumulator layout) of
// key tile kt, in place, with the row statistics c0, c1 of this thread's
// rows acc_row(0), acc_row(2): kClamp and kNone e = exp(min(s scale, 80))
// or exp(s scale) times c (1 / l in the backward, 1 in the forward), with
// ROWSUM its terms added to the row sums l0, l1; kMax (the backward) p =
// exp(s scale - c) with c the row's lse.
// A tile wholly inside the slice takes no mask; in the last one, 8-key
// blocks past it are zero without an exp.
template <bool ROWSUM, int SH>
__device__ __forceinline__ void tile_exp(float (&s)[32], const Geo& g, int vs,
                                         int kt, float scale, float c0,
                                         float c1, float& l0, float& l1) {
  const bool full = g.pk == 1 && (kt + 1) * BM <= g.L;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool past = g.pk == 1 && kt * BM + 8 * j >= g.L;  // warp-uniform
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float c = e < 2 ? c0 : c1;
      float x = 0.f;
      if (full || (!past && key_in(g, vs, kt, acc_row(e), acc_col(j, e))))
        x = exp2f(shift_arg<SH>(s[4 * j + e] * scale, c) * LOG2E);
      if (ROWSUM) (e < 2 ? l0 : l1) += x;
      s[4 * j + e] = SH == kMax ? x : x * c;
    }
  }
}

// The forward's online softmax under kMax for the logit tile s of key tile
// kt: masks it, raises the running maxima m0, m1 (of the scaled logits) of
// this thread's two rows, rescales their sums l0, l1 and, past the first
// tile, their output accumulator o by exp(m_old - m_new), and leaves e =
// exp(s scale - m) in s, added to l0, l1.  A row that has met no key yet
// keeps m = -inf, its e and factor 0.
template <int N>
__device__ __forceinline__ void online_exp(float (&s)[32], float (&o)[N],
                                           bool first, const Geo& g, int vs,
                                           int kt, float scale, float& m0,
                                           float& m1, float& l0, float& l1) {
  const bool full = g.pk == 1 && (kt + 1) * BM <= g.L;
  float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool past = g.pk == 1 && kt * BM + 8 * j >= g.L;  // warp-uniform
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = full ||
                      (!past && key_in(g, vs, kt, acc_row(e), acc_col(j, e)));
      const float x = in ? s[4 * j + e] * scale : -INFINITY;
      s[4 * j + e] = x;
      if (e < 2) t0 = fmaxf(t0, x); else t1 = fmaxf(t1, x);
    }
  }
  const float n0 = fmaxf(m0, quad_max(t0)), n1 = fmaxf(m1, quad_max(t1));
  const float b0 = n0 == -INFINITY ? 0.f : n0, b1 = n1 == -INFINITY ? 0.f : n1;
  const float a0 = exp2f((m0 - b0) * LOG2E), a1 = exp2f((m1 - b1) * LOG2E);
  m0 = n0;
  m1 = n1;
  l0 *= a0;
  l1 *= a1;
  if (!first) {  // o holds the previous tiles' sum (its group is done)
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] *= (i & 2) ? a1 : a0;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = exp2f((s[4 * j + e] - (e < 2 ? b0 : b1)) * LOG2E);
      s[4 * j + e] = x;
      (e < 2 ? l0 : l1) += x;
    }
  }
}

// The backward's statistic of a row from the forward's: 1 / l (kClamp,
// kNone) or lse (kMax); for a padding row (q = g = 0, so that its ds is 0)
// the one that gives p = 1
template <int SH>
__device__ __forceinline__ float row_stat(const float* rowsum, size_t i,
                                          bool ok) {
  if constexpr (SH == kMax) return ok ? rowsum[i] : 0.f;
  else return ok ? 1.f / rowsum[i] : 1.f;
}

// the jacobian row sums D_i += sum_j dp_ij p_ij over a query-major tile,
// this thread's two rows
__device__ __forceinline__ void add_jacobian_rows(float& d0, float& d1,
                                                  const float (&p)[32],
                                                  const float (&dp)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    d0 += dp[4 * j] * p[4 * j] + dp[4 * j + 1] * p[4 * j + 1];
    d1 += dp[4 * j + 2] * p[4 * j + 2] + dp[4 * j + 3] * p[4 * j + 3];
  }
}

// p^T and ds^T = p^T (dp^T - D) in place of the key-major tiles s^T and
// dp^T: rows 64 keys, columns 64 queries whose statistic (row_stat) and D
// are li_s[c], d_s[c]; packed, a key meets only the queries of its own sequence (p = ds
// = 0 for the others).  Keys past the slice are zero rows of k and v: their
// ds multiplies zeros in dq, and their dk, dv rows are not written.
template <int SH>
__device__ __forceinline__ void key_major_ds(float (&s)[32], float (&dp)[32],
                                             const float* li_s,
                                             const float* d_s, const Geo& g,
                                             float scale) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // 1 / l and D of this thread's two query columns of block j
    const int i0 = acc_col(j, 0);
    const float2 li = *reinterpret_cast<const float2*>(li_s + i0);
    const float2 dd = *reinterpret_cast<const float2*>(d_s + i0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = g.pk == 1 ||
                      (acc_row(e) >> g.lp_log) == ((i0 + (e & 1)) >> g.lp_log);
      const float c = (e & 1) ? li.y : li.x;
      float p = 0.f;
      if (in) {
        p = exp2f(shift_arg<SH>(s[4 * j + e] * scale, c) * LOG2E);
        if constexpr (SH != kMax) p *= c;
      }
      s[4 * j + e] = p;
      dp[4 * j + e] = p * (dp[4 * j + e] - ((e & 1) ? dd.y : dd.x));
    }
  }
}

// dk = scale acc_k and dv = acc_v of key tile kt of slice vs, columns c0 ..
// c0 + G of head h
template <int G>
__device__ __forceinline__ void store_kv(const float (&acc_k)[G / 2],
                                         const float (&acc_v)[G / 2],
                                         uint16_t* dk, uint16_t* dv,
                                         uint16_t* dkc, uint16_t* dvc,
                                         const Geo& g, int vs, int h, int kt,
                                         int c0, float scale) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const Row R = slice_row(g, vs, kt * BM + acc_row(2 * half));
    if (!R.ok) continue;
    uint16_t* kd = row_of(dk, dkc, g.ld_d, g.ldc_d, g, R.s, h, R.j) + c0;
    uint16_t* vd = row_of(dv, dvc, g.ld_d, g.ldc_d, g, R.s, h, R.j) + c0;
#pragma unroll
    for (int j = 0; j < G / 8; ++j) {
      const int c = acc_col(j, 0);
      if (c0 + c >= g.d) continue;
      *reinterpret_cast<uint32_t*>(kd + c) =
          pack_bf16x2(acc_k[4 * j + 2 * half] * scale,
                      acc_k[4 * j + 2 * half + 1] * scale);
      *reinterpret_cast<uint32_t*>(vd + c) =
          pack_bf16x2(acc_v[4 * j + 2 * half], acc_v[4 * j + 2 * half + 1]);
    }
  }
}

// dq = scale acc of query tile qt of slice vs, columns c0 .. c0 + G of
// head h
template <int G>
__device__ __forceinline__ void store_q(const float (&acc)[G / 2],
                                        uint16_t* dq, uint16_t* dqc,
                                        const Geo& g, int vs, int h, int qt,
                                        int c0, float scale) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const Row R = slice_row(g, vs, qt * BM + acc_row(2 * half));
    if (!R.ok) continue;
    uint16_t* dst = row_of(dq, dqc, g.ld_d, g.ldc_d, g, R.s, h, R.j) + c0;
#pragma unroll
    for (int j = 0; j < G / 8; ++j) {
      const int c = acc_col(j, 0);
      if (c0 + c < g.d)
        *reinterpret_cast<uint32_t*>(dst + c) =
            pack_bf16x2(acc[4 * j + 2 * half] * scale,
                        acc[4 * j + 2 * half + 1] * scale);
    }
  }
}

// Forward: out (and l, under kMax lse, where rowsum is given) of the query
// tiles 2 x and 2 x + 1 of one slice (the CTA's two warpgroups), columns
// group y; the key / value tiles in a ring of ring_stages(W) stages.
template <int W, int SH>
__global__ void __launch_bounds__(256)
flash_fwd_wg(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
             const uint16_t* __restrict__ v, const uint16_t* __restrict__ qc,
             const uint16_t* __restrict__ kc, const uint16_t* __restrict__ vc,
             uint16_t* __restrict__ out, uint16_t* __restrict__ outc,
             float* __restrict__ rowsum, Geo g, float scale) {
  constexpr int G = group_width(W), STAGE = BM * W + BM * G;
  constexpr int S = ring_stages(W);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint16_t* q_s = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* ring = q_s + 2 * BM * W;  // stage s: k at ring + s STAGE, v after
  const int qblocks = (g.tiles + 1) / 2;
  const int qb = blockIdx.x % qblocks, sh = blockIdx.x / qblocks;
  const int h = sh % g.heads, vs = sh / g.heads;
  const int c0 = blockIdx.y * G;  // this CTA's columns of o
  const int wg = warpgroup(), qt = 2 * qb + wg;
  const bool active = qt < g.tiles;  // warp-uniform

  for (int w = 0; w < 2; ++w)
    stage<W>(q_s + w * BM * W, q, qc, g.ld_in, g.ldc_in, g, vs, h,
             (2 * qb + w) * BM, 0);
  // key tile t into stage t % S (one commit group per tile, empty past the
  // slice, so that group t holds tile t)
  auto stage_kv = [&](int t) {
    if (t < g.tiles) {
      uint16_t* st = ring + (t % S) * STAGE;
      stage<W>(st, k, kc, g.ld_in, g.ldc_in, g, vs, h, t * BM, 0);
      stage<G>(st + BM * W, v, vc, g.ld_in, g.ldc_in, g, vs, h, t * BM, c0);
    }
    cp_async_commit();
  };
  for (int t = 0; t + 1 < S; ++t) stage_kv(t);

  const uint16_t* qa = q_s + wg * BM * W;
  float o[G / 2];  // written by the first P V product
  float l0 = 0.f, l1 = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // kMax: the running row maxima
  bool first = true;
  for (int t = 0; t < g.tiles; ++t) {
    // tile t has landed and every warpgroup is done with tile t - 1: its
    // stage takes tile t + S - 1, which loads under tiles t .. t + S - 2
    cp_async_wait_pending(S - 2);
    fence_async_smem();
    __syncthreads();
    stage_kv(t + S - 1);
    if (!active || (g.pk > 1 && t != qt)) continue;
    const uint16_t* k_s = ring + (t % S) * STAGE;
    const uint16_t* v_s = k_s + BM * W;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < W / 16; ++ks)
      wgmma_ss64(s, kmajor<W>(qa, ks), kmajor<W>(k_s, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if constexpr (SH == kMax)
      online_exp(s, o, first, g, vs, t, scale, m0, m1, l0, l1);
    else
      tile_exp<true, SH>(s, g, vs, t, scale, 1.f, 1.f, l0, l1);
    wgmma_fence();
    accumulate<G, G>(o, s, v_s, first, g, t);
    wgmma_commit();
    // complete before the loop moves on: no accumulator of a group in
    // flight crosses the loop's back edge
    wgmma_wait<0>();
    fence_regs(o);
    first = false;
  }
  if (!active) return;
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const Row R = slice_row(g, vs, qt * BM + acc_row(2 * half));
    if (!R.ok) continue;
    const float l = half ? l1 : l0, inv = 1.f / l;
    uint16_t* dst = row_of(out, outc, g.ld_g, g.ldc_g, g, R.s, h, R.j) + c0;
#pragma unroll
    for (int j = 0; j < G / 8; ++j) {
      const int c = acc_col(j, 0);
      if (c0 + c < g.d)
        *reinterpret_cast<uint32_t*>(dst + c) = pack_bf16x2(
            o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
    }
    if (rowsum != nullptr && blockIdx.y == 0 && (threadIdx.x & 3) == 0)
      rowsum[stat_index(g, R, h)] =
          SH == kMax ? (half ? m1 : m0) + logf(l) : l;
  }
}

// warpgroups of a query-major CTA: two (one at tile width 256, for shared
// memory)
__host__ __device__ constexpr int bwd_wgs(int W) { return W > 192 ? 1 : 2; }

// the query-major kernel: per warpgroup two resident tiles, q_ring_stages(W)
// stages of two tiles
// stages of the query-major ring: five at tile widths up to 64, so that
// slices to L = 320 (K1 at N + 1 = 257) keep their key tiles resident
__host__ __device__ constexpr int q_ring_stages(int W) { return W <= 64 ? 5 : 2; }

template <int W>
constexpr size_t bwd_smem() {
  return (size_t)(bwd_wgs(W) + q_ring_stages(W)) * 2 * BM * W * 2;
}

// Query-major backward: D (stored for the key-major pass) and dq, columns
// group y, of the query tiles of the CTA's warpgroups: sweep A over the key
// tiles sums D_i, sweep B forms ds and accumulates dq.
template <int W, int SH>
__global__ void __launch_bounds__(bwd_wgs(W) * 128, W <= 64 ? 2 : 1)
flash_bwd_q_wg(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
               const uint16_t* __restrict__ v, const uint16_t* __restrict__ qc,
               const uint16_t* __restrict__ kc,
               const uint16_t* __restrict__ vc,
               const uint16_t* __restrict__ gr,
               const uint16_t* __restrict__ gc,
               const float* __restrict__ rowsum, float* __restrict__ delta,
               uint16_t* __restrict__ dq, uint16_t* __restrict__ dqc, Geo g,
               float scale) {
  constexpr int NW = bwd_wgs(W), G = group_width(W), STAGE = 2 * BM * W;
  constexpr int S = q_ring_stages(W);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint16_t* base = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* ring = base + NW * 2 * BM * W;  // stage s: k at ring + s STAGE, v after
  const int qblocks = (g.tiles + NW - 1) / NW;
  const int qb = blockIdx.x % qblocks, sh = blockIdx.x / qblocks;
  const int h = sh % g.heads, vs = sh / g.heads;
  const int c0 = blockIdx.y * G;
  const int wg = warpgroup(), qt = NW * qb + wg;
  const bool active = qt < g.tiles;
  const uint16_t* q_s = base + wg * 2 * BM * W;  // this warpgroup's rows
  const uint16_t* g_s = q_s + BM * W;

  for (int w = 0; w < NW; ++w) {
    uint16_t* res = base + w * 2 * BM * W;
    stage<W>(res, q, qc, g.ld_in, g.ldc_in, g, vs, h, (NW * qb + w) * BM, 0);
    stage<W>(res + BM * W, gr, gc, g.ld_g, g.ldc_g, g, vs, h,
             (NW * qb + w) * BM, 0);
  }
  // Steps 0 .. tiles - 1 are sweep A over the key tiles, the next tiles
  // steps sweep B.  A slice of at most S key tiles keeps them all resident
  // (stage = tile) through both sweeps; a longer one streams step t into
  // stage t % S, one commit group per step.
  const int iters = 2 * g.tiles;
  const bool resident = g.tiles <= S;
  auto slot = [&](int t) { return resident ? t % g.tiles : t % S; };
  auto stage_kv = [&](int t) {
    if (t < iters && (!resident || t < g.tiles)) {
      uint16_t* st = ring + slot(t) * STAGE;
      const int r0 = (t % g.tiles) * BM;
      stage<W>(st, k, kc, g.ld_in, g.ldc_in, g, vs, h, r0, 0);
      stage<W>(st + BM * W, v, vc, g.ld_in, g.ldc_in, g, vs, h, r0, 0);
    }
    cp_async_commit();
  };
  for (int t = 0; t + 1 < S; ++t) stage_kv(t);
  if (resident) stage_kv(S - 1);

  const Row R0 = slice_row(g, vs, qt * BM + acc_row(0));
  const Row R1 = slice_row(g, vs, qt * BM + acc_row(2));
  // 1 / l or lse (padding rows: p = 1, and their g is 0)
  const bool ok0 = active && R0.ok, ok1 = active && R1.ok;
  const float c0l = row_stat<SH>(rowsum, ok0 ? stat_index(g, R0, h) : 0, ok0);
  const float c1l = row_stat<SH>(rowsum, ok1 ? stat_index(g, R1, h) : 0, ok1);
  float d0 = 0.f, d1 = 0.f;
  float acc_q[G / 2];  // written by the first sweep B product
  bool first = true;
  for (int t = 0; t < iters; ++t) {
    if (resident) {
      cp_async_wait_pending(0);
    } else {
      cp_async_wait_pending(S - 2);
    }
    fence_async_smem();
    __syncthreads();
    if (!resident) stage_kv(t + S - 1);
    const int kt = t % g.tiles;
    if (t == g.tiles) {  // sweep A is done: D, for sweep B and the key pass
      d0 = quad_sum(d0);
      d1 = quad_sum(d1);
      if (active && blockIdx.y == 0 && (threadIdx.x & 3) == 0) {
        if (R0.ok) delta[stat_index(g, R0, h)] = d0;
        if (R1.ok) delta[stat_index(g, R1, h)] = d1;
      }
    }
    if (!active || (g.pk > 1 && kt != qt)) continue;
    const uint16_t* k_s = ring + slot(t) * STAGE;
    const uint16_t* v_s = k_s + BM * W;
    float s[32], dp[32];
    issue_logits_dp<W>(s, dp, q_s, k_s, g_s, v_s);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    tile_exp<false, SH>(s, g, vs, kt, scale, c0l, c1l, d0, d1);  // d0, d1 untouched
    if (t < g.tiles) {  // sweep A: D_i = sum_j dp_ij p_ij
      add_jacobian_rows(d0, d1, s, dp);
      continue;
    }
    // sweep B: ds = p (dp - D); dq += ds k (the group's columns of k)
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= dp[i] - ((i & 2) ? d1 : d0);
    wgmma_fence();
    accumulate<G, W>(acc_q, s, k_s + 8 * c0, first, g, kt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_q);
    first = false;
  }
  if (!active) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const Row& R = half ? R1 : R0;
    if (!R.ok) continue;
    uint16_t* dst = row_of(dq, dqc, g.ld_d, g.ldc_d, g, R.s, h, R.j) + c0;
#pragma unroll
    for (int j = 0; j < G / 8; ++j) {
      const int c = acc_col(j, 0);
      if (c0 + c < g.d)
        *reinterpret_cast<uint32_t*>(dst + c) =
            pack_bf16x2(acc_q[4 * j + 2 * half] * scale,
                        acc_q[4 * j + 2 * half + 1] * scale);
    }
  }
}

// A work item of a persistent launch: row block rb (the tiles of the CTA's
// warpgroups) of slice vs, head h.  CTA x takes items x, x + gridDim.x, ...
struct Item {
  int vs, h, rb;
};
__device__ __forceinline__ Item item_at(const Geo& g, int blocks, int i) {
  const int rb = i % blocks, sh = i / blocks;
  return Item{sh / g.heads, sh % g.heads, rb};
}

// buffers of the key-major pass's resident key / value tiles: two, so that
// a persistent CTA stages its next item's under the current one, where
// shared memory holds them (tile widths up to 128); else one CTA per item
__host__ __device__ constexpr int kv_buffers(int W) { return W <= 128 ? 2 : 1; }
// the key-major pass's resident CTAs per SM: three at tile widths up to 64
// (at most 168 registers a thread, 65 KB of shared memory)
__host__ __device__ constexpr int k_min_ctas(int W) { return W <= 64 ? 3 : 1; }

// the key-major kernel: the resident key / value buffers, two ring stages
// of a query and a g tile, two stages of 64 floats twice
template <int W>
constexpr size_t bwd_k_smem() {
  return (size_t)(kv_buffers(W) + 2) * 2 * BM * W * 2 + 4 * BM * sizeof(float);
}

// Key-major backward, persistent, one warpgroup a CTA (its dk and dv
// accumulators leave room for no second one where three CTAs share an
// SM): for each of its items (a key tile), dk and dv, columns group y.
// The CTA walks steps (item, query tile) of the item's slice, the q and g
// tiles with their 1 / l and D in a two-stage ring, the next step staged
// under the current one (at an item's first step also its key / value
// tiles, into the resident buffer of the item two back), so dk and dv are
// summed in registers in a fixed order and written under the next item's
// loads.
template <int W, int SH>
__global__ void __launch_bounds__(128, k_min_ctas(W))
flash_bwd_k_wg(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
               const uint16_t* __restrict__ v, const uint16_t* __restrict__ qc,
               const uint16_t* __restrict__ kc,
               const uint16_t* __restrict__ vc,
               const uint16_t* __restrict__ gr,
               const uint16_t* __restrict__ gc,
               const float* __restrict__ rowsum,
               const float* __restrict__ delta, uint16_t* __restrict__ dk,
               uint16_t* __restrict__ dv, uint16_t* __restrict__ dkc,
               uint16_t* __restrict__ dvc, Geo g, float scale) {
  constexpr int G = group_width(W), STAGE = 2 * BM * W, KB = kv_buffers(W);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint16_t* kvbuf = reinterpret_cast<uint16_t*>(smem_raw);  // [KB][k, v]
  uint16_t* ring = kvbuf + KB * STAGE;  // stage s: q at ring + s STAGE, g after
  float* stats = reinterpret_cast<float*>(ring + 2 * STAGE);
  // stage s: 1 / l_i at stats + 2 s BM, D_i after
  const int items = g.slices * g.heads * g.tiles;
  const int mine = (int)blockIdx.x < items
                       ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int steps = mine * g.tiles;
  const int c0 = blockIdx.y * G;

  // step n: the item's key / value tiles at its first step, and its query
  // tile; one commit group per step (empty past the last)
  auto stage_step = [&](int n) {
    if (n < steps) {
      const int kk = n / g.tiles, t = n - kk * g.tiles;
      const Item it = item_at(g, g.tiles, blockIdx.x + kk * gridDim.x);
      if (t == 0) {
        uint16_t* res = kvbuf + (kk % KB) * STAGE;
        stage<W>(res, k, kc, g.ld_in, g.ldc_in, g, it.vs, it.h, it.rb * BM, 0);
        stage<W>(res + BM * W, v, vc, g.ld_in, g.ldc_in, g, it.vs, it.h,
                 it.rb * BM, 0);
      }
      uint16_t* st = ring + (n & 1) * STAGE;
      stage<W>(st, q, qc, g.ld_in, g.ldc_in, g, it.vs, it.h, t * BM, 0);
      stage<W>(st + BM * W, gr, gc, g.ld_g, g.ldc_g, g, it.vs, it.h, t * BM,
               0);
    }
    cp_async_commit();
  };
  // the row statistics of step n's query tile through this thread's
  // registers (the first 64 threads, one row each; padding rows: row_stat's
  // and D = 0, so that with q = g = 0 there their ds is 0)
  float stat_l = SH == kMax ? 0.f : 1.f, stat_d = 0.f;
  auto load_stats = [&](int n) {
    if (threadIdx.x >= BM || n >= steps) return;
    const int kk = n / g.tiles, t = n - kk * g.tiles;
    const Item it = item_at(g, g.tiles, blockIdx.x + kk * gridDim.x);
    const Row R = slice_row(g, it.vs, t * BM + threadIdx.x);
    const size_t i = R.ok ? stat_index(g, R, it.h) : 0;
    stat_l = row_stat<SH>(rowsum, i, R.ok);
    stat_d = R.ok ? delta[i] : 0.f;
  };
  auto store_stats = [&](int n) {
    float* li_s = stats + (n & 1) * 2 * BM;
    if (threadIdx.x < BM) {
      li_s[threadIdx.x] = stat_l;
      li_s[BM + threadIdx.x] = stat_d;
    }
  };
  stage_step(0);
  load_stats(0);
  store_stats(0);

  float acc_k[G / 2], acc_v[G / 2];  // written by each item's first products
  bool first = true;
  for (int n = 0; n < steps; ++n) {
    // step n has landed (and its statistics); step n - 1 is done, and its
    // stage (and, at an item's first step, the resident buffer of the item
    // two back) take step n + 1
    cp_async_wait_pending(0);
    fence_async_smem();
    __syncthreads();
    stage_step(n + 1);
    load_stats(n + 1);
    const int kk = n / g.tiles, t = n - kk * g.tiles;
    const Item it = item_at(g, g.tiles, blockIdx.x + kk * gridDim.x);
    const int kt = it.rb;
    if (t == 0) first = true;
    if (g.pk == 1 || t == kt) {
      const uint16_t* k_s = kvbuf + (kk % KB) * STAGE;
      const uint16_t* v_s = k_s + BM * W;
      const uint16_t* q_s = ring + (n & 1) * STAGE;
      const uint16_t* g_s = q_s + BM * W;
      const float* li_s = stats + (n & 1) * 2 * BM;
      const float* d_s = li_s + BM;
      // s^T and dp^T = v g^T: rows = keys, columns = the tile's queries
      float s[32], dp[32];
      issue_logits_dp<W>(s, dp, k_s, q_s, v_s, g_s);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      key_major_ds<SH>(s, dp, li_s, d_s, g, scale);
      wgmma_fence();
      accumulate<G, W>(acc_k, dp, q_s + 8 * c0, first, g, t);
      accumulate<G, W>(acc_v, s, g_s + 8 * c0, first, g, t);
      wgmma_commit();
      store_stats(n + 1);  // its stage was last read by step n - 1
      wgmma_wait<0>();
      fence_regs(acc_k);
      fence_regs(acc_v);
      first = false;
    } else {
      store_stats(n + 1);
    }
    // the item's dk and dv, under the next item's loads
    if (t + 1 == g.tiles)
      store_kv<G>(acc_k, acc_v, dk, dv, dkc, dvc, g, it.vs, it.h, kt, c0, scale);
  }
}

// bf16 ds^T of key tile kt (accumulator layout: rows its keys, columns 64
// queries) into rows kt * 64 .. of a core-matrix tile of kr rows (the
// keys) and width 64 (the queries); rows from kr on are not kept
__device__ __forceinline__ void store_ds(uint16_t* dst, const float (&ds)[32],
                                         int kt, int kr) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = kt * BM + acc_row(2 * half);
    if (r >= kr) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = acc_col(j, 0);
      *reinterpret_cast<uint32_t*>(dst + ((r >> 3) * 8 + j) * 64 +
                                   (r & 7) * 8 + (c & 7)) =
          pack_bf16x2(ds[4 * j + 2 * half], ds[4 * j + 2 * half + 1]);
    }
  }
}

constexpr size_t MAX_SMEM = 227 * 1024;  // an H100 CTA's shared memory

// The fused backward's shared memory at tile width W, for a slice of
// `tiles` 64-row tiles and kr keys (its rows rounded up to 16): the
// slice's key and value tiles, a ring of `stages` stages of a query and a
// g tile, ds^T of every query tile (kr x 64), 1 / l and D of every row.
template <int W>
constexpr size_t fused_smem(int tiles, int kr, int stages) {
  return (size_t)(2 * tiles * BM * W + 2 * stages * BM * W + tiles * BM * kr) *
             2 +
         2 * tiles * BM * sizeof(float);
}

// Fused backward, one CTA of two warpgroups per slice and head, at tile
// widths up to 64 where fused_smem fits (K4 / K3 at L <= 256, K2 packed):
// 7 products per (query, key) pair, the slice's key and value tiles
// resident, the query and g tiles of each step through a ring of S stages
// (three at tile width 64 where they fit: two steps load under the current
// one; two at 32, where two CTAs share an SM).
//   Phase D, steps 0 .. tiles - 1: query tile t against every key tile
//     (warpgroup w taking key tiles w, w + 2, ...): s and dp, and each
//     warpgroup's share of D_i; D = share 0 + share 1.
//   Phase K, rounds x tiles steps: in round r warpgroup w owns key tile
//     2 r + w and meets every query tile t: s^T and dp^T, p^T and ds^T,
//     dk += ds^T q and dv += p^T g in registers; bf16 ds^T (the operand's
//     rounding) is kept in shared memory.
//   Phase Q: dq of query tile t (warpgroup w taking t = w, w + 2, ...) =
//     ds k over the slice's keys, both operands from shared memory.
// Every sum runs in a fixed order; no atomics.
template <int W, int S, int SH>
__global__ void __launch_bounds__(256, W <= 32 ? 2 : 1)
flash_bwd_fused_wg(const uint16_t* __restrict__ q,
                   const uint16_t* __restrict__ k,
                   const uint16_t* __restrict__ v,
                   const uint16_t* __restrict__ qc,
                   const uint16_t* __restrict__ kc,
                   const uint16_t* __restrict__ vc,
                   const uint16_t* __restrict__ gr,
                   const uint16_t* __restrict__ gc,
                   const float* __restrict__ rowsum, uint16_t* __restrict__ dq,
                   uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                   uint16_t* __restrict__ dqc, uint16_t* __restrict__ dkc,
                   uint16_t* __restrict__ dvc, Geo g, int kr, float scale) {
  constexpr int TILE = BM * W;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int T = g.tiles, rows = T * BM;
  uint16_t* k_res = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* v_res = k_res + T * TILE;
  uint16_t* ring = v_res + T * TILE;  // stage s: q at ring + 2 s TILE, g after
  uint16_t* ds_buf = ring + 2 * S * TILE;  // query tile t at ds_buf + t kr BM
  float* inv_l = reinterpret_cast<float*>(ds_buf + (size_t)rows * kr);
  float* delta = inv_l + rows;
  float* share = reinterpret_cast<float*>(ds_buf);  // phase D: [2][rows]
  const int h = blockIdx.x % g.heads, vs = blockIdx.x / g.heads;
  const int wg = warpgroup();
  const int steps = T * (1 + (T + 1) / 2);

  for (int t = 0; t < T; ++t) {
    stage<W>(k_res + t * TILE, k, kc, g.ld_in, g.ldc_in, g, vs, h, t * BM, 0);
    stage<W>(v_res + t * TILE, v, vc, g.ld_in, g.ldc_in, g, vs, h, t * BM, 0);
  }
  // step n's query and g tiles (query tile n % T) into stage n % S, one
  // commit group per step (empty past the last)
  auto stage_step = [&](int n) {
    if (n < steps) {
      uint16_t* st = ring + (n % S) * 2 * TILE;
      const int r0 = (n % T) * BM;
      stage<W>(st, q, qc, g.ld_in, g.ldc_in, g, vs, h, r0, 0);
      stage<W>(st + TILE, gr, gc, g.ld_g, g.ldc_g, g, vs, h, r0, 0);
    }
    cp_async_commit();
  };
  for (int n = 0; n + 1 < S; ++n) stage_step(n);
  // 1 / l or lse (padding rows: p = 1, with q = g = 0 there, so that their
  // ds is 0)
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const Row R = slice_row(g, vs, i);
    inv_l[i] = row_stat<SH>(rowsum, R.ok ? stat_index(g, R, h) : 0, R.ok);
  }

  float acc_k[W / 2], acc_v[W / 2];  // written by each round's first products
  bool first = true;
  for (int n = 0; n < steps; ++n) {
    // step n has landed and step n - 1 is done: its stage takes step
    // n + S - 1
    cp_async_wait_pending(S - 2);
    fence_async_smem();
    __syncthreads();
    if (n == T) {  // phase D is done
      for (int i = threadIdx.x; i < rows; i += blockDim.x)
        delta[i] = share[i] + share[rows + i];
      __syncthreads();  // before ds^T takes the shares' place
    }
    stage_step(n + S - 1);
    const int t = n % T;
    const uint16_t* q_s = ring + (n % S) * 2 * TILE;
    const uint16_t* g_s = q_s + TILE;
    if (n < T) {
      const float c0l = inv_l[t * BM + acc_row(0)];
      const float c1l = inv_l[t * BM + acc_row(2)];
      float d0 = 0.f, d1 = 0.f;
      for (int kt = wg; kt < T; kt += 2) {
        if (g.pk > 1 && kt != t) continue;
        float s[32], dp[32];
        issue_logits_dp<W>(s, dp, q_s, k_res + kt * TILE, g_s,
                           v_res + kt * TILE);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        tile_exp<false, SH>(s, g, vs, kt, scale, c0l, c1l, d0, d1);
        add_jacobian_rows(d0, d1, s, dp);
      }
      d0 = quad_sum(d0);
      d1 = quad_sum(d1);
      if ((threadIdx.x & 3) == 0) {
        share[wg * rows + t * BM + acc_row(0)] = d0;
        share[wg * rows + t * BM + acc_row(2)] = d1;
      }
      continue;
    }
    const int kt = 2 * ((n - T) / T) + wg;
    if (t == 0) first = true;
    if (kt >= T) continue;
    if (g.pk == 1 || t == kt) {
      const uint16_t* k_s = k_res + kt * TILE;
      const uint16_t* v_s = v_res + kt * TILE;
      // s^T and dp^T = v g^T: rows = keys, columns = the tile's queries
      float s[32], dp[32];
      issue_logits_dp<W>(s, dp, k_s, q_s, v_s, g_s);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      key_major_ds<SH>(s, dp, inv_l + t * BM, delta + t * BM, g, scale);
      store_ds(ds_buf + (size_t)t * kr * BM, dp, kt, kr);
      wgmma_fence();
      accumulate<W, W>(acc_k, dp, q_s, first, g, t);
      accumulate<W, W>(acc_v, s, g_s, first, g, t);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_k);
      fence_regs(acc_v);
      first = false;
    }
    if (t == T - 1)
      store_kv<W>(acc_k, acc_v, dk, dv, dkc, dvc, g, vs, h, kt, 0, scale);
  }
  // phase Q: every ds^T is in shared memory
  fence_async_smem();
  __syncthreads();
  for (int t = wg; t < T; t += 2) {
    // packed, a query tile meets only the keys of its own tile
    const int klo = g.pk == 1 ? 0 : 4 * t;
    const int khi = g.pk == 1 ? kr / 16 : min(4 * t + 4, kr / 16);
    const uint16_t* ds_t = ds_buf + (size_t)t * kr * BM;
    float acc_q[W / 2];  // written by the first product
    wgmma_fence();
    for (int kk = klo; kk < khi; ++kk)
      wgmma_ss_mn<W>(acc_q, mnmajor<BM>(ds_t, kk), mnmajor<W>(k_res, kk),
                     kk > klo);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_q);
    store_q<W>(acc_q, dq, dqc, g, vs, h, t, 0, scale);
  }
}

// ------------------------------------------ scalar kernels (any head dim)

template <typename T>
__device__ __forceinline__ float dot(const T* a, const T* b, int d) {
  float s = 0.f;
#pragma unroll 8
  for (int e = 0; e < d; ++e) s = fmaf(load1(a + e), load1(b + e), s);
  return s;
}

// x rounded as the tensor-core path rounds an operand of type T
template <typename T>
__device__ __forceinline__ float op(float x) {
  return round_to(x, static_cast<const T*>(nullptr));
}

// Forward: one warp per query row, its HD columns of group y (lane's
// columns lane + 32 u); shared memory holds the warp's row of exponentials
// [L] (kMax: first its logits).  o = sum_j op(e_j) v_j / l.
template <typename T, int HD, int SH>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_scalar(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ qc,
                 const T* __restrict__ kc, const T* __restrict__ vc,
                 T* __restrict__ out, T* __restrict__ outc,
                 float* __restrict__ rowsum, Geo g, float scale) {
  constexpr int U = HD / 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int rows = (g.L + WARPS - 1) / WARPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x / rows, i = (blockIdx.x % rows) * WARPS + warp;
  const int c0 = blockIdx.y * HD;
  if (i >= g.L) return;  // warp-uniform; no block barrier below
  const int b = bh / g.heads, h = bh % g.heads;
  float* e_w = reinterpret_cast<float*>(smem_raw) + (size_t)warp * g.L;
  const T* qi = row_of(q, qc, g.ld_in, g.ldc_in, g, b, h, i);
  auto logit = [&](int j) {
    return dot(qi, row_of(k, kc, g.ld_in, g.ldc_in, g, b, h, j), g.d) * scale;
  };
  float mx = 0.f;
  if constexpr (SH == kMax) {
    mx = -INFINITY;
    for (int j = lane; j < g.L; j += 32) {
      e_w[j] = logit(j);
      mx = fmaxf(mx, e_w[j]);
    }
    mx = warp_max(mx);
  }
  float part = 0.f;
  for (int j = lane; j < g.L; j += 32) {
    const float e = expf(shift_arg<SH>(SH == kMax ? e_w[j] : logit(j), mx));
    e_w[j] = e;
    part += e;
  }
  const float l = warp_sum(part);
  __syncwarp();
  float o[U];
#pragma unroll
  for (int u = 0; u < U; ++u) o[u] = 0.f;
  for (int j = 0; j < g.L; ++j) {
    const float e = op<T>(e_w[j]);
    const T* vj = row_of(v, vc, g.ld_in, g.ldc_in, g, b, h, j) + c0;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + lane + 32 * u < g.d) o[u] = fmaf(e, load1(vj + lane + 32 * u), o[u]);
  }
  T* oi = row_of(out, outc, g.ld_g, g.ldc_g, g, b, h, i) + c0;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (c0 + lane + 32 * u < g.d) store1(oi + lane + 32 * u, o[u] / l);
  if (rowsum != nullptr && c0 == 0 && lane == 0)
    rowsum[(size_t)bh * g.L + i] = SH == kMax ? mx + logf(l) : l;
}

// The probability of a scaled logit x under shift SH from the forward's
// statistic c of its row: l, or lse under kMax
template <int SH>
__device__ __forceinline__ float prob(float x, float c) {
  if constexpr (SH == kMax) return expf(x - c);
  else return expf(shift_arg<SH>(x, 0.f)) / c;
}

// Query-major backward: one warp per query row; per warp two rows [L] of
// shared memory (p, then op(ds); and dp).
template <typename T, int HD, int SH>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_q_scalar(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ qc,
                   const T* __restrict__ kc, const T* __restrict__ vc,
                   const T* __restrict__ gr, const T* __restrict__ gc,
                   const float* __restrict__ rowsum,
                   float* __restrict__ delta, T* __restrict__ dq,
                   T* __restrict__ dqc, Geo g, float scale) {
  constexpr int U = HD / 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int rows = (g.L + WARPS - 1) / WARPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x / rows, i = (blockIdx.x % rows) * WARPS + warp;
  const int c0 = blockIdx.y * HD;
  if (i >= g.L) return;
  const int b = bh / g.heads, h = bh % g.heads;
  float* p_w = reinterpret_cast<float*>(smem_raw) + (size_t)warp * 2 * g.L;
  float* dp_w = p_w + g.L;
  const T* qi = row_of(q, qc, g.ld_in, g.ldc_in, g, b, h, i);
  const T* gi = row_of(gr, gc, g.ld_g, g.ldc_g, g, b, h, i);
  const float l = rowsum[(size_t)bh * g.L + i];
  float part = 0.f;
  for (int j = lane; j < g.L; j += 32) {
    const T* kj = row_of(k, kc, g.ld_in, g.ldc_in, g, b, h, j);
    const T* vj = row_of(v, vc, g.ld_in, g.ldc_in, g, b, h, j);
    const float p = prob<SH>(dot(qi, kj, g.d) * scale, l);
    const float dp = dot(gi, vj, g.d);
    p_w[j] = p;
    dp_w[j] = dp;
    part = fmaf(dp, p, part);
  }
  const float D = warp_sum(part);
  if (c0 == 0 && lane == 0) delta[(size_t)bh * g.L + i] = D;
  for (int j = lane; j < g.L; j += 32) p_w[j] = op<T>(p_w[j] * (dp_w[j] - D));
  __syncwarp();
  float a[U];
#pragma unroll
  for (int u = 0; u < U; ++u) a[u] = 0.f;
  for (int j = 0; j < g.L; ++j) {
    const float ds = p_w[j];
    const T* kj = row_of(k, kc, g.ld_in, g.ldc_in, g, b, h, j) + c0;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + lane + 32 * u < g.d) a[u] = fmaf(ds, load1(kj + lane + 32 * u), a[u]);
  }
  T* dqi = row_of(dq, dqc, g.ld_d, g.ldc_d, g, b, h, i) + c0;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (c0 + lane + 32 * u < g.d) store1(dqi + lane + 32 * u, a[u] * scale);
}

// Key-major backward: one warp per key row of [frames; cls]; lanes take 32
// queries at a time, then sum their products over them.
template <typename T, int HD, int SH>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_k_scalar(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ qc,
                   const T* __restrict__ kc, const T* __restrict__ vc,
                   const T* __restrict__ gr, const T* __restrict__ gc,
                   const float* __restrict__ rowsum,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, T* __restrict__ dkc,
                   T* __restrict__ dvc, Geo g, float scale) {
  constexpr int U = HD / 32;
  __shared__ float p_s[WARPS][32], ds_s[WARPS][32];
  const int rows = (g.L + WARPS - 1) / WARPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x / rows, j = (blockIdx.x % rows) * WARPS + warp;
  const int c0 = blockIdx.y * HD;
  if (j >= g.L) return;
  const int b = bh / g.heads, h = bh % g.heads;
  const T* kj = row_of(k, kc, g.ld_in, g.ldc_in, g, b, h, j);
  const T* vj = row_of(v, vc, g.ld_in, g.ldc_in, g, b, h, j);
  const float* rs = rowsum + (size_t)bh * g.L;
  const float* dl = delta + (size_t)bh * g.L;
  float ak[U], av[U];
#pragma unroll
  for (int u = 0; u < U; ++u) ak[u] = av[u] = 0.f;
  for (int i0 = 0; i0 < g.L; i0 += 32) {
    const int i = i0 + lane;
    float p = 0.f, ds = 0.f;
    if (i < g.L) {
      const T* qi = row_of(q, qc, g.ld_in, g.ldc_in, g, b, h, i);
      const T* gi = row_of(gr, gc, g.ld_g, g.ldc_g, g, b, h, i);
      p = prob<SH>(dot(qi, kj, g.d) * scale, rs[i]);
      ds = p * (dot(gi, vj, g.d) - dl[i]);
    }
    p_s[warp][lane] = op<T>(p);
    ds_s[warp][lane] = op<T>(ds);
    __syncwarp();
    const int n = min(32, g.L - i0);
    for (int t = 0; t < n; ++t) {
      const T* qi = row_of(q, qc, g.ld_in, g.ldc_in, g, b, h, i0 + t) + c0;
      const T* gi = row_of(gr, gc, g.ld_g, g.ldc_g, g, b, h, i0 + t) + c0;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (c0 + lane + 32 * u >= g.d) continue;
        ak[u] = fmaf(ds_s[warp][t], load1(qi + lane + 32 * u), ak[u]);
        av[u] = fmaf(p_s[warp][t], load1(gi + lane + 32 * u), av[u]);
      }
    }
    __syncwarp();
  }
  T* kd = row_of(dk, dkc, g.ld_d, g.ldc_d, g, b, h, j) + c0;
  T* vd = row_of(dv, dvc, g.ld_d, g.ldc_d, g, b, h, j) + c0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (c0 + lane + 32 * u >= g.d) continue;
    store1(kd + lane + 32 * u, ak[u] * scale);
    store1(vd + lane + 32 * u, av[u]);
  }
}

// ------------------------------------------------------------ launchers

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// whether the bf16 tensor-core kernels take head dim d
bool on_tensor_cores(int d) { return d % 8 == 0 && d <= MAX_TC; }

// The tile width of a tensor-core head dim: the narrowest instance >= d.
int tile_width(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 96 ? 96 : d <= 128 ? 128
       : d <= 192 ? 192 : 256;
}

// A scalar kernel's columns per lane group: the narrowest power of two
// from 32 to SGW that holds d (SGW past it, in column groups).
int scalar_width(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : SGW;
}

// pack: short sequences share the tensor-core kernels' slices
Geo make_geo(int b, int n, bool cls, int heads, int d, int seqs, bool pack,
             long long ld_in, long long ldc_in, long long ld_g,
             long long ldc_g, long long ld_d, long long ldc_d) {
  Geo g;
  g.n = n;
  g.L = n + (cls ? 1 : 0);
  g.heads = heads;
  g.d = d;
  g.seqs = seqs;
  g.nseq = b;
  g.pk = 1;
  g.lp_log = 0;
  g.lv = g.L;
  if (pack && g.L <= BM) {
    while ((1 << g.lp_log) < std::max(g.L, 8)) ++g.lp_log;
    g.pk = PACK_ROWS >> g.lp_log;
    g.lv = PACK_ROWS;
  }
  g.tiles = (g.lv + BM - 1) / BM;
  g.slices = (b + g.pk - 1) / g.pk;
  g.ld_in = (size_t)ld_in;
  g.ldc_in = (size_t)ldc_in;
  g.ld_g = (size_t)ld_g;
  g.ldc_g = (size_t)ldc_g;
  g.ld_d = (size_t)ld_d;
  g.ldc_d = (size_t)ldc_d;
  return g;
}

// ld: the largest row stride; with seqs > 1 it must fit 32 bits (row_of)
bool valid(int b, int seqs, int n, int heads, int d, bool cls, int dtype,
           long long ld) {
  return b > 0 && seqs > 0 && b % seqs == 0 && !(cls && seqs > 1) && n > 0 &&
         heads > 0 && n + 1 <= MAX_L && d >= 1 &&
         (d + SGW - 1) / SGW <= 65535 && (dtype == 0 || dtype == 1) &&
         (seqs == 1 || ld < (1LL << 32));
}

// CTAs of a tensor-core launch: slices x heads x row blocks of nw tiles
unsigned wg_ctas(const Geo& g, int nw) {
  return (unsigned)((long long)g.slices * g.heads * ((g.tiles + nw - 1) / nw));
}

template <int W, int SH>
int launch_fwd_wg(const void* q, const void* k, const void* v, const void* qc,
                  const void* kc, const void* vc, void* out, void* outc,
                  void* rowsum, const Geo& g, float scale, cudaStream_t st) {
  using u16 = uint16_t;
  constexpr size_t smem = fwd_smem<W>();
  cudaError_t err = set_smem(flash_fwd_wg<W, SH>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_wg<W, SH><<<dim3(wg_ctas(g, 2), W / group_width(W)), 256, smem,
                        st>>>(
      static_cast<const u16*>(q), static_cast<const u16*>(k),
      static_cast<const u16*>(v), static_cast<const u16*>(qc),
      static_cast<const u16*>(kc), static_cast<const u16*>(vc),
      static_cast<u16*>(out), static_cast<u16*>(outc),
      static_cast<float*>(rowsum), g, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD, int SH>
int launch_fwd_scalar(const void* q, const void* k, const void* v,
                      const void* qc, const void* kc, const void* vc,
                      void* out, void* outc, void* rowsum, const Geo& g,
                      float scale, cudaStream_t st) {
  const size_t smem = (size_t)WARPS * g.L * sizeof(float);
  cudaError_t err = set_smem(flash_fwd_scalar<T, HD, SH>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (g.L + WARPS - 1) / WARPS;
  flash_fwd_scalar<T, HD, SH><<<dim3((unsigned)((long long)g.nseq * g.heads * rows),
                                 (g.d + HD - 1) / HD),
                            WARPS * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(qc),
      static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<T*>(out), static_cast<T*>(outc),
      static_cast<float*>(rowsum), g, scale);
  return (int)cudaGetLastError();
}

// The pointers of one backward call
struct BwdArgs {
  const void *q, *k, *v, *qc, *kc, *vc, *g, *gc, *rowsum;
  void *delta, *dq, *dk, *dv, *dqc, *dkc, *dvc;
};

// CTAs of a kernel the card holds at once
template <typename K>
unsigned resident_ctas(K kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  return (unsigned)(std::max(per_sm, 1) * sms);
}

template <int W, int S, int SH>
int launch_bwd_fused(const BwdArgs& a, const Geo& geo, int kr, size_t smem,
                     float scale, cudaStream_t st) {
  using u16 = uint16_t;
  static const cudaError_t set =
      set_smem(flash_bwd_fused_wg<W, S, SH>, MAX_SMEM);
  if (set != cudaSuccess) return (int)set;
  flash_bwd_fused_wg<W, S, SH><<<wg_ctas(geo, geo.tiles), 256, smem, st>>>(
      static_cast<const u16*>(a.q), static_cast<const u16*>(a.k),
      static_cast<const u16*>(a.v), static_cast<const u16*>(a.qc),
      static_cast<const u16*>(a.kc), static_cast<const u16*>(a.vc),
      static_cast<const u16*>(a.g), static_cast<const u16*>(a.gc),
      static_cast<const float*>(a.rowsum), static_cast<u16*>(a.dq),
      static_cast<u16*>(a.dk), static_cast<u16*>(a.dv),
      static_cast<u16*>(a.dqc), static_cast<u16*>(a.dkc),
      static_cast<u16*>(a.dvc), geo, kr, scale);
  return (int)cudaGetLastError();
}

// The fused kernel where a slice fits it; else the query-major pass (D and
// dq) and the key-major pass (dk and dv), 9 products per pair
template <int W, int SH>
int launch_bwd_wg(const BwdArgs& a, const Geo& geo, float scale,
                  cudaStream_t st) {
  using u16 = uint16_t;
  if constexpr (W <= 64) {
    const int kr = (geo.lv + 15) / 16 * 16;
    if constexpr (W == 64) {
      const size_t smem3 = fused_smem<W>(geo.tiles, kr, 3);
      if (smem3 <= MAX_SMEM)
        return launch_bwd_fused<W, 3, SH>(a, geo, kr, smem3, scale, st);
    }
    const size_t smem2 = fused_smem<W>(geo.tiles, kr, 2);
    if (smem2 <= MAX_SMEM)
      return launch_bwd_fused<W, 2, SH>(a, geo, kr, smem2, scale, st);
  }
  constexpr size_t smem = bwd_smem<W>(), smem_k = bwd_k_smem<W>();
  constexpr int NW = bwd_wgs(W);
  cudaError_t err = set_smem(flash_bwd_q_wg<W, SH>, smem);
  if (err == cudaSuccess) err = set_smem(flash_bwd_k_wg<W, SH>, smem_k);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(wg_ctas(geo, NW), W / group_width(W));
  // the key-major pass persists where it double-buffers its resident
  // tiles: as many CTAs as the card holds (counted once: the process runs
  // on one card model), at most one per item
  static const unsigned resident =
      resident_ctas(flash_bwd_k_wg<W, SH>, 128, smem_k);
  const unsigned kitems = wg_ctas(geo, 1);
  const unsigned kctas =
      kv_buffers(W) > 1 ? std::max(1u, std::min(kitems, resident)) : kitems;
  flash_bwd_q_wg<W, SH><<<grid, NW * 128, smem, st>>>(
      static_cast<const u16*>(a.q), static_cast<const u16*>(a.k),
      static_cast<const u16*>(a.v), static_cast<const u16*>(a.qc),
      static_cast<const u16*>(a.kc), static_cast<const u16*>(a.vc),
      static_cast<const u16*>(a.g), static_cast<const u16*>(a.gc),
      static_cast<const float*>(a.rowsum), static_cast<float*>(a.delta),
      static_cast<u16*>(a.dq), static_cast<u16*>(a.dqc), geo, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_k_wg<W, SH><<<dim3(kctas, grid.y), 128, smem_k, st>>>(
      static_cast<const u16*>(a.q), static_cast<const u16*>(a.k),
      static_cast<const u16*>(a.v), static_cast<const u16*>(a.qc),
      static_cast<const u16*>(a.kc), static_cast<const u16*>(a.vc),
      static_cast<const u16*>(a.g), static_cast<const u16*>(a.gc),
      static_cast<const float*>(a.rowsum), static_cast<const float*>(a.delta),
      static_cast<u16*>(a.dk), static_cast<u16*>(a.dv),
      static_cast<u16*>(a.dkc), static_cast<u16*>(a.dvc), geo, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD, int SH>
int launch_bwd_scalar(const BwdArgs& a, const Geo& geo, float scale,
                      cudaStream_t st) {
  const size_t smem = (size_t)WARPS * 2 * geo.L * sizeof(float);
  cudaError_t err = set_smem(flash_bwd_q_scalar<T, HD, SH>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(
      (unsigned)((long long)geo.nseq * geo.heads * ((geo.L + WARPS - 1) / WARPS)),
      (geo.d + HD - 1) / HD);
  flash_bwd_q_scalar<T, HD, SH><<<grid, WARPS * 32, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.qc),
      static_cast<const T*>(a.kc), static_cast<const T*>(a.vc),
      static_cast<const T*>(a.g), static_cast<const T*>(a.gc),
      static_cast<const float*>(a.rowsum), static_cast<float*>(a.delta),
      static_cast<T*>(a.dq), static_cast<T*>(a.dqc), geo, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_k_scalar<T, HD, SH><<<grid, WARPS * 32, 0, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.qc),
      static_cast<const T*>(a.kc), static_cast<const T*>(a.vc),
      static_cast<const T*>(a.g), static_cast<const T*>(a.gc),
      static_cast<const float*>(a.rowsum), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), static_cast<T*>(a.dkc),
      static_cast<T*>(a.dvc), geo, scale);
  return (int)cudaGetLastError();
}

// f(integral_constant W) for the tensor-core tile width of d
template <typename F>
int with_tile(int d, F f) {
  switch (tile_width(d)) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 192: return f(std::integral_constant<int, 192>{});
    default: return f(std::integral_constant<int, 256>{});
  }
}

// f(type tag T, integral_constant HD) for a scalar kernel of d
template <typename T, typename F>
int with_scalar(int d, F f) {
  switch (scalar_width(d)) {
    case 32: return f(T{}, std::integral_constant<int, 32>{});
    case 64: return f(T{}, std::integral_constant<int, 64>{});
    case 128: return f(T{}, std::integral_constant<int, 128>{});
    default: return f(T{}, std::integral_constant<int, SGW>{});
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: any (the bf16 tensor-core
// kernels take multiples of 8 up to 256, the scalar kernels the rest).
// b: the number of sequences, seqs of them side by side in each row (1 but
// for K2's layout; b a multiple of seqs, no CLS stream with seqs > 1).  qc,
// kc, vc (and outc, gc, dqc, dkc, dvc) are null without the CLS stream.
// Row strides are in elements: ld_in of q, k, v, ldc_in of qc, kc, vc
// (their batch stride), ld_o / ldc_o of out and outc (forward) or of g and
// gc (backward), ld_d / ldc_d of the gradients; with seqs > 1 each ld must
// be a multiple of seqs.  The tensor-core kernels need every row 16-byte
// aligned.  shift: the softmax shift (enum Shift: 0 clamp, 1 max, 2 none).
// Each entry point returns the CUDA error code of its launches (0 on
// success).

// The forward: out, outc and, where rowsum is not null, l [b, heads, L]
// (fp32; under max lse = m + log l, with m the row max of the scaled
// logits).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* qc,
                                   const void* kc, const void* vc, void* out,
                                   void* outc, void* rowsum, int b, int seqs,
                                   int n, int heads, int head_dim,
                                   long long ld_in, long long ldc_in,
                                   long long ld_o, long long ldc_o, int dtype,
                                   int shift, float scale, void* stream) {
  if (!valid(b, seqs, n, heads, head_dim, qc != nullptr, dtype,
             std::max(ld_in, ld_o)))
    return (int)cudaErrorInvalidValue;
  const bool tc = dtype == 1 && on_tensor_cores(head_dim);
  const Geo g = make_geo(b, n, qc != nullptr, heads, head_dim, seqs, tc, ld_in,
                         ldc_in, ld_o, ldc_o, 0, 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_shift(shift, [&](auto sh) {
    constexpr int SH = decltype(sh)::value;
    if (tc)
      return with_tile(head_dim, [&](auto w) {
        return launch_fwd_wg<decltype(w)::value, SH>(q, k, v, qc, kc, vc, out,
                                                     outc, rowsum, g, scale,
                                                     st);
      });
    auto scalar = [&](auto t, auto hd) {
      return launch_fwd_scalar<decltype(t), decltype(hd)::value, SH>(
          q, k, v, qc, kc, vc, out, outc, rowsum, g, scale, st);
    };
    return dtype == 0 ? with_scalar<float>(head_dim, scalar)
                      : with_scalar<__nv_bfloat16>(head_dim, scalar);
  });
}

// The recompute backward from the forward's l (lse under max, the same
// shift as the forward's): dq, dk, dv (and dqc, dkc, dvc).  delta [b, heads, L] fp32 is scratch written by the query-major
// kernel and read by the key-major one.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* qc,
                                   const void* kc, const void* vc,
                                   const void* g, const void* gc,
                                   const void* rowsum, void* delta, void* dq,
                                   void* dk, void* dv, void* dqc, void* dkc,
                                   void* dvc, int b, int seqs, int n,
                                   int heads, int head_dim, long long ld_in,
                                   long long ldc_in, long long ld_g,
                                   long long ldc_g, long long ld_d,
                                   long long ldc_d, int dtype, int shift,
                                   float scale, void* stream) {
  if (!valid(b, seqs, n, heads, head_dim, qc != nullptr, dtype,
             std::max({ld_in, ld_g, ld_d})))
    return (int)cudaErrorInvalidValue;
  const bool tc = dtype == 1 && on_tensor_cores(head_dim);
  const Geo geo = make_geo(b, n, qc != nullptr, heads, head_dim, seqs, tc,
                           ld_in, ldc_in, ld_g, ldc_g, ld_d, ldc_d);
  const BwdArgs a{q, k, v, qc, kc, vc, g, gc, rowsum, delta,
                  dq, dk, dv, dqc, dkc, dvc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_shift(shift, [&](auto sh) {
    constexpr int SH = decltype(sh)::value;
    if (tc)
      return with_tile(head_dim, [&](auto w) {
        return launch_bwd_wg<decltype(w)::value, SH>(a, geo, scale, st);
      });
    auto scalar = [&](auto t, auto hd) {
      return launch_bwd_scalar<decltype(t), decltype(hd)::value, SH>(
          a, geo, scale, st);
    };
    return dtype == 0 ? with_scalar<float>(head_dim, scalar)
                      : with_scalar<__nv_bfloat16>(head_dim, scalar);
  });
}
