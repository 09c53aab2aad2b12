// MViT pooled attention with the decomposed relative-position bias: the
// forward (K5f / K6f) and its recompute backward (K5b / K6b), the key-tiled
// row-max forward (K7f) with its backward (K7b), and the knob variants
// K5bd / K6bd (MVIT_DELTA=1) and K6sp / K6bs (MVIT_SAVE_PROBS=1).
//
// Replaces the TPU kernels of procedurevrl_tpu/ops/pallas_mvit_attention.py:
//   K5f  _fwd_hl_kernel     (via _fwd_hl,  head-last  [B, qN, H*d]);
//   K5b  _bwd_hl_kernel     (via _bwd_hl);
//   K6f  _fwd_kernel        (via _fwd,     head-split [B*H, qN, d]);
//   K6b  _bwd_kernel        (via _bwd);
//   K7f  _fwd_hl_kt_kernel  (via _fwd_hl_kt, head-last, MVIT_KT=1);
//   K7b  _bwd_hl_kt_kernel  (via _bwd_hl_kt);
//   K5bd _bwd_hl_kernel_delta   (via _bwd_hl_delta);
//   K6bd _bwd_kernel_delta      (via _bwd_delta);
//   K6sp _fwd_kernel_saveprobs  (via _fwd with save_probs);
//   K6bs _bwd_kernel_saveprobs  (via _bwd_saved).
// One kernel serves both layouts: every tensor is addressed per (batch,
// head) slice with a token-row stride, so the head-last call passes
// (B, H) and row stride H*d, the head-split call (B*H, 1) and row stride d.
// Any head dim d: the bf16 tensor-core kernels take multiples of 8 up to
// 128 and run them on the narrowest tile width DP of (64, 96, 128) that
// holds them, their tiles zero past column d; the scalar kernels take
// float32 at every d and bf16 at the other head dims (not a multiple of 8,
// or past 128), in column groups of 128 (see there).
//
// Contract, per (batch b, head h) slice:
//   q [qN, d] body queries; k, v [kN, d] body keys/values, row-major over
//   (t', h', w') of the pooled key grid k_shape = (kt, kh, kw); kc, vc
//   [1, d] the cls key/value, which is key column kN; rel [qN, kcat],
//   kcat = kt + kh + kw, the per-axis bias tables in the order [t | h | w]
//   (head-last: rel [B, qN, H*kcat], head h at columns h*kcat..).
//   s_ij = (q_i . k_j) * scale + ((rel[i, t'] + rel[i, kt+h']) +
//   rel[i, kt+kh+w']) for body keys, (q_i . kc) * scale for the cls key;
//   p = exp(min(s, 80)) / l_i with l_i = sum_j exp(min(s_ij, 80)) over the
//   kN + 1 columns (the clamp shift of the TPU kernels, MVIT_SHIFT=clamp);
//   o_i = sum_j bf16(p_ij) v_j, accumulated in fp32, in the input dtype.
//   The forward also writes rowsum [B, H, qN] = l (fp32), the backward's
//   residual.
// Backward (the TPU kernel's arithmetic): p recomputed in fp32 from l;
//   dp = g v^T; D_i = sum_j dp_ij p_ij; ds = p (dp - D), ds_c = bf16(ds);
//   dq = scale ds_c k, dk = scale ds_c^T q, dv = bf16(p)^T g, all fp32
//   accumulated; d(rel)[i, c] = sum of ds_c[i, j] over the body keys j on
//   axis entry c; dkc, dvc are key column kN of dk, dv.  Like the TPU
//   kernel it is the softmax jacobian, ignoring the clamp.
//
// Bounds on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) at the MViT-v2-S
// training step, 18 clips: the forward of block 0 (head-last, qN = 25088,
// kN = 392, H = 1) moves ~200 MB (q and out dominate) and does 68 GFLOP:
// ~69 us, operations and bytes about even; block 1 (head-split, BH = 36,
// qN = 6272, kN = 1568) moves ~50 MB and does 136 GFLOP: operation-bound.
// The backward does 10 products of qN (kN + 1) d: operation-bound at every
// MViT-v2-S block (170 GFLOP at block 0, 340 at block 1).  The logits
// matrix [qN, kN+1] never reaches device memory.
//
// Forward design (bf16, mma.sync m16n8k16 with fp32 accumulators, ldmatrix
// fragments, cp.async staging):
//   * a CTA of 4 warps owns 64 query rows (16 per warp) of one slice; the
//     keys are walked in tiles of 64 staged in shared memory;
//   * the bias is one more tensor-core product, as on the TPU: the rel
//     rows (padded to 48 columns) times the 0/1 expander [48 x 64 keys],
//     built per key tile in shared memory from (kt, kh, kw); exact, since
//     the expander holds ones and zeros;
//   * sweep 1 over the keys sums l, sweep 2 forms p = e / l and the PV
//     product, so bf16(p) is the normalised probability the plain version
//     rounds.
// Backward design, for Hopper (bf16; wgmma, see wgmma.cuh): every product
// a warpgroup product of a 64-row tile with its B operand (and the
// warpgroup's resident A tiles) in shared memory in the core-matrix
// layout, ds and p handed to the next product as register A operands, and
// the other side's tiles in a two-stage cp.async ring: the next tile loads
// under the whole of the current one, and the current tile's accumulate
// products run on while the next tile's copies are awaited.
//   * query-major kernel (two warpgroups of 64 queries sharing each key
//     tile, which halves the key traffic that bounds this pass; q, g and
//     rel resident): sweep A over the key tiles computes D_i = rowsum(dp p)
//     (and stores it), sweep B forms ds and accumulates dq += ds k and
//     d(rel) += ds E^T (E^T, the expander, as the MN-major B);
//   * key-major kernel (two warpgroups of 64 keys sharing each query tile;
//     k, v and the expander resident): walks a chunk of the query tiles and
//     accumulates dk += ds^T q and dv += p^T g.  The query range of a slice
//     is split over `splits` CTAs where the key tiles alone do not fill the
//     card (MViT-v2-S block 0: 4 tiles of 128 keys x 18 slices); each
//     writes fp32 partial dk and dv to a workspace and a second kernel
//     sums them in split order, so the result is deterministic (no
//     atomics);
//   * the logits are s = (q k^T) scale, then the bias product accumulated
//     onto them: s rounds once more than the TPU kernel's fused form (fp32
//     ulps);
//   * the first product into an accumulator overwrites it, so no plain
//     instruction defines an accumulator of a group in flight (ptxas would
//     serialize the group's products);
//   * fp32, and bf16 at the head dims the tensor-core kernels do not take:
//     scalar kernels (the tensor cores have no exact fp32 mode), one warp
//     per query or key row, for small shapes, in column groups.
// K7 has the same contract and layout except its softmax: the row max, not
// the clamp.  K7f keeps a running max m over key tiles, p = exp(s - m)
// (padding columns masked to -1e30 as on the TPU), rounds the unnormalised
// p to bf16 before P V, divides by l at the end and writes lse = m + log l
// (fp32 [B, H, qN]) in place of l.  K7b rebuilds p = exp(s - lse) and takes
// D_i = rowsum(g_i o_i) from the saved output o; the rest is K5b's kernel
// pair (a compile-time switch), so its products run on bf16 operands (ds,
// p, g, k, q) where the TPU kernel multiplies fp32 ones (:1128-1143).
// The knob variants are compile-time switches of the same kernels.  K5bd /
// K6bd: K5b's pair with D_i = rowsum(g_i o_i) from the saved output, as
// K7b takes it, but p still the clamp exp(min(s, 80)) / l; the query-major
// pass loses its sweep A.  K6sp: K6f whose sweep 2 also stores the bf16(p)
// fragments it feeds to P V, probs [BH, qN, LP] with LP = kN + 1 rounded up
// to 8 (16-byte rows; columns past kN zero).  K6bs: K6b's pair with p read
// from those probabilities (tiles staged by cp.async beside each ring
// stage; its sweep A loads v alone), D_i = rowsum(dp p) with the saved p;
// no QK^T and no exp.  Times against the previous (mma.sync) pair and
// against the bounds: PERF.md.
// Not done yet: TMA and a producer warp, 128-key tiles, fewer
// recomputations of s (the backward forms s three times and g v^T twice).

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using namespace pvrl;

constexpr int MAX_D = 128;    // widest head dim of the tensor-core kernels
constexpr int BM = 64;        // query rows per tile (4 warps x 16)
constexpr int BN = 64;        // keys per tile
constexpr int KCAT = 48;      // rel columns, padded to 3 mma k-steps
constexpr int SE = KCAT + 8;  // smem row of a rel / expander tile: 112 B
constexpr int SP = BN + 8;    // smem row of a saved-probability tile: 144 B
constexpr int WARPS = 4;
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint32_t BF16_ONE = 0x3F80u;
constexpr float MASKED = -1e30f;  // K7's logit of a padding key column

// The backward's variants (compile-time switches of one kernel pair)
enum Bwd : int {
  kRecompute = 0,  // K5b / K6b: p = exp(min(s, 80)) / l, D = rowsum(dp p)
  kRowMax = 1,     // K7b: p = exp(s - lse), D = rowsum(g o)
  kDelta = 2,      // K5bd / K6bd: p = exp(min(s, 80)) / l, D = rowsum(g o)
  kSaved = 3,      // K6bs: p read from K6sp's probs, D = rowsum(dp p)
};

struct Geo {
  int heads, qn, kn, kt, kh, kw, kcat;
  int d;        // head dim
  int pld;      // row stride of the saved probabilities: kn + 1 rounded to 8
  size_t row;   // elements between token rows of q, k, v, g, out (heads*d)
  size_t rrow;  // elements between rows of rel (heads*kcat)
};

Geo make_geo(int heads, int qn, int kn, int kt, int kh, int kw, int d) {
  Geo g;
  g.heads = heads;
  g.qn = qn;
  g.kn = kn;
  g.kt = kt;
  g.kh = kh;
  g.kw = kw;
  g.kcat = kt + kh + kw;
  g.d = d;
  g.pld = (kn + 1 + 7) / 8 * 8;
  g.row = (size_t)heads * d;
  g.rrow = (size_t)heads * g.kcat;
  return g;
}

template <typename T>
__device__ __forceinline__ T* q_of(T* x, const Geo& g, int bh) {
  const int b = bh / g.heads, h = bh % g.heads;
  return x + (size_t)b * g.qn * g.row + (size_t)h * g.d;
}
template <typename T>
__device__ __forceinline__ T* k_of(T* x, const Geo& g, int bh) {
  const int b = bh / g.heads, h = bh % g.heads;
  return x + (size_t)b * g.kn * g.row + (size_t)h * g.d;
}
template <typename T>
__device__ __forceinline__ T* c_of(T* x, const Geo& g, int bh) {
  const int b = bh / g.heads, h = bh % g.heads;
  return x + (size_t)b * g.row + (size_t)h * g.d;
}
template <typename T>
__device__ __forceinline__ T* probs_of(T* x, const Geo& g, int bh) {
  return x + (size_t)bh * g.qn * g.pld;
}
template <typename T>
__device__ __forceinline__ T* rel_of(T* x, const Geo& g, int bh) {
  const int b = bh / g.heads, h = bh % g.heads;
  return x + (size_t)b * g.qn * g.rrow + (size_t)h * g.kcat;
}

// columns t', kt + h', kt + kh + w' of rel that key j < kn reads (-1 for
// the cls key and padding, which take no bias)
__device__ __forceinline__ void axis_cols(int j, const Geo& g, int& a, int& b,
                                          int& c) {
  a = b = c = -1;
  if (j < g.kn) {
    a = j / (g.kh * g.kw);
    b = g.kt + (j / g.kw) % g.kh;
    c = g.kt + g.kh + j % g.kw;
  }
}

// ------------------------------------- bf16 forward (mma.sync) kernels

// rows [r0, r0 + 64) of an [n x d] slice into a [64 x (DP + 8)] tile; rows
// >= n and columns >= d are zero
template <int DP>
__device__ __forceinline__ void stage_rows(uint16_t* dst, const uint16_t* src,
                                           size_t row, int r0, int n, int d) {
  constexpr int SD = DP + 8, CH = DP / 8;
  for (int idx = threadIdx.x; idx < BM * CH; idx += blockDim.x) {
    const int r = idx / CH, e = 8 * (idx % CH);
    uint16_t* t = dst + r * SD + e;
    if (r0 + r < n && e < d) {
      cp_async16(t, src + (size_t)(r0 + r) * row + e);
    } else {
      *reinterpret_cast<uint4*>(t) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// keys [j0, j0 + 64) of [body; cls]: rows < kn from x, row kn from xc,
// rows past it and columns >= d zero
template <int DP>
__device__ __forceinline__ void stage_keys(uint16_t* dst, const uint16_t* x,
                                           const uint16_t* xc, size_t row,
                                           int j0, int kn, int d) {
  constexpr int SD = DP + 8, CH = DP / 8;
  for (int idx = threadIdx.x; idx < BN * CH; idx += blockDim.x) {
    const int r = idx / CH, e = 8 * (idx % CH);
    const int j = j0 + r;
    uint16_t* t = dst + r * SD + e;
    if (j <= kn && e < d) {
      cp_async16(t, (j < kn ? x + (size_t)j * row : xc) + e);
    } else {
      *reinterpret_cast<uint4*>(t) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// rel rows [i0, i0 + 64) into a [64 x SE] tile, zero past qn and kcat
// (rows of kcat bf16 values need not be 4-byte aligned: plain loads)
__device__ __forceinline__ void stage_rel(uint16_t* dst, const uint16_t* rel,
                                          const Geo& g, int i0) {
  for (int idx = threadIdx.x; idx < BM * KCAT; idx += blockDim.x) {
    const int r = idx / KCAT, c = idx % KCAT;
    dst[r * SE + c] = (i0 + r < g.qn && c < g.kcat)
                          ? rel[(size_t)(i0 + r) * g.rrow + c]
                          : (uint16_t)0;
  }
}

// The transposed 0/1 expander of keys [j0, j0 + 64): row r holds ones at
// columns t', kt + h', kt + kh + w' of key j0 + r; rows of the cls key and
// of padding are zero (no bias there)
__device__ __forceinline__ void build_expander(uint16_t* dst, int j0,
                                               const Geo& g) {
  for (int r = threadIdx.x; r < BN; r += blockDim.x) {
    int a, b, c;
    axis_cols(j0 + r, g, a, b, c);
    for (int cc = 0; cc < KCAT; cc += 2) {
      const uint32_t lo = (cc == a || cc == b || cc == c) ? BF16_ONE : 0u;
      const uint32_t hi =
          (cc + 1 == a || cc + 1 == b || cc + 1 == c) ? BF16_ONE : 0u;
      *reinterpret_cast<uint32_t*>(dst + r * SE + cc) = lo | (hi << 16);
    }
  }
}

// A fragments of rows [row0, row0 + 16) over STEPS 16-column steps
template <int STEPS>
__device__ __forceinline__ void load_a(uint32_t (&a)[STEPS][4],
                                       const uint16_t* tile, int stride,
                                       int row0) {
  const int lane = threadIdx.x & 31, lrow = lane & 7, ltile = lane >> 3;
#pragma unroll
  for (int ks = 0; ks < STEPS; ++ks)
    ldsm_x4(a[ks], tile + (row0 + (ltile & 1) * 8 + lrow) * stride + ks * 16 +
                       (ltile >> 1) * 8);
}

// acc += A (16 x 16*STEPS) times rows [n0, n0 + 8) of `tile` taken as the
// column-major B operand (n = tile row, k = tile column)
template <int STEPS>
__device__ __forceinline__ void mma_rows(float (&acc)[4],
                                         const uint32_t (&a)[STEPS][4],
                                         const uint16_t* tile, int stride,
                                         int n0) {
  const int lane = threadIdx.x & 31, lrow = lane & 7, ltile = lane >> 3;
  const uint16_t* p = tile + (n0 + lrow) * stride + ltile * 8;
#pragma unroll
  for (int ks = 0; ks + 1 < STEPS; ks += 2) {
    uint32_t b[4];
    ldsm_x4(b, p + ks * 16);
    mma_16816(acc, a[ks], b[0], b[1]);
    mma_16816(acc, a[ks + 1], b[2], b[3]);
  }
  if constexpr (STEPS & 1) {
    uint32_t b[2];
    ldsm_x2(b, p + (STEPS - 1) * 16);
    mma_16816(acc, a[STEPS - 1], b[0], b[1]);
  }
}

// acc[0..NT) += A (16 x 16) times rows [k0, k0 + 16) x columns [0, 8*NT)
// of `tile` (k = tile row, n = tile column)
template <int NT>
__device__ __forceinline__ void mma_cols(float (&acc)[NT][4],
                                         const uint32_t (&a)[4],
                                         const uint16_t* tile, int stride,
                                         int k0) {
  const int lane = threadIdx.x & 31, lrow = lane & 7, ltile = lane >> 3;
  const uint16_t* p = tile + (k0 + (ltile & 1) * 8 + lrow) * stride +
                      (ltile >> 1) * 8;
#pragma unroll
  for (int nt = 0; nt < NT; nt += 2) {
    uint32_t b[4];
    ldsm_x4_t(b, p + nt * 8);
    mma_16816(acc[nt], a, b[0], b[1]);
    mma_16816(acc[nt + 1], a, b[2], b[3]);
  }
}

// K7: the logits s = (q.k) * scale + bias for the warp's 16 query rows and
// tile keys [n0, n0 + 8), MASKED for keys past the cls (j > kn), as the
// TPU kernel masks its padding columns; K5/K6 (CLAMP): exp(min(s, 80)),
// zero past the cls
template <bool CLAMP, int KS>
__device__ __forceinline__ void logits8(float (&s)[4],
                                        const uint32_t (&qa)[KS][4],
                                        const uint32_t (&ra)[3][4],
                                        const uint16_t* k_s, int sd,
                                        const uint16_t* e_s, int n0, int j0,
                                        int kn, float scale) {
  float qk[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f};
  mma_rows<KS>(qk, qa, k_s, sd, n0);
  mma_rows<3>(b, ra, e_s, SE, n0);
  const int col = j0 + n0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (CLAMP) {
      const float x = fmaf(qk[e], scale, b[e]);
      s[e] = col + (e & 1) <= kn ? exp2f(fminf(x, CLAMP_HI) * LOG2E) : 0.f;
    } else {
      s[e] = col + (e & 1) <= kn ? fmaf(qk[e], scale, b[e]) : MASKED;
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int DP>
__host__ __device__ constexpr size_t fwd_smem() {
  return (size_t)(3 * 64 * (DP + 8) + 2 * 64 * SE) * 2;
}

// K5f / K6f, and with SAVE K6sp, which also stores the bf16(p) fragments
// of P V to probs.  EXACT: the head dim is the tile width DP, so the
// column tests against d fold away at compile time.
template <bool SAVE, int DP, bool EXACT>
__global__ void __launch_bounds__(WARPS * 32)
mvit_fwd_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
             const uint16_t* __restrict__ v, const uint16_t* __restrict__ kc,
             const uint16_t* __restrict__ vc, const uint16_t* __restrict__ rel,
             uint16_t* __restrict__ out, float* __restrict__ rowsum,
             uint16_t* __restrict__ probs, Geo g, float scale) {
  constexpr int SD = DP + 8, KS = DP / 16, DT = DP / 8;
  if constexpr (EXACT) g.d = DP;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint16_t* q_s = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* k_s = q_s + BM * SD;
  uint16_t* v_s = k_s + BN * SD;
  uint16_t* e_s = v_s + BN * SD;
  uint16_t* r_s = e_s + BN * SE;
  const int bh = blockIdx.y, i0 = blockIdx.x * BM;
  const uint16_t* kp = k_of(k, g, bh);
  const uint16_t* vp = k_of(v, g, bh);
  const uint16_t* kcp = c_of(kc, g, bh);
  const uint16_t* vcp = c_of(vc, g, bh);

  stage_rows<DP>(q_s, q_of(q, g, bh), g.row, i0, g.qn, g.d);
  stage_rel(r_s, rel_of(rel, g, bh), g, i0);
  cp_async_wait_all();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  uint32_t qa[KS][4], ra[3][4];
  load_a<KS>(qa, q_s, SD, warp * 16);
  load_a<3>(ra, r_s, SE, warp * 16);

  // sweep 1: the row sums l
  float l0 = 0.f, l1 = 0.f;
  for (int j0 = 0; j0 <= g.kn; j0 += BN) {
    __syncthreads();  // the previous key tile is consumed
    stage_keys<DP>(k_s, kp, kcp, g.row, j0, g.kn, g.d);
    build_expander(e_s, j0, g);
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 2
    for (int n0 = 0; n0 < BN; n0 += 8) {
      float s[4];
      logits8<true, KS>(s, qa, ra, k_s, SD, e_s, n0, j0, g.kn, scale);
      l0 += s[0] + s[1];
      l1 += s[2] + s[3];
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = i0 + warp * 16 + gid, r1 = r0 + 8;
  uint16_t* pp = SAVE ? probs_of(probs, g, bh) : nullptr;

  // sweep 2: p = e / l, rounded to bf16 as the A operand of P V
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  for (int j0 = 0; j0 <= g.kn; j0 += BN) {
    __syncthreads();
    stage_keys<DP>(k_s, kp, kcp, g.row, j0, g.kn, g.d);
    stage_keys<DP>(v_s, vp, vcp, g.row, j0, g.kn, g.d);
    build_expander(e_s, j0, g);
    cp_async_wait_all();
    __syncthreads();
    for (int ks = 0; ks < BN / 16; ++ks) {
      float s0[4], s1[4];
      logits8<true, KS>(s0, qa, ra, k_s, SD, e_s, ks * 16, j0, g.kn, scale);
      logits8<true, KS>(s1, qa, ra, k_s, SD, e_s, ks * 16 + 8, j0, g.kn, scale);
      const uint32_t pa[4] = {pack_bf16x2(s0[0] * inv0, s0[1] * inv0),
                              pack_bf16x2(s0[2] * inv1, s0[3] * inv1),
                              pack_bf16x2(s1[0] * inv0, s1[1] * inv0),
                              pack_bf16x2(s1[2] * inv1, s1[3] * inv1)};
      if constexpr (SAVE) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = j0 + ks * 16 + u * 8 + 2 * tig;
          if (c >= g.pld) continue;
          const uint32_t w0 = pa[2 * u], w1 = pa[2 * u + 1];
          if (r0 < g.qn)
            *reinterpret_cast<uint32_t*>(pp + (size_t)r0 * g.pld + c) = w0;
          if (r1 < g.qn)
            *reinterpret_cast<uint32_t*>(pp + (size_t)r1 * g.pld + c) = w1;
        }
      }
      mma_cols<DT>(o, pa, v_s, SD, ks * 16);
    }
  }
  uint16_t* op = q_of(out, g, bh);
  float* rs = rowsum + (size_t)bh * g.qn;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = i0 + warp * 16 + gid + 8 * half;
    if (r >= g.qn) continue;
    uint16_t* dst = op + (size_t)r * g.row + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      if (dt * 8 < g.d)
        *reinterpret_cast<uint32_t*>(dst + dt * 8) =
            pack_bf16x2(o[dt][2 * half], o[dt][2 * half + 1]);
    if (tig == 0) rs[r] = half ? l1 : l0;
  }
}

// K7f: one sweep over the key tiles with an online softmax (the
// FlashAttention-2 form of the TPU kernel): per query row a running max m
// and partial sums l and acc; a tile whose max exceeds m rescales them by
// exp(m_old - m_new); p = exp(s - m) is rounded to bf16 unnormalised as the
// A operand of P V; o = acc / l and lse = m + log l at the end.  EXACT as
// for mvit_fwd_mma.
template <int DP, bool EXACT>
__global__ void __launch_bounds__(WARPS * 32)
mvit_fwd_kt_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                const uint16_t* __restrict__ v,
                const uint16_t* __restrict__ kc,
                const uint16_t* __restrict__ vc,
                const uint16_t* __restrict__ rel, uint16_t* __restrict__ out,
                float* __restrict__ lse, Geo g, float scale) {
  constexpr int SD = DP + 8, KS = DP / 16, DT = DP / 8;
  if constexpr (EXACT) g.d = DP;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint16_t* q_s = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* k_s = q_s + BM * SD;
  uint16_t* v_s = k_s + BN * SD;
  uint16_t* e_s = v_s + BN * SD;
  uint16_t* r_s = e_s + BN * SE;
  const int bh = blockIdx.y, i0 = blockIdx.x * BM;
  const uint16_t* kp = k_of(k, g, bh);
  const uint16_t* vp = k_of(v, g, bh);
  const uint16_t* kcp = c_of(kc, g, bh);
  const uint16_t* vcp = c_of(vc, g, bh);

  stage_rows<DP>(q_s, q_of(q, g, bh), g.row, i0, g.qn, g.d);
  stage_rel(r_s, rel_of(rel, g, bh), g, i0);
  cp_async_wait_all();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  uint32_t qa[KS][4], ra[3][4];
  load_a<KS>(qa, q_s, SD, warp * 16);
  load_a<3>(ra, r_s, SE, warp * 16);

  float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  const int kcols = g.kn + 1;  // the body keys and the cls key
  for (int j0 = 0; j0 < kcols; j0 += BN) {
    __syncthreads();  // the previous key tile is consumed
    stage_keys<DP>(k_s, kp, kcp, g.row, j0, g.kn, g.d);
    stage_keys<DP>(v_s, vp, vcp, g.row, j0, g.kn, g.d);
    build_expander(e_s, j0, g);
    cp_async_wait_all();
    __syncthreads();
    float s[8][4];
    float t0 = MASKED, t1 = MASKED;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      logits8<false, KS>(s[nb], qa, ra, k_s, SD, e_s, nb * 8, j0, g.kn, scale);
      t0 = fmaxf(t0, fmaxf(s[nb][0], s[nb][1]));
      t1 = fmaxf(t1, fmaxf(s[nb][2], s[nb][3]));
    }
    const float n0 = fmaxf(m0, quad_max(t0)), n1 = fmaxf(m1, quad_max(t1));
    const float a0 = exp2f((m0 - n0) * LOG2E), a1 = exp2f((m1 - n1) * LOG2E);
    m0 = n0;
    m1 = n1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= a0;
      o[dt][1] *= a0;
      o[dt][2] *= a1;
      o[dt][3] *= a1;
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      s[nb][0] = exp2f((s[nb][0] - n0) * LOG2E);
      s[nb][1] = exp2f((s[nb][1] - n0) * LOG2E);
      s[nb][2] = exp2f((s[nb][2] - n1) * LOG2E);
      s[nb][3] = exp2f((s[nb][3] - n1) * LOG2E);
      l0 += s[nb][0] + s[nb][1];
      l1 += s[nb][2] + s[nb][3];
    }
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) {
      const uint32_t pa[4] = {pack_bf16x2(s[2 * ks][0], s[2 * ks][1]),
                              pack_bf16x2(s[2 * ks][2], s[2 * ks][3]),
                              pack_bf16x2(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                              pack_bf16x2(s[2 * ks + 1][2], s[2 * ks + 1][3])};
      mma_cols<DT>(o, pa, v_s, SD, ks * 16);
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  uint16_t* op = q_of(out, g, bh);
  float* ls = lse + (size_t)bh * g.qn;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = i0 + warp * 16 + gid + 8 * half;
    if (r >= g.qn) continue;
    const float l = half ? l1 : l0;
    uint16_t* dst = op + (size_t)r * g.row + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      if (dt * 8 < g.d)
        *reinterpret_cast<uint32_t*>(dst + dt * 8) =
            pack_bf16x2(o[dt][2 * half] / l, o[dt][2 * half + 1] / l);
    if (tig == 0) ls[r] = (half ? m1 : m0) + logf(l);
  }
}

// --------------------------------------- bf16 backward (wgmma) kernels

// Tiles of the backward live in the core-matrix layout of wgmma.cuh
// (kmajor, mnmajor, chunk_rc).

// rows [r0, r0 + 64) of an [n x d] slice (row stride `row`) into a
// core-matrix tile of width W; rows >= n and columns >= d zero
template <int W>
__device__ __forceinline__ void stage_cm(uint16_t* dst, const uint16_t* src,
                                         size_t row, int r0, int n, int d) {
  for (int idx = threadIdx.x; idx < BM * W / 8; idx += blockDim.x) {
    int r, c;
    chunk_rc<W>(idx, r, c);
    uint16_t* t = dst + idx * 8;
    if (r0 + r < n && c < d) {
      cp_async16(t, src + (size_t)(r0 + r) * row + c);
    } else {
      *reinterpret_cast<uint4*>(t) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// keys [j0, j0 + 64) of [body; cls] (rows < kn from x, row kn from xc) into
// a core-matrix tile of width W; rows past kn and columns >= d zero
template <int W>
__device__ __forceinline__ void stage_keys_cm(uint16_t* dst, const uint16_t* x,
                                              const uint16_t* xc, size_t row,
                                              int j0, const Geo& g) {
  for (int idx = threadIdx.x; idx < BN * W / 8; idx += blockDim.x) {
    int r, c;
    chunk_rc<W>(idx, r, c);
    const int j = j0 + r;
    uint16_t* t = dst + idx * 8;
    if (j <= g.kn && c < g.d) {
      cp_async16(t, (j < g.kn ? x + (size_t)j * row : xc) + c);
    } else {
      *reinterpret_cast<uint4*>(t) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// rel rows [i0, i0 + 64) into a core-matrix tile of width KCAT, zero past
// qn and kcat: cp.async pairs where kcat is even (rows 4-byte aligned),
// else plain loads
__device__ __forceinline__ void stage_rel_cm(uint16_t* dst,
                                             const uint16_t* rel,
                                             const Geo& g, int i0) {
  const bool pairs = (g.kcat & 1) == 0;
  for (int idx = threadIdx.x; idx < BM * KCAT / 8; idx += blockDim.x) {
    int r, c;
    chunk_rc<KCAT>(idx, r, c);
    if (pairs) {
      const uint16_t* src = rel + (size_t)(i0 + r) * g.rrow + c;
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        uint16_t* t = dst + idx * 8 + e;
        if (i0 + r < g.qn && c + e < g.kcat) {
          cp_async_pair(t, src + e);
        } else {
          *reinterpret_cast<uint32_t*>(t) = 0u;
        }
      }
      continue;
    }
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (i0 + r < g.qn) {
      const uint16_t* src = rel + (size_t)(i0 + r) * g.rrow;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (c + e < g.kcat) w[e / 2] |= (uint32_t)src[c + e] << (16 * (e & 1));
    }
    *reinterpret_cast<uint4*>(dst + idx * 8) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The 0/1 expander of keys [j0, j0 + 64) as a core-matrix tile of width
// KCAT: row r holds ones at columns t', kt + h', kt + kh + w' of key
// j0 + r; rows of the cls key and of padding are zero (no bias there)
__device__ __forceinline__ void build_expander_cm(uint16_t* dst, int j0,
                                                  const Geo& g) {
  for (int idx = threadIdx.x; idx < BN * KCAT / 8; idx += blockDim.x) {
    int r, c;
    chunk_rc<KCAT>(idx, r, c);
    int a, b, cc;
    axis_cols(j0 + r, g, a, b, cc);
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const int x = c + e;
      const uint32_t lo = (x == a || x == b || x == cc) ? BF16_ONE : 0u;
      const uint32_t hi = (x + 1 == a || x + 1 == b || x + 1 == cc) ? BF16_ONE : 0u;
      w[e / 2] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(dst + idx * 8) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// rows [i0, i0 + R) x columns [j0, j0 + C) of one slice's saved
// probabilities [qn x pld] into an [R x (C + 8)] row-major tile; zero past
// qn and pld
template <int R, int C>
__device__ __forceinline__ void stage_probs(uint16_t* dst, const uint16_t* p,
                                            const Geo& g, int i0, int j0) {
  for (int idx = threadIdx.x; idx < R * (C / 8); idx += blockDim.x) {
    const int r = idx / (C / 8), c = 8 * (idx % (C / 8));
    uint16_t* t = dst + r * (C + 8) + c;
    if (i0 + r < g.qn && j0 + c < g.pld) {
      cp_async16(t, p + (size_t)(i0 + r) * g.pld + j0 + c);
    } else {
      *reinterpret_cast<uint4*>(t) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Issue t = C D^T (the dp product) and, with `logits`, s = A B^T (A, B,
// C, D tiles of width DP) for the 64 x 64 tile of a pass, as one group
template <int DP>
__device__ __forceinline__ void issue_logits_dp(float (&s)[32], float (&t)[32],
                                                const uint16_t* a_s,
                                                const uint16_t* b_s,
                                                const uint16_t* c_s,
                                                const uint16_t* d_s,
                                                bool logits) {
  // defined before the fence: an accumulator a plain instruction defines
  // inside the group would serialize the group's products
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = t[i] = 0.f;
  wgmma_fence();
  if (logits) {
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks)
      wgmma_ss64(s, kmajor<DP>(a_s, ks), kmajor<DP>(b_s, ks), ks > 0);
  }
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks)
    wgmma_ss64(t, kmajor<DP>(c_s, ks), kmajor<DP>(d_s, ks), ks > 0);
  wgmma_commit();
}

// Once that group is complete: s = s scale + R E^T, the bias product (R, E
// of width KCAT) accumulated onto the scaled logits
__device__ __forceinline__ void add_bias(float (&s)[32], const uint16_t* r_s,
                                         const uint16_t* e_s, float scale) {
  fence_regs(s);
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] *= scale;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KCAT / 16; ++ks)
    wgmma_ss64(s, kmajor<KCAT>(r_s, ks), kmajor<KCAT>(e_s, ks), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// acc (64 x N) = A B (first) or += A B for the four k-steps of a 64-deep
// B tile of width N (MN-major), A the register operand rounded from a
// 64 x 64 accumulator.  The first product overwrites acc, so no plain
// instruction defines it (which would serialize the products).
template <int N>
__device__ __forceinline__ void accumulate(float (&acc)[N / 2],
                                           const float (&x)[32],
                                           const uint16_t* b_s, bool first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    acc_to_a(a, x, kk);
    wgmma_rs<N>(acc, a, mnmajor<N>(b_s, kk), kk > 0 || !first);
  }
}

// The query-major kernel: QWG warpgroups of 64 query rows each share the
// key tiles, which every CTA streams twice (sweeps A and B)
constexpr int QWG = 2;
constexpr int QM = QWG * BM;  // query rows of a query-major CTA

// Its shared memory: per warpgroup q, g (width DP) and rel (KCAT)
// resident; two ring stages of k, v (DP), the expander (KCAT) and, for
// kSaved, a p tile (row-major [QM x SP]); QM floats of D.
template <int DP>
__host__ __device__ constexpr int bwd_q_resident() {
  return 2 * 64 * DP + 64 * KCAT;  // elements per warpgroup
}
template <int M, int DP>
__host__ __device__ constexpr size_t bwd_q_stage() {
  return (size_t)(2 * 64 * DP + 64 * KCAT + (M == kSaved ? QM * SP : 0)) * 2;
}
template <int M, int DP>
__host__ __device__ constexpr size_t bwd_q_smem() {
  return (size_t)QWG * bwd_q_resident<DP>() * 2 + 2 * bwd_q_stage<M, DP>() +
         QM * sizeof(float);
}

// Query-major backward: D (stored for the key-major pass), dq and d(rel)
// of QM query rows, for the variant M (enum Bwd).  rowsum holds l
// (kRecompute, kDelta) or lse (kRowMax); o is the saved output (kRowMax,
// kDelta); probs K6sp's probabilities (kSaved: no logits, so no q or rel).
template <int M, int DP>
__global__ void __launch_bounds__(QWG * 128)
mvit_bwd_q_wg(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
              const uint16_t* __restrict__ v, const uint16_t* __restrict__ kc,
              const uint16_t* __restrict__ vc, const uint16_t* __restrict__ rel,
              const float* __restrict__ rowsum, const uint16_t* __restrict__ o,
              const uint16_t* __restrict__ probs,
              const uint16_t* __restrict__ gr, float* __restrict__ delta,
              uint16_t* __restrict__ dq, uint16_t* __restrict__ drel, Geo g,
              float scale) {
  constexpr bool LSE = M == kRowMax, SAVED = M == kSaved;
  constexpr bool D_FROM_O = M == kRowMax || M == kDelta;
  constexpr int RES = bwd_q_resident<DP>();
  constexpr int STAGE = (int)(bwd_q_stage<M, DP>() / 2);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint16_t* base = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* ring = base + QWG * RES;  // stage s at ring + s * STAGE
  float* dd_s = reinterpret_cast<float*>(ring + 2 * STAGE);
  const int wg = threadIdx.x >> 7;
  const uint16_t* q_s = base + wg * RES;  // this warpgroup's rows
  const uint16_t* g_s = q_s + 64 * DP;
  const uint16_t* r_s = g_s + 64 * DP;
  const int bh = blockIdx.y, i0 = blockIdx.x * QM;
  const uint16_t* kp = k_of(k, g, bh);
  const uint16_t* vp = k_of(v, g, bh);
  const uint16_t* kcp = c_of(kc, g, bh);
  const uint16_t* vcp = c_of(vc, g, bh);
  const uint16_t* pp = SAVED ? probs_of(probs, g, bh) : nullptr;
  const int tiles = (g.kn + 1 + BN - 1) / BN;
  const int iters = D_FROM_O ? tiles : 2 * tiles;  // sweep A, then B

  auto stage = [&](int t) {  // key tile t % tiles into ring stage t % 2
    uint16_t* st = ring + (t & 1) * STAGE;
    const int j0 = (t % tiles) * BN;
    // kSaved's sweep A forms no logits and no dq: it needs v and p alone
    if (!SAVED || t >= tiles) {
      stage_keys_cm<DP>(st, kp, kcp, g.row, j0, g);
      build_expander_cm(st + 128 * DP, j0, g);
    }
    stage_keys_cm<DP>(st + 64 * DP, vp, vcp, g.row, j0, g);
    if constexpr (SAVED)
      stage_probs<QM, BN>(st + 128 * DP + 64 * KCAT, pp, g, i0, j0);
  };
  for (int w = 0; w < QWG; ++w) {
    uint16_t* res = base + w * RES;
    if constexpr (!SAVED) {
      stage_cm<DP>(res, q_of(q, g, bh), g.row, i0 + w * BM, g.qn, g.d);
      stage_rel_cm(res + 128 * DP, rel_of(rel, g, bh), g, i0 + w * BM);
    }
    stage_cm<DP>(res + 64 * DP, q_of(gr, g, bh), g.row, i0 + w * BM, g.qn, g.d);
  }
  stage(0);
  cp_async_commit();

  const int tig = threadIdx.x & 3;
  const int pr = wg * BM + acc_row(0);  // this thread's first CTA row
  const int r0 = i0 + pr, r1 = r0 + 8;
  const float* rs = rowsum + (size_t)bh * g.qn;
  // 1 / l, or lse (pad rows: p = 1 either way, and their g is 0)
  float c0 = LSE ? 0.f : 1.f, c1 = c0;
  if constexpr (!SAVED) {
    if (r0 < g.qn) c0 = LSE ? rs[r0] : 1.f / rs[r0];
    if (r1 < g.qn) c1 = LSE ? rs[r1] : 1.f / rs[r1];
  }
  float d0 = 0.f, d1 = 0.f;
  if constexpr (D_FROM_O) {
    // D_i = sum_e g_ie o_ie, one thread per row, read from memory
    if (threadIdx.x < QM) {
      float acc = 0.f;
      const int i = i0 + threadIdx.x;
      if (i < g.qn) {
        const uint16_t* gi = q_of(gr, g, bh) + (size_t)i * g.row;
        const uint16_t* oi = q_of(o, g, bh) + (size_t)i * g.row;
        for (int e = 0; e < g.d; e += 2) {
          const float2 a = load_bf16x2(gi + e), b = load_bf16x2(oi + e);
          acc = fmaf(a.x, b.x, acc);
          acc = fmaf(a.y, b.y, acc);
        }
      }
      dd_s[threadIdx.x] = acc;
    }
    __syncthreads();
    d0 = dd_s[pr];
    d1 = dd_s[pr + 8];
  }
  float acc_q[DP / 2], acc_r[KCAT / 2];  // written by the first sweep B tile
  float* dl = delta + (size_t)bh * g.qn;

  // The accumulate group of tile t - 1 runs on while tile t's copies are
  // awaited; once every warpgroup has seen it complete, its ring stage
  // takes tile t + 1, which loads under the whole of tile t.
  for (int t = 0; t < iters; ++t) {
    wgmma_wait<0>();
    cp_async_wait_pending(0);
    fence_async_smem();
    __syncthreads();
    if (t + 1 < iters) {
      stage(t + 1);
      cp_async_commit();
    }
    const bool sweep_a = !D_FROM_O && t < tiles;
    if (!D_FROM_O && t == tiles) {  // sweep A is done: D, for the key pass
      d0 = quad_sum(d0);
      d1 = quad_sum(d1);
      if (tig == 0) {
        if (r0 < g.qn) dl[r0] = d0;
        if (r1 < g.qn) dl[r1] = d1;
      }
    }
    const uint16_t* st = ring + (t & 1) * STAGE;
    const uint16_t* k_s = st;
    const uint16_t* v_s = st + 64 * DP;
    const uint16_t* e_s = st + 128 * DP;
    const int j0 = (t % tiles) * BN;
    float s[32], dp[32];
    issue_logits_dp<DP>(s, dp, q_s, k_s, g_s, v_s, !SAVED);
    wgmma_wait<0>();
    fence_regs(dp);
    if constexpr (!SAVED) add_bias(s, r_s, e_s, scale);
    // p in place of s
    if constexpr (SAVED) {
      const uint16_t* p_s = e_s + 64 * KCAT;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 x = load_bf16x2(p_s + (pr + 8 * h) * SP + acc_col(j, 0));
          s[4 * j + 2 * h] = x.x;
          s[4 * j + 2 * h + 1] = x.y;
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float c = e < 2 ? c0 : c1, x = s[4 * j + e];
          s[4 * j + e] =
              j0 + acc_col(j, e) > g.kn ? 0.f
              : LSE ? exp2f((x - c) * LOG2E)
                    : exp2f(fminf(x, CLAMP_HI) * LOG2E) * c;
        }
    }
    if (sweep_a) {  // D_i = sum_j dp_ij p_ij
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        d0 += dp[4 * j] * s[4 * j] + dp[4 * j + 1] * s[4 * j + 1];
        d1 += dp[4 * j + 2] * s[4 * j + 2] + dp[4 * j + 3] * s[4 * j + 3];
      }
    } else {
      // ds = p (dp - D); dq += ds k, d(rel) += ds E^T
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= dp[i] - ((i & 2) ? d1 : d0);
      const bool first = t == iters - tiles;
      wgmma_fence();
      accumulate<DP>(acc_q, s, k_s, first);
      accumulate<KCAT>(acc_r, s, e_s, first);
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
  fence_regs(acc_q);
  fence_regs(acc_r);
  if constexpr (D_FROM_O) {
    if (tig == 0) {
      if (r0 < g.qn) dl[r0] = d0;
      if (r1 < g.qn) dl[r1] = d1;
    }
  }
  uint16_t* dqp = q_of(dq, g, bh);
  uint16_t* drp = rel_of(drel, g, bh);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= g.qn) continue;
    uint16_t* dst = dqp + (size_t)r * g.row;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < g.d)
        *reinterpret_cast<uint32_t*>(dst + acc_col(j, 0)) = pack_bf16x2(
            acc_q[4 * j + 2 * half] * scale, acc_q[4 * j + 2 * half + 1] * scale);
    uint16_t* rdst = drp + (size_t)r * g.rrow;
#pragma unroll
    for (int j = 0; j < KCAT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = acc_col(j, e);
        if (c < g.kcat) {
          const __nv_bfloat16 x = __float2bfloat16(acc_r[4 * j + 2 * half + e]);
          rdst[c] = *reinterpret_cast<const uint16_t*>(&x);
        }
      }
  }
}

// The key-major kernel: KWG warpgroups of 64 keys each share the query
// tiles
constexpr int KWG = 2;
constexpr int KM = KWG * BN;  // keys of a key-major CTA
constexpr int SPK = KM + 8;   // smem row of its saved-probability tile

// Its shared memory: per warpgroup k, v (width DP) and the expander (KCAT)
// resident; two ring stages of q, g (DP), rel (KCAT), for kSaved a p tile
// ([64 x SPK]), and 1 / l (or lse) and D of the query tile.
template <int DP>
__host__ __device__ constexpr int bwd_k_resident() {
  return 2 * 64 * DP + 64 * KCAT;  // elements per warpgroup
}
template <int M, int DP>
__host__ __device__ constexpr size_t bwd_k_stage() {
  return (size_t)(2 * 64 * DP + 64 * KCAT + (M == kSaved ? 64 * SPK : 0)) * 2 +
         2 * BM * sizeof(float);
}
template <int M, int DP>
__host__ __device__ constexpr size_t bwd_k_smem() {
  return (size_t)KWG * bwd_k_resident<DP>() * 2 + 2 * bwd_k_stage<M, DP>();
}

// Key-major backward: the CTA (blockIdx.x, blockIdx.y, blockIdx.z) owns
// keys [KM x, KM x + KM) of [body; cls] of slice z, 64 per warpgroup, and
// walks query chunk y of `splits` (the query tiles split evenly, the last
// chunk shorter), summing dk and dv in registers.  With one chunk it
// writes the bf16 gradients; with several, fp32 partials [2][splits][BH]
// [kN + 1][d] to `work` (dk unscaled, then dv), which mvit_bwd_reduce sums.
template <int M, int DP>
__global__ void __launch_bounds__(KWG * 128)
mvit_bwd_k_wg(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
              const uint16_t* __restrict__ v, const uint16_t* __restrict__ kc,
              const uint16_t* __restrict__ vc, const uint16_t* __restrict__ rel,
              const float* __restrict__ rowsum,
              const uint16_t* __restrict__ probs,
              const uint16_t* __restrict__ gr, const float* __restrict__ delta,
              uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
              uint16_t* __restrict__ dkc, uint16_t* __restrict__ dvc,
              float* __restrict__ work, int splits, Geo g, float scale) {
  constexpr bool LSE = M == kRowMax, SAVED = M == kSaved;
  constexpr int RES = bwd_k_resident<DP>();
  constexpr int STAGE = (int)(bwd_k_stage<M, DP>() / 2);
  constexpr int PS = SAVED ? 64 * SPK : 0;  // the p tile's elements
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint16_t* base = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* ring = base + KWG * RES;
  const int wg = threadIdx.x >> 7;
  const uint16_t* k_s = base + wg * RES;  // this warpgroup's keys
  const uint16_t* v_s = k_s + 64 * DP;
  const uint16_t* e_s = v_s + 64 * DP;
  const int jc = blockIdx.x * KM, split = blockIdx.y, bh = blockIdx.z;
  const int j0 = jc + wg * BN;
  const int qtiles = (g.qn + BM - 1) / BM;
  const int per = (qtiles + splits - 1) / splits;
  const int t0 = min(qtiles, split * per), t1 = min(qtiles, t0 + per);
  const uint16_t* qp = q_of(q, g, bh);
  const uint16_t* gp = q_of(gr, g, bh);
  const uint16_t* relp = rel_of(rel, g, bh);
  const uint16_t* pp = SAVED ? probs_of(probs, g, bh) : nullptr;
  const float* rs = rowsum + (size_t)bh * g.qn;
  const float* dl = delta + (size_t)bh * g.qn;

  // the row statistics of query tile t, in this thread's registers (the
  // first BM threads: 1 / l or lse, and D of one row; padding rows: l = 1
  // (lse = 0) and D = 0, so p = 1, or the zero of a staged p row, and with
  // q = g = rel = 0 there ds = 0)
  float stat_l = 0.f, stat_d = 0.f;
  auto load_stats = [&](int t) {
    const int i = t * BM + threadIdx.x;
    if (threadIdx.x >= BM) return;
    stat_l = LSE ? 0.f : 1.f;
    stat_d = 0.f;
    if (i < g.qn) {
      if constexpr (!SAVED) stat_l = LSE ? rs[i] : 1.f / rs[i];
      stat_d = dl[i];
    }
  };
  auto store_stats = [&](int t) {
    float* li_s = reinterpret_cast<float*>(ring + (t & 1) * STAGE + 128 * DP +
                                           64 * KCAT + PS);
    if (threadIdx.x < BM) {
      li_s[threadIdx.x] = stat_l;
      li_s[BM + threadIdx.x] = stat_d;
    }
  };
  auto stage = [&](int t) {  // query tile t into ring stage t % 2
    uint16_t* st = ring + (t & 1) * STAGE;
    const int i0 = t * BM;
    stage_cm<DP>(st, qp, g.row, i0, g.qn, g.d);
    stage_cm<DP>(st + 64 * DP, gp, g.row, i0, g.qn, g.d);
    if constexpr (SAVED) {
      stage_probs<BM, KM>(st + 128 * DP + 64 * KCAT, pp, g, i0, jc);
    } else {
      stage_rel_cm(st + 128 * DP, relp, g, i0);
    }
  };
  for (int w = 0; w < KWG; ++w) {
    uint16_t* res = base + w * RES;
    stage_keys_cm<DP>(res, k_of(k, g, bh), c_of(kc, g, bh), g.row, jc + w * BN, g);
    stage_keys_cm<DP>(res + 64 * DP, k_of(v, g, bh), c_of(vc, g, bh), g.row,
                      jc + w * BN, g);
    build_expander_cm(res + 128 * DP, jc + w * BN, g);
  }
  if (t0 < t1) {
    stage(t0);
    load_stats(t0);
    store_stats(t0);
  }
  cp_async_commit();

  float acc_k[DP / 2], acc_v[DP / 2];  // written by the chunk's first tile
  // As in the query-major kernel: the accumulate group of tile t - 1 runs
  // on while tile t's copies are awaited, then tile t + 1 loads under the
  // whole of tile t (its row statistics through registers, stored once
  // tile t's products are issued).
  for (int t = t0; t < t1; ++t) {
    wgmma_wait<0>();
    cp_async_wait_pending(0);
    fence_async_smem();
    __syncthreads();
    if (t + 1 < t1) {
      stage(t + 1);
      cp_async_commit();
      load_stats(t + 1);
    }
    const uint16_t* st = ring + (t & 1) * STAGE;
    const uint16_t* q_s = st;
    const uint16_t* g_s = st + 64 * DP;
    const uint16_t* r_s = st + 128 * DP;
    const uint16_t* p_s = r_s + 64 * KCAT;
    const float* li_s = reinterpret_cast<const float*>(p_s + PS);
    const float* d_s = li_s + BM;
    // s^T and dp^T = v g^T: rows = keys, columns = the tile's queries
    float s[32], dp[32];
    issue_logits_dp<DP>(s, dp, k_s, q_s, v_s, g_s, !SAVED);
    wgmma_wait<0>();
    fence_regs(dp);
    if constexpr (!SAVED) add_bias(s, e_s, r_s, scale);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = acc_col(j, e);
        float p;
        if constexpr (SAVED) {
          const uint16_t x = p_s[i * SPK + wg * BN + acc_row(e)];
          p = __uint_as_float((uint32_t)x << 16);
        } else if constexpr (LSE) {
          p = exp2f((s[4 * j + e] - li_s[i]) * LOG2E);
        } else {
          p = exp2f(fminf(s[4 * j + e], CLAMP_HI) * LOG2E) * li_s[i];
        }
        s[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - d_s[i]);  // ds^T
      }
    wgmma_fence();
    accumulate<DP>(acc_k, dp, q_s, t == t0);
    accumulate<DP>(acc_v, s, g_s, t == t0);
    wgmma_commit();
    if (t + 1 < t1) store_stats(t + 1);  // its stage was last read by tile t - 1
  }
  wgmma_wait<0>();
  fence_regs(acc_k);
  fence_regs(acc_v);
  if (t0 >= t1) {  // an empty chunk: its partial sums are zero
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  }
  cp_async_wait_all();  // an empty chunk still staged k and v
  const int bhs = gridDim.z;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = j0 + acc_row(2 * half);
    if (j > g.kn) continue;
    if (splits == 1) {
      uint16_t* kd = j < g.kn ? k_of(dk, g, bh) + (size_t)j * g.row : c_of(dkc, g, bh);
      uint16_t* vd = j < g.kn ? k_of(dv, g, bh) + (size_t)j * g.row : c_of(dvc, g, bh);
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) {
        if (8 * c >= g.d) continue;
        const int col = acc_col(c, 0);
        *reinterpret_cast<uint32_t*>(kd + col) = pack_bf16x2(
            acc_k[4 * c + 2 * half] * scale, acc_k[4 * c + 2 * half + 1] * scale);
        *reinterpret_cast<uint32_t*>(vd + col) =
            pack_bf16x2(acc_v[4 * c + 2 * half], acc_v[4 * c + 2 * half + 1]);
      }
    } else {
      const size_t plane = (size_t)splits * bhs * (g.kn + 1) * g.d;
      float* wk = work + (((size_t)split * bhs + bh) * (g.kn + 1) + j) * g.d;
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) {
        if (8 * c >= g.d) continue;
        const int col = acc_col(c, 0);
        *reinterpret_cast<float2*>(wk + col) =
            make_float2(acc_k[4 * c + 2 * half], acc_k[4 * c + 2 * half + 1]);
        *reinterpret_cast<float2*>(wk + plane + col) =
            make_float2(acc_v[4 * c + 2 * half], acc_v[4 * c + 2 * half + 1]);
      }
    }
  }
}

// The key-major pass's partials summed over the splits in order: one
// thread per 4 columns of a row of dk or dv (dk scaled), written as bf16
// to dk / dv (body keys) or dkc / dvc (the cls key).
__global__ void mvit_bwd_reduce(const float* __restrict__ work, int splits,
                                int bhs, uint16_t* __restrict__ dk,
                                uint16_t* __restrict__ dv,
                                uint16_t* __restrict__ dkc,
                                uint16_t* __restrict__ dvc, Geo g,
                                float scale) {
  const int q4 = g.d / 4;
  const size_t rows = (size_t)bhs * (g.kn + 1);
  const size_t n = 2 * rows * q4;
  const size_t plane = (size_t)splits * rows * g.d;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int c = 4 * (int)(idx % q4);
    const size_t rr = (idx / q4) % rows;
    const int which = (int)(idx / q4 / rows);  // 0: dk, 1: dv
    const int bh = (int)(rr / (g.kn + 1)), j = (int)(rr % (g.kn + 1));
    const float* src = work + which * plane + rr * g.d + c;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(src + (size_t)s * rows * g.d);
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    const float f = which ? 1.f : scale;
    uint16_t* base = which ? (j < g.kn ? k_of(dv, g, bh) : c_of(dvc, g, bh))
                           : (j < g.kn ? k_of(dk, g, bh) : c_of(dkc, g, bh));
    uint16_t* dst = base + (j < g.kn ? (size_t)j * g.row : 0) + c;
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(pack_bf16x2(a.x * f, a.y * f), pack_bf16x2(a.z * f, a.w * f));
  }
}

// ------------------------------------------ scalar kernels (any head dim)

// The fp32 kernels, and the bf16 ones at the head dims the tensor-core
// kernels do not take (d not a multiple of 8, or d > 128): one warp per
// query or key row, fp32 arithmetic with the bf16 roundings of the
// tensor-core path (p, or K7's unnormalised e, before P V; ds before the
// dq, dk and d(rel) sums; p before dv).  A head of d columns is split into
// ceil(d / GW) column groups along grid z: each CTA forms the logits over
// all d columns and writes its group's columns of o (dq, dk, dv); group 0
// alone writes l or lse, the saved probabilities, D and d(rel).
constexpr int GW = 128;     // columns of a group
constexpr int U = GW / 32;  // a lane's columns lane + 32 u of its group

__device__ __forceinline__ int groups_of(int d) { return (d + GW - 1) / GW; }

// key row j of [body; cls]
template <typename T>
__device__ __forceinline__ const T* key_row(const T* x, const T* xc, int j,
                                            const Geo& g) {
  return j < g.kn ? x + (size_t)j * g.row : xc;
}

template <typename T>
__device__ __forceinline__ float dot(const T* a, const T* b, int d) {
  float s = 0.f;
#pragma unroll 8
  for (int e = 0; e < d; ++e) s = fmaf(load1(a + e), load1(b + e), s);
  return s;
}

// bias of key j < kn on the rel row r: ((rel_t + rel_h) + rel_w)
template <typename T>
__device__ __forceinline__ float bias_of(const T* r, int j, const Geo& g) {
  const int hw = g.kh * g.kw;
  return (load1(r + j / hw) + load1(r + g.kt + (j / g.kw) % g.kh)) +
         load1(r + g.kt + g.kh + j % g.kw);
}

// s_ij of query row qi (its rel row ri) and key row j
template <typename T>
__device__ __forceinline__ float logit(const T* qi, const T* ri, const T* kj,
                                       int j, const Geo& g, float scale) {
  const float s = dot(qi, kj, g.d) * scale;
  return j < g.kn ? s + bias_of(ri, j, g) : s;
}

// x rounded as the tensor-core path rounds an operand of type T
template <typename T>
__device__ __forceinline__ float op(float x) {
  return round_to(x, static_cast<const T*>(nullptr));
}

// Forward: one warp per query row; shared memory holds the warp's row of
// exponentials [kn + 1].  SAVE (K6sp) also writes p to probs.
template <typename T, bool SAVE>
__global__ void __launch_bounds__(WARPS * 32)
mvit_fwd_scalar(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ kc,
                const T* __restrict__ vc, const T* __restrict__ rel,
                T* __restrict__ out, float* __restrict__ rowsum,
                T* __restrict__ probs, Geo g, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, i = blockIdx.x * WARPS + warp;
  const int c0 = blockIdx.z * GW;  // this CTA's column group
  if (i >= g.qn) return;  // warp-uniform; no block barrier below
  float* e_w = reinterpret_cast<float*>(smem_raw) + (size_t)warp * (g.kn + 1);
  const T* qi = q_of(q, g, bh) + (size_t)i * g.row;
  const T* ri = rel_of(rel, g, bh) + (size_t)i * g.rrow;
  const T* kp = k_of(k, g, bh);
  const T* kcp = c_of(kc, g, bh);
  float part = 0.f;
  for (int j = lane; j <= g.kn; j += 32) {
    const float e =
        expf(fminf(logit(qi, ri, key_row(kp, kcp, j, g), j, g, scale), CLAMP_HI));
    e_w[j] = e;
    part += e;
  }
  const float l = warp_sum(part);
  if (SAVE && c0 == 0) {
    T* pi = probs_of(probs, g, bh) + (size_t)i * g.pld;
    for (int j = lane; j < g.pld; j += 32) store1(pi + j, j <= g.kn ? e_w[j] / l : 0.f);
  }
  __syncwarp();
  const T* vp = k_of(v, g, bh);
  const T* vcp = c_of(vc, g, bh);
  float o[U] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j <= g.kn; ++j) {
    const float p = op<T>(e_w[j] / l);
    const T* vj = key_row(vp, vcp, j, g) + c0;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + lane + 32 * u < g.d) o[u] = fmaf(p, load1(vj + lane + 32 * u), o[u]);
  }
  T* oi = q_of(out, g, bh) + (size_t)i * g.row + c0;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (c0 + lane + 32 * u < g.d) store1(oi + lane + 32 * u, o[u]);
  if (c0 == 0 && lane == 0) rowsum[(size_t)bh * g.qn + i] = l;
}

// K7f: one warp per query row; shared memory holds the warp's logits, then
// e = exp(s - m) with m the row max; o = (sum_j e_j v_j) / l.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
mvit_fwd_kt_scalar(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ kc,
                   const T* __restrict__ vc, const T* __restrict__ rel,
                   T* __restrict__ out, float* __restrict__ lse, Geo g,
                   float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, i = blockIdx.x * WARPS + warp;
  const int c0 = blockIdx.z * GW;
  if (i >= g.qn) return;  // warp-uniform; no block barrier below
  float* e_w = reinterpret_cast<float*>(smem_raw) + (size_t)warp * (g.kn + 1);
  const T* qi = q_of(q, g, bh) + (size_t)i * g.row;
  const T* ri = rel_of(rel, g, bh) + (size_t)i * g.rrow;
  const T* kp = k_of(k, g, bh);
  const T* kcp = c_of(kc, g, bh);
  float mx = MASKED;
  for (int j = lane; j <= g.kn; j += 32) {
    const float s = logit(qi, ri, key_row(kp, kcp, j, g), j, g, scale);
    e_w[j] = s;
    mx = fmaxf(mx, s);
  }
  const float m = warp_max(mx);
  float part = 0.f;
  for (int j = lane; j <= g.kn; j += 32) {
    const float e = expf(e_w[j] - m);
    e_w[j] = e;
    part += e;
  }
  const float l = warp_sum(part);
  __syncwarp();
  const T* vp = k_of(v, g, bh);
  const T* vcp = c_of(vc, g, bh);
  float o[U] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j <= g.kn; ++j) {
    const float e = op<T>(e_w[j]);
    const T* vj = key_row(vp, vcp, j, g) + c0;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + lane + 32 * u < g.d) o[u] = fmaf(e, load1(vj + lane + 32 * u), o[u]);
  }
  T* oi = q_of(out, g, bh) + (size_t)i * g.row + c0;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (c0 + lane + 32 * u < g.d) store1(oi + lane + 32 * u, o[u] / l);
  if (c0 == 0 && lane == 0) lse[(size_t)bh * g.qn + i] = m + logf(l);
}

// Query-major backward: one warp per query row; per warp two rows [kn + 1]
// of shared memory (p, then ds rounded; and dp).  M as in mvit_bwd_q_wg.
template <typename T, int M>
__global__ void __launch_bounds__(WARPS * 32)
mvit_bwd_q_scalar(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ kc,
                  const T* __restrict__ vc, const T* __restrict__ rel,
                  const float* __restrict__ rowsum, const T* __restrict__ o,
                  const T* __restrict__ probs, const T* __restrict__ gr,
                  float* __restrict__ delta, T* __restrict__ dq,
                  T* __restrict__ drel, Geo g, float scale) {
  constexpr bool LSE = M == kRowMax, SAVED = M == kSaved;
  constexpr bool D_FROM_O = M == kRowMax || M == kDelta;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, i = blockIdx.x * WARPS + warp;
  const int c0 = blockIdx.z * GW;
  if (i >= g.qn) return;
  float* p_w = reinterpret_cast<float*>(smem_raw) + (size_t)warp * 2 * (g.kn + 1);
  float* dp_w = p_w + g.kn + 1;
  const T* qi = q_of(q, g, bh) + (size_t)i * g.row;
  const T* gi = q_of(gr, g, bh) + (size_t)i * g.row;
  const T* ri = rel_of(rel, g, bh) + (size_t)i * g.rrow;
  const T* kp = k_of(k, g, bh);
  const T* kcp = c_of(kc, g, bh);
  const T* vp = k_of(v, g, bh);
  const T* vcp = c_of(vc, g, bh);
  const float l = SAVED ? 1.f : rowsum[(size_t)bh * g.qn + i];  // K7: lse
  const T* pi = SAVED ? probs_of(probs, g, bh) + (size_t)i * g.pld : nullptr;
  float part = 0.f;
  for (int j = lane; j <= g.kn; j += 32) {
    float p;
    if constexpr (SAVED) {
      p = load1(pi + j);
    } else {
      const float s = logit(qi, ri, key_row(kp, kcp, j, g), j, g, scale);
      p = LSE ? expf(s - l) : expf(fminf(s, CLAMP_HI)) / l;
    }
    const float dp = dot(gi, key_row(vp, vcp, j, g), g.d);
    p_w[j] = p;
    dp_w[j] = dp;
    part = fmaf(dp, p, part);
  }
  const float Dl = D_FROM_O ? dot(gi, q_of(o, g, bh) + (size_t)i * g.row, g.d)
                            : warp_sum(part);
  if (c0 == 0 && lane == 0) delta[(size_t)bh * g.qn + i] = Dl;
  for (int j = lane; j <= g.kn; j += 32) p_w[j] = op<T>(p_w[j] * (dp_w[j] - Dl));
  __syncwarp();
  float a[U] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j <= g.kn; ++j) {
    const float ds = p_w[j];
    const T* kj = key_row(kp, kcp, j, g) + c0;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + lane + 32 * u < g.d) a[u] = fmaf(ds, load1(kj + lane + 32 * u), a[u]);
  }
  T* dqi = q_of(dq, g, bh) + (size_t)i * g.row + c0;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (c0 + lane + 32 * u < g.d) store1(dqi + lane + 32 * u, a[u] * scale);
  if (c0 != 0) return;
  // d(rel): lane c sums ds over the body keys on its axis entry, j rising
  T* dri = rel_of(drel, g, bh) + (size_t)i * g.rrow;
  const int hw = g.kh * g.kw;
  for (int c = lane; c < g.kcat; c += 32) {
    float s = 0.f;
    for (int j = 0; j < g.kn; ++j) {
      const bool on = c < g.kt ? j / hw == c
                    : c < g.kt + g.kh ? (j / g.kw) % g.kh == c - g.kt
                                      : j % g.kw == c - g.kt - g.kh;
      if (on) s += p_w[j];
    }
    store1(dri + c, s);
  }
}

// Key-major backward: one warp per key row of [body; cls]; lanes take 32
// queries at a time, then sum their products over them.  M as in
// mvit_bwd_q_wg.
template <typename T, int M>
__global__ void __launch_bounds__(WARPS * 32)
mvit_bwd_k_scalar(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ kc,
                  const T* __restrict__ vc, const T* __restrict__ rel,
                  const float* __restrict__ rowsum,
                  const T* __restrict__ probs, const T* __restrict__ gr,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, T* __restrict__ dkc,
                  T* __restrict__ dvc, Geo g, float scale) {
  constexpr bool LSE = M == kRowMax, SAVED = M == kSaved;
  __shared__ float p_s[WARPS][32], ds_s[WARPS][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, j = blockIdx.x * WARPS + warp;
  const int c0 = blockIdx.z * GW;
  if (j > g.kn) return;
  const T* kj = key_row(k_of(k, g, bh), c_of(kc, g, bh), j, g);
  const T* vj = key_row(k_of(v, g, bh), c_of(vc, g, bh), j, g);
  const T* qp = q_of(q, g, bh);
  const T* gp = q_of(gr, g, bh);
  const T* relp = rel_of(rel, g, bh);
  const float* rs = rowsum + (size_t)bh * g.qn;
  const float* dl = delta + (size_t)bh * g.qn;
  float ak[U] = {0.f, 0.f, 0.f, 0.f}, av[U] = {0.f, 0.f, 0.f, 0.f};
  for (int i0 = 0; i0 < g.qn; i0 += 32) {
    const int i = i0 + lane;
    float p = 0.f, ds = 0.f;
    if (i < g.qn) {
      if constexpr (SAVED) {
        p = load1(probs_of(probs, g, bh) + (size_t)i * g.pld + j);
      } else {
        const T* qi = qp + (size_t)i * g.row;
        const float s = logit(qi, relp + (size_t)i * g.rrow, kj, j, g, scale);
        p = LSE ? expf(s - rs[i]) : expf(fminf(s, CLAMP_HI)) / rs[i];
      }
      ds = p * (dot(gp + (size_t)i * g.row, vj, g.d) - dl[i]);
    }
    p_s[warp][lane] = op<T>(p);
    ds_s[warp][lane] = op<T>(ds);
    __syncwarp();
    const int n = min(32, g.qn - i0);
    for (int t = 0; t < n; ++t) {
      const T* qi = qp + (size_t)(i0 + t) * g.row + c0;
      const T* gi = gp + (size_t)(i0 + t) * g.row + c0;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (c0 + lane + 32 * u >= g.d) continue;
        ak[u] = fmaf(ds_s[warp][t], load1(qi + lane + 32 * u), ak[u]);
        av[u] = fmaf(p_s[warp][t], load1(gi + lane + 32 * u), av[u]);
      }
    }
    __syncwarp();
  }
  T* kd = (j < g.kn ? k_of(dk, g, bh) + (size_t)j * g.row : c_of(dkc, g, bh)) + c0;
  T* vd = (j < g.kn ? k_of(dv, g, bh) + (size_t)j * g.row : c_of(dvc, g, bh)) + c0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (c0 + lane + 32 * u >= g.d) continue;
    store1(kd + lane + 32 * u, ak[u] * scale);
    store1(vd + lane + 32 * u, av[u]);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

bool valid(int b, int heads, int qn, int kn, int kt, int kh, int kw, int d) {
  return b > 0 && heads > 0 && qn > 0 && kn > 0 && kt > 0 && kh > 0 &&
         kw > 0 && kt * kh * kw == kn && kt + kh + kw <= KCAT &&
         b * heads <= 65535 && d >= 1 && (d + GW - 1) / GW <= 65535;
}

// whether the bf16 tensor-core kernels take head dim d
bool on_tensor_cores(int d) { return d % 8 == 0 && d <= MAX_D; }

// f(width) for the bf16 tile width of head dim d: the narrowest of 64, 96
// and 128 that holds it
template <typename F>
int with_width(int d, F f) {
  if (d <= 64) return f(std::integral_constant<int, 64>{});
  if (d <= 96) return f(std::integral_constant<int, 96>{});
  return f(std::integral_constant<int, 128>{});
}

// The scalar forward of element type T: K5/K6 (KT = false; with SAVE,
// K6sp) or K7 (KT = true)
template <typename T, bool KT, bool SAVE>
int launch_fwd_scalar(const void* q, const void* k, const void* v,
                      const void* kc, const void* vc, const void* rel,
                      void* out, void* stats, void* probs, int bhs,
                      const Geo& g, float scale, cudaStream_t st) {
  const size_t smem = (size_t)WARPS * (g.kn + 1) * sizeof(float);
  const dim3 grid((g.qn + WARPS - 1) / WARPS, bhs, (g.d + GW - 1) / GW);
  if constexpr (KT) {
    cudaError_t err = set_smem(mvit_fwd_kt_scalar<T>, smem);
    if (err != cudaSuccess) return (int)err;
    mvit_fwd_kt_scalar<T><<<grid, WARPS * 32, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(kc),
        static_cast<const T*>(vc), static_cast<const T*>(rel),
        static_cast<T*>(out), static_cast<float*>(stats), g, scale);
  } else {
    cudaError_t err = set_smem(mvit_fwd_scalar<T, SAVE>, smem);
    if (err != cudaSuccess) return (int)err;
    mvit_fwd_scalar<T, SAVE><<<grid, WARPS * 32, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(kc),
        static_cast<const T*>(vc), static_cast<const T*>(rel),
        static_cast<T*>(out), static_cast<float*>(stats),
        static_cast<T*>(probs), g, scale);
  }
  return (int)cudaGetLastError();
}

// The forward of K5/K6 (KT = false: out and the row sums l; with SAVE,
// K6sp, also probs) or of K7 (KT = true: out and lse).
template <bool KT, bool SAVE>
int launch_fwd(const void* q, const void* k, const void* v, const void* kc,
               const void* vc, const void* rel, void* out, void* stats,
               void* probs, int b, int heads, int qn, int kn, int kt, int kh,
               int kw, int d, int dtype, float scale, void* stream) {
  if (!valid(b, heads, qn, kn, kt, kh, kw, d) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geo g = make_geo(heads, qn, kn, kt, kh, kw, d);
  if (dtype == 0)
    return launch_fwd_scalar<float, KT, SAVE>(q, k, v, kc, vc, rel, out, stats,
                                              probs, b * heads, g, scale, st);
  if (!on_tensor_cores(d))
    return launch_fwd_scalar<__nv_bfloat16, KT, SAVE>(
        q, k, v, kc, vc, rel, out, stats, probs, b * heads, g, scale, st);
  using u16 = uint16_t;
  const dim3 grid((qn + BM - 1) / BM, b * heads);
  auto run = [&](auto w, auto exact) {
    constexpr int DP = decltype(w)::value;
    constexpr bool EXACT = decltype(exact)::value;
    constexpr size_t smem = fwd_smem<DP>();
    if constexpr (KT) {
      cudaError_t err = set_smem(mvit_fwd_kt_mma<DP, EXACT>, smem);
      if (err != cudaSuccess) return (int)err;
      mvit_fwd_kt_mma<DP, EXACT><<<grid, WARPS * 32, smem, st>>>(
          static_cast<const u16*>(q), static_cast<const u16*>(k),
          static_cast<const u16*>(v), static_cast<const u16*>(kc),
          static_cast<const u16*>(vc), static_cast<const u16*>(rel),
          static_cast<u16*>(out), static_cast<float*>(stats), g, scale);
    } else {
      cudaError_t err = set_smem(mvit_fwd_mma<SAVE, DP, EXACT>, smem);
      if (err != cudaSuccess) return (int)err;
      mvit_fwd_mma<SAVE, DP, EXACT><<<grid, WARPS * 32, smem, st>>>(
          static_cast<const u16*>(q), static_cast<const u16*>(k),
          static_cast<const u16*>(v), static_cast<const u16*>(kc),
          static_cast<const u16*>(vc), static_cast<const u16*>(rel),
          static_cast<u16*>(out), static_cast<float*>(stats),
          static_cast<u16*>(probs), g, scale);
    }
    return (int)cudaGetLastError();
  };
  return with_width(d, [&](auto w) {
    return d == decltype(w)::value ? run(w, std::true_type{})
                                   : run(w, std::false_type{});
  });
}

// The pointers of one backward call
struct BwdArgs {
  const void *q, *k, *v, *kc, *vc, *rel, *o, *stats, *probs, *g;
  void *delta, *dq, *dk, *dv, *dkc, *dvc, *drel;
  float* work;  // [2][splits][b * heads][kn + 1][d] fp32, splits > 1
};

// The bf16 backward of variant M at tile width DP: the query-major pass,
// then the key-major pass and, with splits > 1, its reduction.
template <int M, int DP>
int launch_bwd_wg(const BwdArgs& a, int bhs, const Geo& geo, int splits,
                  float scale, cudaStream_t st) {
  using u16 = uint16_t;
  constexpr size_t sq = bwd_q_smem<M, DP>(), sk = bwd_k_smem<M, DP>();
  cudaError_t err = set_smem(mvit_bwd_q_wg<M, DP>, sq);
  if (err == cudaSuccess) err = set_smem(mvit_bwd_k_wg<M, DP>, sk);
  if (err != cudaSuccess) return (int)err;
  mvit_bwd_q_wg<M, DP><<<dim3((geo.qn + QM - 1) / QM, bhs), QWG * 128, sq,
                         st>>>(
      static_cast<const u16*>(a.q), static_cast<const u16*>(a.k),
      static_cast<const u16*>(a.v), static_cast<const u16*>(a.kc),
      static_cast<const u16*>(a.vc), static_cast<const u16*>(a.rel),
      static_cast<const float*>(a.stats), static_cast<const u16*>(a.o),
      static_cast<const u16*>(a.probs), static_cast<const u16*>(a.g),
      static_cast<float*>(a.delta), static_cast<u16*>(a.dq),
      static_cast<u16*>(a.drel), geo, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mvit_bwd_k_wg<M, DP><<<dim3((geo.kn + 1 + KM - 1) / KM, splits, bhs),
                         KWG * 128, sk, st>>>(
      static_cast<const u16*>(a.q), static_cast<const u16*>(a.k),
      static_cast<const u16*>(a.v), static_cast<const u16*>(a.kc),
      static_cast<const u16*>(a.vc), static_cast<const u16*>(a.rel),
      static_cast<const float*>(a.stats), static_cast<const u16*>(a.probs),
      static_cast<const u16*>(a.g), static_cast<const float*>(a.delta),
      static_cast<u16*>(a.dk), static_cast<u16*>(a.dv),
      static_cast<u16*>(a.dkc), static_cast<u16*>(a.dvc), a.work, splits,
      geo, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t n = (size_t)2 * bhs * (geo.kn + 1) * (geo.d / 4);
  const unsigned blocks = (unsigned)std::min<size_t>((n + 255) / 256, 4096);
  mvit_bwd_reduce<<<blocks, 256, 0, st>>>(
      a.work, splits, bhs, static_cast<u16*>(a.dk), static_cast<u16*>(a.dv),
      static_cast<u16*>(a.dkc), static_cast<u16*>(a.dvc), geo, scale);
  return (int)cudaGetLastError();
}

// The scalar backward of element type T, variant M: the query-major and
// the key-major kernel, each over the head's column groups
template <typename T, int M>
int launch_bwd_scalar(const BwdArgs& a, int bhs, const Geo& geo, float scale,
                      cudaStream_t st) {
  const int groups = (geo.d + GW - 1) / GW;
  const size_t smem = (size_t)WARPS * 2 * (geo.kn + 1) * sizeof(float);
  cudaError_t err = set_smem(mvit_bwd_q_scalar<T, M>, smem);
  if (err != cudaSuccess) return (int)err;
  mvit_bwd_q_scalar<T, M><<<dim3((geo.qn + WARPS - 1) / WARPS, bhs, groups),
                            WARPS * 32, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.kc),
      static_cast<const T*>(a.vc), static_cast<const T*>(a.rel),
      static_cast<const float*>(a.stats), static_cast<const T*>(a.o),
      static_cast<const T*>(a.probs), static_cast<const T*>(a.g),
      static_cast<float*>(a.delta), static_cast<T*>(a.dq),
      static_cast<T*>(a.drel), geo, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mvit_bwd_k_scalar<T, M><<<dim3((geo.kn + 1 + WARPS - 1) / WARPS, bhs, groups),
                            WARPS * 32, 0, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.kc),
      static_cast<const T*>(a.vc), static_cast<const T*>(a.rel),
      static_cast<const float*>(a.stats), static_cast<const T*>(a.probs),
      static_cast<const T*>(a.g), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), static_cast<T*>(a.dkc),
      static_cast<T*>(a.dvc), geo, scale);
  return (int)cudaGetLastError();
}

// The backward of variant M (enum Bwd): stats = l (kRecompute, kDelta) or
// lse (kRowMax), null for kSaved; o the saved output (kRowMax, kDelta);
// probs K6sp's probabilities (kSaved).  A query-major kernel writes delta,
// dq and drel, then a key-major kernel dk, dv, dkc and dvc (bf16: through
// `work` and a reduction when splits > 1).
template <int M>
int launch_bwd(const BwdArgs& a, int b, int heads, int qn, int kn, int kt,
               int kh, int kw, int d, int splits, int dtype, float scale,
               void* stream) {
  if (!valid(b, heads, qn, kn, kt, kh, kw, d) || splits < 1 || splits > 65535 ||
      (splits > 1 && a.work == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geo geo = make_geo(heads, qn, kn, kt, kh, kw, d);
  if (dtype == 1 && on_tensor_cores(d)) {
    return with_width(d, [&](auto w) {
      return launch_bwd_wg<M, decltype(w)::value>(a, b * heads, geo, splits,
                                                  scale, st);
    });
  }
  if (dtype == 1)
    return launch_bwd_scalar<__nv_bfloat16, M>(a, b * heads, geo, scale, st);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return launch_bwd_scalar<float, M>(a, b * heads, geo, scale, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  b, heads: the head-last call passes
// (B, H) with tensors [B, L, H*d]; the head-split call (B*H, 1) with
// tensors [B*H, L, d].  head_dim d: any; the bf16 tensor-core kernels take
// multiples of 8 up to 128, the scalar kernels the rest.  Each entry point
// returns the CUDA error code of its launches (0 on success).

// K5f / K6f: out (like q) and rowsum [b, heads, qn] fp32.
extern "C" int mvit_attention_fwd(const void* q, const void* k, const void* v,
                                  const void* kc, const void* vc,
                                  const void* rel, void* out, void* rowsum,
                                  int b, int heads, int qn, int kn, int kt,
                                  int kh, int kw, int head_dim, int dtype,
                                  float scale, void* stream) {
  return launch_fwd<false, false>(q, k, v, kc, vc, rel, out, rowsum, nullptr,
                                  b, heads, qn, kn, kt, kh, kw, head_dim,
                                  dtype, scale, stream);
}

// K6sp: K6f's out and rowsum, and probs [b, heads, qn, LP] (like q; LP =
// kn + 1 rounded up to 8, columns past kn zero).
extern "C" int mvit_attention_fwd_probs(const void* q, const void* k,
                                        const void* v, const void* kc,
                                        const void* vc, const void* rel,
                                        void* out, void* rowsum, void* probs,
                                        int b, int heads, int qn, int kn,
                                        int kt, int kh, int kw, int head_dim,
                                        int dtype, float scale, void* stream) {
  return launch_fwd<false, true>(q, k, v, kc, vc, rel, out, rowsum, probs, b,
                                 heads, qn, kn, kt, kh, kw, head_dim, dtype,
                                 scale, stream);
}

// K7f (head-last, b = B): out (like q) and lse [b, heads, qn] fp32.
extern "C" int mvit_attention_kt_fwd(const void* q, const void* k,
                                     const void* v, const void* kc,
                                     const void* vc, const void* rel,
                                     void* out, void* lse, int b, int heads,
                                     int qn, int kn, int kt, int kh, int kw,
                                     int head_dim, int dtype, float scale,
                                     void* stream) {
  return launch_fwd<true, false>(q, k, v, kc, vc, rel, out, lse, nullptr, b,
                                 heads, qn, kn, kt, kh, kw, head_dim, dtype,
                                 scale, stream);
}

// The backward of variant (0 K5b / K6b, 1 K7b, 2 K5bd / K6bd, 3 K6bs): dq
// (like q), dk, dv (like k), dkc, dvc (like kc), drel (like rel) from q, k,
// v, kc, vc, rel, the output gradient g (like q) and the forward's
// residuals: o, the output (variants 1, 2); stats, l (0, 2) or lse (1);
// probs, K6sp's probabilities (3).  delta [b, heads, qn] fp32 is scratch
// written by the query-major kernel and read by the key-major one; work,
// with splits > 1 (the bf16 tensor-core kernels only), scratch of 2 *
// splits * b * heads * (kn + 1) * head_dim floats for the key-major
// partials.
extern "C" int mvit_attention_bwd(int variant, const void* q, const void* k,
                                  const void* v, const void* kc,
                                  const void* vc, const void* rel,
                                  const void* o, const void* stats,
                                  const void* probs, const void* g,
                                  void* delta, void* dq, void* dk, void* dv,
                                  void* dkc, void* dvc, void* drel,
                                  void* work, int b, int heads, int qn,
                                  int kn, int kt, int kh, int kw, int head_dim,
                                  int splits, int dtype, float scale,
                                  void* stream) {
  const BwdArgs a{q, k, v, kc, vc, rel, o, stats, probs, g, delta, dq, dk,
                  dv, dkc, dvc, drel, static_cast<float*>(work)};
#define BWD(M) launch_bwd<M>(a, b, heads, qn, kn, kt, kh, kw, head_dim, \
                             splits, dtype, scale, stream)
  switch (variant) {
    case kRecompute: return BWD(kRecompute);
    case kRowMax: return BWD(kRowMax);
    case kDelta: return BWD(kDelta);
    case kSaved: return BWD(kSaved);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BWD
}
