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
// (B, H) and row stride H*96, the head-split call (B*H, 1) and row stride
// 96.  The head dimension is 96.
//
// Contract, per (batch b, head h) slice:
//   q [qN, 96] body queries; k, v [kN, 96] body keys/values, row-major over
//   (t', h', w') of the pooled key grid k_shape = (kt, kh, kw); kc, vc
//   [1, 96] the cls key/value, which is key column kN; rel [qN, kcat],
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
// The logits matrix [qN, kN+1] never reaches device memory.
// Design (bf16, mma.sync m16n8k16 with fp32 accumulators, ldmatrix
// fragments, cp.async staging):
//   * a CTA of 4 warps owns 64 query rows (16 per warp) of one slice, or,
//     in the key-major backward pass, 64 keys; the other side is walked in
//     tiles of 64 staged in shared memory;
//   * the bias is one more tensor-core product, as on the TPU: the rel
//     rows (padded to 48 columns) times the 0/1 expander [48 x 64 keys],
//     built per key tile in shared memory from (kt, kh, kw); exact, since
//     the expander holds ones and zeros.  Its transpose gives d(rel) =
//     ds_c E^T as a product too, so every sum is in a fixed order and the
//     output is deterministic (no atomics);
//   * forward: sweep 1 over the keys sums l, sweep 2 forms p = e / l and
//     the PV product, so bf16(p) is the normalised probability the plain
//     version rounds;
//   * backward, query-major kernel: sweep A computes D_i (and stores it),
//     sweep B forms ds and accumulates dq and d(rel); key-major kernel:
//     each CTA loops over all query tiles for its 64 keys and accumulates
//     dk and dv in registers, so no sum crosses CTAs.
//   * fp32: scalar paths (the tensor cores have no exact fp32 mode), one
//     warp per query or key row, for small shapes.
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
// from those probabilities (64 x 64 tiles staged by cp.async in place of
// the q / rel tiles the logits no longer need), D_i = rowsum(dp p) with the
// saved p; no QK^T and no exp.  K6sp adds ~710 MB of writes at block 1 (p
// is bf16 [36, 6272, 1576]), so it is bound by bytes; K6bs reads p three
// times (sweeps A and B, and the key-major pass).
// Not done yet: double-buffered staging, wgmma and TMA, and fewer
// recomputations of s (the backward computes s three times and g v^T
// twice: ~18 d operations per (query, key) pair against 10 d needed).

#include "common.cuh"

namespace {

using namespace pvrl;

constexpr int D = 96;         // head dim
constexpr int BM = 64;        // query rows per tile (4 warps x 16)
constexpr int BN = 64;        // keys per tile
constexpr int KCAT = 48;      // rel columns, padded to 3 mma k-steps
constexpr int SD = D + 8;     // smem row of a 96-wide tile: 208 B
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
  int pld;      // row stride of the saved probabilities: kn + 1 rounded to 8
  size_t row;   // elements between token rows of q, k, v, g, out (heads*D)
  size_t rrow;  // elements between rows of rel (heads*kcat)
};

Geo make_geo(int heads, int qn, int kn, int kt, int kh, int kw) {
  Geo g;
  g.heads = heads;
  g.qn = qn;
  g.kn = kn;
  g.kt = kt;
  g.kh = kh;
  g.kw = kw;
  g.kcat = kt + kh + kw;
  g.pld = (kn + 1 + 7) / 8 * 8;
  g.row = (size_t)heads * D;
  g.rrow = (size_t)heads * g.kcat;
  return g;
}

template <typename T>
__device__ __forceinline__ T* q_of(T* x, const Geo& g, int bh) {
  const int b = bh / g.heads, h = bh % g.heads;
  return x + (size_t)b * g.qn * g.row + h * D;
}
template <typename T>
__device__ __forceinline__ T* k_of(T* x, const Geo& g, int bh) {
  const int b = bh / g.heads, h = bh % g.heads;
  return x + (size_t)b * g.kn * g.row + h * D;
}
template <typename T>
__device__ __forceinline__ T* c_of(T* x, const Geo& g, int bh) {
  const int b = bh / g.heads, h = bh % g.heads;
  return x + (size_t)b * g.row + h * D;
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

// bias of key j < kn on the fp32 rel row r: ((rel_t + rel_h) + rel_w)
__device__ __forceinline__ float bias_of(const float* r, int j, const Geo& g) {
  const int hw = g.kh * g.kw;
  return (r[j / hw] + r[g.kt + (j / g.kw) % g.kh]) + r[g.kt + g.kh + j % g.kw];
}

// ------------------------------------------- bf16 (tensor-core) kernels

// rows [r0, r0 + 64) of an [n x 96] slice into a [64 x SD] tile; rows >= n
// are zero
__device__ __forceinline__ void stage_rows(uint16_t* dst, const uint16_t* src,
                                           size_t row, int r0, int n) {
  for (int idx = threadIdx.x; idx < BM * (D / 8); idx += blockDim.x) {
    const int r = idx / (D / 8), e = 8 * (idx % (D / 8));
    uint16_t* d = dst + r * SD + e;
    if (r0 + r < n) {
      cp_async16(d, src + (size_t)(r0 + r) * row + e);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// keys [j0, j0 + 64) of [body; cls]: rows < kn from x, row kn from xc,
// rows past it zero
__device__ __forceinline__ void stage_keys(uint16_t* dst, const uint16_t* x,
                                           const uint16_t* xc, size_t row,
                                           int j0, int kn) {
  for (int idx = threadIdx.x; idx < BN * (D / 8); idx += blockDim.x) {
    const int r = idx / (D / 8), e = 8 * (idx % (D / 8));
    const int j = j0 + r;
    uint16_t* d = dst + r * SD + e;
    if (j <= kn) {
      cp_async16(d, (j < kn ? x + (size_t)j * row : xc) + e);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
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
    const int j = j0 + r;
    int a = -1, b = -1, c = -1;
    if (j < g.kn) {
      a = j / (g.kh * g.kw);
      b = g.kt + (j / g.kw) % g.kh;
      c = g.kt + g.kh + j % g.kw;
    }
    for (int cc = 0; cc < KCAT; cc += 2) {
      const uint32_t lo = (cc == a || cc == b || cc == c) ? BF16_ONE : 0u;
      const uint32_t hi =
          (cc + 1 == a || cc + 1 == b || cc + 1 == c) ? BF16_ONE : 0u;
      *reinterpret_cast<uint32_t*>(dst + r * SE + cc) = lo | (hi << 16);
    }
  }
}

// rows [i0, i0 + 64) x columns [j0, j0 + 64) of one slice's saved
// probabilities [qn x pld] into a [64 x SP] tile; zero past qn and pld
__device__ __forceinline__ void stage_probs(uint16_t* dst, const uint16_t* p,
                                            const Geo& g, int i0, int j0) {
  for (int idx = threadIdx.x; idx < BM * (BN / 8); idx += blockDim.x) {
    const int r = idx / (BN / 8), c = 8 * (idx % (BN / 8));
    uint16_t* d = dst + r * SP + c;
    if (i0 + r < g.qn && j0 + c < g.pld) {
      cp_async16(d, p + (size_t)(i0 + r) * g.pld + j0 + c);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// the saved p of rows (r, r + 8) and tile columns (c, c + 1) as an
// accumulator-layout quad
__device__ __forceinline__ void load_p4(float (&p)[4], const uint16_t* p_s,
                                        int r, int c) {
  const float2 a = load_bf16x2(p_s + r * SP + c);
  const float2 b = load_bf16x2(p_s + (r + 8) * SP + c);
  p[0] = a.x;
  p[1] = a.y;
  p[2] = b.x;
  p[3] = b.y;
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

// s = (q.k) * scale + bias for the warp's 16 query rows and tile keys
// [n0, n0 + 8), then exp(min(s, 80)), zero for keys past the cls (j > kn)
__device__ __forceinline__ void exp_logits8(float (&s)[4],
                                            const uint32_t (&qa)[6][4],
                                            const uint32_t (&ra)[3][4],
                                            const uint16_t* k_s,
                                            const uint16_t* e_s, int n0,
                                            int j0, int kn, float scale) {
  float qk[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f};
  mma_rows<6>(qk, qa, k_s, SD, n0);
  mma_rows<3>(b, ra, e_s, SE, n0);
  const int col = j0 + n0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float x = fmaf(qk[e], scale, b[e]);
    s[e] = col + (e & 1) <= kn ? exp2f(fminf(x, CLAMP_HI) * LOG2E) : 0.f;
  }
}

// K7: the logits s = (q.k) * scale + bias for the warp's 16 query rows and
// tile keys [n0, n0 + 8), MASKED for keys past the cls (j > kn), as the
// TPU kernel masks its padding columns
__device__ __forceinline__ void logits8(float (&s)[4],
                                        const uint32_t (&qa)[6][4],
                                        const uint32_t (&ra)[3][4],
                                        const uint16_t* k_s,
                                        const uint16_t* e_s, int n0, int j0,
                                        int kn, float scale) {
  float qk[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f};
  mma_rows<6>(qk, qa, k_s, SD, n0);
  mma_rows<3>(b, ra, e_s, SE, n0);
  const int col = j0 + n0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    s[e] = col + (e & 1) <= kn ? fmaf(qk[e], scale, b[e]) : MASKED;
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

constexpr size_t FWD_SMEM = (size_t)(3 * 64 * SD + 2 * 64 * SE) * 2;

// K5f / K6f, and with SAVE K6sp, which also stores the bf16(p) fragments
// of P V to probs.
template <bool SAVE>
__global__ void __launch_bounds__(WARPS * 32)
mvit_fwd_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
             const uint16_t* __restrict__ v, const uint16_t* __restrict__ kc,
             const uint16_t* __restrict__ vc, const uint16_t* __restrict__ rel,
             uint16_t* __restrict__ out, float* __restrict__ rowsum,
             uint16_t* __restrict__ probs, Geo g, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
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

  stage_rows(q_s, q_of(q, g, bh), g.row, i0, g.qn);
  stage_rel(r_s, rel_of(rel, g, bh), g, i0);
  cp_async_wait_all();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  uint32_t qa[6][4], ra[3][4];
  load_a<6>(qa, q_s, SD, warp * 16);
  load_a<3>(ra, r_s, SE, warp * 16);

  // sweep 1: the row sums l
  float l0 = 0.f, l1 = 0.f;
  for (int j0 = 0; j0 <= g.kn; j0 += BN) {
    __syncthreads();  // the previous key tile is consumed
    stage_keys(k_s, kp, kcp, g.row, j0, g.kn);
    build_expander(e_s, j0, g);
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 2
    for (int n0 = 0; n0 < BN; n0 += 8) {
      float s[4];
      exp_logits8(s, qa, ra, k_s, e_s, n0, j0, g.kn, scale);
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
  float o[12][4];
#pragma unroll
  for (int dt = 0; dt < 12; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  for (int j0 = 0; j0 <= g.kn; j0 += BN) {
    __syncthreads();
    stage_keys(k_s, kp, kcp, g.row, j0, g.kn);
    stage_keys(v_s, vp, vcp, g.row, j0, g.kn);
    build_expander(e_s, j0, g);
    cp_async_wait_all();
    __syncthreads();
    for (int ks = 0; ks < BN / 16; ++ks) {
      float s0[4], s1[4];
      exp_logits8(s0, qa, ra, k_s, e_s, ks * 16, j0, g.kn, scale);
      exp_logits8(s1, qa, ra, k_s, e_s, ks * 16 + 8, j0, g.kn, scale);
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
      mma_cols<12>(o, pa, v_s, SD, ks * 16);
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
    for (int dt = 0; dt < 12; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          pack_bf16x2(o[dt][2 * half], o[dt][2 * half + 1]);
    if (tig == 0) rs[r] = half ? l1 : l0;
  }
}

// K7f: one sweep over the key tiles with an online softmax (the
// FlashAttention-2 form of the TPU kernel): per query row a running max m
// and partial sums l and acc; a tile whose max exceeds m rescales them by
// exp(m_old - m_new); p = exp(s - m) is rounded to bf16 unnormalised as the
// A operand of P V; o = acc / l and lse = m + log l at the end.
__global__ void __launch_bounds__(WARPS * 32)
mvit_fwd_kt_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                const uint16_t* __restrict__ v,
                const uint16_t* __restrict__ kc,
                const uint16_t* __restrict__ vc,
                const uint16_t* __restrict__ rel, uint16_t* __restrict__ out,
                float* __restrict__ lse, Geo g, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
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

  stage_rows(q_s, q_of(q, g, bh), g.row, i0, g.qn);
  stage_rel(r_s, rel_of(rel, g, bh), g, i0);
  cp_async_wait_all();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  uint32_t qa[6][4], ra[3][4];
  load_a<6>(qa, q_s, SD, warp * 16);
  load_a<3>(ra, r_s, SE, warp * 16);

  float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;
  float o[12][4];
#pragma unroll
  for (int dt = 0; dt < 12; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  const int kcols = g.kn + 1;  // the body keys and the cls key
  for (int j0 = 0; j0 < kcols; j0 += BN) {
    __syncthreads();  // the previous key tile is consumed
    stage_keys(k_s, kp, kcp, g.row, j0, g.kn);
    stage_keys(v_s, vp, vcp, g.row, j0, g.kn);
    build_expander(e_s, j0, g);
    cp_async_wait_all();
    __syncthreads();
    float s[8][4];
    float t0 = MASKED, t1 = MASKED;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      logits8(s[nb], qa, ra, k_s, e_s, nb * 8, j0, g.kn, scale);
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
    for (int dt = 0; dt < 12; ++dt) {
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
      mma_cols<12>(o, pa, v_s, SD, ks * 16);
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
    for (int dt = 0; dt < 12; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          pack_bf16x2(o[dt][2 * half] / l, o[dt][2 * half + 1] / l);
    if (tig == 0) ls[r] = (half ? m1 : m0) + logf(l);
  }
}

constexpr size_t BWD_Q_SMEM = (size_t)(4 * 64 * SD + 2 * 64 * SE) * 2;

// Query-major backward: D (stored for the key-major pass), dq and d(rel),
// for the variant M (enum Bwd).  rowsum holds l (kRecompute, kDelta) or
// lse (kRowMax); o is the saved output (kRowMax, kDelta); probs K6sp's
// probabilities (kSaved, whose p tile takes the q tile's place: the logits
// need neither q nor rel).
template <int M>
__global__ void __launch_bounds__(WARPS * 32)
mvit_bwd_q_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
               const uint16_t* __restrict__ v, const uint16_t* __restrict__ kc,
               const uint16_t* __restrict__ vc,
               const uint16_t* __restrict__ rel,
               const float* __restrict__ rowsum,
               const uint16_t* __restrict__ o,
               const uint16_t* __restrict__ probs,
               const uint16_t* __restrict__ gr, float* __restrict__ delta,
               uint16_t* __restrict__ dq, uint16_t* __restrict__ drel, Geo g,
               float scale) {
  constexpr bool LSE = M == kRowMax, SAVED = M == kSaved;
  constexpr bool D_FROM_O = M == kRowMax || M == kDelta;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* q_s = reinterpret_cast<uint16_t*>(smem_raw);  // kSaved: p tile
  uint16_t* g_s = q_s + BM * SD;
  uint16_t* k_s = g_s + BM * SD;
  uint16_t* v_s = k_s + BN * SD;
  uint16_t* e_s = v_s + BN * SD;
  uint16_t* r_s = e_s + BN * SE;
  const int bh = blockIdx.y, i0 = blockIdx.x * BM;
  const uint16_t* kp = k_of(k, g, bh);
  const uint16_t* vp = k_of(v, g, bh);
  const uint16_t* kcp = c_of(kc, g, bh);
  const uint16_t* vcp = c_of(vc, g, bh);
  const uint16_t* pp = SAVED ? probs_of(probs, g, bh) : nullptr;

  if constexpr (!SAVED) {
    stage_rows(q_s, q_of(q, g, bh), g.row, i0, g.qn);
    stage_rel(r_s, rel_of(rel, g, bh), g, i0);
  }
  stage_rows(g_s, q_of(gr, g, bh), g.row, i0, g.qn);
  cp_async_wait_all();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int pr = warp * 16 + gid;  // this thread's first tile row
  uint32_t qa[6][4], ga[6][4], ra[3][4];
  if constexpr (!SAVED) {
    load_a<6>(qa, q_s, SD, warp * 16);
    load_a<3>(ra, r_s, SE, warp * 16);
  }
  load_a<6>(ga, g_s, SD, warp * 16);
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
    // D_i = sum_e g_ie o_ie, the o tile staged in k_s, D in v_s
    float* d_s = reinterpret_cast<float*>(v_s);
    stage_rows(k_s, q_of(o, g, bh), g.row, i0, g.qn);
    cp_async_wait_all();
    __syncthreads();
    if (threadIdx.x < BM) {
      float acc = 0.f;
      for (int e = 0; e < D; e += 2) {
        const float2 a = load_bf16x2(g_s + threadIdx.x * SD + e);
        const float2 b = load_bf16x2(k_s + threadIdx.x * SD + e);
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
      }
      d_s[threadIdx.x] = acc;
    }
    __syncthreads();
    d0 = d_s[pr];
    d1 = d_s[pr + 8];
  } else {
    // sweep A: D_i = sum_j dp_ij p_ij
    for (int j0 = 0; j0 <= g.kn; j0 += BN) {
      __syncthreads();
      stage_keys(v_s, vp, vcp, g.row, j0, g.kn);
      if constexpr (SAVED) {
        stage_probs(q_s, pp, g, i0, j0);
      } else {
        stage_keys(k_s, kp, kcp, g.row, j0, g.kn);
        build_expander(e_s, j0, g);
      }
      cp_async_wait_all();
      __syncthreads();
#pragma unroll 2
      for (int n0 = 0; n0 < BN; n0 += 8) {
        float p[4], dp[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (SAVED) {
          load_p4(p, q_s, pr, n0 + 2 * tig);
        } else {
          exp_logits8(p, qa, ra, k_s, e_s, n0, j0, g.kn, scale);
#pragma unroll
          for (int e = 0; e < 4; ++e) p[e] *= e < 2 ? c0 : c1;
        }
        mma_rows<6>(dp, ga, v_s, SD, n0);
        d0 += dp[0] * p[0] + dp[1] * p[1];
        d1 += dp[2] * p[2] + dp[3] * p[3];
      }
    }
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);
  }
  float* dl = delta + (size_t)bh * g.qn;
  if (tig == 0) {
    if (r0 < g.qn) dl[r0] = d0;
    if (r1 < g.qn) dl[r1] = d1;
  }

  // sweep B: ds = p (dp - D) as bf16 A fragments; dq += ds k,
  // d(rel) += ds E^T
  float acc[12][4], dr[6][4];
#pragma unroll
  for (int dt = 0; dt < 12; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
#pragma unroll
  for (int ct = 0; ct < 6; ++ct) dr[ct][0] = dr[ct][1] = dr[ct][2] = dr[ct][3] = 0.f;
  for (int j0 = 0; j0 <= g.kn; j0 += BN) {
    __syncthreads();
    stage_keys(k_s, kp, kcp, g.row, j0, g.kn);
    stage_keys(v_s, vp, vcp, g.row, j0, g.kn);
    build_expander(e_s, j0, g);
    if constexpr (SAVED) stage_probs(q_s, pp, g, i0, j0);
    cp_async_wait_all();
    __syncthreads();
    for (int ks = 0; ks < BN / 16; ++ks) {
      float ds[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float p[4], dp[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (SAVED) {
          load_p4(p, q_s, pr, ks * 16 + u * 8 + 2 * tig);
        } else if constexpr (LSE) {
          logits8(p, qa, ra, k_s, e_s, ks * 16 + u * 8, j0, g.kn, scale);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[e] = exp2f((p[e] - (e < 2 ? c0 : c1)) * LOG2E);
        } else {
          exp_logits8(p, qa, ra, k_s, e_s, ks * 16 + u * 8, j0, g.kn, scale);
#pragma unroll
          for (int e = 0; e < 4; ++e) p[e] *= e < 2 ? c0 : c1;
        }
        mma_rows<6>(dp, ga, v_s, SD, ks * 16 + u * 8);
        ds[u][0] = p[0] * (dp[0] - d0);
        ds[u][1] = p[1] * (dp[1] - d0);
        ds[u][2] = p[2] * (dp[2] - d1);
        ds[u][3] = p[3] * (dp[3] - d1);
      }
      const uint32_t da[4] = {pack_bf16x2(ds[0][0], ds[0][1]),
                              pack_bf16x2(ds[0][2], ds[0][3]),
                              pack_bf16x2(ds[1][0], ds[1][1]),
                              pack_bf16x2(ds[1][2], ds[1][3])};
      mma_cols<12>(acc, da, k_s, SD, ks * 16);
      mma_cols<6>(dr, da, e_s, SE, ks * 16);
    }
  }
  uint16_t* dqp = q_of(dq, g, bh);
  uint16_t* drp = rel_of(drel, g, bh);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= g.qn) continue;
    uint16_t* dst = dqp + (size_t)r * g.row + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < 12; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) = pack_bf16x2(
          acc[dt][2 * half] * scale, acc[dt][2 * half + 1] * scale);
    uint16_t* rdst = drp + (size_t)r * g.rrow;
#pragma unroll
    for (int ct = 0; ct < 6; ++ct)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = ct * 8 + 2 * tig + e;
        if (c < g.kcat) {
          const __nv_bfloat16 x = __float2bfloat16(dr[ct][2 * half + e]);
          rdst[c] = *reinterpret_cast<const uint16_t*>(&x);
        }
      }
  }
}

constexpr size_t BWD_K_SMEM =
    (size_t)(4 * 64 * SD + 2 * 64 * SE) * 2 + 2 * BM * sizeof(float);

// Key-major backward: each CTA owns 64 keys of [body; cls] and walks every
// query tile, so dk and dv are summed in registers in a fixed order (M as
// in mvit_bwd_q_mma; kSaved stages the p tile where the expander and rel
// tiles sit, which it does not need).
template <int M>
__global__ void __launch_bounds__(WARPS * 32)
mvit_bwd_k_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
               const uint16_t* __restrict__ v, const uint16_t* __restrict__ kc,
               const uint16_t* __restrict__ vc,
               const uint16_t* __restrict__ rel,
               const float* __restrict__ rowsum,
               const uint16_t* __restrict__ probs,
               const uint16_t* __restrict__ gr,
               const float* __restrict__ delta, uint16_t* __restrict__ dk,
               uint16_t* __restrict__ dv, uint16_t* __restrict__ dkc,
               uint16_t* __restrict__ dvc, Geo g, float scale) {
  constexpr bool LSE = M == kRowMax, SAVED = M == kSaved;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* k_s = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* v_s = k_s + BN * SD;
  uint16_t* q_s = v_s + BN * SD;
  uint16_t* g_s = q_s + BM * SD;
  uint16_t* e_s = g_s + BM * SD;  // kSaved: the p tile, over e_s and r_s
  uint16_t* r_s = e_s + BN * SE;
  float* li_s = reinterpret_cast<float*>(r_s + BM * SE);  // 1 / l_i or lse_i
  float* d_s = li_s + BM;                                 // D_i
  const int bh = blockIdx.y, j0 = blockIdx.x * BN;
  const uint16_t* qp = q_of(q, g, bh);
  const uint16_t* gp = q_of(gr, g, bh);
  const uint16_t* relp = rel_of(rel, g, bh);
  const uint16_t* pp = SAVED ? probs_of(probs, g, bh) : nullptr;
  const float* rs = rowsum + (size_t)bh * g.qn;
  const float* dl = delta + (size_t)bh * g.qn;

  stage_keys(k_s, k_of(k, g, bh), c_of(kc, g, bh), g.row, j0, g.kn);
  stage_keys(v_s, k_of(v, g, bh), c_of(vc, g, bh), g.row, j0, g.kn);
  if constexpr (!SAVED) build_expander(e_s, j0, g);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  float acc_k[12][4], acc_v[12][4];
#pragma unroll
  for (int dt = 0; dt < 12; ++dt) {
    acc_k[dt][0] = acc_k[dt][1] = acc_k[dt][2] = acc_k[dt][3] = 0.f;
    acc_v[dt][0] = acc_v[dt][1] = acc_v[dt][2] = acc_v[dt][3] = 0.f;
  }
  for (int i0 = 0; i0 < g.qn; i0 += BM) {
    __syncthreads();  // the previous query tile is consumed
    stage_rows(q_s, qp, g.row, i0, g.qn);
    stage_rows(g_s, gp, g.row, i0, g.qn);
    if constexpr (SAVED) {
      stage_probs(e_s, pp, g, i0, j0);
    } else {
      stage_rel(r_s, relp, g, i0);
    }
    // padding rows: q = g = rel = 0, l = 1 (lse = 0), D = 0, so p = 1 (or
    // the zero of a staged p row) and ds = 0
    for (int t = threadIdx.x; t < BM; t += blockDim.x) {
      if constexpr (!SAVED)
        li_s[t] = i0 + t < g.qn ? (LSE ? rs[i0 + t] : 1.f / rs[i0 + t])
                                : (LSE ? 0.f : 1.f);
      d_s[t] = i0 + t < g.qn ? dl[i0 + t] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();
    for (int kk = 0; kk < BM / 16; ++kk) {
      // s^T, p^T: rows = this warp's 16 keys, columns = queries
      float p[2][4];
      if constexpr (SAVED) {
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = kk * 16 + u * 8 + 2 * tig + (e & 1);
            const uint16_t x = e_s[i * SP + warp * 16 + gid + 8 * (e >> 1)];
            p[u][e] = __uint_as_float((uint32_t)x << 16);
          }
      } else {
        uint32_t ka[6][4], ea[3][4];
        load_a<6>(ka, k_s, SD, warp * 16);
        load_a<3>(ea, e_s, SE, warp * 16);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float qk[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f};
          mma_rows<6>(qk, ka, q_s, SD, kk * 16 + u * 8);
          mma_rows<3>(b, ea, r_s, SE, kk * 16 + u * 8);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = kk * 16 + u * 8 + 2 * tig + (e & 1);
            const float x = fmaf(qk[e], scale, b[e]);
            if constexpr (LSE) {
              p[u][e] = exp2f((x - li_s[i]) * LOG2E);
            } else {
              p[u][e] = exp2f(fminf(x, CLAMP_HI) * LOG2E) * li_s[i];
            }
          }
        }
      }
      // dp^T = v g^T, ds^T = p^T (dp^T - D)
      float ds[2][4];
      {
        uint32_t va[6][4];
        load_a<6>(va, v_s, SD, warp * 16);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float dp[4] = {0.f, 0.f, 0.f, 0.f};
          mma_rows<6>(dp, va, g_s, SD, kk * 16 + u * 8);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = kk * 16 + u * 8 + 2 * tig + (e & 1);
            ds[u][e] = p[u][e] * (dp[e] - d_s[i]);
          }
        }
      }
      const uint32_t pa[4] = {pack_bf16x2(p[0][0], p[0][1]),
                              pack_bf16x2(p[0][2], p[0][3]),
                              pack_bf16x2(p[1][0], p[1][1]),
                              pack_bf16x2(p[1][2], p[1][3])};
      const uint32_t da[4] = {pack_bf16x2(ds[0][0], ds[0][1]),
                              pack_bf16x2(ds[0][2], ds[0][3]),
                              pack_bf16x2(ds[1][0], ds[1][1]),
                              pack_bf16x2(ds[1][2], ds[1][3])};
      mma_cols<12>(acc_k, da, q_s, SD, kk * 16);
      mma_cols<12>(acc_v, pa, g_s, SD, kk * 16);
    }
  }
  uint16_t* dkp = k_of(dk, g, bh);
  uint16_t* dvp = k_of(dv, g, bh);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = j0 + warp * 16 + gid + 8 * half;
    if (j > g.kn) continue;
    uint16_t* kd = (j < g.kn ? dkp + (size_t)j * g.row : c_of(dkc, g, bh)) + 2 * tig;
    uint16_t* vd = (j < g.kn ? dvp + (size_t)j * g.row : c_of(dvc, g, bh)) + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < 12; ++dt) {
      *reinterpret_cast<uint32_t*>(kd + dt * 8) = pack_bf16x2(
          acc_k[dt][2 * half] * scale, acc_k[dt][2 * half + 1] * scale);
      *reinterpret_cast<uint32_t*>(vd + dt * 8) =
          pack_bf16x2(acc_v[dt][2 * half], acc_v[dt][2 * half + 1]);
    }
  }
}

// ------------------------------------------------- fp32 (scalar) kernels

// key row j of [body; cls]
__device__ __forceinline__ const float* key_row(const float* x, const float* xc,
                                                int j, const Geo& g) {
  return j < g.kn ? x + (size_t)j * g.row : xc;
}

__device__ __forceinline__ float dot96(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 8
  for (int e = 0; e < D; ++e) s = fmaf(a[e], b[e], s);
  return s;
}

// s_ij of query row qi (its rel row ri) and key row j
__device__ __forceinline__ float logit(const float* qi, const float* ri,
                                       const float* kj, int j, const Geo& g,
                                       float scale) {
  const float s = dot96(qi, kj) * scale;
  return j < g.kn ? s + bias_of(ri, j, g) : s;
}

// Forward: one warp per query row; shared memory holds the warp's row of
// exponentials [kn + 1].  SAVE (K6sp) also writes p to probs.
template <bool SAVE>
__global__ void __launch_bounds__(WARPS * 32)
mvit_fwd_scalar(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ kc,
                const float* __restrict__ vc, const float* __restrict__ rel,
                float* __restrict__ out, float* __restrict__ rowsum,
                float* __restrict__ probs, Geo g, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, i = blockIdx.x * WARPS + warp;
  if (i >= g.qn) return;  // warp-uniform; no block barrier below
  float* e_w = reinterpret_cast<float*>(smem_raw) + (size_t)warp * (g.kn + 1);
  const float* qi = q_of(q, g, bh) + (size_t)i * g.row;
  const float* ri = rel_of(rel, g, bh) + (size_t)i * g.rrow;
  const float* kp = k_of(k, g, bh);
  const float* kcp = c_of(kc, g, bh);
  float part = 0.f;
  for (int j = lane; j <= g.kn; j += 32) {
    const float e =
        expf(fminf(logit(qi, ri, key_row(kp, kcp, j, g), j, g, scale), CLAMP_HI));
    e_w[j] = e;
    part += e;
  }
  const float l = warp_sum(part);
  if constexpr (SAVE) {
    float* pi = probs_of(probs, g, bh) + (size_t)i * g.pld;
    for (int j = lane; j < g.pld; j += 32) pi[j] = j <= g.kn ? e_w[j] / l : 0.f;
  }
  __syncwarp();
  const float* vp = k_of(v, g, bh);
  const float* vcp = c_of(vc, g, bh);
  float o[3] = {0.f, 0.f, 0.f};
  for (int j = 0; j <= g.kn; ++j) {
    const float p = e_w[j] / l;
    const float* vj = key_row(vp, vcp, j, g);
#pragma unroll
    for (int u = 0; u < 3; ++u) o[u] = fmaf(p, vj[lane + 32 * u], o[u]);
  }
  float* oi = q_of(out, g, bh) + (size_t)i * g.row;
#pragma unroll
  for (int u = 0; u < 3; ++u) oi[lane + 32 * u] = o[u];
  if (lane == 0) rowsum[(size_t)bh * g.qn + i] = l;
}

// K7f: one warp per query row; shared memory holds the warp's logits, then
// p = exp(s - m) with m the row max; o = (sum_j p_j v_j) / l.
__global__ void __launch_bounds__(WARPS * 32)
mvit_fwd_kt_scalar(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ kc,
                   const float* __restrict__ vc, const float* __restrict__ rel,
                   float* __restrict__ out, float* __restrict__ lse, Geo g,
                   float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, i = blockIdx.x * WARPS + warp;
  if (i >= g.qn) return;  // warp-uniform; no block barrier below
  float* e_w = reinterpret_cast<float*>(smem_raw) + (size_t)warp * (g.kn + 1);
  const float* qi = q_of(q, g, bh) + (size_t)i * g.row;
  const float* ri = rel_of(rel, g, bh) + (size_t)i * g.rrow;
  const float* kp = k_of(k, g, bh);
  const float* kcp = c_of(kc, g, bh);
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
  const float* vp = k_of(v, g, bh);
  const float* vcp = c_of(vc, g, bh);
  float o[3] = {0.f, 0.f, 0.f};
  for (int j = 0; j <= g.kn; ++j) {
    const float* vj = key_row(vp, vcp, j, g);
#pragma unroll
    for (int u = 0; u < 3; ++u) o[u] = fmaf(e_w[j], vj[lane + 32 * u], o[u]);
  }
  float* oi = q_of(out, g, bh) + (size_t)i * g.row;
#pragma unroll
  for (int u = 0; u < 3; ++u) oi[lane + 32 * u] = o[u] / l;
  if (lane == 0) lse[(size_t)bh * g.qn + i] = m + logf(l);
}

// Query-major backward: one warp per query row; per warp two rows [kn + 1]
// of shared memory (p, then ds; and dp).  M as in mvit_bwd_q_mma.
template <int M>
__global__ void __launch_bounds__(WARPS * 32)
mvit_bwd_q_scalar(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ kc,
                  const float* __restrict__ vc, const float* __restrict__ rel,
                  const float* __restrict__ rowsum, const float* __restrict__ o,
                  const float* __restrict__ probs,
                  const float* __restrict__ gr, float* __restrict__ delta,
                  float* __restrict__ dq, float* __restrict__ drel, Geo g,
                  float scale) {
  constexpr bool LSE = M == kRowMax, SAVED = M == kSaved;
  constexpr bool D_FROM_O = M == kRowMax || M == kDelta;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, i = blockIdx.x * WARPS + warp;
  if (i >= g.qn) return;
  float* p_w = reinterpret_cast<float*>(smem_raw) + (size_t)warp * 2 * (g.kn + 1);
  float* dp_w = p_w + g.kn + 1;
  const float* qi = q_of(q, g, bh) + (size_t)i * g.row;
  const float* gi = q_of(gr, g, bh) + (size_t)i * g.row;
  const float* ri = rel_of(rel, g, bh) + (size_t)i * g.rrow;
  const float* kp = k_of(k, g, bh);
  const float* kcp = c_of(kc, g, bh);
  const float* vp = k_of(v, g, bh);
  const float* vcp = c_of(vc, g, bh);
  const float l = SAVED ? 1.f : rowsum[(size_t)bh * g.qn + i];  // K7: lse
  const float* pi = SAVED ? probs_of(probs, g, bh) + (size_t)i * g.pld : nullptr;
  float part = 0.f;
  for (int j = lane; j <= g.kn; j += 32) {
    float p;
    if constexpr (SAVED) {
      p = pi[j];
    } else {
      const float s = logit(qi, ri, key_row(kp, kcp, j, g), j, g, scale);
      p = LSE ? expf(s - l) : expf(fminf(s, CLAMP_HI)) / l;
    }
    const float dp = dot96(gi, key_row(vp, vcp, j, g));
    p_w[j] = p;
    dp_w[j] = dp;
    part = fmaf(dp, p, part);
  }
  const float Dl = D_FROM_O ? dot96(gi, q_of(o, g, bh) + (size_t)i * g.row)
                            : warp_sum(part);
  if (lane == 0) delta[(size_t)bh * g.qn + i] = Dl;
  for (int j = lane; j <= g.kn; j += 32) p_w[j] = p_w[j] * (dp_w[j] - Dl);
  __syncwarp();
  float a[3] = {0.f, 0.f, 0.f};
  for (int j = 0; j <= g.kn; ++j) {
    const float ds = p_w[j];
    const float* kj = key_row(kp, kcp, j, g);
#pragma unroll
    for (int u = 0; u < 3; ++u) a[u] = fmaf(ds, kj[lane + 32 * u], a[u]);
  }
  float* dqi = q_of(dq, g, bh) + (size_t)i * g.row;
#pragma unroll
  for (int u = 0; u < 3; ++u) dqi[lane + 32 * u] = a[u] * scale;
  // d(rel): lane c sums ds over the body keys on its axis entry, j rising
  float* dri = rel_of(drel, g, bh) + (size_t)i * g.rrow;
  const int hw = g.kh * g.kw;
  for (int c = lane; c < g.kcat; c += 32) {
    float s = 0.f;
    for (int j = 0; j < g.kn; ++j) {
      const bool on = c < g.kt ? j / hw == c
                    : c < g.kt + g.kh ? (j / g.kw) % g.kh == c - g.kt
                                      : j % g.kw == c - g.kt - g.kh;
      if (on) s += p_w[j];
    }
    dri[c] = s;
  }
}

// Key-major backward: one warp per key row of [body; cls]; lanes take 32
// queries at a time, then sum their products over them.  M as in
// mvit_bwd_q_mma.
template <int M>
__global__ void __launch_bounds__(WARPS * 32)
mvit_bwd_k_scalar(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ kc,
                  const float* __restrict__ vc, const float* __restrict__ rel,
                  const float* __restrict__ rowsum,
                  const float* __restrict__ probs, const float* __restrict__ gr,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, float* __restrict__ dkc,
                  float* __restrict__ dvc, Geo g, float scale) {
  constexpr bool LSE = M == kRowMax, SAVED = M == kSaved;
  __shared__ float p_s[WARPS][32], ds_s[WARPS][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, j = blockIdx.x * WARPS + warp;
  if (j > g.kn) return;
  const float* kj = key_row(k_of(k, g, bh), c_of(kc, g, bh), j, g);
  const float* vj = key_row(k_of(v, g, bh), c_of(vc, g, bh), j, g);
  const float* qp = q_of(q, g, bh);
  const float* gp = q_of(gr, g, bh);
  const float* relp = rel_of(rel, g, bh);
  const float* rs = rowsum + (size_t)bh * g.qn;
  const float* dl = delta + (size_t)bh * g.qn;
  float ak[3] = {0.f, 0.f, 0.f}, av[3] = {0.f, 0.f, 0.f};
  for (int i0 = 0; i0 < g.qn; i0 += 32) {
    const int i = i0 + lane;
    float p = 0.f, ds = 0.f;
    if (i < g.qn) {
      if constexpr (SAVED) {
        p = probs_of(probs, g, bh)[(size_t)i * g.pld + j];
      } else {
        const float* qi = qp + (size_t)i * g.row;
        const float s = logit(qi, relp + (size_t)i * g.rrow, kj, j, g, scale);
        p = LSE ? expf(s - rs[i]) : expf(fminf(s, CLAMP_HI)) / rs[i];
      }
      ds = p * (dot96(gp + (size_t)i * g.row, vj) - dl[i]);
    }
    p_s[warp][lane] = p;
    ds_s[warp][lane] = ds;
    __syncwarp();
    const int n = min(32, g.qn - i0);
    for (int t = 0; t < n; ++t) {
      const float* qi = qp + (size_t)(i0 + t) * g.row;
      const float* gi = gp + (size_t)(i0 + t) * g.row;
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        ak[u] = fmaf(ds_s[warp][t], qi[lane + 32 * u], ak[u]);
        av[u] = fmaf(p_s[warp][t], gi[lane + 32 * u], av[u]);
      }
    }
    __syncwarp();
  }
  float* kd = j < g.kn ? k_of(dk, g, bh) + (size_t)j * g.row : c_of(dkc, g, bh);
  float* vd = j < g.kn ? k_of(dv, g, bh) + (size_t)j * g.row : c_of(dvc, g, bh);
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    kd[lane + 32 * u] = ak[u] * scale;
    vd[lane + 32 * u] = av[u];
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

bool valid(int b, int heads, int qn, int kn, int kt, int kh, int kw) {
  return b > 0 && heads > 0 && qn > 0 && kn > 0 && kt > 0 && kh > 0 &&
         kw > 0 && kt * kh * kw == kn && kt + kh + kw <= KCAT && b * heads <= 65535;
}

// The forward of K5/K6 (KT = false: out and the row sums l; with SAVE,
// K6sp, also probs) or of K7 (KT = true: out and lse).
template <bool KT, bool SAVE>
int launch_fwd(const void* q, const void* k, const void* v, const void* kc,
               const void* vc, const void* rel, void* out, void* stats,
               void* probs, int b, int heads, int qn, int kn, int kt, int kh,
               int kw, int dtype, float scale, void* stream) {
  if (!valid(b, heads, qn, kn, kt, kh, kw)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geo g = make_geo(heads, qn, kn, kt, kh, kw);
  if (dtype == 1) {
    const dim3 grid((qn + BM - 1) / BM, b * heads);
    using u16 = uint16_t;
    cudaError_t err = KT ? set_smem(mvit_fwd_kt_mma, FWD_SMEM)
                         : set_smem(mvit_fwd_mma<SAVE>, FWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    if constexpr (KT) {
      mvit_fwd_kt_mma<<<grid, WARPS * 32, FWD_SMEM, st>>>(
          static_cast<const u16*>(q), static_cast<const u16*>(k),
          static_cast<const u16*>(v), static_cast<const u16*>(kc),
          static_cast<const u16*>(vc), static_cast<const u16*>(rel),
          static_cast<u16*>(out), static_cast<float*>(stats), g, scale);
    } else {
      mvit_fwd_mma<SAVE><<<grid, WARPS * 32, FWD_SMEM, st>>>(
          static_cast<const u16*>(q), static_cast<const u16*>(k),
          static_cast<const u16*>(v), static_cast<const u16*>(kc),
          static_cast<const u16*>(vc), static_cast<const u16*>(rel),
          static_cast<u16*>(out), static_cast<float*>(stats),
          static_cast<u16*>(probs), g, scale);
    }
    return (int)cudaGetLastError();
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)WARPS * (kn + 1) * sizeof(float);
  const dim3 grid((qn + WARPS - 1) / WARPS, b * heads);
  if constexpr (KT) {
    cudaError_t err = set_smem(mvit_fwd_kt_scalar, smem);
    if (err != cudaSuccess) return (int)err;
    mvit_fwd_kt_scalar<<<grid, WARPS * 32, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(kc),
        static_cast<const float*>(vc), static_cast<const float*>(rel),
        static_cast<float*>(out), static_cast<float*>(stats), g, scale);
  } else {
    cudaError_t err = set_smem(mvit_fwd_scalar<SAVE>, smem);
    if (err != cudaSuccess) return (int)err;
    mvit_fwd_scalar<SAVE><<<grid, WARPS * 32, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(kc),
        static_cast<const float*>(vc), static_cast<const float*>(rel),
        static_cast<float*>(out), static_cast<float*>(stats),
        static_cast<float*>(probs), g, scale);
  }
  return (int)cudaGetLastError();
}

// The backward of variant M (enum Bwd): stats = l (kRecompute, kDelta) or
// lse (kRowMax), null for kSaved; o the saved output (kRowMax, kDelta);
// probs K6sp's probabilities (kSaved).  A query-major kernel writes delta,
// dq and drel, then a key-major kernel dk, dv, dkc and dvc.
template <int M>
int launch_bwd(const void* q, const void* k, const void* v, const void* kc,
               const void* vc, const void* rel, const void* o,
               const void* stats, const void* probs, const void* g,
               void* delta, void* dq, void* dk, void* dv, void* dkc, void* dvc,
               void* drel, int b, int heads, int qn, int kn, int kt, int kh,
               int kw, int dtype, float scale, void* stream) {
  if (!valid(b, heads, qn, kn, kt, kh, kw)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geo geo = make_geo(heads, qn, kn, kt, kh, kw);
  if (dtype == 1) {
    using u16 = uint16_t;
    cudaError_t err = set_smem(mvit_bwd_q_mma<M>, BWD_Q_SMEM);
    if (err != cudaSuccess) return (int)err;
    err = set_smem(mvit_bwd_k_mma<M>, BWD_K_SMEM);
    if (err != cudaSuccess) return (int)err;
    mvit_bwd_q_mma<M><<<dim3((qn + BM - 1) / BM, b * heads), WARPS * 32,
                        BWD_Q_SMEM, st>>>(
        static_cast<const u16*>(q), static_cast<const u16*>(k),
        static_cast<const u16*>(v), static_cast<const u16*>(kc),
        static_cast<const u16*>(vc), static_cast<const u16*>(rel),
        static_cast<const float*>(stats), static_cast<const u16*>(o),
        static_cast<const u16*>(probs), static_cast<const u16*>(g),
        static_cast<float*>(delta), static_cast<u16*>(dq),
        static_cast<u16*>(drel), geo, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    mvit_bwd_k_mma<M><<<dim3((kn + 1 + BN - 1) / BN, b * heads), WARPS * 32,
                        BWD_K_SMEM, st>>>(
        static_cast<const u16*>(q), static_cast<const u16*>(k),
        static_cast<const u16*>(v), static_cast<const u16*>(kc),
        static_cast<const u16*>(vc), static_cast<const u16*>(rel),
        static_cast<const float*>(stats), static_cast<const u16*>(probs),
        static_cast<const u16*>(g), static_cast<const float*>(delta),
        static_cast<u16*>(dk), static_cast<u16*>(dv), static_cast<u16*>(dkc),
        static_cast<u16*>(dvc), geo, scale);
    return (int)cudaGetLastError();
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)WARPS * 2 * (kn + 1) * sizeof(float);
  cudaError_t err = set_smem(mvit_bwd_q_scalar<M>, smem);
  if (err != cudaSuccess) return (int)err;
  mvit_bwd_q_scalar<M><<<dim3((qn + WARPS - 1) / WARPS, b * heads),
                         WARPS * 32, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(kc),
      static_cast<const float*>(vc), static_cast<const float*>(rel),
      static_cast<const float*>(stats), static_cast<const float*>(o),
      static_cast<const float*>(probs), static_cast<const float*>(g),
      static_cast<float*>(delta), static_cast<float*>(dq),
      static_cast<float*>(drel), geo, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mvit_bwd_k_scalar<M><<<dim3((kn + 1 + WARPS - 1) / WARPS, b * heads),
                         WARPS * 32, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(kc),
      static_cast<const float*>(vc), static_cast<const float*>(rel),
      static_cast<const float*>(stats), static_cast<const float*>(probs),
      static_cast<const float*>(g), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(dkc), static_cast<float*>(dvc), geo, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  b, heads: the head-last call passes
// (B, H) with tensors [B, L, H*96]; the head-split call (B*H, 1) with
// tensors [B*H, L, 96].  Each entry point returns the CUDA error code of
// its launches (0 on success).

// K5f / K6f: out (like q) and rowsum [b, heads, qn] fp32.
extern "C" int mvit_attention_fwd(const void* q, const void* k, const void* v,
                                  const void* kc, const void* vc,
                                  const void* rel, void* out, void* rowsum,
                                  int b, int heads, int qn, int kn, int kt,
                                  int kh, int kw, int dtype, float scale,
                                  void* stream) {
  return launch_fwd<false, false>(q, k, v, kc, vc, rel, out, rowsum, nullptr,
                                  b, heads, qn, kn, kt, kh, kw, dtype, scale,
                                  stream);
}

// K6sp: K6f's out and rowsum, and probs [b, heads, qn, LP] (like q; LP =
// kn + 1 rounded up to 8, columns past kn zero).
extern "C" int mvit_attention_fwd_probs(const void* q, const void* k,
                                        const void* v, const void* kc,
                                        const void* vc, const void* rel,
                                        void* out, void* rowsum, void* probs,
                                        int b, int heads, int qn, int kn,
                                        int kt, int kh, int kw, int dtype,
                                        float scale, void* stream) {
  return launch_fwd<false, true>(q, k, v, kc, vc, rel, out, rowsum, probs, b,
                                 heads, qn, kn, kt, kh, kw, dtype, scale,
                                 stream);
}

// K5b / K6b: dq (like q), dk, dv (like k), dkc, dvc (like kc), drel (like
// rel) from the forward's rowsum and the output gradient g (like q).
// delta [b, heads, qn] fp32 is scratch written by the first kernel and read
// by the second.
extern "C" int mvit_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* kc, const void* vc,
                                  const void* rel, const void* rowsum,
                                  const void* g, void* delta, void* dq,
                                  void* dk, void* dv, void* dkc, void* dvc,
                                  void* drel, int b, int heads, int qn, int kn,
                                  int kt, int kh, int kw, int dtype,
                                  float scale, void* stream) {
  return launch_bwd<kRecompute>(q, k, v, kc, vc, rel, nullptr, rowsum,
                                nullptr, g, delta, dq, dk, dv, dkc, dvc, drel,
                                b, heads, qn, kn, kt, kh, kw, dtype, scale,
                                stream);
}

// K5bd / K6bd: the gradients as for K5b / K6b, from the forward's output
// `out` (D = rowsum(g out)) and its rowsum; delta as for K5b.
extern "C" int mvit_attention_bwd_delta(const void* q, const void* k,
                                        const void* v, const void* kc,
                                        const void* vc, const void* rel,
                                        const void* out, const void* rowsum,
                                        const void* g, void* delta, void* dq,
                                        void* dk, void* dv, void* dkc,
                                        void* dvc, void* drel, int b,
                                        int heads, int qn, int kn, int kt,
                                        int kh, int kw, int dtype, float scale,
                                        void* stream) {
  return launch_bwd<kDelta>(q, k, v, kc, vc, rel, out, rowsum, nullptr, g,
                            delta, dq, dk, dv, dkc, dvc, drel, b, heads, qn,
                            kn, kt, kh, kw, dtype, scale, stream);
}

// K6bs: the gradients as for K6b from K6sp's probabilities (rel is not
// read: no logits are formed); delta as for K5b.
extern "C" int mvit_attention_bwd_probs(const void* q, const void* k,
                                        const void* v, const void* kc,
                                        const void* vc, const void* rel,
                                        const void* probs, const void* g,
                                        void* delta, void* dq, void* dk,
                                        void* dv, void* dkc, void* dvc,
                                        void* drel, int b, int heads, int qn,
                                        int kn, int kt, int kh, int kw,
                                        int dtype, float scale, void* stream) {
  return launch_bwd<kSaved>(q, k, v, kc, vc, rel, nullptr, nullptr, probs, g,
                            delta, dq, dk, dv, dkc, dvc, drel, b, heads, qn,
                            kn, kt, kh, kw, dtype, scale, stream);
}

// K7f (head-last, b = B): out (like q) and lse [b, heads, qn] fp32.
extern "C" int mvit_attention_kt_fwd(const void* q, const void* k,
                                     const void* v, const void* kc,
                                     const void* vc, const void* rel,
                                     void* out, void* lse, int b, int heads,
                                     int qn, int kn, int kt, int kh, int kw,
                                     int dtype, float scale, void* stream) {
  return launch_fwd<true, false>(q, k, v, kc, vc, rel, out, lse, nullptr, b,
                                 heads, qn, kn, kt, kh, kw, dtype, scale,
                                 stream);
}

// K7b: the gradients as for K5b, from the forward's output `out` and lse;
// delta [b, heads, qn] fp32 is scratch (rowsum(g out), written by the first
// kernel and read by the second).
extern "C" int mvit_attention_kt_bwd(const void* q, const void* k,
                                     const void* v, const void* kc,
                                     const void* vc, const void* rel,
                                     const void* out, const void* lse,
                                     const void* g, void* delta, void* dq,
                                     void* dk, void* dv, void* dkc, void* dvc,
                                     void* drel, int b, int heads, int qn,
                                     int kn, int kt, int kh, int kw, int dtype,
                                     float scale, void* stream) {
  return launch_bwd<kRowMax>(q, k, v, kc, vc, rel, out, lse, nullptr, g,
                             delta, dq, dk, dv, dkc, dvc, drel, b, heads, qn,
                             kn, kt, kh, kw, dtype, scale, stream);
}
