// Key-tiled softmax attention over one whole sequence per (batch, head),
// unmasked and non-causal, with an optional CLS stream: the forward and its
// recompute backward.  One kernel pair serves three callers, told apart only
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
//   p = e / l.  bf16: e is rounded to bf16 as the A operand of P V and the
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
// Design (bf16: mma.sync m16n8k16 with fp32 accumulators, ldmatrix
// fragments, cp.async staging; fp32: scalar, one warp per row):
//   * a CTA of 4 warps owns 64 query rows (16 per warp) of one slice, or,
//     in the backward's key-major pass, 64 keys; the other side is walked
//     in tiles of 64 rows staged in shared memory, rows past L zero, and
//     in chunks of 32 inside a tile: chunks and warps wholly past L skip
//     their tensor-core work;
//   * forward: a two-stage cp.async ring of k/v tiles.  The clamp needs no
//     running max and no rescale: the loop only adds l += sum e and
//     o += e v, and divides once;
//   * backward, query-major kernel: sweep A sums D_i (and stores it),
//     sweep B forms ds and accumulates dq; key-major kernel: each CTA walks
//     every query tile (a two-stage ring) for its 64 keys and accumulates
//     dk and dv in registers, so no sum crosses CTAs (deterministic, no
//     atomics);
//   * the tile width is a template parameter (32, 64, 96, 128, 192, 256);
//     a head dim d (a multiple of 8) runs on the narrowest width >= d, its
//     tiles zero past column d, and only d columns are written.
// A row of e can reach L exp(80) ~ 5.6e37 (finite in fp32), and o's sum of
// e v stays finite while fewer than ~6000 / max|v| logits reach 80.
// Measured at the training shape (PERF.md): the forward at 4.3x its bound,
// the backward at 9x.  Not done yet: wgmma and TMA, 32 query rows per warp,
// longer-lived CTAs, and fewer recomputations (the backward forms s three
// times and g v^T twice: ~18 d operations per (query, key) pair against
// 10 d needed).

#include <algorithm>

#include "common.cuh"

namespace {

using namespace pvrl;

constexpr int BM = 64;   // query rows per tile (4 warps x 16)
constexpr int BN = 64;   // keys per tile
constexpr int WARPS = 4;
constexpr int MAX_L = 1025;  // the JAX rule's 1024 tokens (+ the CLS)
constexpr int MAX_D = 256;   // the widest tile
constexpr float LOG2E = 1.4426950408889634f;

// Where the rows of each tensor group live.  Sequence s = b * seqs + m
// (b < B, m < seqs) has its row j at base + (b * n + j) * ld + m * (ld /
// seqs): a row of ld elements holds the rows of `seqs` sequences side by
// side (seqs = 1 but for K2's layout).  A CLS tensor [B, 1, *] has its row
// of sequence s at base + s * ldc.  Head h is columns [h * d, h * d + d) of
// a sequence's row.
struct Geo {
  int n;       // frame rows
  int L;       // n + 1 with the CLS, else n
  int heads;
  int d;       // head dim (a multiple of 8, at most the tile width HD)
  int seqs;    // sequences side by side in a row
  int tiles;   // row tiles of a slice: ceil(L / 64)
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

// ------------------------------------------- bf16 (tensor-core) kernels

// rows [r0, r0 + 64) of [frames; cls] into a [64 x (HD + 8)] tile; rows
// >= L and columns >= d are zero
template <int HD>
__device__ __forceinline__ void stage(uint16_t* dst, const uint16_t* x,
                                      const uint16_t* xc, size_t ld,
                                      size_t ldc, const Geo& g, int b, int h,
                                      int r0) {
  constexpr int SD = HD + 8, CH = HD / 8;
  for (int idx = threadIdx.x; idx < BM * CH; idx += blockDim.x) {
    const int r = idx / CH, e = 8 * (idx % CH), j = r0 + r;
    uint16_t* d = dst + r * SD + e;
    if (j < g.L && e < g.d) {
      cp_async16(d, row_of(x, xc, ld, ldc, g, b, h, j) + e);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
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

// s[nb] = A (16 x 16*KS) times rows [n0 + 8 nb, n0 + 8 nb + 8) of `tile`
// taken as the column-major B operand (n = tile row, k = tile column), for
// NB blocks of 8 rows.  The k-step loop is outside the block loop, so the
// NB accumulator chains are independent.
template <int KS, int NB>
__device__ __forceinline__ void mma_blocks(float (&s)[NB][4],
                                           const uint32_t (&a)[KS][4],
                                           const uint16_t* tile, int stride,
                                           int n0) {
  static_assert(KS % 2 == 0, "head dims are multiples of 32");
  const int lane = threadIdx.x & 31, lrow = lane & 7, ltile = lane >> 3;
  const uint16_t* p = tile + (n0 + lrow) * stride + ltile * 8;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ks += 2) {
    uint32_t b[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) ldsm_x4(b[nb], p + nb * 8 * stride + ks * 16);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_16816(s[nb], a[ks], b[nb][0], b[nb][1]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_16816(s[nb], a[ks + 1], b[nb][2], b[nb][3]);
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

// logits s (accumulator layout) of NB blocks of 8 keys from column col0 ->
// e = exp(min(s * scale, 80)), zero for keys past the sequence
template <int NB>
__device__ __forceinline__ void clamp_exp(float (&s)[NB][4], int col0, int L,
                                          float scale) {
  const int col = col0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      s[nb][u] = col + nb * 8 + (u & 1) < L
                     ? exp2f(fminf(s[nb][u] * scale, CLAMP_HI) * LOG2E)
                     : 0.f;
}

// the A fragment of 16 keys (blocks 2 kk and 2 kk + 1 of x) as bf16 pairs
template <int NB>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&x)[NB][4],
                                       int kk) {
  a[0] = pack_bf16x2(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack_bf16x2(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack_bf16x2(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack_bf16x2(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

// The other side of a tile is walked in chunks of KC = 32 rows (4 blocks of
// 8): a chunk past the sequence is skipped, and so is a warp whose 16 rows
// all lie past it, so that L = 197 costs 208 x 224 of tensor-core work, not
// the 256 x 256 of whole tiles.
constexpr int KC = 32;

template <int HD>
constexpr size_t fwd_smem() { return (size_t)(BM + 4 * BN) * (HD + 8) * 2; }

// Forward: out (and l, where rowsum is given) of one 64-row query tile,
// k / v tiles in a two-stage cp.async ring.
template <int HD>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
              const uint16_t* __restrict__ v, const uint16_t* __restrict__ qc,
              const uint16_t* __restrict__ kc,
              const uint16_t* __restrict__ vc, uint16_t* __restrict__ out,
              uint16_t* __restrict__ outc, float* __restrict__ rowsum, Geo g,
              float scale) {
  constexpr int SD = HD + 8, KS = HD / 16, DT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* q_s = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* ring = q_s + BM * SD;  // stage s: k at ring + 2 s BN SD, v after
  const int bh = blockIdx.x / g.tiles, i0 = (blockIdx.x % g.tiles) * BM;
  const int b = bh / g.heads, h = bh % g.heads;

  stage<HD>(q_s, q, qc, g.ld_in, g.ldc_in, g, b, h, i0);
  stage<HD>(ring, k, kc, g.ld_in, g.ldc_in, g, b, h, 0);
  stage<HD>(ring + BN * SD, v, vc, g.ld_in, g.ldc_in, g, b, h, 0);
  cp_async_commit();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const bool active = i0 + warp * 16 < g.L;  // warp-uniform
  uint32_t qa[KS][4];
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  for (int t = 0; t < g.tiles; ++t) {
    if (t + 1 < g.tiles) {  // the next key tile into the other stage
      uint16_t* nxt = ring + ((t + 1) & 1) * 2 * BN * SD;
      stage<HD>(nxt, k, kc, g.ld_in, g.ldc_in, g, b, h, (t + 1) * BN);
      stage<HD>(nxt + BN * SD, v, vc, g.ld_in, g.ldc_in, g, b, h, (t + 1) * BN);
      cp_async_commit();
      cp_async_wait_pending(1);
    } else {
      cp_async_wait_pending(0);
    }
    __syncthreads();
    if (active) {
      if (t == 0) load_a<KS>(qa, q_s, SD, warp * 16);
      const uint16_t* k_s = ring + (t & 1) * 2 * BN * SD;
      const uint16_t* v_s = k_s + BN * SD;
#pragma unroll
      for (int c = 0; c < BN; c += KC) {
        const int col0 = t * BN + c;
        if (col0 >= g.L) break;
        float e[KC / 8][4];
        mma_blocks<KS, KC / 8>(e, qa, k_s, SD, c);
        clamp_exp<KC / 8>(e, col0, g.L, scale);
#pragma unroll
        for (int nb = 0; nb < KC / 8; ++nb) {
          l0 += e[nb][0] + e[nb][1];
          l1 += e[nb][2] + e[nb][3];
        }
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          if (col0 + kk * 16 >= g.L) break;
          uint32_t pa[4];
          pack_a(pa, e, kk);
          mma_cols<DT>(o, pa, v_s, SD, c + kk * 16);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = i0 + warp * 16 + gid + 8 * half;
    if (r >= g.L) continue;
    const float l = half ? l1 : l0, inv = 1.f / l;
    uint16_t* dst = row_of(out, outc, g.ld_g, g.ldc_g, g, b, h, r) + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      if (dt * 8 < g.d)
        *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          pack_bf16x2(o[dt][2 * half] * inv, o[dt][2 * half + 1] * inv);
    if (rowsum != nullptr && tig == 0) rowsum[(size_t)bh * g.L + r] = l;
  }
}

// both backward kernels: the query-major one holds four tiles, the
// key-major one two resident tiles, a two-stage ring of two more and two
// stages of 64 floats twice (its 1 / l and D)
template <int HD>
constexpr size_t bwd_smem() {
  return (size_t)(2 * BM + 4 * BN) * (HD + 8) * 2 + 4 * BM * sizeof(float);
}

// Query-major backward: D (stored for the key-major pass) and dq of one
// 64-row query tile: sweep A over the key tiles sums D_i, sweep B forms ds
// and accumulates dq.
template <int HD>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_q_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                const uint16_t* __restrict__ v,
                const uint16_t* __restrict__ qc,
                const uint16_t* __restrict__ kc,
                const uint16_t* __restrict__ vc,
                const uint16_t* __restrict__ gr,
                const uint16_t* __restrict__ gc,
                const float* __restrict__ rowsum, float* __restrict__ delta,
                uint16_t* __restrict__ dq, uint16_t* __restrict__ dqc, Geo g,
                float scale) {
  constexpr int SD = HD + 8, KS = HD / 16, DT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* q_s = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* g_s = q_s + BM * SD;
  uint16_t* k_s = g_s + BM * SD;
  uint16_t* v_s = k_s + BN * SD;
  const int bh = blockIdx.x / g.tiles, i0 = (blockIdx.x % g.tiles) * BM;
  const int b = bh / g.heads, h = bh % g.heads;

  stage<HD>(q_s, q, qc, g.ld_in, g.ldc_in, g, b, h, i0);
  stage<HD>(g_s, gr, gc, g.ld_g, g.ldc_g, g, b, h, i0);
  cp_async_wait_all();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const bool active = i0 + warp * 16 < g.L;  // warp-uniform
  const int r0 = i0 + warp * 16 + gid, r1 = r0 + 8;
  const float* rs = rowsum + (size_t)bh * g.L;
  // 1 / l (padding rows: p = 1, and their g is 0)
  const float c0 = r0 < g.L ? 1.f / rs[r0] : 1.f;
  const float c1 = r1 < g.L ? 1.f / rs[r1] : 1.f;
  uint32_t qa[KS][4], ga[KS][4];
  if (active) {
    load_a<KS>(qa, q_s, SD, warp * 16);
    load_a<KS>(ga, g_s, SD, warp * 16);
  }
  float d0 = 0.f, d1 = 0.f;
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  for (int sweep = 0; sweep < 2; ++sweep) {
    if (sweep == 1) {  // sweep A is done: D, stored for the key-major pass
      d0 = quad_sum(d0);
      d1 = quad_sum(d1);
      float* dl = delta + (size_t)bh * g.L;
      if (tig == 0) {
        if (r0 < g.L) dl[r0] = d0;
        if (r1 < g.L) dl[r1] = d1;
      }
    }
    for (int j0 = 0; j0 < g.L; j0 += BN) {
      __syncthreads();  // the previous key tile is consumed
      stage<HD>(k_s, k, kc, g.ld_in, g.ldc_in, g, b, h, j0);
      stage<HD>(v_s, v, vc, g.ld_in, g.ldc_in, g, b, h, j0);
      cp_async_wait_all();
      __syncthreads();
      if (!active) continue;
#pragma unroll
      for (int c = 0; c < BN; c += KC) {
        const int col0 = j0 + c;
        if (col0 >= g.L) break;
        float p[KC / 8][4], dp[KC / 8][4];
        mma_blocks<KS, KC / 8>(p, qa, k_s, SD, c);
        mma_blocks<KS, KC / 8>(dp, ga, v_s, SD, c);
        clamp_exp<KC / 8>(p, col0, g.L, scale);
        if (sweep == 0) {  // D_i = sum_j dp_ij p_ij
#pragma unroll
          for (int nb = 0; nb < KC / 8; ++nb) {
            d0 += dp[nb][0] * (p[nb][0] * c0) + dp[nb][1] * (p[nb][1] * c0);
            d1 += dp[nb][2] * (p[nb][2] * c1) + dp[nb][3] * (p[nb][3] * c1);
          }
          continue;
        }
        // ds = p (dp - D); dq += ds k
#pragma unroll
        for (int nb = 0; nb < KC / 8; ++nb) {
          p[nb][0] *= c0 * (dp[nb][0] - d0);
          p[nb][1] *= c0 * (dp[nb][1] - d0);
          p[nb][2] *= c1 * (dp[nb][2] - d1);
          p[nb][3] *= c1 * (dp[nb][3] - d1);
        }
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          if (col0 + kk * 16 >= g.L) break;
          uint32_t da[4];
          pack_a(da, p, kk);
          mma_cols<DT>(acc, da, k_s, SD, c + kk * 16);
        }
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= g.L) continue;
    uint16_t* dst = row_of(dq, dqc, g.ld_d, g.ldc_d, g, b, h, r) + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      if (dt * 8 < g.d)
        *reinterpret_cast<uint32_t*>(dst + dt * 8) = pack_bf16x2(
          acc[dt][2 * half] * scale, acc[dt][2 * half + 1] * scale);
  }
}

// 1 / l and D of query rows [i0, i0 + 64) into shared memory (padding rows:
// 1 and 0, so that their p is 1 and their ds 0)
__device__ __forceinline__ void stage_rows_stats(float* li, float* dd,
                                                 const float* rs,
                                                 const float* dl, int i0,
                                                 int L) {
  for (int t = threadIdx.x; t < BM; t += blockDim.x) {
    li[t] = i0 + t < L ? 1.f / rs[i0 + t] : 1.f;
    dd[t] = i0 + t < L ? dl[i0 + t] : 0.f;
  }
}

// Key-major backward: each CTA owns 64 keys of [frames; cls] and walks
// every query tile (q / g tiles in a two-stage ring), so dk and dv are
// summed in registers in a fixed order.
template <int HD>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_k_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                const uint16_t* __restrict__ v,
                const uint16_t* __restrict__ qc,
                const uint16_t* __restrict__ kc,
                const uint16_t* __restrict__ vc,
                const uint16_t* __restrict__ gr,
                const uint16_t* __restrict__ gc,
                const float* __restrict__ rowsum,
                const float* __restrict__ delta, uint16_t* __restrict__ dk,
                uint16_t* __restrict__ dv, uint16_t* __restrict__ dkc,
                uint16_t* __restrict__ dvc, Geo g, float scale) {
  constexpr int SD = HD + 8, KS = HD / 16, DT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* k_s = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* v_s = k_s + BN * SD;
  uint16_t* ring = v_s + BN * SD;  // stage s: q at ring + 2 s BM SD, g after
  float* stats = reinterpret_cast<float*>(ring + 4 * BM * SD);
  // stage s: 1 / l_i at stats + 2 s BM, D_i after
  const int bh = blockIdx.x / g.tiles, j0 = (blockIdx.x % g.tiles) * BN;
  const int b = bh / g.heads, h = bh % g.heads;
  const float* rs = rowsum + (size_t)bh * g.L;
  const float* dl = delta + (size_t)bh * g.L;

  stage<HD>(k_s, k, kc, g.ld_in, g.ldc_in, g, b, h, j0);
  stage<HD>(v_s, v, vc, g.ld_in, g.ldc_in, g, b, h, j0);
  stage<HD>(ring, q, qc, g.ld_in, g.ldc_in, g, b, h, 0);
  stage<HD>(ring + BM * SD, gr, gc, g.ld_g, g.ldc_g, g, b, h, 0);
  stage_rows_stats(stats, stats + BM, rs, dl, 0, g.L);
  cp_async_commit();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const bool active = j0 + warp * 16 < g.L;  // warp-uniform
  float acc_k[DT][4], acc_v[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    acc_k[dt][0] = acc_k[dt][1] = acc_k[dt][2] = acc_k[dt][3] = 0.f;
    acc_v[dt][0] = acc_v[dt][1] = acc_v[dt][2] = acc_v[dt][3] = 0.f;
  }
  for (int t = 0; t < g.tiles; ++t) {
    if (t + 1 < g.tiles) {
      const int nx = (t + 1) & 1, i1 = (t + 1) * BM;
      uint16_t* nxt = ring + nx * 2 * BM * SD;
      stage<HD>(nxt, q, qc, g.ld_in, g.ldc_in, g, b, h, i1);
      stage<HD>(nxt + BM * SD, gr, gc, g.ld_g, g.ldc_g, g, b, h, i1);
      stage_rows_stats(stats + nx * 2 * BM, stats + nx * 2 * BM + BM, rs, dl,
                       i1, g.L);
      cp_async_commit();
      cp_async_wait_pending(1);
    } else {
      cp_async_wait_pending(0);
    }
    __syncthreads();
    if (active) {
      const uint16_t* q_s = ring + (t & 1) * 2 * BM * SD;
      const uint16_t* g_s = q_s + BM * SD;
      const float* li_s = stats + (t & 1) * 2 * BM;
      const float* d_s = li_s + BM;
#pragma unroll
      for (int c = 0; c < BM; c += KC) {
        if (t * BM + c >= g.L) break;
        // p^T and dp^T = v g^T: rows = this warp's 16 keys, columns = the
        // chunk's 32 queries
        float p[KC / 8][4], ds[KC / 8][4];
        {
          uint32_t ka[KS][4];
          load_a<KS>(ka, k_s, SD, warp * 16);
          mma_blocks<KS, KC / 8>(p, ka, q_s, SD, c);
        }
        {
          uint32_t va[KS][4];
          load_a<KS>(va, v_s, SD, warp * 16);
          mma_blocks<KS, KC / 8>(ds, va, g_s, SD, c);
        }
#pragma unroll
        for (int nb = 0; nb < KC / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = c + nb * 8 + 2 * tig + (e & 1);
            p[nb][e] = exp2f(fminf(p[nb][e] * scale, CLAMP_HI) * LOG2E) * li_s[i];
            ds[nb][e] = p[nb][e] * (ds[nb][e] - d_s[i]);
          }
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          if (t * BM + c + kk * 16 >= g.L) break;
          uint32_t pa[4], da[4];
          pack_a(pa, p, kk);
          pack_a(da, ds, kk);
          mma_cols<DT>(acc_k, da, q_s, SD, c + kk * 16);
          mma_cols<DT>(acc_v, pa, g_s, SD, c + kk * 16);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = j0 + warp * 16 + gid + 8 * half;
    if (j >= g.L) continue;
    uint16_t* kd = row_of(dk, dkc, g.ld_d, g.ldc_d, g, b, h, j) + 2 * tig;
    uint16_t* vd = row_of(dv, dvc, g.ld_d, g.ldc_d, g, b, h, j) + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      if (dt * 8 >= g.d) continue;
      *reinterpret_cast<uint32_t*>(kd + dt * 8) = pack_bf16x2(
          acc_k[dt][2 * half] * scale, acc_k[dt][2 * half + 1] * scale);
      *reinterpret_cast<uint32_t*>(vd + dt * 8) =
          pack_bf16x2(acc_v[dt][2 * half], acc_v[dt][2 * half + 1]);
    }
  }
}

// ------------------------------------------------- fp32 (scalar) kernels

__device__ __forceinline__ float dot(const float* a, const float* b, int d) {
  float s = 0.f;
#pragma unroll 8
  for (int e = 0; e < d; ++e) s = fmaf(a[e], b[e], s);
  return s;
}

// Forward: one warp per query row; shared memory holds the warp's row of
// exponentials [L].
template <int HD>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_scalar(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ qc,
                 const float* __restrict__ kc, const float* __restrict__ vc,
                 float* __restrict__ out, float* __restrict__ outc,
                 float* __restrict__ rowsum, Geo g, float scale) {
  constexpr int U = HD / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = (g.L + WARPS - 1) / WARPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x / rows, i = (blockIdx.x % rows) * WARPS + warp;
  if (i >= g.L) return;  // warp-uniform; no block barrier below
  const int b = bh / g.heads, h = bh % g.heads;
  float* e_w = reinterpret_cast<float*>(smem_raw) + (size_t)warp * g.L;
  const float* qi = row_of(q, qc, g.ld_in, g.ldc_in, g, b, h, i);
  float part = 0.f;
  for (int j = lane; j < g.L; j += 32) {
    const float* kj = row_of(k, kc, g.ld_in, g.ldc_in, g, b, h, j);
    const float e = expf(fminf(dot(qi, kj, g.d) * scale, CLAMP_HI));
    e_w[j] = e;
    part += e;
  }
  const float l = warp_sum(part);
  __syncwarp();
  float o[U];
#pragma unroll
  for (int u = 0; u < U; ++u) o[u] = 0.f;
  for (int j = 0; j < g.L; ++j) {
    const float p = e_w[j] / l;
    const float* vj = row_of(v, vc, g.ld_in, g.ldc_in, g, b, h, j);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (lane + 32 * u < g.d) o[u] = fmaf(p, vj[lane + 32 * u], o[u]);
  }
  float* oi = row_of(out, outc, g.ld_g, g.ldc_g, g, b, h, i);
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (lane + 32 * u < g.d) oi[lane + 32 * u] = o[u];
  if (rowsum != nullptr && lane == 0) rowsum[(size_t)bh * g.L + i] = l;
}

// Query-major backward: one warp per query row; per warp two rows [L] of
// shared memory (p, then ds; and dp).
template <int HD>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_q_scalar(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ qc,
                   const float* __restrict__ kc, const float* __restrict__ vc,
                   const float* __restrict__ gr, const float* __restrict__ gc,
                   const float* __restrict__ rowsum,
                   float* __restrict__ delta, float* __restrict__ dq,
                   float* __restrict__ dqc, Geo g, float scale) {
  constexpr int U = HD / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = (g.L + WARPS - 1) / WARPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x / rows, i = (blockIdx.x % rows) * WARPS + warp;
  if (i >= g.L) return;
  const int b = bh / g.heads, h = bh % g.heads;
  float* p_w = reinterpret_cast<float*>(smem_raw) + (size_t)warp * 2 * g.L;
  float* dp_w = p_w + g.L;
  const float* qi = row_of(q, qc, g.ld_in, g.ldc_in, g, b, h, i);
  const float* gi = row_of(gr, gc, g.ld_g, g.ldc_g, g, b, h, i);
  const float l = rowsum[(size_t)bh * g.L + i];
  float part = 0.f;
  for (int j = lane; j < g.L; j += 32) {
    const float* kj = row_of(k, kc, g.ld_in, g.ldc_in, g, b, h, j);
    const float* vj = row_of(v, vc, g.ld_in, g.ldc_in, g, b, h, j);
    const float p = expf(fminf(dot(qi, kj, g.d) * scale, CLAMP_HI)) / l;
    const float dp = dot(gi, vj, g.d);
    p_w[j] = p;
    dp_w[j] = dp;
    part = fmaf(dp, p, part);
  }
  const float D = warp_sum(part);
  if (lane == 0) delta[(size_t)bh * g.L + i] = D;
  for (int j = lane; j < g.L; j += 32) p_w[j] = p_w[j] * (dp_w[j] - D);
  __syncwarp();
  float a[U];
#pragma unroll
  for (int u = 0; u < U; ++u) a[u] = 0.f;
  for (int j = 0; j < g.L; ++j) {
    const float ds = p_w[j];
    const float* kj = row_of(k, kc, g.ld_in, g.ldc_in, g, b, h, j);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (lane + 32 * u < g.d) a[u] = fmaf(ds, kj[lane + 32 * u], a[u]);
  }
  float* dqi = row_of(dq, dqc, g.ld_d, g.ldc_d, g, b, h, i);
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (lane + 32 * u < g.d) dqi[lane + 32 * u] = a[u] * scale;
}

// Key-major backward: one warp per key row of [frames; cls]; lanes take 32
// queries at a time, then sum their products over them.
template <int HD>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_k_scalar(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ qc,
                   const float* __restrict__ kc, const float* __restrict__ vc,
                   const float* __restrict__ gr, const float* __restrict__ gc,
                   const float* __restrict__ rowsum,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, float* __restrict__ dkc,
                   float* __restrict__ dvc, Geo g, float scale) {
  constexpr int U = HD / 32;
  __shared__ float p_s[WARPS][32], ds_s[WARPS][32];
  const int rows = (g.L + WARPS - 1) / WARPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x / rows, j = (blockIdx.x % rows) * WARPS + warp;
  if (j >= g.L) return;
  const int b = bh / g.heads, h = bh % g.heads;
  const float* kj = row_of(k, kc, g.ld_in, g.ldc_in, g, b, h, j);
  const float* vj = row_of(v, vc, g.ld_in, g.ldc_in, g, b, h, j);
  const float* rs = rowsum + (size_t)bh * g.L;
  const float* dl = delta + (size_t)bh * g.L;
  float ak[U], av[U];
#pragma unroll
  for (int u = 0; u < U; ++u) ak[u] = av[u] = 0.f;
  for (int i0 = 0; i0 < g.L; i0 += 32) {
    const int i = i0 + lane;
    float p = 0.f, ds = 0.f;
    if (i < g.L) {
      const float* qi = row_of(q, qc, g.ld_in, g.ldc_in, g, b, h, i);
      const float* gi = row_of(gr, gc, g.ld_g, g.ldc_g, g, b, h, i);
      p = expf(fminf(dot(qi, kj, g.d) * scale, CLAMP_HI)) / rs[i];
      ds = p * (dot(gi, vj, g.d) - dl[i]);
    }
    p_s[warp][lane] = p;
    ds_s[warp][lane] = ds;
    __syncwarp();
    const int n = min(32, g.L - i0);
    for (int t = 0; t < n; ++t) {
      const float* qi = row_of(q, qc, g.ld_in, g.ldc_in, g, b, h, i0 + t);
      const float* gi = row_of(gr, gc, g.ld_g, g.ldc_g, g, b, h, i0 + t);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (lane + 32 * u >= g.d) continue;
        ak[u] = fmaf(ds_s[warp][t], qi[lane + 32 * u], ak[u]);
        av[u] = fmaf(p_s[warp][t], gi[lane + 32 * u], av[u]);
      }
    }
    __syncwarp();
  }
  float* kd = row_of(dk, dkc, g.ld_d, g.ldc_d, g, b, h, j);
  float* vd = row_of(dv, dvc, g.ld_d, g.ldc_d, g, b, h, j);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (lane + 32 * u >= g.d) continue;
    kd[lane + 32 * u] = ak[u] * scale;
    vd[lane + 32 * u] = av[u];
  }
}

// ------------------------------------------------------------ launchers

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

Geo make_geo(int n, bool cls, int heads, int d, int seqs, long long ld_in,
             long long ldc_in, long long ld_g, long long ldc_g,
             long long ld_d, long long ldc_d) {
  Geo g;
  g.n = n;
  g.L = n + (cls ? 1 : 0);
  g.heads = heads;
  g.d = d;
  g.seqs = seqs;
  g.tiles = (g.L + BM - 1) / BM;
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
         heads > 0 && n + 1 <= MAX_L && d >= 8 && d <= MAX_D && d % 8 == 0 &&
         (dtype == 0 || dtype == 1) && (seqs == 1 || ld < (1LL << 32));
}

template <int HD>
int launch_fwd(const void* q, const void* k, const void* v, const void* qc,
               const void* kc, const void* vc, void* out, void* outc,
               void* rowsum, int b, const Geo& g, int dtype, float scale,
               cudaStream_t st) {
  const long long bh = (long long)b * g.heads;
  if (dtype == 1) {
    using u16 = uint16_t;
    const size_t smem = fwd_smem<HD>();
    cudaError_t err = set_smem(flash_fwd_mma<HD>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_mma<HD><<<(unsigned)(bh * g.tiles), WARPS * 32, smem, st>>>(
        static_cast<const u16*>(q), static_cast<const u16*>(k),
        static_cast<const u16*>(v), static_cast<const u16*>(qc),
        static_cast<const u16*>(kc), static_cast<const u16*>(vc),
        static_cast<u16*>(out), static_cast<u16*>(outc),
        static_cast<float*>(rowsum), g, scale);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)WARPS * g.L * sizeof(float);
  cudaError_t err = set_smem(flash_fwd_scalar<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (g.L + WARPS - 1) / WARPS;
  flash_fwd_scalar<HD><<<(unsigned)(bh * rows), WARPS * 32, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(qc),
      static_cast<const float*>(kc), static_cast<const float*>(vc),
      static_cast<float*>(out), static_cast<float*>(outc),
      static_cast<float*>(rowsum), g, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* qc,
               const void* kc, const void* vc, const void* gr, const void* gc,
               const void* rowsum, void* delta, void* dq, void* dk, void* dv,
               void* dqc, void* dkc, void* dvc, int b, const Geo& g, int dtype,
               float scale, cudaStream_t st) {
  const long long bh = (long long)b * g.heads;
  if (dtype == 1) {
    using u16 = uint16_t;
    const size_t smem = bwd_smem<HD>();
    cudaError_t err = set_smem(flash_bwd_q_mma<HD>, smem);
    if (err != cudaSuccess) return (int)err;
    err = set_smem(flash_bwd_k_mma<HD>, smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = (unsigned)(bh * g.tiles);
    flash_bwd_q_mma<HD><<<grid, WARPS * 32, smem, st>>>(
        static_cast<const u16*>(q), static_cast<const u16*>(k),
        static_cast<const u16*>(v), static_cast<const u16*>(qc),
        static_cast<const u16*>(kc), static_cast<const u16*>(vc),
        static_cast<const u16*>(gr), static_cast<const u16*>(gc),
        static_cast<const float*>(rowsum), static_cast<float*>(delta),
        static_cast<u16*>(dq), static_cast<u16*>(dqc), g, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_k_mma<HD><<<grid, WARPS * 32, smem, st>>>(
        static_cast<const u16*>(q), static_cast<const u16*>(k),
        static_cast<const u16*>(v), static_cast<const u16*>(qc),
        static_cast<const u16*>(kc), static_cast<const u16*>(vc),
        static_cast<const u16*>(gr), static_cast<const u16*>(gc),
        static_cast<const float*>(rowsum), static_cast<const float*>(delta),
        static_cast<u16*>(dk), static_cast<u16*>(dv), static_cast<u16*>(dkc),
        static_cast<u16*>(dvc), g, scale);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)WARPS * 2 * g.L * sizeof(float);
  cudaError_t err = set_smem(flash_bwd_q_scalar<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)(bh * ((g.L + WARPS - 1) / WARPS));
  flash_bwd_q_scalar<HD><<<grid, WARPS * 32, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(qc),
      static_cast<const float*>(kc), static_cast<const float*>(vc),
      static_cast<const float*>(gr), static_cast<const float*>(gc),
      static_cast<const float*>(rowsum), static_cast<float*>(delta),
      static_cast<float*>(dq), static_cast<float*>(dqc), g, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_k_scalar<HD><<<grid, WARPS * 32, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(qc),
      static_cast<const float*>(kc), static_cast<const float*>(vc),
      static_cast<const float*>(gr), static_cast<const float*>(gc),
      static_cast<const float*>(rowsum), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(dkc), static_cast<float*>(dvc), g, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The tile width of head dim d: the narrowest instance >= d.
static int tile_width(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 96 ? 96 : d <= 128 ? 128
       : d <= 192 ? 192 : 256;
}

// dtype: 0 = float32, 1 = bfloat16.  head_dim: a multiple of 8 up to 256.
// b: the number of sequences, seqs of them side by side in each row (1 but
// for K2's layout; b a multiple of seqs, no CLS stream with seqs > 1).  qc,
// kc, vc (and outc, gc, dqc, dkc, dvc) are null without the CLS stream.
// Row strides are in elements: ld_in of q, k, v, ldc_in of qc, kc, vc
// (their batch stride), ld_o / ldc_o of out and outc (forward) or of g and
// gc (backward), ld_d / ldc_d of the gradients; with seqs > 1 each ld must
// be a multiple of seqs.  Every row must be 16-byte aligned.  Each entry
// point returns the CUDA error code of its launches (0 on success).

// The forward: out, outc and, where rowsum is not null, l [b, heads, L]
// (fp32).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* qc,
                                   const void* kc, const void* vc, void* out,
                                   void* outc, void* rowsum, int b, int seqs,
                                   int n, int heads, int head_dim,
                                   long long ld_in, long long ldc_in,
                                   long long ld_o, long long ldc_o, int dtype,
                                   float scale, void* stream) {
  if (!valid(b, seqs, n, heads, head_dim, qc != nullptr, dtype,
             std::max(ld_in, ld_o)))
    return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(n, qc != nullptr, heads, head_dim, seqs, ld_in,
                         ldc_in, ld_o, ldc_o, 0, 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FWD(HD) launch_fwd<HD>(q, k, v, qc, kc, vc, out, outc, rowsum, b, g, \
                               dtype, scale, st)
  switch (tile_width(head_dim)) {
    case 32: return FWD(32);
    case 64: return FWD(64);
    case 96: return FWD(96);
    case 128: return FWD(128);
    case 192: return FWD(192);
    default: return FWD(256);
  }
#undef FWD
}

// The recompute backward from the forward's l: dq, dk, dv (and dqc, dkc,
// dvc).  delta [b, heads, L] fp32 is scratch written by the query-major
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
                                   long long ldc_d, int dtype, float scale,
                                   void* stream) {
  if (!valid(b, seqs, n, heads, head_dim, qc != nullptr, dtype,
             std::max({ld_in, ld_g, ld_d})))
    return (int)cudaErrorInvalidValue;
  const Geo geo = make_geo(n, qc != nullptr, heads, head_dim, seqs, ld_in,
                           ldc_in, ld_g, ldc_g, ld_d, ldc_d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BWD(HD) launch_bwd<HD>(q, k, v, qc, kc, vc, g, gc, rowsum, delta, dq, \
                               dk, dv, dqc, dkc, dvc, b, geo, dtype, scale, st)
  switch (tile_width(head_dim)) {
    case 32: return BWD(32);
    case 64: return BWD(64);
    case 96: return BWD(96);
    case 128: return BWD(128);
    case 192: return BWD(192);
    default: return BWD(256);
  }
#undef BWD
}
