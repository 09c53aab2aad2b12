// Spatial (per-frame) attention of the divided space-time block, with the
// CLS token as a separate stream: forward (K1f), forward that also writes
// the probabilities (K1sp), and the backward from those probabilities (K1b).
//
// Replaces the TPU kernels procedurevrl_tpu/ops/pallas_attention.py:
//   K1f  _fwd_cls_qkv_kernel     (via _flash_cls_qkv_fwd, the primal forward
//        of flash_attention_cls_qkv);
//   K1sp _fwd_cls_qkv_kernel_sp  (via _flash_cls_qkv_fwd_sp, the forward
//        under grad on one device, SPATIAL_SAVE_PROBS=1);
//   K1b  _bwd_cls_qkv_kernel_sp  (via _flash_cls_qkv_bwd_sp, its backward,
//        rowsum form of the softmax jacobian).
//
// Contract (one call per TimeSformer block):
//   qkv   [BT, N, 3C]  fused projection output, columns [q | k | v], heads
//                      interleaved inside each third (head h owns columns
//                      h*64 .. h*64+63 of its third);
//   qkv_c [BT, 1, 3C]  the CLS row of every frame, same columns;
//   out   [BT, N, C], out_c [BT, 1, C];
//   probs [BT, H, L, LS] (K1sp output, K1b input), L = N + 1 rows in the
//                      order [patches; CLS], LS = L rounded up to 8 so rows
//                      are 16-byte aligned; p[i, j] is the probability of
//                      query i on key j after the cast to the value dtype,
//                      exactly the p that multiplies V; columns L..LS-1 are
//                      written as zeros;
//   g [BT, N, C], gc [BT, 1, C] -> dqkv [BT, N, 3C], dqkv_c [BT, 1, 3C].
// Forward: each of the L queries attends over the L keys [patches; CLS]:
// s = (q.k) * scale in fp32, p = exp(min(s, 80)) / sum, p cast to the value
// dtype, o = sum p*v accumulated in fp32.  The CLS row sits at row N of the
// staged tile, as the TPU kernel splices it into its padding row.
// Backward (per frame and head): dv = p^T g with p in the value dtype;
// dp = g v^T in fp32; ds = p * (dp - sum_j dp*p) in fp32, cast to the value
// dtype; dq = scale * ds k, dk = scale * ds^T q, accumulated in fp32.  Like
// the TPU kernel it is the softmax jacobian: it ignores the clamp.
//
// Bounds on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) at the training shape
// (BT = 144, N = 196, C = 768, 12 heads, bf16):
//   K1f  reads 130.7 MB of qkv, writes 43.6 MB:          ~52 us (bytes);
//   K1sp the same plus 136.2 MB of probs (LS = 200):     ~93 us (bytes),
//        17.2 GFLOP, ~17 us at the tensor-core peak;
//   K1b  reads qkv, g (43.6 MB) and probs, writes 130.7 MB of dqkv:
//        441 MB, ~132 us (bytes); 34.3 GFLOP, ~35 us.
// All three are memory-bound.  Design: one CTA per (frame, head) stages
// that head's rows in shared memory with cp.async (all of a CTA's copies in
// flight at once), so every input byte is read from device memory once and
// the L x L logits never reach device memory.
//   * bf16 forward: four warps, each owns 16-query tiles; QK^T and PV run on
//     the tensor cores with mma.sync m16n8k16 (fp32 accumulators).  The
//     logits tile stays in registers; its accumulator layout is reused
//     directly as the A operand of the PV product; the Q, K and V fragments
//     come from shared memory by ldmatrix.  The exponential is exp2f of a
//     log2(e)-scaled argument and each row is normalised by one reciprocal.
//     K1sp is the same template with the probabilities stored from those A
//     fragments (4-byte stores, zeros past L), so the forward math has one
//     copy.
//   * bf16 backward: q, k, v, g (208 x 64 each) and the saved probability
//     tile (208 x 216) fill 210 KB of shared memory.  Pass 1, each warp over
//     16 query rows: dp = g v^T, the row sums D_i = sum_j dp*p (kept in
//     shared memory), ds, and dq = ds k with ds packed in registers as the A
//     operand.  Pass 2, each warp over 16 key rows: ldmatrix.trans of the
//     probability tile gives p^T directly as the A operand of dv = p^T g and,
//     unpacked, in the accumulator layout of dp^T = v g^T (recomputed, cheap
//     next to the bytes), which with D_i gives ds^T for dk = ds^T q.
//   * fp32: scalar FMA paths (the tensor cores have no exact fp32 mode); one
//     warp per query row (forward, backward pass 1) or key row (backward
//     pass 2), lanes over keys for the logits and over the head dimension
//     for the products with V, K, Q and G; expf and a true division.
// Not done yet: overlapping one head's staging with another's compute
// (TMA and a persistent CTA), wgmma.

#include "common.cuh"

namespace {

using namespace pvrl;

constexpr int WARPS = 4;
constexpr float LOG2E = 1.4426950408889634f;

// Row r (0 <= r <= n) of the [patches; CLS] sequence of frame bt: the
// start of its `width` columns.
template <typename T>
__device__ __forceinline__ T* seq_row(T* x, T* x_c, int bt, int r, int n,
                                      int width) {
  return r < n ? x + ((size_t)bt * n + r) * width : x_c + (size_t)bt * width;
}

// probability row stride: L rounded up to 8 elements
__host__ __device__ __forceinline__ int probs_stride(int L) {
  return (L + 7) & ~7;
}

// ------------------------------------------------- fp32 (scalar) kernels

// Shared-memory row stride in elements: 66 keeps the per-lane row reads of
// the logits loop on distinct banks (2-word float2 accesses).
constexpr int SC_STRIDE = HEAD_DIM + 2;

template <typename T, bool SAVE_P>
__global__ void __launch_bounds__(WARPS * 32)
spatial_scalar_kernel(const T* __restrict__ qkv, const T* __restrict__ qkv_c,
                      T* __restrict__ out, T* __restrict__ out_c,
                      T* __restrict__ probs, int n, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = n + 1;
  const int c = heads * HEAD_DIM, c3 = 3 * c;
  const int bt = blockIdx.x / heads, h = blockIdx.x % heads;
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = q_s + (size_t)L * SC_STRIDE;
  T* v_s = k_s + (size_t)L * SC_STRIDE;
  float* p_all = reinterpret_cast<float*>(v_s + (size_t)L * SC_STRIDE);
  const int lp = (L + 31) & ~31;  // per-warp probability row, padded

  // stage q, k, v of this head as element pairs
  for (int idx = threadIdx.x; idx < L * (HEAD_DIM / 2); idx += blockDim.x) {
    const int r = idx / (HEAD_DIM / 2), e = 2 * (idx % (HEAD_DIM / 2));
    const T* src = seq_row(qkv, qkv_c, bt, r, n, c3) + h * HEAD_DIM + e;
#pragma unroll
    for (int part = 0; part < 3; ++part)
      cp_async_pair(q_s + (size_t)part * L * SC_STRIDE + (size_t)r * SC_STRIDE + e,
                    src + part * c);
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* p_s = p_all + warp * lp;
  for (int i = warp; i < L; i += WARPS) {
    float qf[HEAD_DIM];
#pragma unroll
    for (int m = 0; m < HEAD_DIM / 2; ++m) {
      const float2 t = load2(q_s + (size_t)i * SC_STRIDE + 2 * m);
      qf[2 * m] = t.x;
      qf[2 * m + 1] = t.y;
    }
    // logits for keys lane, lane+32, ...; clamp-exp; row sum
    float part_sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const T* kr = k_s + (size_t)j * SC_STRIDE;
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < HEAD_DIM / 2; ++m) {
        const float2 kk = load2(kr + 2 * m);
        s = fmaf(qf[2 * m], kk.x, s);
        s = fmaf(qf[2 * m + 1], kk.y, s);
      }
      const float e = expf(fminf(s * scale, CLAMP_HI));
      p_s[j] = e;
      part_sum += e;
    }
    const float denom = warp_sum(part_sum);
    for (int j = lane; j < L; j += 32) p_s[j] = round_to(p_s[j] / denom, q_s);
    if constexpr (SAVE_P) {
      // this lane wrote p_s[j] itself just above: no sync needed
      const int ls = probs_stride(L);
      T* prow = probs + ((size_t)blockIdx.x * L + i) * ls;
      for (int j = lane; j < ls; j += 32) store1(prow + j, j < L ? p_s[j] : 0.f);
    }
    __syncwarp();
    // PV: lane owns head-dim columns 2*lane, 2*lane+1
    float o0 = 0.f, o1 = 0.f;
    for (int j = 0; j < L; ++j) {
      const float p = p_s[j];
      const float2 vv = load2(v_s + (size_t)j * SC_STRIDE + 2 * lane);
      o0 = fmaf(p, vv.x, o0);
      o1 = fmaf(p, vv.y, o1);
    }
    T* dst = seq_row(out, out_c, bt, i, n, c);
    store2(dst + h * HEAD_DIM + 2 * lane, o0, o1);
    __syncwarp();  // p_s is rewritten by the next row
  }
}

// fp32 backward.  Shared memory: q, k, v, g rows [L x 66], the row sums D_i
// [lp], and per warp two rows [lp] (ds and p of the row in hand).
__global__ void __launch_bounds__(WARPS * 32)
spatial_bwd_scalar_kernel(const float* __restrict__ qkv,
                          const float* __restrict__ qkv_c,
                          const float* __restrict__ probs,
                          const float* __restrict__ g,
                          const float* __restrict__ gc,
                          float* __restrict__ dqkv, float* __restrict__ dqkv_c,
                          int n, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = n + 1, ls = probs_stride(L), lp = (L + 31) & ~31;
  const int c = heads * HEAD_DIM, c3 = 3 * c;
  const int bt = blockIdx.x / heads, h = blockIdx.x % heads;
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* k_s = q_s + (size_t)L * SC_STRIDE;
  float* v_s = k_s + (size_t)L * SC_STRIDE;
  float* g_s = v_s + (size_t)L * SC_STRIDE;
  float* d_s = g_s + (size_t)L * SC_STRIDE;

  for (int idx = threadIdx.x; idx < L * (HEAD_DIM / 2); idx += blockDim.x) {
    const int r = idx / (HEAD_DIM / 2), e = 2 * (idx % (HEAD_DIM / 2));
    const float* src = seq_row(qkv, qkv_c, bt, r, n, c3) + h * HEAD_DIM + e;
#pragma unroll
    for (int part = 0; part < 3; ++part)
      cp_async_pair(q_s + (size_t)part * L * SC_STRIDE + (size_t)r * SC_STRIDE + e,
                    src + part * c);
    cp_async_pair(g_s + (size_t)r * SC_STRIDE + e,
                  seq_row(g, gc, bt, r, n, c) + h * HEAD_DIM + e);
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* pb = probs + (size_t)blockIdx.x * L * ls;
  float* ds_w = d_s + lp + warp * 2 * lp;
  float* p_w = ds_w + lp;

  // pass 1: query rows i
  for (int i = warp; i < L; i += WARPS) {
    float gf[HEAD_DIM];
#pragma unroll
    for (int m = 0; m < HEAD_DIM / 2; ++m) {
      const float2 t = load2(g_s + (size_t)i * SC_STRIDE + 2 * m);
      gf[2 * m] = t.x;
      gf[2 * m + 1] = t.y;
    }
    float part = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float* vr = v_s + (size_t)j * SC_STRIDE;
      float dp = 0.f;
#pragma unroll
      for (int m = 0; m < HEAD_DIM / 2; ++m) {
        const float2 vv = load2(vr + 2 * m);
        dp = fmaf(gf[2 * m], vv.x, dp);
        dp = fmaf(gf[2 * m + 1], vv.y, dp);
      }
      const float p = pb[(size_t)i * ls + j];
      ds_w[j] = dp;
      p_w[j] = p;
      part = fmaf(dp, p, part);
    }
    const float D = warp_sum(part);
    if (lane == 0) d_s[i] = D;
    for (int j = lane; j < L; j += 32) ds_w[j] = p_w[j] * (ds_w[j] - D);
    __syncwarp();
    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < L; ++j) {
      const float w = ds_w[j];
      const float2 kk = load2(k_s + (size_t)j * SC_STRIDE + 2 * lane);
      a0 = fmaf(w, kk.x, a0);
      a1 = fmaf(w, kk.y, a1);
    }
    float* dst = seq_row(dqkv, dqkv_c, bt, i, n, c3) + h * HEAD_DIM;
    store2(dst + 2 * lane, a0 * scale, a1 * scale);
    __syncwarp();  // ds_w / p_w are rewritten by the next row
  }
  __syncthreads();  // every D_i is in shared memory

  // pass 2: key rows j
  for (int j = warp; j < L; j += WARPS) {
    float vf[HEAD_DIM];
#pragma unroll
    for (int m = 0; m < HEAD_DIM / 2; ++m) {
      const float2 t = load2(v_s + (size_t)j * SC_STRIDE + 2 * m);
      vf[2 * m] = t.x;
      vf[2 * m + 1] = t.y;
    }
    for (int i = lane; i < L; i += 32) {
      const float* gr = g_s + (size_t)i * SC_STRIDE;
      float dp = 0.f;
#pragma unroll
      for (int m = 0; m < HEAD_DIM / 2; ++m) {
        const float2 gg = load2(gr + 2 * m);
        dp = fmaf(vf[2 * m], gg.x, dp);
        dp = fmaf(vf[2 * m + 1], gg.y, dp);
      }
      const float p = pb[(size_t)i * ls + j];
      p_w[i] = p;
      ds_w[i] = p * (dp - d_s[i]);
    }
    __syncwarp();
    float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
    for (int i = 0; i < L; ++i) {
      const float w = ds_w[i], p = p_w[i];
      const float2 qq = load2(q_s + (size_t)i * SC_STRIDE + 2 * lane);
      const float2 gg = load2(g_s + (size_t)i * SC_STRIDE + 2 * lane);
      k0 = fmaf(w, qq.x, k0);
      k1 = fmaf(w, qq.y, k1);
      v0 = fmaf(p, gg.x, v0);
      v1 = fmaf(p, gg.y, v1);
    }
    float* dst = seq_row(dqkv, dqkv_c, bt, j, n, c3) + h * HEAD_DIM;
    store2(dst + c + 2 * lane, k0 * scale, k1 * scale);
    store2(dst + 2 * c + 2 * lane, v0, v1);
    __syncwarp();
  }
}

// ------------------------------------------ bf16 (tensor-core) kernels

constexpr int MMA_STRIDE = HEAD_DIM + 8;  // 72 bf16 = 36 words per row

// Stage rows [0, LP) x 64 of one head of a [patches; CLS] stream into a
// [LP x MMA_STRIDE] tile, 16-byte pieces; rows >= L are zero.
__device__ __forceinline__ void stage_rows(uint16_t* dst, const uint16_t* x,
                                           const uint16_t* x_c, int bt, int n,
                                           int width, int col0, int LP) {
  const int L = n + 1;
  for (int idx = threadIdx.x; idx < LP * 8; idx += blockDim.x) {
    const int r = idx / 8, e = 8 * (idx % 8);
    uint16_t* d = dst + r * MMA_STRIDE + e;
    if (r < L) {
      cp_async16(d, seq_row(x, x_c, bt, r, n, width) + col0 + e);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// LP: padded sequence length (multiple of 16); NT = LP / 8 key tiles.
// SAVE_P: also write the probabilities (K1sp).
template <int LP, bool SAVE_P>
__global__ void __launch_bounds__(WARPS * 32)
spatial_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                   const __nv_bfloat16* __restrict__ qkv_c,
                   __nv_bfloat16* __restrict__ out,
                   __nv_bfloat16* __restrict__ out_c,
                   __nv_bfloat16* __restrict__ probs, int n, int heads,
                   float scale) {
  constexpr int NT = LP / 8;   // 8-wide key tiles of the logits row
  constexpr int KT = LP / 16;  // 16-deep key steps of the PV product
  constexpr int MT = LP / 16;  // 16-row query tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* q_s = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* k_s = q_s + LP * MMA_STRIDE;
  uint16_t* v_s = k_s + LP * MMA_STRIDE;
  const int L = n + 1;
  const int c = heads * HEAD_DIM, c3 = 3 * c;
  const int bt = blockIdx.x / heads, h = blockIdx.x % heads;
  const uint16_t* g = reinterpret_cast<const uint16_t*>(qkv);
  const uint16_t* gc = reinterpret_cast<const uint16_t*>(qkv_c);

  // stage q, k, v rows; rows >= L are zero so padded keys contribute exact
  // zeros to PV
#pragma unroll
  for (int part = 0; part < 3; ++part)
    stage_rows(q_s + part * LP * MMA_STRIDE, g, gc, bt, n, c3,
               part * c + h * HEAD_DIM, LP);
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  // ldmatrix: this lane addresses row (lane % 8) of tile (lane / 8)
  const int lrow = lane & 7, ltile = lane >> 3;
  const float scale2 = scale * LOG2E, hi2 = CLAMP_HI * LOG2E;
  const int ls = probs_stride(L);
  uint16_t* p_dst = SAVE_P ? reinterpret_cast<uint16_t*>(probs) +
                                 (size_t)blockIdx.x * L * ls
                           : nullptr;
  for (int mt = warp; mt < MT; mt += WARPS) {
    const int r0 = mt * 16 + gid, r1 = r0 + 8;
    // A fragments of the 16 x 64 query tile: tiles (rows 0-7 | 8-15) x
    // (cols 0-7 | 8-15) of each 16-column step
    uint32_t qa[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      ldsm_x4(qa[ks], q_s + (mt * 16 + (ltile & 1) * 8 + lrow) * MMA_STRIDE +
                          ks * 16 + (ltile >> 1) * 8);
    // S = Q K^T over all LP keys, fp32 accumulators; one ldmatrix gives the
    // B fragments of two 16-deep steps (K rows are the n index)
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const uint16_t* kr = k_s + (nt * 8 + lrow) * MMA_STRIDE + ltile * 8;
#pragma unroll
      for (int ks = 0; ks < 4; ks += 2) {
        uint32_t kb[4];
        ldsm_x4(kb, kr + ks * 16);
        mma_16816(s[nt], qa[ks], kb[0], kb[1]);
        mma_16816(s[nt], qa[ks + 1], kb[2], kb[3]);
      }
    }
    // clamp softmax over the valid keys (columns < L):
    // exp(min(s*scale, 80)) = 2^(min(s*scale*log2e, 80*log2e)); each row's
    // sum is spread over the 4 threads of a quad
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * tig + (e & 1);
        const float x = col < L ? exp2f(fminf(s[nt][e] * scale2, hi2)) : 0.f;
        s[nt][e] = x;
        if (e < 2) sum0 += x; else sum1 += x;
      }
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
    // O = P V: the accumulator layout of two adjacent key tiles is the A
    // fragment of one 16-deep step; p is rounded to bf16 there
    float o[8][4];
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kt][0] * inv0, s[2 * kt][1] * inv0);
      pa[1] = pack_bf16x2(s[2 * kt][2] * inv1, s[2 * kt][3] * inv1);
      pa[2] = pack_bf16x2(s[2 * kt + 1][0] * inv0, s[2 * kt + 1][1] * inv0);
      pa[3] = pack_bf16x2(s[2 * kt + 1][2] * inv1, s[2 * kt + 1][3] * inv1);
      if constexpr (SAVE_P) {
        // rows r0 (pa[0], pa[2]) and r1 (pa[1], pa[3]), column pairs
        // kt*16 + 2*tig and 8 further; LS is a multiple of 8, so a pair is
        // inside the row or wholly past it; columns >= L hold zeros
        const int col = kt * 16 + 2 * tig;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (col + 8 * u >= ls) continue;
          if (r0 < L)
            *reinterpret_cast<uint32_t*>(p_dst + (size_t)r0 * ls + col + 8 * u) =
                pa[2 * u];
          if (r1 < L)
            *reinterpret_cast<uint32_t*>(p_dst + (size_t)r1 * ls + col + 8 * u) =
                pa[2 * u + 1];
        }
      }
      // B fragments of V (keys are the k index): transposed tiles
      // (keys 0-7 | 8-15) x (columns of this dt | the next)
      const uint16_t* vr = v_s + (kt * 16 + (ltile & 1) * 8 + lrow) * MMA_STRIDE +
                           (ltile >> 1) * 8;
#pragma unroll
      for (int dt = 0; dt < 8; dt += 2) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vr + dt * 8);
        mma_16816(o[dt], pa, vb[0], vb[1]);
        mma_16816(o[dt + 1], pa, vb[2], vb[3]);
      }
    }
    // rows < n are patches, row n is the CLS query, rows > n are padding
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (r > n) continue;
      uint16_t* dst = seq_row(reinterpret_cast<uint16_t*>(out),
                              reinterpret_cast<uint16_t*>(out_c), bt, r, n, c) +
                      h * HEAD_DIM + 2 * tig;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
        *reinterpret_cast<uint32_t*>(dst + dt * 8) =
            pack_bf16x2(o[dt][2 * half], o[dt][2 * half + 1]);
    }
  }
}

// Backward.  LP: padded sequence length (64 or 208); the probability tile
// has PSTR = LP + 8 columns (432-byte rows: conflict-free ldmatrix and
// 4-byte row reads).
template <int LP>
__global__ void __launch_bounds__(WARPS * 32)
spatial_bwd_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                       const __nv_bfloat16* __restrict__ qkv_c,
                       const __nv_bfloat16* __restrict__ probs,
                       const __nv_bfloat16* __restrict__ g,
                       const __nv_bfloat16* __restrict__ gc,
                       __nv_bfloat16* __restrict__ dqkv,
                       __nv_bfloat16* __restrict__ dqkv_c, int n, int heads,
                       float scale) {
  constexpr int NT = LP / 8, KT = LP / 16, MT = LP / 16;
  constexpr int PSTR = LP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* q_s = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* k_s = q_s + LP * MMA_STRIDE;
  uint16_t* v_s = k_s + LP * MMA_STRIDE;
  uint16_t* g_s = v_s + LP * MMA_STRIDE;
  uint16_t* p_s = g_s + LP * MMA_STRIDE;
  float* d_s = reinterpret_cast<float*>(p_s + LP * PSTR);
  const int L = n + 1, ls = probs_stride(L);
  const int c = heads * HEAD_DIM, c3 = 3 * c;
  const int bt = blockIdx.x / heads, h = blockIdx.x % heads;
  const uint16_t* x = reinterpret_cast<const uint16_t*>(qkv);
  const uint16_t* x_c = reinterpret_cast<const uint16_t*>(qkv_c);
  const uint16_t* pg = reinterpret_cast<const uint16_t*>(probs) +
                       (size_t)blockIdx.x * L * ls;

#pragma unroll
  for (int part = 0; part < 3; ++part)
    stage_rows(q_s + part * LP * MMA_STRIDE, x, x_c, bt, n, c3,
               part * c + h * HEAD_DIM, LP);
  stage_rows(g_s, reinterpret_cast<const uint16_t*>(g),
             reinterpret_cast<const uint16_t*>(gc), bt, n, c, h * HEAD_DIM, LP);
  // the saved L x LS block; zero past it (columns LS.., rows L..)
  constexpr int PV = PSTR / 8;  // 16-byte pieces per tile row
  for (int idx = threadIdx.x; idx < LP * PV; idx += blockDim.x) {
    const int r = idx / PV, e = 8 * (idx % PV);
    uint16_t* d = p_s + r * PSTR + e;
    if (r < L && e < ls) {
      cp_async16(d, pg + (size_t)r * ls + e);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int lrow = lane & 7, ltile = lane >> 3;
  uint16_t* dx = reinterpret_cast<uint16_t*>(dqkv);
  uint16_t* dx_c = reinterpret_cast<uint16_t*>(dqkv_c);

  // ---- pass 1: 16 query rows per tile; dp = g v^T, D_i, ds, dq = ds k
  for (int mt = warp; mt < MT; mt += WARPS) {
    const int r0 = mt * 16 + gid, r1 = r0 + 8;
    uint32_t ga[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      ldsm_x4(ga[ks], g_s + (mt * 16 + (ltile & 1) * 8 + lrow) * MMA_STRIDE +
                          ks * 16 + (ltile >> 1) * 8);
    float dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      const uint16_t* vr = v_s + (nt * 8 + lrow) * MMA_STRIDE + ltile * 8;
#pragma unroll
      for (int ks = 0; ks < 4; ks += 2) {
        uint32_t vb[4];
        ldsm_x4(vb, vr + ks * 16);
        mma_16816(dp[nt], ga[ks], vb[0], vb[1]);
        mma_16816(dp[nt], ga[ks + 1], vb[2], vb[3]);
      }
    }
    // D_i = sum_j dp_ij p_ij: p read in the accumulator layout
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + 2 * tig;
      const float2 p0 = load_bf16x2(p_s + r0 * PSTR + col);
      const float2 p1 = load_bf16x2(p_s + r1 * PSTR + col);
      d0 = fmaf(dp[nt][0], p0.x, fmaf(dp[nt][1], p0.y, d0));
      d1 = fmaf(dp[nt][2], p1.x, fmaf(dp[nt][3], p1.y, d1));
    }
    d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
    d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
    d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
    d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
    if (tig == 0) {
      d_s[r0] = d0;
      d_s[r1] = d1;
    }
    // ds = p (dp - D), rounded to bf16 as the A fragments of dq = ds k
    float dq[8][4];
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t da[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int nt = 2 * kt + u, col = nt * 8 + 2 * tig;
        const float2 p0 = load_bf16x2(p_s + r0 * PSTR + col);
        const float2 p1 = load_bf16x2(p_s + r1 * PSTR + col);
        da[2 * u] = pack_bf16x2(p0.x * (dp[nt][0] - d0), p0.y * (dp[nt][1] - d0));
        da[2 * u + 1] =
            pack_bf16x2(p1.x * (dp[nt][2] - d1), p1.y * (dp[nt][3] - d1));
      }
      const uint16_t* kr = k_s + (kt * 16 + (ltile & 1) * 8 + lrow) * MMA_STRIDE +
                           (ltile >> 1) * 8;
#pragma unroll
      for (int dt = 0; dt < 8; dt += 2) {
        uint32_t kb[4];
        ldsm_x4_t(kb, kr + dt * 8);
        mma_16816(dq[dt], da, kb[0], kb[1]);
        mma_16816(dq[dt + 1], da, kb[2], kb[3]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (r > n) continue;
      uint16_t* dst = seq_row(dx, dx_c, bt, r, n, c3) + h * HEAD_DIM + 2 * tig;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
        *reinterpret_cast<uint32_t*>(dst + dt * 8) = pack_bf16x2(
            dq[dt][2 * half] * scale, dq[dt][2 * half + 1] * scale);
    }
  }
  __syncthreads();  // every D_i is in shared memory

  // ---- pass 2: 16 key rows per tile; dk = ds^T q, dv = p^T g
  for (int mt = warp; mt < MT; mt += WARPS) {
    const int j0 = mt * 16, r0 = j0 + gid, r1 = r0 + 8;
    uint32_t va[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      ldsm_x4(va[ks], v_s + (j0 + (ltile & 1) * 8 + lrow) * MMA_STRIDE +
                          ks * 16 + (ltile >> 1) * 8);
    float dk[8][4], dv[8][4];
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
      dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
    }
#pragma unroll 2
    for (int kt = 0; kt < KT; ++kt) {  // query rows i = kt*16 .. kt*16+15
      // dp^T [j, i] = v_j . g_i for the two 8-wide column tiles of this step
      float dpt[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        dpt[u][0] = dpt[u][1] = dpt[u][2] = dpt[u][3] = 0.f;
        const uint16_t* gr = g_s + ((2 * kt + u) * 8 + lrow) * MMA_STRIDE + ltile * 8;
#pragma unroll
        for (int ks = 0; ks < 4; ks += 2) {
          uint32_t gb[4];
          ldsm_x4(gb, gr + ks * 16);
          mma_16816(dpt[u], va[ks], gb[0], gb[1]);
          mma_16816(dpt[u], va[ks + 1], gb[2], gb[3]);
        }
      }
      // p^T as an A fragment (rows j, k index i): transposed 8x8 tiles of
      // the stored p[i][j]: (i 0-7 | 8-15) x (j 0-7 | 8-15)
      uint32_t pa[4];
      ldsm_x4_t(pa, p_s + (kt * 16 + (ltile >> 1) * 8 + lrow) * PSTR + j0 +
                        (ltile & 1) * 8);
      // the same registers are p^T in the accumulator layout of dpt[u]:
      // pa[2u] row r0, pa[2u+1] row r1, columns i0, i0 + 1
      uint32_t da[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i0 = kt * 16 + u * 8 + 2 * tig;
        const float D0 = d_s[i0], D1 = d_s[i0 + 1];
        const float2 p0 = unpack_bf16x2(pa[2 * u]);
        const float2 p1 = unpack_bf16x2(pa[2 * u + 1]);
        da[2 * u] = pack_bf16x2(p0.x * (dpt[u][0] - D0), p0.y * (dpt[u][1] - D1));
        da[2 * u + 1] =
            pack_bf16x2(p1.x * (dpt[u][2] - D0), p1.y * (dpt[u][3] - D1));
      }
      // B fragments of q and g (query rows are the k index): transposed
      const int brow = (kt * 16 + (ltile & 1) * 8 + lrow) * MMA_STRIDE +
                       (ltile >> 1) * 8;
#pragma unroll
      for (int dt = 0; dt < 8; dt += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, q_s + brow + dt * 8);
        mma_16816(dk[dt], da, b[0], b[1]);
        mma_16816(dk[dt + 1], da, b[2], b[3]);
        ldsm_x4_t(b, g_s + brow + dt * 8);
        mma_16816(dv[dt], pa, b[0], b[1]);
        mma_16816(dv[dt + 1], pa, b[2], b[3]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (r > n) continue;
      uint16_t* dst = seq_row(dx, dx_c, bt, r, n, c3) + h * HEAD_DIM + 2 * tig;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        *reinterpret_cast<uint32_t*>(dst + c + dt * 8) = pack_bf16x2(
            dk[dt][2 * half] * scale, dk[dt][2 * half + 1] * scale);
        *reinterpret_cast<uint32_t*>(dst + 2 * c + dt * 8) =
            pack_bf16x2(dv[dt][2 * half], dv[dt][2 * half + 1]);
      }
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int LP, bool SAVE_P>
cudaError_t launch_mma(const void* qkv, const void* qkv_c, void* out,
                       void* out_c, void* probs, int bt, int n, int heads,
                       float scale, cudaStream_t stream) {
  const size_t smem = (size_t)3 * LP * MMA_STRIDE * sizeof(uint16_t);
  cudaError_t err = set_smem(spatial_mma_kernel<LP, SAVE_P>, smem);
  if (err != cudaSuccess) return err;
  spatial_mma_kernel<LP, SAVE_P><<<bt * heads, WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(qkv_c),
      static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(out_c),
      static_cast<__nv_bfloat16*>(probs), n, heads, scale);
  return cudaGetLastError();
}

template <bool SAVE_P>
cudaError_t launch_scalar(const void* qkv, const void* qkv_c, void* out,
                          void* out_c, void* probs, int bt, int n, int heads,
                          float scale, cudaStream_t stream) {
  const int L = n + 1, lp = (L + 31) & ~31;
  const size_t smem = (size_t)3 * L * SC_STRIDE * sizeof(float) +
                      (size_t)WARPS * lp * sizeof(float);
  cudaError_t err = set_smem(spatial_scalar_kernel<float, SAVE_P>, smem);
  if (err != cudaSuccess) return err;
  spatial_scalar_kernel<float, SAVE_P><<<bt * heads, WARPS * 32, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(qkv_c),
      static_cast<float*>(out), static_cast<float*>(out_c),
      static_cast<float*>(probs), n, heads, scale);
  return cudaGetLastError();
}

template <bool SAVE_P>
int forward(const void* qkv, const void* qkv_c, void* out, void* out_c,
            void* probs, int bt, int n, int heads, int dtype, float scale,
            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_scalar<SAVE_P>(qkv, qkv_c, out, out_c, probs, bt, n,
                                      heads, scale, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const int L = n + 1;
  if (L <= 64)
    return (int)launch_mma<64, SAVE_P>(qkv, qkv_c, out, out_c, probs, bt, n,
                                       heads, scale, st);
  if (L <= 208)
    return (int)launch_mma<208, SAVE_P>(qkv, qkv_c, out, out_c, probs, bt, n,
                                        heads, scale, st);
  if (L <= 256)
    return (int)launch_mma<256, SAVE_P>(qkv, qkv_c, out, out_c, probs, bt, n,
                                        heads, scale, st);
  return (int)cudaErrorInvalidValue;
}

template <int LP>
cudaError_t launch_bwd_mma(const void* qkv, const void* qkv_c,
                           const void* probs, const void* g, const void* gc,
                           void* dqkv, void* dqkv_c, int bt, int n, int heads,
                           float scale, cudaStream_t stream) {
  const size_t smem = (size_t)4 * LP * MMA_STRIDE * sizeof(uint16_t) +
                      (size_t)LP * (LP + 8) * sizeof(uint16_t) +
                      (size_t)LP * sizeof(float);
  cudaError_t err = set_smem(spatial_bwd_mma_kernel<LP>, smem);
  if (err != cudaSuccess) return err;
  using bf = __nv_bfloat16;
  spatial_bwd_mma_kernel<LP><<<bt * heads, WARPS * 32, smem, stream>>>(
      static_cast<const bf*>(qkv), static_cast<const bf*>(qkv_c),
      static_cast<const bf*>(probs), static_cast<const bf*>(g),
      static_cast<const bf*>(gc), static_cast<bf*>(dqkv),
      static_cast<bf*>(dqkv_c), n, heads, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Head dim is 64.  Each entry point
// returns the CUDA error code of its launch (0 on success).

// K1f.  Sequences of up to 256 tokens with the CLS (n + 1 <= 256; fp32
// staging then needs 207 KB of shared memory).
extern "C" int spatial_attention_fwd(const void* qkv, const void* qkv_c,
                                     void* out, void* out_c, int bt, int n,
                                     int heads, int dtype, float scale,
                                     void* stream) {
  return forward<false>(qkv, qkv_c, out, out_c, nullptr, bt, n, heads, dtype,
                        scale, stream);
}

// K1sp: K1f that also writes probs [bt, heads, n + 1, LS] (LS = n + 1
// rounded up to 8).  Same limits as K1f.
extern "C" int spatial_attention_fwd_probs(const void* qkv, const void* qkv_c,
                                           void* out, void* out_c, void* probs,
                                           int bt, int n, int heads, int dtype,
                                           float scale, void* stream) {
  return forward<true>(qkv, qkv_c, out, out_c, probs, bt, n, heads, dtype,
                       scale, stream);
}

// K1b: dqkv [bt, n, 3C], dqkv_c [bt, 1, 3C] from qkv, qkv_c, the K1sp
// probabilities and the output gradients g [bt, n, C], gc [bt, 1, C].
// n + 1 <= 208 (bf16: 210 KB of shared memory at 208; fp32: 228 KB).
extern "C" int spatial_attention_bwd(const void* qkv, const void* qkv_c,
                                     const void* probs, const void* g,
                                     const void* gc, void* dqkv, void* dqkv_c,
                                     int bt, int n, int heads, int dtype,
                                     float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int L = n + 1;
  if (L > 208) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    const int lp = (L + 31) & ~31;
    const size_t smem = (size_t)4 * L * SC_STRIDE * sizeof(float) +
                        (size_t)(1 + 2 * WARPS) * lp * sizeof(float);
    cudaError_t err = set_smem(spatial_bwd_scalar_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    spatial_bwd_scalar_kernel<<<bt * heads, WARPS * 32, smem, st>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(qkv_c),
        static_cast<const float*>(probs), static_cast<const float*>(g),
        static_cast<const float*>(gc), static_cast<float*>(dqkv),
        static_cast<float*>(dqkv_c), n, heads, scale);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (L <= 64)
    return (int)launch_bwd_mma<64>(qkv, qkv_c, probs, g, gc, dqkv, dqkv_c, bt,
                                   n, heads, scale, st);
  return (int)launch_bwd_mma<208>(qkv, qkv_c, probs, g, gc, dqkv, dqkv_c, bt,
                                  n, heads, scale, st);
}
