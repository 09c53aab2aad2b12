// Temporal attention of the divided space-time block: forward (K2f) and
// backward (K2b), and the saved-probability pair K2v3f / K2v3b, read in
// place from the time-major stream.
//
// Replaces the TPU kernels procedurevrl_tpu/ops/pallas_attention.py:
//   K2f   _temporal_fwd_kernel (via _temporal_fwd, the forward of
//         flash_attention_temporal);
//   K2b   _temporal_bwd_kernel (via _temporal_bwd, its backward);
//   K2v3f _temporal_fwd_kernel_v3 and K2v3b _temporal_bwd_kernel_v3
//         (TEMPORAL_BATCHED=1, the same function with the T logits of a
//         query in one dot over all key frames).
// The TPU forward writes its probabilities in a compact 0/1-expander layout
// for the backward.  Here K2f writes none and K2b recomputes them from q and
// k with the forward's own device function, so it multiplies with exactly
// the values the forward used: p is 8 x 8 per (position, head), 128 bytes
// against 3 KB of qkv.  K2v3 keeps the TPU pair's residual: K2v3f stores p
// [B, N, H, T, T] in the value dtype and K2v3b reads it.
//
// Contract: qkv [B, T, N, 3C] (T <= 16), the fused projection output in the
// time-major stream layout, columns [q | k | v] with heads interleaved
// inside each third; out [B, T, N, C]; g [B, T, N, C] -> dqkv [B, T, N, 3C].
// For every (b, n, head):
//   s[t, t'] = scale * sum_d q[t] k[t'] in fp32,
//   p = exp(min(s, 80)) / sum_t' exp(min(s, 80)), cast to the value dtype
//   (the clamp; TEMPORAL_SHIFT max takes exp(s - m), m the max over the
//   row's T keys, a quad_max in the tensor-core kernels; none exp(s): a
//   compile-time switch, enum Shift of common.cuh),
//   o[t] = sum_t' p[t, t'] v[t'] accumulated in fp32;
//   dp[t, t'] = g[t] . v[t'] in fp32, ds = p (dp - sum_t' dp p) cast to the
//   value dtype, dq[t] = scale sum_t' ds[t, t'] k[t'],
//   dk[t'] = scale sum_t ds[t, t'] q[t], dv[t'] = sum_t p[t, t'] g[t].
// (The TPU kernels round each q*k and g*v product to the input dtype before
// their fp32 sums; here the products are exact in fp32.)
//
// Bounds on an H100 SXM (3.35 TB/s) at the training shape (B = 18, T = 8,
// N = 196, C = 768, bf16): K2f reads 130.0 MB and writes 43.4 MB, ~52 us;
// K2b reads 130.0 MB of qkv and 43.4 MB of g and writes 130.0 MB of dqkv,
// ~91 us; K2v3f also writes 5.4 MB of p and K2v3b reads it.  Their 0.7 and
// 1.7 GFLOP are nothing next to that: memory-bound.
//
// bf16 design.  Every bf16 kernel does its math on the tensor cores with
// mma.sync m16n8k16 on 16-row tiles that hold two patch positions of <= 8
// frames (or one of 9-16): the logits of both come from two products over
// the head's 64 columns (each keeps its own position's rows), and P V, ds K,
// p^T g and ds^T q are one product per 8 output columns with a
// block-diagonal 16 x 16 A operand (one 8 x 8 block per position), so the
// products of both positions and all key frames are single instructions.
// K2f, K2b and K2v3 share these device functions (v3_products, v3_softmax,
// v3_blockdiag_product, v3_bwd_head) in one arithmetic order: for the same
// inputs K2f's output is K2v3f's bit for bit, and K2b's K2v3b's fed
// K2v3f's p.
//   * K2f / K2b (temporal_ring_kernel): persistent CTAs, two per SM, walk
//     items of one tile of a clip times a group of 4 heads (24.6 KB of qkv,
//     K2b also 8.2 KB of g).  A copying warp keeps a ring of 4 (K2b 3)
//     slots full with one TMA box a third on a tensor map of the stream as
//     [B, T, N, 3H, 64] taken in the order (64, T, N, heads, B), so each
//     head's 16 rows land as one 2 KB tile in the 128-byte swizzle (the
//     rows an ldmatrix reads sit in 8 bank groups); frames past T and the
//     missing position of an odd N are the unit's zero fill, and no thread
//     computes an address.  A computing warp per head writes its results
//     over its consumed tiles and stores them with a TMA box each; the slot
//     returns to the ring once its stores have read it, one item later, so
//     stores and loads overlap the products.
//   * K2v3f / K2v3b (temporal_v3_*_kernel): one CTA of 4 warps per 16-row
//     tile, staged by cp.async from every thread.
// fp32 runs the scalar kernels (temporal_kernel / temporal_bwd_kernel),
// K2v3 with the store or the load of p in place of the softmax: one CTA per
// patch position (b, n) stages that position's T rows of 3C values (and,
// backward, of C gradient values) in shared memory with 16-byte cp.async
// copies; two threads per (frame t, head) query row, each owning 32 of the
// 64 head-dimension columns, compute its T logits and the softmax.
//   * forward: the row's outputs go back over its own query slot and the
//     CTA stores the T output rows with 16-byte coalesced writes.
//   * backward, phase 1 per query row (t, head): p, dp, ds (p and ds to
//     shared memory) and dq[t]; phase 2 per key row (t', head), after a
//     barrier: dk[t'] and dv[t'] sum over t from shared memory.
// Head slots are padded by 8 elements, which keeps them 16-byte aligned.

#include <algorithm>

#include "common.cuh"
#include "tma.cuh"

namespace {

using namespace pvrl;

constexpr int HEAD_STRIDE = HEAD_DIM + 8;  // padded head slot in smem
constexpr int MAX_T = 16;
constexpr int HALF = HEAD_DIM / 2;  // head-dim columns per thread

// The probabilities p[u] (u < frames) of one query row, from this thread's
// half of the head dimension of q and of the keys k0 + u * kstep; the two
// halves of a row are adjacent lanes (`mask`) and end with the same row.
template <typename T_, int S>
__device__ __forceinline__ void softmax_row(const T_* q, const T_* k0,
                                            size_t kstep, int frames,
                                            float scale, unsigned mask,
                                            float (&s)[MAX_T]) {
#pragma unroll
  for (int u = 0; u < MAX_T; ++u) s[u] = 0.f;
#pragma unroll 4
  for (int m = 0; m < HALF / 2; ++m) {
    const float2 qq = load2(q + 2 * m);
#pragma unroll
    for (int u = 0; u < MAX_T; ++u) {
      if (u < frames) {
        const float2 kk = load2(k0 + u * kstep + 2 * m);
        s[u] = fmaf(qq.x, kk.x, s[u]);
        s[u] = fmaf(qq.y, kk.y, s[u]);
      }
    }
  }
  // both lanes of the row hold its whole logits; kMax: their max
  float m = -INFINITY;
#pragma unroll
  for (int u = 0; u < MAX_T; ++u) {
    if (u < frames) {
      s[u] += __shfl_xor_sync(mask, s[u], 1);
      s[u] *= scale;
      if constexpr (S == kMax) m = fmaxf(m, s[u]);
    }
  }
  float denom = 0.f;
#pragma unroll
  for (int u = 0; u < MAX_T; ++u) {
    if (u < frames) {
      s[u] = expf(shift_arg<S>(s[u], m));
      denom += s[u];
    }
  }
#pragma unroll
  for (int u = 0; u < MAX_T; ++u) {
    if (u < frames) s[u] = round_to(s[u] / denom, q);
  }
}

// Stage the T rows of `width` values at src, src + row_stride, ... into
// smem slots of HEAD_STRIDE (slot = first_slot + column / 64 of frame t's
// `slots` slots), 16-byte pieces.
template <typename T_>
__device__ __forceinline__ void stage_frames(T_* sm, const T_* src,
                                             size_t row_stride, int frames,
                                             int width, int slots,
                                             int first_slot) {
  constexpr int V = 16 / sizeof(T_);
  const int vecs = width / V;
  for (int idx = threadIdx.x; idx < frames * vecs; idx += blockDim.x) {
    const int t = idx / vecs, e = V * (idx % vecs);
    const int slot = first_slot + e / HEAD_DIM, d = e % HEAD_DIM;
    cp_async16(sm + ((size_t)t * slots + slot) * HEAD_STRIDE + d,
               src + t * row_stride + e);
  }
}

// this thread's 32 head-dim columns, times mul, as 16-byte stores
template <typename T_>
__device__ __forceinline__ void store_half(T_* dst, const float (&v)[HALF],
                                           float mul) {
  constexpr int V = 16 / sizeof(T_);
#pragma unroll
  for (int i = 0; i < HALF; i += V) {
    float w[V];
#pragma unroll
    for (int j = 0; j < V; ++j) w[j] = v[i + j] * mul;
    store16(dst + i, w);
  }
}

// dynamic smem: [T][3][heads][HEAD_STRIDE] elements of T_.  SAVE_P: also
// write p to probs [B, N, H, T, T] (K2v3f's scalar path).
template <typename T_, bool SAVE_P, int S>
__global__ void temporal_kernel(const T_* __restrict__ qkv, T_* __restrict__ out,
                                T_* __restrict__ probs, int frames, int n,
                                int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T_* sm = reinterpret_cast<T_*>(smem_raw);
  const int c = heads * HEAD_DIM, c3 = 3 * c;
  const int b = blockIdx.x / n, pos = blockIdx.x % n;
  const T_* src = qkv + ((size_t)b * frames * n + pos) * c3;

  // stage: 16-byte pieces, contiguous along each frame's 3C row
  stage_frames(sm, src, (size_t)n * c3, frames, c3, 3 * heads, 0);
  cp_async_wait_all();
  __syncthreads();

  // two threads per query row (t, head), each owning half of the head
  // dimension; partners are adjacent lanes
  const int row = threadIdx.x / 2, half = threadIdx.x % 2;
  const bool active = row < frames * heads;
  const unsigned mask = __ballot_sync(0xffffffffu, active);
  if (active) {
    const int t = row / heads, h = row % heads;
    T_* q = sm + ((size_t)t * 3 * heads + h) * HEAD_STRIDE + half * HALF;
    const size_t kstep = (size_t)3 * heads * HEAD_STRIDE;  // next frame
    const T_* k0 = sm + ((size_t)heads + h) * HEAD_STRIDE + half * HALF;
    const T_* v0 = sm + ((size_t)2 * heads + h) * HEAD_STRIDE + half * HALF;

    float s[MAX_T];
    softmax_row<T_, S>(q, k0, kstep, frames, scale, mask, s);
    if constexpr (SAVE_P) {
      if (half == 0) {
        T_* prow = probs + (((size_t)blockIdx.x * heads + h) * frames + t) * frames;
#pragma unroll
        for (int u = 0; u < MAX_T; ++u) {
          if (u < frames) store1(prow + u, s[u]);
        }
      }
    }
    // the row's probabilities go to this thread's half of its query slot
    // (consumed; 32 elements hold MAX_T floats), so the PV loop over frames
    // can run without unrolling: a fully unrolled body is thousands of
    // instructions
    float* p_s = reinterpret_cast<float*>(q);
#pragma unroll
    for (int u = 0; u < MAX_T; ++u) {
      if (u < frames) p_s[u] = s[u];
    }
    float o[HALF];
#pragma unroll
    for (int d = 0; d < HALF; ++d) o[d] = 0.f;
#pragma unroll 1
    for (int u = 0; u < frames; ++u) {
      const float p = p_s[u];
      const T_* v = v0 + u * kstep;
#pragma unroll
      for (int m = 0; m < HALF / 2; ++m) {
        const float2 vv = load2(v + 2 * m);
        o[2 * m] = fmaf(p, vv.x, o[2 * m]);
        o[2 * m + 1] = fmaf(p, vv.y, o[2 * m + 1]);
      }
    }
    // this half of the query slot is read by this thread only: o goes there
#pragma unroll
    for (int m = 0; m < HALF / 2; ++m) store2(q + 2 * m, o[2 * m], o[2 * m + 1]);
  }
  __syncthreads();

  // store: each frame's C outputs are the q slots of its heads
  constexpr int VO = 16 / sizeof(T_);
  const int ovecs = c / VO;
  T_* dst = out + ((size_t)b * frames * n + pos) * c;
  for (int idx = threadIdx.x; idx < frames * ovecs; idx += blockDim.x) {
    const int t = idx / ovecs, e = VO * (idx % ovecs);
    const int h = e / HEAD_DIM, d = e % HEAD_DIM;
    *reinterpret_cast<uint4*>(dst + (size_t)t * n * c + e) =
        *reinterpret_cast<const uint4*>(sm + ((size_t)t * 3 * heads + h) * HEAD_STRIDE + d);
  }
}

// dynamic smem: [T][4][heads][HEAD_STRIDE] elements of T_ (q, k, v and g
// slots of each frame), then p and ds as floats [T * heads][T].  SAVED_P:
// read p from probs [B, N, H, T, T] (K2v3b's scalar path) instead of
// recomputing it.
template <typename T_, bool SAVED_P, int S>
__global__ void temporal_bwd_kernel(const T_* __restrict__ qkv,
                                    const T_* __restrict__ g,
                                    const T_* __restrict__ probs,
                                    T_* __restrict__ dqkv, int frames, int n,
                                    int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T_* sm = reinterpret_cast<T_*>(smem_raw);
  const int slots = 4 * heads;
  float* p_sm = reinterpret_cast<float*>(sm + (size_t)frames * slots * HEAD_STRIDE);
  float* ds_sm = p_sm + frames * heads * frames;
  const int c = heads * HEAD_DIM, c3 = 3 * c;
  const int b = blockIdx.x / n, pos = blockIdx.x % n;
  const size_t row0 = (size_t)b * frames * n + pos;  // (b, t = 0, pos)

  stage_frames(sm, qkv + row0 * c3, (size_t)n * c3, frames, c3, slots, 0);
  stage_frames(sm, g + row0 * c, (size_t)n * c, frames, c, slots, 3 * heads);
  cp_async_wait_all();
  __syncthreads();

  const int row = threadIdx.x / 2, half = threadIdx.x % 2;
  const bool active = row < frames * heads;
  const unsigned mask = __ballot_sync(0xffffffffu, active);
  const size_t fstep = (size_t)slots * HEAD_STRIDE;  // next frame
  const int t = row / heads, h = row % heads;
  // this thread's half of head h in frame 0's q / k / v / g slots
  const T_* q0 = sm + (size_t)h * HEAD_STRIDE + half * HALF;
  const T_* k0 = q0 + (size_t)heads * HEAD_STRIDE;
  const T_* v0 = q0 + (size_t)2 * heads * HEAD_STRIDE;
  const T_* g0 = q0 + (size_t)3 * heads * HEAD_STRIDE;

  // phase 1, query row (t, h): p, dp, ds; dq[t]
  if (active) {
    float p[MAX_T], ds[MAX_T];
    if constexpr (SAVED_P) {
      const T_* prow = probs + (((size_t)blockIdx.x * heads + h) * frames + t) * frames;
#pragma unroll
      for (int u = 0; u < MAX_T; ++u) p[u] = u < frames ? load1(prow + u) : 0.f;
    } else {
      softmax_row<T_, S>(q0 + t * fstep, k0, fstep, frames, scale, mask, p);
    }
#pragma unroll
    for (int u = 0; u < MAX_T; ++u) ds[u] = 0.f;
    const T_* gt = g0 + t * fstep;
#pragma unroll 4
    for (int m = 0; m < HALF / 2; ++m) {
      const float2 gg = load2(gt + 2 * m);
#pragma unroll
      for (int u = 0; u < MAX_T; ++u) {
        if (u < frames) {
          const float2 vv = load2(v0 + u * fstep + 2 * m);
          ds[u] = fmaf(gg.x, vv.x, ds[u]);
          ds[u] = fmaf(gg.y, vv.y, ds[u]);
        }
      }
    }
    float rowsum = 0.f;
#pragma unroll
    for (int u = 0; u < MAX_T; ++u) {
      if (u < frames) {
        ds[u] += __shfl_xor_sync(mask, ds[u], 1);  // dp
        rowsum = fmaf(ds[u], p[u], rowsum);
      }
    }
    float* p_row = p_sm + row * frames;
    float* ds_row = ds_sm + row * frames;
#pragma unroll
    for (int u = 0; u < MAX_T; ++u) {
      if (u < frames) {
        ds[u] = round_to(p[u] * (ds[u] - rowsum), q0);
        if (half == 0) {
          p_row[u] = p[u];
          ds_row[u] = ds[u];
        }
      }
    }
    __syncwarp(mask);
    float acc[HALF];
#pragma unroll
    for (int d = 0; d < HALF; ++d) acc[d] = 0.f;
#pragma unroll 1
    for (int u = 0; u < frames; ++u) {
      const float w = ds_row[u];
      const T_* k = k0 + u * fstep;
#pragma unroll
      for (int m = 0; m < HALF / 2; ++m) {
        const float2 kk = load2(k + 2 * m);
        acc[2 * m] = fmaf(w, kk.x, acc[2 * m]);
        acc[2 * m + 1] = fmaf(w, kk.y, acc[2 * m + 1]);
      }
    }
    store_half(dqkv + (row0 + (size_t)t * n) * c3 + h * HEAD_DIM + half * HALF,
               acc, scale);
  }
  __syncthreads();  // every row's p and ds are in shared memory

  // phase 2, key row (t' = t, h): dk[t'] and dv[t'] sum over query frames
  if (active) {
    float dk[HALF], dv[HALF];
#pragma unroll
    for (int d = 0; d < HALF; ++d) dk[d] = dv[d] = 0.f;
#pragma unroll 1
    for (int u = 0; u < frames; ++u) {  // query frame
      const int at = (u * heads + h) * frames + t;
      const float w = ds_sm[at], pw = p_sm[at];
      const T_* qu = q0 + u * fstep;
      const T_* gu = g0 + u * fstep;
#pragma unroll
      for (int m = 0; m < HALF / 2; ++m) {
        const float2 qq = load2(qu + 2 * m);
        const float2 gg = load2(gu + 2 * m);
        dk[2 * m] = fmaf(w, qq.x, dk[2 * m]);
        dk[2 * m + 1] = fmaf(w, qq.y, dk[2 * m + 1]);
        dv[2 * m] = fmaf(pw, gg.x, dv[2 * m]);
        dv[2 * m + 1] = fmaf(pw, gg.y, dv[2 * m + 1]);
      }
    }
    T_* dst = dqkv + (row0 + (size_t)t * n) * c3 + h * HEAD_DIM + half * HALF;
    store_half(dst + c, dk, scale);
    store_half(dst + 2 * c, dv, 1.f);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

int threads_for(int frames, int heads) {
  return ((2 * frames * heads + 31) / 32) * 32;
}

template <typename T_, bool SAVE_P, int S>
cudaError_t launch(const void* qkv, void* out, void* probs, int batch,
                   int frames, int n, int heads, float scale,
                   cudaStream_t stream) {
  const int threads = threads_for(frames, heads);
  if (threads > 1024) return cudaErrorInvalidValue;
  const size_t smem = (size_t)frames * 3 * heads * HEAD_STRIDE * sizeof(T_);
  cudaError_t err = set_smem(temporal_kernel<T_, SAVE_P, S>, smem);
  if (err != cudaSuccess) return err;
  temporal_kernel<T_, SAVE_P, S><<<batch * n, threads, smem, stream>>>(
      static_cast<const T_*>(qkv), static_cast<T_*>(out),
      static_cast<T_*>(probs), frames, n, heads, scale);
  return cudaGetLastError();
}

template <typename T_, bool SAVED_P, int S>
cudaError_t launch_bwd(const void* qkv, const void* g, const void* probs,
                       void* dqkv, int batch, int frames, int n, int heads,
                       float scale, cudaStream_t stream) {
  const int threads = threads_for(frames, heads);
  if (threads > 1024) return cudaErrorInvalidValue;
  const size_t smem = (size_t)frames * 4 * heads * HEAD_STRIDE * sizeof(T_) +
                      (size_t)2 * frames * heads * frames * sizeof(float);
  cudaError_t err = set_smem(temporal_bwd_kernel<T_, SAVED_P, S>, smem);
  if (err != cudaSuccess) return err;
  temporal_bwd_kernel<T_, SAVED_P, S><<<batch * n, threads, smem, stream>>>(
      static_cast<const T_*>(qkv), static_cast<const T_*>(g),
      static_cast<const T_*>(probs), static_cast<T_*>(dqkv), frames, n, heads,
      scale);
  return cudaGetLastError();
}

// ------------------------------------------ 16-row tensor-core tiles (bf16)
// The bf16 kernels put 16 / FR patch positions into the 16 rows of one
// m16n8k16 tile: row r = u * FR + t is frame t of the tile's position u.
// FR = 8: two positions, frames <= 8; FR = 16: one position, frames <= 16.
// Rows of missing frames or positions are zero.  K2v3 pairs the positions
// P = b * N + pos, 2j and 2j + 1; K2f / K2b pair positions 2j and 2j + 1 of
// one clip (the same pairs for an even N).
constexpr int V3_WARPS = 4;
constexpr int V3_ROWS = 16;
constexpr int V3_TS = 24;  // per-warp 16 x 16 tile, 48-byte rows

// One head's 16 x 64 tile of q, k, v or g in shared memory: the address of
// element (row, col), col even (a multiple of 8 for an ldmatrix row).
// PadTile: rows of rs elements from p (K2v3's stage, p at the head's first
// column).
struct PadTile {
  uint16_t* p;
  int rs;
  __device__ __forceinline__ uint16_t* at(int row, int col) const {
    return p + row * rs + col;
  }
};
// SwzTile: 16 rows of 128 bytes from a 1024-byte aligned p, the 16-byte
// piece c of row r at piece c ^ (r % 8): the TMA unit's 128-byte swizzle,
// which puts the 8 rows an ldmatrix reads in 8 different bank groups.
struct SwzTile {
  uint16_t* p;
  __device__ __forceinline__ uint16_t* at(int row, int col) const {
    return p + row * HEAD_DIM + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
  }
};

// row (b, t, pos) of a [B, T, N, width] stream for position P = b * N + pos
__device__ __forceinline__ size_t stream_row(int P, int t, int frames, int n) {
  return ((size_t)(P / n) * frames + t) * n + P % n;
}

// the 16 rows of `width` columns of src into smem columns col0.. of rows of
// rs elements (16-byte cp.async pieces, not waited for)
template <int FR>
__device__ __forceinline__ void v3_stage(uint16_t* sm, int rs, int col0,
                                         const uint16_t* src, int width,
                                         int p0, int positions, int frames,
                                         int n) {
  const int vecs = width / 8;
  for (int idx = threadIdx.x; idx < V3_ROWS * vecs; idx += blockDim.x) {
    const int r = idx / vecs, e = 8 * (idx % vecs);
    const int u = r / FR, t = r % FR, P = p0 + u;
    uint16_t* d = sm + (size_t)r * rs + col0 + e;
    if (t < frames && P < positions) {
      cp_async16(d, src + stream_row(P, t, frames, n) * width + e);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// X Y^T of one head: A = the 16 rows of X, B = rows 0-7 (s0) and rows 8-15
// (s1) of Y, in the accumulator layout: s[0..1] row lane/4, s[2..3] row
// lane/4 + 8, against the B rows 2*(lane%4) and +1.  With two positions
// (FR = 8) a thread keeps its own position's rows, s0[0..1] and s1[2..3];
// with one, all of them.
template <class Tile>
__device__ __forceinline__ void v3_products(const Tile& x, const Tile& y,
                                            float (&s0)[4], float (&s1)[4]) {
  const int lane = threadIdx.x % 32, lrow = lane & 7, ltile = lane >> 3;
  uint32_t xa[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldsm_x4(xa[ks], x.at((ltile & 1) * 8 + lrow, ks * 16 + (ltile >> 1) * 8));
#pragma unroll
  for (int e = 0; e < 4; ++e) s0[e] = s1[e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ks += 2) {
    uint32_t kb[4];
    ldsm_x4(kb, y.at(lrow, ltile * 8 + ks * 16));
    mma_16816(s0, xa[ks], kb[0], kb[1]);
    mma_16816(s0, xa[ks + 1], kb[2], kb[3]);
    ldsm_x4(kb, y.at(8 + lrow, ltile * 8 + ks * 16));
    mma_16816(s1, xa[ks], kb[0], kb[1]);
    mma_16816(s1, xa[ks + 1], kb[2], kb[3]);
  }
}

// The softmax under shift S of one head's logits s0, s1 (v3_products of q
// and k) over each row's `frames` keys, in registers (a quad holds a row;
// kMax takes the max over the row's quad), as the
// A fragment of P V: with two positions block-diagonal, position 0's 8 x 8
// block in a[0], position 1's in a[3]; with one, a[w] holds row gid + 8 (w
// & 1) over key frames 8 (w >> 1) + 2 tig and + 1.  Keys past `frames` get
// p = 0.  The one softmax of K2f, K2v3f and K2b's recomputation.
template <int FR, int S>
__device__ __forceinline__ void v3_softmax(const float (&s0)[4],
                                           const float (&s1)[4], int frames,
                                           float scale2, uint32_t (&a)[4]) {
  const int tig = (threadIdx.x % 32) & 3;
  if constexpr (FR == 8) {
    // kMax: -(row max) scale2 of the two positions' rows
    float na = 0.f, nb = 0.f;
    if constexpr (S == kMax) {
      float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (2 * tig + e < frames) {
          ma = fmaxf(ma, s0[e]);
          mb = fmaxf(mb, s1[2 + e]);
        }
      na = -quad_max(ma) * scale2;
      nb = -quad_max(mb) * scale2;
    }
    float ea[2], eb[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool key = 2 * tig + e < frames;
      ea[e] = key ? exp2f(shift_arg2<S>(s0[e], scale2, na)) : 0.f;
      eb[e] = key ? exp2f(shift_arg2<S>(s1[2 + e], scale2, nb)) : 0.f;
    }
    const float ia = 1.f / quad_sum(ea[0] + ea[1]);
    const float ib = 1.f / quad_sum(eb[0] + eb[1]);
    a[0] = pack_bf16x2(ea[0] * ia, ea[1] * ia);
    a[1] = a[2] = 0u;
    a[3] = pack_bf16x2(eb[0] * ib, eb[1] * ib);
  } else {
    // one position: rows lane/4 (e < 2) and lane/4 + 8 over key frames
    // 2*(lane%4) + (e & 1) (s0) and 8 more (s1)
    // kMax: -(row max) scale2 of the rows lane/4 (e < 2) and lane/4 + 8
    float nt = 0.f, nb = 0.f;
    if constexpr (S == kMax) {
      float mt = -INFINITY, mb = -INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& m = e < 2 ? mt : mb;
        if (2 * tig + (e & 1) < frames) m = fmaxf(m, s0[e]);
        if (8 + 2 * tig + (e & 1) < frames) m = fmaxf(m, s1[e]);
      }
      nt = -quad_max(mt) * scale2;
      nb = -quad_max(mb) * scale2;
    }
    float e0[4], e1[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool key0 = 2 * tig + (e & 1) < frames;
      const bool key1 = 8 + 2 * tig + (e & 1) < frames;
      const float nm = e < 2 ? nt : nb;
      e0[e] = key0 ? exp2f(shift_arg2<S>(s0[e], scale2, nm)) : 0.f;
      e1[e] = key1 ? exp2f(shift_arg2<S>(s1[e], scale2, nm)) : 0.f;
    }
    const float it = 1.f / quad_sum(e0[0] + e0[1] + e1[0] + e1[1]);
    const float ib = 1.f / quad_sum(e0[2] + e0[3] + e1[2] + e1[3]);
    a[0] = pack_bf16x2(e0[0] * it, e0[1] * it);
    a[1] = pack_bf16x2(e0[2] * ib, e0[3] * ib);
    a[2] = pack_bf16x2(e1[0] * it, e1[1] * it);
    a[3] = pack_bf16x2(e1[2] * ib, e1[3] * ib);
  }
}

// acc = A Y for the A fragment `a` of a 16 x 16 matrix (with two positions
// block-diagonal: position 0's 8 x 8 block, then position 1's) and the 16
// rows of Y (the k index) as transposed B fragments
template <class Tile>
__device__ __forceinline__ void v3_blockdiag_product(const uint32_t (&a)[4],
                                                     const Tile& y,
                                                     float (&acc)[8][4]) {
  const int lane = threadIdx.x % 32, lrow = lane & 7, ltile = lane >> 3;
#pragma unroll
  for (int dt = 0; dt < 8; dt += 2) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
    acc[dt + 1][0] = acc[dt + 1][1] = acc[dt + 1][2] = acc[dt + 1][3] = 0.f;
    uint32_t b[4];
    ldsm_x4_t(b, y.at((ltile & 1) * 8 + lrow, (ltile >> 1) * 8 + dt * 8));
    mma_16816(acc[dt], a, b[0], b[1]);
    mma_16816(acc[dt + 1], a, b[2], b[3]);
  }
}

// acc * mul as bf16 over the 16 rows of a tile
template <class Tile>
__device__ __forceinline__ void v3_store_rows(const Tile& t,
                                              const float (&acc)[8][4],
                                              float mul) {
  const int lane = threadIdx.x % 32, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    *reinterpret_cast<uint32_t*>(t.at(gid, dt * 8 + 2 * tig)) =
        pack_bf16x2(acc[dt][0] * mul, acc[dt][1] * mul);
    *reinterpret_cast<uint32_t*>(t.at(8 + gid, dt * 8 + 2 * tig)) =
        pack_bf16x2(acc[dt][2] * mul, acc[dt][3] * mul);
  }
}

// The backward of one head from its p (p[w][e]: row gid + 8 (w & 1), key
// frame 8 (w >> 1) + 2 tig + e, the order of v3_softmax's fragment; with two
// positions only p[0] and p[3]): dp = g v^T (v3_products), D_t = sum_s dp p
// over the quad, ds = p (dp - D); dv = p^T g and dk = ds^T q with the
// transposes from the warp's two 16 x 16 tiles (ds_t, p_t) by
// ldmatrix.trans, dq = ds k with ds from registers.  dv, dk and dq go over
// the consumed v, k and q tiles.  The one body of K2v3b and K2b.
template <int FR, class Tile>
__device__ __forceinline__ void v3_bwd_head(const float (&p)[4][2],
                                            const Tile& q, const Tile& k,
                                            const Tile& v, const Tile& g,
                                            uint16_t* ds_t, uint16_t* p_t,
                                            float scale) {
  const int lane = threadIdx.x % 32, gid = lane >> 2, tig = lane & 3;
  const int lrow = lane & 7, ltile = lane >> 3;
  float dp0[4], dp1[4];
  v3_products(g, v, dp0, dp1);
  uint32_t ds[4], pw[4];
  if constexpr (FR == 8) {
    // this thread's rows: frame lane/4 of both positions
    const float dpa[2] = {dp0[0], dp0[1]}, dpb[2] = {dp1[2], dp1[3]};
    const float(&pa)[2] = p[0];
    const float(&pb)[2] = p[3];
    const float da = quad_sum(fmaf(dpa[0], pa[0], dpa[1] * pa[1]));
    const float db = quad_sum(fmaf(dpb[0], pb[0], dpb[1] * pb[1]));
    ds[0] = pack_bf16x2(pa[0] * (dpa[0] - da), pa[1] * (dpa[1] - da));
    ds[3] = pack_bf16x2(pb[0] * (dpb[0] - db), pb[1] * (dpb[1] - db));
    ds[1] = ds[2] = 0u;
    pw[0] = pack_bf16x2(pa[0], pa[1]);
    pw[3] = pack_bf16x2(pb[0], pb[1]);
    pw[1] = pw[2] = 0u;
  } else {
    // dp in p's order: w = 0 rows gid s0[0..1], 1 rows gid + 8 s0[2..3],
    // 2 rows gid s1[0..1], 3 rows gid + 8 s1[2..3]
    const float dp[4][2] = {{dp0[0], dp0[1]}, {dp0[2], dp0[3]},
                            {dp1[0], dp1[1]}, {dp1[2], dp1[3]}};
    const float dtop = quad_sum(fmaf(dp[0][0], p[0][0], dp[0][1] * p[0][1]) +
                                fmaf(dp[2][0], p[2][0], dp[2][1] * p[2][1]));
    const float dbot = quad_sum(fmaf(dp[1][0], p[1][0], dp[1][1] * p[1][1]) +
                                fmaf(dp[3][0], p[3][0], dp[3][1] * p[3][1]));
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float dd = (w & 1) ? dbot : dtop;
      ds[w] = pack_bf16x2(p[w][0] * (dp[w][0] - dd), p[w][1] * (dp[w][1] - dd));
      pw[w] = pack_bf16x2(p[w][0], p[w][1]);
    }
  }
  // the tiles: fragment w covers rows gid + 8 * (w & 1), columns
  // 8 * (w >> 1) + 2 * tig
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const int off = (gid + 8 * (w & 1)) * V3_TS + 8 * (w >> 1) + 2 * tig;
    *reinterpret_cast<uint32_t*>(ds_t + off) = ds[w];
    *reinterpret_cast<uint32_t*>(p_t + off) = pw[w];
  }
  __syncwarp();
  // ldmatrix.trans address of this lane in a tile: its transpose as an A
  // fragment
  const int tt = ((ltile >> 1) * 8 + lrow) * V3_TS + (ltile & 1) * 8;
  float acc[8][4], dq[8][4];
  uint32_t at[4];
  // dv = p^T g over the consumed v
  ldsm_x4_t(at, p_t + tt);
  v3_blockdiag_product(at, g, acc);
  v3_store_rows(v, acc, 1.f);
  // dq = ds k (kept until q is consumed), dk = ds^T q over the consumed k
  v3_blockdiag_product(ds, k, dq);
  ldsm_x4_t(at, ds_t + tt);
  v3_blockdiag_product(at, q, acc);
  v3_store_rows(k, acc, scale);
  v3_store_rows(q, dq, scale);
  __syncwarp();  // the tiles are rewritten for the next head
}

// columns 0..width-1 of the staged rows that exist to dst [B, T, N, width]
template <int FR>
__device__ __forceinline__ void v3_write(uint16_t* dst, int width,
                                         const uint16_t* sm, int rs, int p0,
                                         int positions, int frames, int n) {
  const int vecs = width / 8;
  for (int idx = threadIdx.x; idx < V3_ROWS * vecs; idx += blockDim.x) {
    const int r = idx / vecs, e = 8 * (idx % vecs);
    const int u = r / FR, t = r % FR, P = p0 + u;
    if (t < frames && P < positions)
      *reinterpret_cast<uint4*>(dst + stream_row(P, t, frames, n) * width + e) =
          *reinterpret_cast<const uint4*>(sm + (size_t)r * rs + e);
  }
}

// ------------------------------------------ K2v3f / K2v3b (bf16)
// One CTA stages 16 / FR patch positions P = p0, p0 + 1 (p0 = blockIdx.x *
// (16 / FR)) as the 16 rows of the tile.
// K2v3f.  Shared memory: the 16 rows of 3C (+ 8) values.  Each warp takes
// heads warp, warp + 4, ...: the logits (v3_products), v3_softmax, P V
// (block-diagonal with two positions); O goes over the head's consumed q
// columns and the CTA writes the 16 output rows with 16-byte stores.
// SAVE_P: p to probs.
template <bool SAVE_P, int FR, int S>
__global__ void __launch_bounds__(V3_WARPS * 32)
temporal_v3_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                       __nv_bfloat16* __restrict__ out,
                       __nv_bfloat16* __restrict__ probs, int frames, int n,
                       int heads, int positions, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sm = reinterpret_cast<uint16_t*>(smem_raw);
  const int c = heads * HEAD_DIM, rs = 3 * c + 8;
  const int p0 = blockIdx.x * (V3_ROWS / FR);
  v3_stage<FR>(sm, rs, 0, reinterpret_cast<const uint16_t*>(qkv), 3 * c, p0,
               positions, frames, n);
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const float scale2 = scale * LOG2E;
  uint16_t* pg = reinterpret_cast<uint16_t*>(probs);
  for (int h = warp; h < heads; h += V3_WARPS) {
    const PadTile q{sm + h * HEAD_DIM, rs}, k{sm + c + h * HEAD_DIM, rs},
        v{sm + 2 * c + h * HEAD_DIM, rs};
    float s0[4], s1[4];
    v3_products(q, k, s0, s1);
    uint32_t a[4];
    v3_softmax<FR, S>(s0, s1, frames, scale2, a);
    if constexpr (SAVE_P && FR == 8) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int P = p0 + u;
        if (P >= positions || gid >= frames) continue;
        uint16_t* prow = pg + (((size_t)P * heads + h) * frames + gid) * frames;
        const uint32_t w = u ? a[3] : a[0];
        if (2 * tig < frames) prow[2 * tig] = (uint16_t)(w & 0xffffu);
        if (2 * tig + 1 < frames) prow[2 * tig + 1] = (uint16_t)(w >> 16);
      }
    } else if constexpr (SAVE_P) {
      if (p0 < positions) {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          // a[w]: row gid + 8 * (w & 1), key frames 8 * (w >> 1) + 2 * tig
          const int t = gid + 8 * (w & 1), s = 8 * (w >> 1) + 2 * tig;
          if (t >= frames) continue;
          uint16_t* prow = pg + (((size_t)p0 * heads + h) * frames + t) * frames;
          if (s < frames) prow[s] = (uint16_t)(a[w] & 0xffffu);
          if (s + 1 < frames) prow[s + 1] = (uint16_t)(a[w] >> 16);
        }
      }
    }
    float o[8][4];
    v3_blockdiag_product(a, v, o);
    v3_store_rows(q, o, 1.f);
  }
  __syncthreads();
  v3_write<FR>(reinterpret_cast<uint16_t*>(out), c, sm, rs, p0, positions,
               frames, n);
}

// K2v3b.  Shared memory: the 16 rows of [q | k | v | g] (4C + 8 values),
// then per warp two 16 x 16 tiles (ds, p) whose unused blocks stay zero.
// Per head: the saved p, then v3_bwd_head; the CTA writes the 16 rows of
// 3C with 16-byte stores.
template <int FR>
__global__ void __launch_bounds__(V3_WARPS * 32)
temporal_v3_bwd_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                           const __nv_bfloat16* __restrict__ probs,
                           const __nv_bfloat16* __restrict__ g,
                           __nv_bfloat16* __restrict__ dqkv, int frames, int n,
                           int heads, int positions, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sm = reinterpret_cast<uint16_t*>(smem_raw);
  const int c = heads * HEAD_DIM, c3 = 3 * c, rs = 4 * c + 8;
  uint16_t* tiles = sm + (size_t)V3_ROWS * rs;
  const int p0 = blockIdx.x * (V3_ROWS / FR);
  v3_stage<FR>(sm, rs, 0, reinterpret_cast<const uint16_t*>(qkv), c3, p0,
               positions, frames, n);
  v3_stage<FR>(sm, rs, c3, reinterpret_cast<const uint16_t*>(g), c, p0,
               positions, frames, n);
  for (int idx = threadIdx.x; idx < V3_WARPS * 2 * V3_ROWS * V3_TS / 8;
       idx += blockDim.x)
    reinterpret_cast<uint4*>(tiles)[idx] = make_uint4(0u, 0u, 0u, 0u);
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  uint16_t* ds_t = tiles + warp * 2 * V3_ROWS * V3_TS;
  uint16_t* p_t = ds_t + V3_ROWS * V3_TS;
  const uint16_t* pg = reinterpret_cast<const uint16_t*>(probs);
  for (int h = warp; h < heads; h += V3_WARPS) {
    // the saved p in v3_bwd_head's order (with two positions, frame lane/4
    // of position 0 in p[0], of position 1 in p[3])
    float p[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    if constexpr (FR == 8) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int P = p0 + u;
        if (P >= positions || gid >= frames) continue;
        const uint16_t* prow = pg + (((size_t)P * heads + h) * frames + gid) * frames;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (2 * tig + e >= frames) continue;
          p[3 * u][e] = __uint_as_float((uint32_t)prow[2 * tig + e] << 16);
        }
      }
    } else if (p0 < positions) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int t = gid + 8 * (w & 1), s = 8 * (w >> 1) + 2 * tig;
        if (t >= frames) continue;
        const uint16_t* prow = pg + (((size_t)p0 * heads + h) * frames + t) * frames;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (s + e < frames)
            p[w][e] = __uint_as_float((uint32_t)prow[s + e] << 16);
      }
    }
    const PadTile q{sm + h * HEAD_DIM, rs}, k{sm + c + h * HEAD_DIM, rs},
        v{sm + 2 * c + h * HEAD_DIM, rs}, gt{sm + c3 + h * HEAD_DIM, rs};
    v3_bwd_head<FR>(p, q, k, v, gt, ds_t, p_t, scale);
  }
  __syncthreads();
  v3_write<FR>(reinterpret_cast<uint16_t*>(dqkv), c3, sm, rs, p0, positions,
               frames, n);
}

// ------------------------------------------ K2f / K2b (bf16): the ring
// An item is one 16-row tile of a clip (positions pos0, pos0 + 1 for FR =
// 8; pos0 for FR = 16) times a group of hg heads (hg of {4, 3, 2, 1} that
// divides the head count), item it = tile * groups + group.
struct RingGeo {
  int frames, heads, hg, groups;
  int tiles;  // per clip
  int items;
  float scale;
};
struct Item {
  int b, pos0, h0;
};
template <int FR>
__device__ __forceinline__ Item item_of(const RingGeo& g, int it) {
  const int tile = it / g.groups;
  return {tile / g.tiles, (tile % g.tiles) * (V3_ROWS / FR),
          (it % g.groups) * g.hg};
}

constexpr int HEAD_TILE = V3_ROWS * HEAD_DIM;  // elements of one head's tile
constexpr int RING_MAX_STAGES = 8;
// shared memory of one CTA: two CTAs fit on an SM (228 KB, 1 KB of it
// reserved per CTA)
constexpr size_t RING_SMEM = 113 * 1024;

// K2f (BWD false) and K2b (BWD true) on persistent CTAs.  Warp 0 is the
// copying warp: one thread keeps a ring of `stages` slots full, each slot
// one item's q, k and v (K2b also g) of its heads, one TMA box a third
// (qkv_map, g_map), completed on the slot's `full` mbarrier.  Warp 1 + j
// computes head j of every item: K2f the logits (v3_products), v3_softmax
// and P V over its consumed q tile; K2b the same softmax, recomputed, then
// v3_bwd_head (dq, dk, dv over its q, k and v tiles).  Each computing warp
// then stores its results from the slot with one TMA box a tile (out_map:
// out [B, T, N, H, 64] or dqkv [B, T, N, 3H, 64]) and releases the slot of
// its previous item on the `empty` mbarrier once that item's store has
// read it: a store runs under the next item's products and the copies in
// flight.
template <int FR, bool BWD, int S>
__global__ void __launch_bounds__((V3_WARPS + 1) * 32)
temporal_ring_kernel(const __grid_constant__ CUtensorMap qkv_map,
                     const __grid_constant__ CUtensorMap g_map,
                     const __grid_constant__ CUtensorMap out_map, RingGeo geo,
                     int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + stages;
  // the ring from the first 1024-byte boundary past the barriers (the
  // period of the swizzle), then K2b's per-warp ds and p tiles
  const unsigned base = smem_addr(smem);
  uint16_t* ring = reinterpret_cast<uint16_t*>(
      smem + (((base + 16 * stages + 1023) & ~1023u) - base));
  const int box = geo.hg * HEAD_TILE;       // elements of a third's box
  const int stage = (BWD ? 4 : 3) * box;    // elements of a slot
  uint16_t* tiles = ring + (size_t)stages * stage;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, geo.hg);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 0) {
    if (lane == 0) {
      for (int k = 0, it = blockIdx.x; it < geo.items; it += gridDim.x, ++k) {
        const int slot = k % stages;
        if (k >= stages) mbar_wait(empty + slot, (k / stages - 1) & 1);
        const Item I = item_of<FR>(geo, it);
        uint16_t* st = ring + (size_t)slot * stage;
        mbar_expect_tx(full + slot, stage * 2);
#pragma unroll
        for (int x = 0; x < 3; ++x)
          tma_load_5d(st + x * box, &qkv_map, full + slot, 0, 0, I.pos0,
                      x * geo.heads + I.h0, I.b);
        if constexpr (BWD)
          tma_load_5d(st + 3 * box, &g_map, full + slot, 0, 0, I.pos0, I.h0,
                      I.b);
      }
    }
    return;
  }

  const int hh = warp - 1;  // this warp's head in the group
  const float scale2 = geo.scale * LOG2E;
  uint16_t* ds_t = tiles + hh * 2 * V3_ROWS * V3_TS;
  uint16_t* p_t = ds_t + V3_ROWS * V3_TS;
  int held = -1;  // the slot of the previous item, its store in flight
  for (int k = 0, it = blockIdx.x; it < geo.items; it += gridDim.x, ++k) {
    const int slot = k % stages;
    mbar_wait(full + slot, (k / stages) & 1);
    const Item I = item_of<FR>(geo, it);
    uint16_t* st = ring + (size_t)slot * stage + hh * HEAD_TILE;
    const SwzTile q{st}, kt{st + box}, v{st + 2 * box};
    float s0[4], s1[4];
    v3_products(q, kt, s0, s1);
    uint32_t a[4];
    v3_softmax<FR, S>(s0, s1, geo.frames, scale2, a);
    if constexpr (BWD) {
      float p[4][2];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float2 f = unpack_bf16x2(a[w]);
        p[w][0] = f.x;
        p[w][1] = f.y;
      }
      v3_bwd_head<FR>(p, q, kt, v, SwzTile{st + 3 * box}, ds_t, p_t,
                      geo.scale);
    } else {
      float o[8][4];
      v3_blockdiag_product(a, v, o);
      v3_store_rows(q, o, 1.f);
    }
    fence_async_smem();
    __syncwarp();
    if (lane == 0) {
      const int h = I.h0 + hh;
      tma_store_5d(&out_map, q.p, 0, 0, I.pos0, h, I.b);
      if constexpr (BWD) {
        tma_store_5d(&out_map, kt.p, 0, 0, I.pos0, geo.heads + h, I.b);
        tma_store_5d(&out_map, v.p, 0, 0, I.pos0, 2 * geo.heads + h, I.b);
      }
      bulk_commit();
      if (held >= 0) {
        bulk_wait_read_all_but_newest();
        mbar_arrive(empty + held);
      }
    }
    held = slot;
  }
  if (lane == 0) bulk_wait();
}

// The tensor map of a time-major bf16 stream [B, T, N, heads, 64] at base,
// its dims taken in the order (64, T, N, heads, B) and its boxes [1,
// box_heads, 16 / FR, FR, 64]: each head's 16 rows (frame t of the box's
// position u at row u * FR + t; frames past T and positions past N are
// zeros, or not written) land as one swizzled 2 KB tile.
bool stream_map(CUtensorMap* map, const void* base, int frames, int n,
                int heads, int batch, int fr, int box_heads) {
  const cuuint64_t row = (cuuint64_t)heads * HEAD_DIM * 2;  // a position
  const cuuint64_t dims[5] = {HEAD_DIM, (cuuint64_t)frames, (cuuint64_t)n,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[4] = {row * n, row, HEAD_DIM * 2,
                                 row * n * frames};
  const cuuint32_t box[5] = {HEAD_DIM, (cuuint32_t)fr,
                             (cuuint32_t)(V3_ROWS / fr), (cuuint32_t)box_heads,
                             1};
  return tensor_map_5d(map, base, 2, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

// persistent CTAs of `kernel` with `threads` threads and `smem` bytes: as
// many as fit on the card at once, at most one per item
template <typename K>
cudaError_t persistent_ctas(K kernel, int threads, size_t smem, int items,
                            int& ctas) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = set_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  ctas = sms * per_sm < items ? sms * per_sm : items;
  return cudaSuccess;
}

// K2f (g null) or K2b on the ring
template <int FR, bool BWD, int S>
cudaError_t launch_ring(const void* qkv, const void* g, void* out, int batch,
                        int frames, int n, int heads, float scale,
                        cudaStream_t stream) {
  RingGeo geo;
  geo.frames = frames;
  geo.heads = heads;
  geo.hg = heads % 4 == 0 ? 4 : heads % 3 == 0 ? 3 : heads % 2 == 0 ? 2 : 1;
  geo.groups = heads / geo.hg;
  geo.tiles = (n + V3_ROWS / FR - 1) / (V3_ROWS / FR);
  const long long items = (long long)batch * geo.tiles * geo.groups;
  if (items < 1 || items >= (1LL << 31)) return cudaErrorInvalidValue;
  geo.items = (int)items;
  geo.scale = scale;
  CUtensorMap qkv_map, g_map, out_map;
  if (!bind_context() ||
      !stream_map(&qkv_map, qkv, frames, n, 3 * heads, batch, FR, geo.hg) ||
      !stream_map(&out_map, out, frames, n, BWD ? 3 * heads : heads, batch,
                  FR, 1) ||
      (BWD && !stream_map(&g_map, g, frames, n, heads, batch, FR, geo.hg)))
    return cudaErrorInvalidValue;
  if (!BWD) g_map = qkv_map;  // K2f reads no g
  const size_t slot = (size_t)(BWD ? 4 : 3) * geo.hg * HEAD_TILE * 2 + 16;
  const size_t fixed =
      1024 + (BWD ? (size_t)V3_WARPS * 2 * V3_ROWS * V3_TS * 2 : 0);
  const int stages = (int)std::min<size_t>((RING_SMEM - fixed) / slot,
                                           RING_MAX_STAGES);
  if (stages < 2) return cudaErrorInvalidValue;
  const size_t smem = fixed + stages * slot;
  const int threads = (geo.hg + 1) * 32;
  auto kernel = temporal_ring_kernel<FR, BWD, S>;
  int ctas = 0;
  cudaError_t err = persistent_ctas(kernel, threads, smem, geo.items, ctas);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, threads, smem, stream>>>(qkv_map, g_map, out_map, geo,
                                          stages);
  return cudaGetLastError();
}

// K2v3f / K2v3b
template <bool SAVE_P, int FR, int S>
cudaError_t launch_v3(const void* qkv, void* out, void* probs, int batch,
                      int frames, int n, int heads, float scale,
                      cudaStream_t stream) {
  const int positions = batch * n, per = V3_ROWS / FR;
  const size_t smem = (size_t)V3_ROWS * (3 * heads * HEAD_DIM + 8) * 2;
  cudaError_t err = set_smem(temporal_v3_mma_kernel<SAVE_P, FR, S>, smem);
  if (err != cudaSuccess) return err;
  temporal_v3_mma_kernel<SAVE_P, FR, S><<<(positions + per - 1) / per,
                                       V3_WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
      static_cast<__nv_bfloat16*>(probs), frames, n, heads, positions, scale);
  return cudaGetLastError();
}

template <int FR>
cudaError_t launch_v3_bwd(const void* qkv, const void* probs, const void* g,
                          void* dqkv, int batch, int frames, int n, int heads,
                          float scale, cudaStream_t stream) {
  const int positions = batch * n, per = V3_ROWS / FR;
  const size_t smem = (size_t)V3_ROWS * (4 * heads * HEAD_DIM + 8) * 2 +
                      (size_t)V3_WARPS * 2 * V3_ROWS * V3_TS * 2;
  cudaError_t err = set_smem(temporal_v3_bwd_mma_kernel<FR>, smem);
  if (err != cudaSuccess) return err;
  using bf = __nv_bfloat16;
  temporal_v3_bwd_mma_kernel<FR><<<(positions + per - 1) / per,
                                   V3_WARPS * 32, smem, stream>>>(
      static_cast<const bf*>(qkv), static_cast<const bf*>(probs),
      static_cast<const bf*>(g), static_cast<bf*>(dqkv), frames, n, heads,
      positions, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Head dim is 64 and frames <= 16.
// float32 (the scalar kernels) needs frames * heads <= 512 and the staged
// rows within shared memory (forward frames * 3 * heads * 72 elements,
// backward frames * 4 * heads * 72 elements plus 8 * frames^2 * heads
// bytes); bfloat16 (the ring) needs qkv, out, g and dqkv 16-byte aligned.
// shift: the softmax shift (enum Shift: 0 clamp, 1 max, 2 none; K2v3b reads
// p and takes none).  Each entry point returns the CUDA error code of its
// launch (0 on success;
// cudaErrorInvalidValue for a geometry the kernels do not take or a tensor
// map the driver refuses).
extern "C" int temporal_attention_fwd(const void* qkv, void* out, int batch,
                                      int frames, int n, int heads, int dtype,
                                      int shift, float scale, void* stream) {
  if (frames < 1 || frames > MAX_T) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_shift(shift, [&](auto s) {
    constexpr int S = decltype(s)::value;
    if (dtype == 0)
      return (int)launch<float, false, S>(qkv, out, nullptr, batch, frames, n,
                                          heads, scale, st);
    if (dtype == 1)
      return (int)(frames > 8
                       ? launch_ring<16, false, S>(qkv, nullptr, out, batch,
                                                   frames, n, heads, scale, st)
                       : launch_ring<8, false, S>(qkv, nullptr, out, batch,
                                                  frames, n, heads, scale,
                                                  st));
    return (int)cudaErrorInvalidValue;
  });
}

extern "C" int temporal_attention_bwd(const void* qkv, const void* g,
                                      void* dqkv, int batch, int frames, int n,
                                      int heads, int dtype, int shift,
                                      float scale, void* stream) {
  if (frames < 1 || frames > MAX_T) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_shift(shift, [&](auto s) {
    constexpr int S = decltype(s)::value;
    if (dtype == 0)
      return (int)launch_bwd<float, false, S>(qkv, g, nullptr, dqkv, batch,
                                              frames, n, heads, scale, st);
    if (dtype == 1)
      return (int)(frames > 8
                       ? launch_ring<16, true, S>(qkv, g, dqkv, batch, frames,
                                                  n, heads, scale, st)
                       : launch_ring<8, true, S>(qkv, g, dqkv, batch, frames,
                                                 n, heads, scale, st));
    return (int)cudaErrorInvalidValue;
  });
}

// K2v3f: K2f that writes p [B, N, H, T, T] in the value dtype (probs null:
// no store, the evaluation forward).  bf16 stages a 16 x (3C + 8) tile, 74
// KB at C = 768: two positions per 16-row tensor-core tile for frames <= 8,
// one for 9..16; fp32 runs K2f's scalar kernel with the store.
extern "C" int temporal_attention_v3_fwd(const void* qkv, void* out,
                                         void* probs, int batch, int frames,
                                         int n, int heads, int dtype,
                                         int shift, float scale,
                                         void* stream) {
  if (frames < 1 || frames > MAX_T) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_shift(shift, [&](auto s) {
    constexpr int S = decltype(s)::value;
    if (dtype == 0)
      return (int)(probs ? launch<float, true, S>(qkv, out, probs, batch,
                                                  frames, n, heads, scale, st)
                         : launch<float, false, S>(qkv, out, nullptr, batch,
                                                   frames, n, heads, scale,
                                                   st));
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (frames > 8)
      return (int)(probs ? launch_v3<true, 16, S>(qkv, out, probs, batch,
                                                  frames, n, heads, scale, st)
                         : launch_v3<false, 16, S>(qkv, out, nullptr, batch,
                                                   frames, n, heads, scale,
                                                   st));
    return (int)(probs ? launch_v3<true, 8, S>(qkv, out, probs, batch, frames,
                                               n, heads, scale, st)
                       : launch_v3<false, 8, S>(qkv, out, nullptr, batch,
                                                frames, n, heads, scale, st));
  });
}

// K2v3b: dqkv [B, T, N, 3C] from qkv, K2v3f's probabilities and g
// [B, T, N, C]; bf16 takes 104 KB of shared memory at C = 768.
extern "C" int temporal_attention_v3_bwd(const void* qkv, const void* probs,
                                         const void* g, void* dqkv, int batch,
                                         int frames, int n, int heads,
                                         int dtype, float scale,
                                         void* stream) {
  if (frames < 1 || frames > MAX_T) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_bwd<float, true, kClamp>(qkv, g, probs, dqkv, batch,
                                                frames, n, heads, scale, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  return (int)(frames > 8 ? launch_v3_bwd<16>(qkv, probs, g, dqkv, batch,
                                              frames, n, heads, scale, st)
                          : launch_v3_bwd<8>(qkv, probs, g, dqkv, batch,
                                             frames, n, heads, scale, st));
}
