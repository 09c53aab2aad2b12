// Temporal attention of the divided space-time block: forward (K2f) and
// backward (K2b), read in place from the time-major stream.
//
// Replaces the TPU kernels procedurevrl_tpu/ops/pallas_attention.py:
//   K2f _temporal_fwd_kernel (via _temporal_fwd, the forward of
//       flash_attention_temporal);
//   K2b _temporal_bwd_kernel (via _temporal_bwd, its backward).
// The TPU forward writes its probabilities in a compact 0/1-expander layout
// for the backward.  Here the forward writes none and the backward
// recomputes them from q and k with the same device function the forward
// uses (softmax_row), so it multiplies with exactly the values the forward
// used: p is 8 x 8 per (position, head), 128 bytes against 3 KB of qkv, and
// recomputing it costs ~0.1 GFLOP at the training shape.
//
// Contract: qkv [B, T, N, 3C] (T <= 16), the fused projection output in the
// time-major stream layout, columns [q | k | v] with heads interleaved
// inside each third; out [B, T, N, C]; g [B, T, N, C] -> dqkv [B, T, N, 3C].
// For every (b, n, head):
//   s[t, t'] = scale * sum_d q[t] k[t'] in fp32,
//   p = exp(min(s, 80)) / sum_t' exp(min(s, 80)), cast to the value dtype,
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
// ~91 us.  Their 0.7 and 1.7 GFLOP are nothing next to that: memory-bound.
// Design: one CTA per patch position (b, n) stages that position's T rows
// of 3C values (and, backward, of C gradient values) in shared memory with
// contiguous 16-byte cp.async copies (each input byte is read once, all
// copies in flight at once).  Two threads per (frame t, head) query row,
// each owning 32 of the 64 head-dimension columns, compute its T logits
// (one shuffle each joins the halves) and the softmax from shared memory.
//   * K2f: the row's outputs go back over its own query slot and the CTA
//     stores the T output rows with 16-byte coalesced writes.
//   * K2b, phase 1 per query row (t, head): p, dp, ds (p and ds to shared
//     memory) and dq[t], written with 16-byte stores; phase 2 per key row
//     (t', head), after a barrier: dk[t'] and dv[t'] sum over t from shared
//     memory, written with 16-byte stores.
// Head slots are padded by 8 elements, which keeps them 16-byte aligned at
// the price of some 2-way bank conflicts.
// Measured on an H100 (PERF.md), K2f: 4-byte copies with conflict-free
// 2-element padding took 1.56x as long (the copy instructions were the
// limit); a persistent, double-buffered CTA was slower, not faster; a first
// version with one warp per (b, n, head) took 3.7x as long (every lane
// repeated the softmax, and each logit took a 5-step shuffle reduction).

#include "common.cuh"

namespace {

using namespace pvrl;

constexpr int HEAD_STRIDE = HEAD_DIM + 8;  // padded head slot in smem
constexpr int MAX_T = 16;
constexpr int HALF = HEAD_DIM / 2;  // head-dim columns per thread

// The probabilities p[u] (u < frames) of one query row, from this thread's
// half of the head dimension of q and of the keys k0 + u * kstep; the two
// halves of a row are adjacent lanes (`mask`) and end with the same row.
template <typename T_>
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
  float denom = 0.f;
#pragma unroll
  for (int u = 0; u < MAX_T; ++u) {
    if (u < frames) {
      s[u] += __shfl_xor_sync(mask, s[u], 1);
      s[u] = expf(fminf(s[u] * scale, CLAMP_HI));
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

// dynamic smem: [T][3][heads][HEAD_STRIDE] elements of T_
template <typename T_>
__global__ void temporal_kernel(const T_* __restrict__ qkv, T_* __restrict__ out,
                                int frames, int n, int heads, float scale) {
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
    softmax_row(q, k0, kstep, frames, scale, mask, s);
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
// slots of each frame), then p and ds as floats [T * heads][T]
template <typename T_>
__global__ void temporal_bwd_kernel(const T_* __restrict__ qkv,
                                    const T_* __restrict__ g,
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
    softmax_row(q0 + t * fstep, k0, fstep, frames, scale, mask, p);
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

template <typename T_>
cudaError_t launch(const void* qkv, void* out, int batch, int frames, int n,
                   int heads, float scale, cudaStream_t stream) {
  const int threads = threads_for(frames, heads);
  if (threads > 1024) return cudaErrorInvalidValue;
  const size_t smem = (size_t)frames * 3 * heads * HEAD_STRIDE * sizeof(T_);
  cudaError_t err = set_smem(temporal_kernel<T_>, smem);
  if (err != cudaSuccess) return err;
  temporal_kernel<T_><<<batch * n, threads, smem, stream>>>(
      static_cast<const T_*>(qkv), static_cast<T_*>(out), frames, n, heads,
      scale);
  return cudaGetLastError();
}

template <typename T_>
cudaError_t launch_bwd(const void* qkv, const void* g, void* dqkv, int batch,
                       int frames, int n, int heads, float scale,
                       cudaStream_t stream) {
  const int threads = threads_for(frames, heads);
  if (threads > 1024) return cudaErrorInvalidValue;
  const size_t smem = (size_t)frames * 4 * heads * HEAD_STRIDE * sizeof(T_) +
                      (size_t)2 * frames * heads * frames * sizeof(float);
  cudaError_t err = set_smem(temporal_bwd_kernel<T_>, smem);
  if (err != cudaSuccess) return err;
  temporal_bwd_kernel<T_><<<batch * n, threads, smem, stream>>>(
      static_cast<const T_*>(qkv), static_cast<const T_*>(g),
      static_cast<T_*>(dqkv), frames, n, heads, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Head dim is 64, frames <= 16, and
// frames * heads <= 512; the staged rows must fit in shared memory
// (forward frames * 3 * heads * 72 elements, backward frames * 4 * heads * 72
// elements plus 8 * frames^2 * heads bytes).  Each entry point returns the
// CUDA error code of its launch (0 on success).
extern "C" int temporal_attention_fwd(const void* qkv, void* out, int batch,
                                      int frames, int n, int heads, int dtype,
                                      float scale, void* stream) {
  if (frames < 1 || frames > MAX_T) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(qkv, out, batch, frames, n, heads, scale, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(qkv, out, batch, frames, n, heads, scale,
                                      st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int temporal_attention_bwd(const void* qkv, const void* g,
                                      void* dqkv, int batch, int frames, int n,
                                      int heads, int dtype, float scale,
                                      void* stream) {
  if (frames < 1 || frames > MAX_T) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_bwd<float>(qkv, g, dqkv, batch, frames, n, heads, scale,
                                  st);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(qkv, g, dqkv, batch, frames, n,
                                          heads, scale, st);
  return (int)cudaErrorInvalidValue;
}
