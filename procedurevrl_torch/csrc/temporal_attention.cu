// Temporal attention forward of the divided space-time block.
//
// Replaces the TPU kernel procedurevrl_tpu/ops/pallas_attention.py:
// _temporal_fwd_kernel (launched by _temporal_fwd, the forward of
// flash_attention_temporal).  The TPU kernel also writes its probabilities
// in a compact 0/1-expander layout for the backward; this forward-only
// version writes none.
//
// Contract: qkv [B, T, N, 3C] (T <= 16), the fused projection output in the
// time-major stream layout, columns [q | k | v] with heads interleaved
// inside each third; out [B, T, N, C].  For every (b, n, head):
//   s[t, t'] = scale * sum_d q[t] k[t'] in fp32,
//   p = exp(min(s, 80)) / sum_t' exp(min(s, 80)), cast to the value dtype,
//   o[t] = sum_t' p[t, t'] v[t'] accumulated in fp32, cast to the output
//   dtype.
// (The TPU kernel rounds each q*k product to the input dtype before its
// fp32 sum; here the products are exact in fp32.)
//
// Bound on an H100 SXM at the main-path shape (B = 16, T = 8, N = 196,
// C = 768, bf16): it must read 116 MB and write 39 MB, ~46 us at
// 3.35 TB/s; its 0.62 GFLOP are nothing next to that.  Memory-bound.
// Design: one CTA per patch position (b, n) stages that position's T rows
// of 3C values in shared memory with contiguous 16-byte cp.async copies
// (each input byte is read once, all copies in flight at once), then two
// threads per (frame t, head) query row, each owning 32 of the 64
// head-dimension columns, compute its T logits (one shuffle each joins the
// halves), the softmax and the outputs from shared memory, write the row
// back over its own query slot, and the CTA stores the T output rows with
// 16-byte coalesced writes.  Head slots are padded by 8 elements, which
// keeps them 16-byte aligned at the price of some 2-way bank conflicts.
// Measured on an H100 (PERF.md): 4-byte copies with conflict-free 2-element
// padding took 1.56x as long (the copy instructions were the limit); a
// persistent, double-buffered CTA was slower, not faster; a first version
// with one warp per (b, n, head) took 3.7x as long (every lane repeated the
// softmax, and each logit took a 5-step shuffle reduction).

#include "common.cuh"

namespace {

using namespace pvrl;

constexpr int HEAD_STRIDE = HEAD_DIM + 8;  // padded head slot in smem
constexpr int MAX_T = 16;

// dynamic smem: [T][3][heads][HEAD_STRIDE] elements of T_
template <typename T_>
__global__ void temporal_kernel(const T_* __restrict__ qkv, T_* __restrict__ out,
                                int frames, int n, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T_* sm = reinterpret_cast<T_*>(smem_raw);
  const int c = heads * HEAD_DIM, c3 = 3 * c;
  const int b = blockIdx.x / n, pos = blockIdx.x % n;
  const size_t frame_stride = (size_t)n * c3;
  const T_* src = qkv + ((size_t)b * frames * n + pos) * c3;

  // stage: 16-byte pieces, contiguous along each frame's 3C row, all of
  // the CTA's copies in flight at once
  constexpr int V = 16 / sizeof(T_);
  const int vecs = c3 / V;
  for (int idx = threadIdx.x; idx < frames * vecs; idx += blockDim.x) {
    const int t = idx / vecs, e = V * (idx % vecs);
    const int slot = e / HEAD_DIM, d = e % HEAD_DIM;  // slot = part*heads + h
    cp_async16(sm + ((size_t)t * 3 * heads + slot) * HEAD_STRIDE + d,
               src + t * frame_stride + e);
  }
  cp_async_wait_all();
  __syncthreads();

  // two threads per query row (t, head), each owning half of the head
  // dimension; partners are adjacent lanes
  constexpr int HALF = HEAD_DIM / 2;
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
    // the row's probabilities go to this thread's half of its query slot
    // (consumed; 32 elements hold MAX_T floats), so the PV loop over frames
    // can run without unrolling: a fully unrolled body is thousands of
    // instructions
    float* p_s = reinterpret_cast<float*>(q);
#pragma unroll
    for (int u = 0; u < MAX_T; ++u) {
      if (u < frames) p_s[u] = round_to(s[u] / denom, qkv);
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

template <typename T_>
cudaError_t launch(const void* qkv, void* out, int batch, int frames, int n,
                   int heads, float scale, cudaStream_t stream) {
  const int threads = ((2 * frames * heads + 31) / 32) * 32;
  if (threads > 1024) return cudaErrorInvalidValue;
  const size_t smem = (size_t)frames * 3 * heads * HEAD_STRIDE * sizeof(T_);
  cudaError_t err = cudaFuncSetAttribute(
      temporal_kernel<T_>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  temporal_kernel<T_><<<batch * n, threads, smem, stream>>>(
      static_cast<const T_*>(qkv), static_cast<T_*>(out), frames, n, heads,
      scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Head dim is 64, frames <= 16, and
// frames * heads <= 512 with frames * 3 * heads * 72 elements fitting in
// shared memory.  Returns the CUDA error code of the launch (0 on success).
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
