// MViT's depthwise 3x3x3 attention pool: the forward (K8f, which the
// stride-1 backward also runs for dx, on the output gradient with the tap
// table reversed) and the stride-1 weight gradient (K8dw).
//
// Replaces the TPU kernels of procedurevrl_tpu/ops/pallas_pool.py:
//   K8f   _fwd_kernel (via _pool_call; dx via _dp_bwd with w27[::-1]);
//   K8dw  _dw_kernel  (via _dw_call).
//
// Contract: x [B, T, H, W, C] channels-last, read through a token-row
// stride `row` (elements between neighbouring (t, h, w) positions; the
// model passes a view of its fused qkv product, row = 3C) and a batch
// stride `sb`; w27 [27, C] contiguous, row r = dt*9 + dh*3 + dw, in the
// dtype of x; kernel 3x3x3, zero pad 1, stride (1, s, s), s in {1, 2, 4,
// 8}; out [B, T, H', W', C] contiguous, H' = (H-1)/s + 1.  Products in
// fp32, summed over the taps in row order, rounded once.  K8dw: dw[r, c] =
// sum over (b, t, h, w) of x at tap r of (t, h, w) times g[b, t, h, w, c]
// (stride 1), fp32 [27, C].
//
// Bounds on an H100 SXM (3.35 TB/s): both are bound by bytes.  The pool of
// MViT-v2-S block 0 at the 18-clip training step ([18, 8, 56, 56, 96],
// bf16) reads 86.7 MB and writes 86.7 MB: ~52 us; K8dw reads x and g, the
// same bytes.  27 x 2 flops per element are ~8 GFLOP, nothing beside it.
// Design (simple first; the TPU kernel's rolling 3-plane window in VMEM
// has no counterpart here yet):
//   * K8f: one thread per output position and 8-channel vector (one
//     16-byte load of bf16), 27 bounds-checked taps straight from device
//     memory (the 27-fold reuse of each input is left to L1/L2), the
//     [27 x 32-channel] weight slice of the CTA in shared memory as fp32;
//   * K8dw: one thread per channel pair; 16 lanes of positions per CTA walk
//     the positions of their block, each thread holds the 27 x 2 fp32 tap
//     sums in registers, the CTA reduces its lanes in shared memory in a
//     fixed order and writes one fp32 partial [27, C] per block; a second
//     kernel adds the partials in block order.  No atomics: the result is
//     deterministic.
// Not done yet: staging input planes in shared memory (the TPU kernel's
// window), so that each input is read from L2 once.

#include "common.cuh"

namespace {

using namespace pvrl;

constexpr int KTAPS = 27;
constexpr int VEC = 8;          // channels per K8f thread
constexpr int FWD_CH = 32;      // channels per K8f CTA (4 vectors)
constexpr int FWD_POS = 64;     // output positions per K8f CTA
constexpr int DW_CH = 32;       // channels per K8dw CTA (16 pairs)
constexpr int DW_LANES = 16;    // position lanes per K8dw CTA
constexpr int THREADS = 256;

struct Geo {
  int b, t, h, w, c, s, ho, wo;
  long long row;   // elements between neighbouring (t, h, w) positions of x
  long long sb;    // elements between batches of x
  long long npos;  // output positions b * t * ho * wo
};

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = unpack_bf16x2(w[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  store16(p, v);
  store16(p + 4, v + 4);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  store16(p, v);
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// output position -> (b, t, h', w')
__device__ __forceinline__ void split_pos(long long pos, const Geo& g, int& b,
                                          int& t, int& ho, int& wo) {
  wo = (int)(pos % g.wo);
  pos /= g.wo;
  ho = (int)(pos % g.ho);
  pos /= g.ho;
  t = (int)(pos % g.t);
  b = (int)(pos / g.t);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dwpool_fwd(const T* __restrict__ x, const T* __restrict__ w27,
           T* __restrict__ out, Geo g) {
  __shared__ float w_s[KTAPS][FWD_CH];
  const int c0 = blockIdx.y * FWD_CH;
  for (int i = threadIdx.x; i < KTAPS * FWD_CH; i += blockDim.x) {
    const int r = i / FWD_CH, cc = i % FWD_CH;
    w_s[r][cc] = c0 + cc < g.c ? to_f(w27[(size_t)r * g.c + c0 + cc]) : 0.f;
  }
  __syncthreads();
  const int vec = threadIdx.x % (FWD_CH / VEC);
  const int c = c0 + vec * VEC;
  const long long pos =
      (long long)blockIdx.x * FWD_POS + threadIdx.x / (FWD_CH / VEC);
  if (c >= g.c || pos >= g.npos) return;  // no barrier below
  int b, t, ho, wo;
  split_pos(pos, g, b, t, ho, wo);
  const T* xb = x + (size_t)b * g.sb + c;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
  for (int dt = 0; dt < 3; ++dt) {
    const int ti = t + dt - 1;
    if (ti < 0 || ti > g.t - 1) continue;
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) {
      const int hi = ho * g.s + dh - 1;
      if (hi < 0 || hi >= g.h) continue;
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        const int wi = wo * g.s + dw - 1;
        if (wi < 0 || wi >= g.w) continue;
        float xv[VEC];
        load8(xb + ((size_t)(ti * g.h + hi) * g.w + wi) * g.row, xv);
        const float* wr = &w_s[dt * 9 + dh * 3 + dw][vec * VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(xv[e], wr[e], acc[e]);
      }
    }
  }
  store8(out + (size_t)pos * g.c + c, acc);
}

// K8dw, pass 1: block blk = blockIdx.x sums the output positions
// [blk * per_block, (blk + 1) * per_block) into partial[blk] [27, C].
template <typename T>
__global__ void __launch_bounds__(THREADS)
dwpool_dw_partial(const T* __restrict__ x, const T* __restrict__ gr,
                  float* __restrict__ partial, Geo g, int per_block) {
  __shared__ float red[DW_LANES][DW_CH];
  const int pair = threadIdx.x % (DW_CH / 2), lane = threadIdx.x / (DW_CH / 2);
  const int c = blockIdx.y * DW_CH + 2 * pair;
  float acc[KTAPS][2];
#pragma unroll
  for (int r = 0; r < KTAPS; ++r) acc[r][0] = acc[r][1] = 0.f;
  if (c < g.c) {
    const long long p0 = (long long)blockIdx.x * per_block;
    const long long p1 = min(p0 + per_block, g.npos);
    for (long long pos = p0 + lane; pos < p1; pos += DW_LANES) {
      int b, t, h, w;
      split_pos(pos, g, b, t, h, w);
      const float2 gv = load2(gr + (size_t)pos * g.c + c);
      const T* xb = x + (size_t)b * g.sb + c;
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
        const int ti = t + dt - 1;
        if (ti < 0 || ti >= g.t) continue;
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
          const int hi = h + dh - 1;
          if (hi < 0 || hi >= g.h) continue;
#pragma unroll
          for (int dw = 0; dw < 3; ++dw) {
            const int wi = w + dw - 1;
            if (wi < 0 || wi >= g.w) continue;
            const float2 xv =
                load2(xb + ((size_t)(ti * g.h + hi) * g.w + wi) * g.row);
            const int r = dt * 9 + dh * 3 + dw;
            acc[r][0] = fmaf(xv.x, gv.x, acc[r][0]);
            acc[r][1] = fmaf(xv.y, gv.y, acc[r][1]);
          }
        }
      }
    }
  }
  float* pb = partial + (size_t)blockIdx.x * KTAPS * g.c;
#pragma unroll
  for (int r = 0; r < KTAPS; ++r) {
    red[lane][2 * pair] = acc[r][0];
    red[lane][2 * pair + 1] = acc[r][1];
    __syncthreads();
    if (threadIdx.x < DW_CH) {
      float s = 0.f;
#pragma unroll
      for (int l = 0; l < DW_LANES; ++l) s += red[l][threadIdx.x];
      const int cc = blockIdx.y * DW_CH + threadIdx.x;
      if (cc < g.c) pb[(size_t)r * g.c + cc] = s;
    }
    __syncthreads();
  }
}

// K8dw, pass 2: dw = the sum of the partials in block order.
__global__ void __launch_bounds__(THREADS)
dwpool_dw_reduce(const float* __restrict__ partial, float* __restrict__ dw,
                 int nblk, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < nblk; ++k) s += partial[(size_t)k * n + i];
  dw[i] = s;
}

bool valid(int b, int t, int h, int w, int c, int s, long long row,
           long long sb) {
  return b > 0 && t > 0 && h > 0 && w > 0 && c > 0 && c % VEC == 0 &&
         (s == 1 || s == 2 || s == 4 || s == 8) && row >= c &&
         row % VEC == 0 && sb % VEC == 0 && (c + FWD_CH - 1) / FWD_CH <= 65535;
}

Geo make_geo(int b, int t, int h, int w, int c, int s, long long row,
             long long sb) {
  Geo g;
  g.b = b;
  g.t = t;
  g.h = h;
  g.w = w;
  g.c = c;
  g.s = s;
  g.ho = (h - 1) / s + 1;
  g.wo = (w - 1) / s + 1;
  g.row = row;
  g.sb = sb;
  g.npos = (long long)b * t * g.ho * g.wo;
  return g;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each entry point returns the CUDA
// error code of its launches (0 on success).

// K8f: out [b, t, h', w', c] (contiguous, the dtype of x).
extern "C" int depthwise_pool3d_fwd(const void* x, const void* w27, void* out,
                                    int b, int t, int h, int w, int c, int s,
                                    long long row, long long sb, int dtype,
                                    void* stream) {
  if (!valid(b, t, h, w, c, s, row, sb)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geo g = make_geo(b, t, h, w, c, s, row, sb);
  const dim3 grid((unsigned)((g.npos + FWD_POS - 1) / FWD_POS),
                  (c + FWD_CH - 1) / FWD_CH);
  if (dtype == 1) {
    dwpool_fwd<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w27),
        static_cast<__nv_bfloat16*>(out), g);
  } else if (dtype == 0) {
    dwpool_fwd<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w27),
        static_cast<float*>(out), g);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K8dw (stride 1): dw [27, c] fp32 from x and the output gradient g [b, t,
// h, w, c] (contiguous, the dtype of x); partial [nblk, 27, c] fp32 is
// scratch, nblk = ceil(b*t*h*w / 1024).
extern "C" int depthwise_pool3d_dw(const void* x, const void* g, void* partial,
                                   void* dw, int b, int t, int h, int w, int c,
                                   long long row, long long sb, int nblk,
                                   int dtype, void* stream) {
  if (!valid(b, t, h, w, c, 1, row, sb) || nblk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geo geo = make_geo(b, t, h, w, c, 1, row, sb);
  const int per_block = (int)((geo.npos + nblk - 1) / nblk);
  const dim3 grid(nblk, (c + DW_CH - 1) / DW_CH);
  if (dtype == 1) {
    dwpool_dw_partial<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g), static_cast<float*>(partial),
        geo, per_block);
  } else if (dtype == 0) {
    dwpool_dw_partial<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<float*>(partial), geo, per_block);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = KTAPS * c;
  dwpool_dw_reduce<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), nblk, n);
  return (int)cudaGetLastError();
}
