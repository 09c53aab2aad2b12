// Spatial (per-frame) attention forward of the divided space-time block,
// with the CLS token as a separate stream.
//
// Replaces the TPU kernel procedurevrl_tpu/ops/pallas_attention.py:
// _fwd_cls_qkv_kernel (launched by _flash_cls_qkv_fwd, the primal forward
// of flash_attention_cls_qkv).
//
// Contract (one call per TimeSformer block):
//   qkv   [BT, N, 3C]  fused projection output, columns [q | k | v], heads
//                      interleaved inside each third (head h owns columns
//                      h*64 .. h*64+63 of its third);
//   qkv_c [BT, 1, 3C]  the CLS row of every frame, same columns;
//   out   [BT, N, C], out_c [BT, 1, C].
// Each of the N+1 queries (patches and CLS) attends over the N+1 keys
// [patches; CLS]:  s = (q.k) * scale in fp32,  p = exp(min(s, 80)) / sum,
// p cast to the value dtype,  o = sum p*v accumulated in fp32, cast to the
// output dtype.  The CLS row sits at row N of the staged tile, as the TPU
// kernel splices it into its padding row; key order does not change the
// result.
//
// Bound on an H100 SXM at the main-path shape (BT = 128, N = 196, C = 768,
// bf16): it must read 116 MB of qkv and write 39 MB, ~46 us at 3.35 TB/s;
// its 15.3 GFLOP take ~15 us at 989 TFLOP/s.  The kernel is memory-bound.
// Design: one CTA per (frame, head) stages that head's q, k, v rows
// (197 x 64 each) in shared memory with cp.async (all of a CTA's copies in
// flight at once), so every input byte is read from device memory once and
// the 197 x 197 logits never leave the SM.
//   * bf16: four warps, each owns 16-query tiles; QK^T and PV run on the
//     tensor cores with mma.sync m16n8k16 (fp32 accumulators).  The logits
//     tile stays in registers; its accumulator layout is reused directly as
//     the A operand of the PV product (no shared-memory round trip); the
//     Q, K and V fragments come from shared memory by ldmatrix.  The
//     exponential is exp2f of a log2(e)-scaled argument and each row is
//     normalised by one reciprocal: fewer instructions, at fp32 rounding
//     differences that vanish when p is rounded to bf16.
//   * fp32: scalar FMA path (the tensor cores have no exact fp32 mode);
//     one warp per query row, lanes over keys for QK^T and over the head
//     dimension for PV; expf and a true division, as the plain version.
// Not done yet: overlapping one head's staging with another's compute
// (TMA and a persistent CTA), wgmma.

#include "common.cuh"

namespace {

using namespace pvrl;

constexpr int WARPS = 4;
constexpr float LOG2E = 1.4426950408889634f;

// Row r (0 <= r <= n) of the [patches; CLS] sequence of frame bt: the
// start of its 3C columns.
template <typename T>
__device__ __forceinline__ const T* seq_row(const T* qkv, const T* qkv_c,
                                            int bt, int r, int n, int c3) {
  return r < n ? qkv + ((size_t)bt * n + r) * c3 : qkv_c + (size_t)bt * c3;
}

// ------------------------------------------------- fp32 (scalar) kernel

// Shared-memory row stride in elements: 66 keeps the per-lane row reads of
// the logits loop on distinct banks (33 words for bf16, 2-word float2
// accesses for fp32).
constexpr int SC_STRIDE = HEAD_DIM + 2;

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
spatial_scalar_kernel(const T* __restrict__ qkv, const T* __restrict__ qkv_c,
                      T* __restrict__ out, T* __restrict__ out_c, int n,
                      int heads, float scale) {
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
    __syncwarp();
    // PV: lane owns head-dim columns 2*lane, 2*lane+1
    float o0 = 0.f, o1 = 0.f;
    for (int j = 0; j < L; ++j) {
      const float p = p_s[j];
      const float2 vv = load2(v_s + (size_t)j * SC_STRIDE + 2 * lane);
      o0 = fmaf(p, vv.x, o0);
      o1 = fmaf(p, vv.y, o1);
    }
    T* dst = i < n ? out + ((size_t)bt * n + i) * c : out_c + (size_t)bt * c;
    store2(dst + h * HEAD_DIM + 2 * lane, o0, o1);
    __syncwarp();  // p_s is rewritten by the next row
  }
}

// ------------------------------------------ bf16 (tensor-core) kernel

constexpr int MMA_STRIDE = HEAD_DIM + 8;  // 72 bf16 = 36 words per row

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 tiles from shared memory in the mma fragment layout; lanes
// 8i..8i+7 give the 16-byte row addresses of tile i.  .trans hands each
// thread a column pair instead of a row pair.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// LP: padded sequence length (multiple of 16); NT = LP / 8 key tiles.
template <int LP>
__global__ void __launch_bounds__(WARPS * 32)
spatial_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                   const __nv_bfloat16* __restrict__ qkv_c,
                   __nv_bfloat16* __restrict__ out,
                   __nv_bfloat16* __restrict__ out_c, int n, int heads,
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

  // stage q, k, v rows in 16-byte pieces (8 per row); rows >= L are zero so
  // padded keys contribute exact zeros to PV
  for (int idx = threadIdx.x; idx < LP * 8; idx += blockDim.x) {
    const int r = idx / 8, e = 8 * (idx % 8);
#pragma unroll
    for (int part = 0; part < 3; ++part) {
      uint16_t* dst = q_s + part * LP * MMA_STRIDE + r * MMA_STRIDE + e;
      if (r < L) {
        cp_async16(dst, (r < n ? g + ((size_t)bt * n + r) * c3
                               : gc + (size_t)bt * c3) +
                            part * c + h * HEAD_DIM + e);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  // ldmatrix: this lane addresses row (lane % 8) of tile (lane / 8)
  const int lrow = lane & 7, ltile = lane >> 3;
  const float scale2 = scale * LOG2E, hi2 = CLAMP_HI * LOG2E;
  uint16_t* o_dst = reinterpret_cast<uint16_t*>(out);
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
      pa[0] = pack_f2(s[2 * kt][0] * inv0, s[2 * kt][1] * inv0);
      pa[1] = pack_f2(s[2 * kt][2] * inv1, s[2 * kt][3] * inv1);
      pa[2] = pack_f2(s[2 * kt + 1][0] * inv0, s[2 * kt + 1][1] * inv0);
      pa[3] = pack_f2(s[2 * kt + 1][2] * inv1, s[2 * kt + 1][3] * inv1);
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
      uint16_t* dst = (r < n ? o_dst + ((size_t)bt * n + r) * c
                             : reinterpret_cast<uint16_t*>(out_c) +
                                   (size_t)bt * c) +
                      h * HEAD_DIM + 2 * tig;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
        *reinterpret_cast<uint32_t*>(dst + dt * 8) =
            pack_f2(o[dt][2 * half], o[dt][2 * half + 1]);
    }
  }
}

template <int LP>
cudaError_t launch_mma(const void* qkv, const void* qkv_c, void* out,
                       void* out_c, int bt, int n, int heads, float scale,
                       cudaStream_t stream) {
  const size_t smem = (size_t)3 * LP * MMA_STRIDE * sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      spatial_mma_kernel<LP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  spatial_mma_kernel<LP><<<bt * heads, WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(qkv_c),
      static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(out_c), n,
      heads, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_scalar(const void* qkv, const void* qkv_c, void* out,
                          void* out_c, int bt, int n, int heads, float scale,
                          cudaStream_t stream) {
  const int L = n + 1, lp = (L + 31) & ~31;
  const size_t smem = (size_t)3 * L * SC_STRIDE * sizeof(T) +
                      (size_t)WARPS * lp * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      spatial_scalar_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  spatial_scalar_kernel<T><<<bt * heads, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(qkv_c),
      static_cast<T*>(out), static_cast<T*>(out_c), n, heads, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Head dim is 64.  Returns the CUDA error
// code of the launch (0 on success).  Both paths take sequences of up to
// 256 tokens with the CLS (n + 1 <= 256; fp32 staging then needs 207 KB of
// shared memory).
extern "C" int spatial_attention_fwd(const void* qkv, const void* qkv_c,
                                     void* out, void* out_c, int bt, int n,
                                     int heads, int dtype, float scale,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_scalar<float>(qkv, qkv_c, out, out_c, bt, n, heads,
                                     scale, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const int L = n + 1;
  if (L <= 64)
    return (int)launch_mma<64>(qkv, qkv_c, out, out_c, bt, n, heads, scale, st);
  if (L <= 208)
    return (int)launch_mma<208>(qkv, qkv_c, out, out_c, bt, n, heads, scale,
                                st);
  if (L <= 256)
    return (int)launch_mma<256>(qkv, qkv_c, out, out_c, bt, n, heads, scale,
                                st);
  return (int)cudaErrorInvalidValue;
}
