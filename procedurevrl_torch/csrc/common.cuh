// Device helpers shared by the port's attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace pvrl {

constexpr int HEAD_DIM = 64;
// softmax shift of the TPU kernels: exp(min(s, 80)); a row of exp(80)
// terms still sums far below the fp32 maximum
constexpr float CLAMP_HI = 80.0f;
constexpr float LOG2E = 1.4426950408889634f;

// The softmax shift (SPATIAL_SHIFT, TEMPORAL_SHIFT, MVIT_SHIFT), a
// compile-time switch of every attention kernel that forms exponentials:
// kClamp exp(min(x, 80)) (the default), kMax exp(x - m) with m the row max
// over the valid keys (the reference's softmax), kNone exp(x) (overflows to
// inf past x ~ 88.7, as the reference does).  The entry points take it as
// an int of these values.
enum Shift : int { kClamp = 0, kMax = 1, kNone = 2 };

// f(integral_constant S) for the shift S of an entry point's int, or
// cudaErrorInvalidValue for any other value
template <typename F>
int with_shift(int shift, F f) {
  switch (shift) {
    case kClamp: return f(std::integral_constant<int, kClamp>{});
    case kMax: return f(std::integral_constant<int, kMax>{});
    case kNone: return f(std::integral_constant<int, kNone>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// The exponent of a scaled logit x under shift S; m the row max (kMax).
template <int S>
__device__ __forceinline__ float shift_arg(float x, float m) {
  if constexpr (S == kClamp) return fminf(x, CLAMP_HI);
  else if constexpr (S == kMax) return x - m;
  else return x;
}
// The base-2 exponent of a raw logit s (scale2 = scale * log2 e) under
// shift S; nm2 = -(row max of s) * scale2 (kMax), so that under kMax it is
// one FMA, as the clamp's product and min are two instructions.
template <int S>
__device__ __forceinline__ float shift_arg2(float s, float scale2,
                                            float nm2) {
  if constexpr (S == kClamp) return fminf(s * scale2, CLAMP_HI * LOG2E);
  else if constexpr (S == kMax) return fmaf(s, scale2, nm2);
  else return s * scale2;
}

// two consecutive elements as floats / from floats
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// value of x after a round trip through the storage type of the pointer
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// one element as a float / from a float
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes from consecutive floats v[0..]: 4 floats or 8 bf16 values
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                 pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

// 2^x by the MUFU alone (ex2.approx.ftz: results below 2^-126 flush to
// zero), the exponential of the Hopper forwards (K1's, with K1br's
// recompute; K5f / K6f / K6sp)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Asynchronous global -> shared copies (cp.async): a thread issues all of
// its copies before waiting once, so a CTA's staging costs about one
// memory latency instead of one per loop iteration.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
// one pair of elements: 8 bytes of float, 4 bytes of bf16
template <typename T>
__device__ __forceinline__ void cp_async_pair(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
  }
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// Ring pipelines: close this thread's copies issued since the last commit
// into one group, and wait until at most `pending` (0..7, uniform across
// the block) of its groups are still in flight.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// Bulk asynchronous stores (the TMA unit, no tensor map): `bytes` (a
// multiple of 16; both addresses 16-byte aligned) from shared to global
// memory, tracked by the issuing thread's bulk groups.  The shared memory
// must have been written through the async proxy's fence
// (fence.proxy.async) before the store is issued.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until this thread's bulk stores have read their shared memory / are done
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// until all but this thread's newest bulk group have read their shared memory
__device__ __forceinline__ void bulk_wait_read_all_but_newest() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Ask the L2 cache to fetch `bytes` (a multiple of 16; the address 16-byte
// aligned) of device memory ahead of the loads that will read them.
__device__ __forceinline__ void prefetch_l2(const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
               :: "l"(src), "r"(bytes) : "memory");
}
// mbarriers in shared memory (64-bit words): init by one thread (then
// mbar_init_fence and a CTA barrier before any use); arrive; the arrive of
// this thread's cp.async copies issued so far, once they have landed (the
// barrier's count includes it: noinc); and the wait for the completion of
// the phase of the given parity
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}
// this thread's arrive on `bar`, announcing `bytes` of asynchronous copies
// that will complete the phase (expect-tx)
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// The TMA unit's copy of one box of a 5-d tensor map (a __grid_constant__
// kernel parameter) at element coordinates {c0, c1, c2, c3, c4} into
// shared memory, densely in the box's order (dimension 0 innermost); what
// lies outside the tensor is zero-filled.  Completes its bytes on `bar`.
__device__ __forceinline__ void tma_load_5d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
      :: "r"(smem_addr(dst)), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(c4), "r"(smem_addr(bar))
      : "memory");
}
// The TMA unit's store of one box of a 5-d tensor map (a __grid_constant__
// kernel parameter) from shared memory (laid out as tma_load_5d lands it)
// at element coordinates {c0, ..., c4}; what lies outside the tensor is not
// written.  Tracked by the issuing thread's bulk groups (bulk_commit).
__device__ __forceinline__ void tma_store_5d(const void* map, const void* src,
                                             int c0, int c1, int c2, int c3,
                                             int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5, %6}], [%1];\n"
      :: "l"(map), "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(c4)
      : "memory");
}
// shared-memory writes of this thread (st.shared, cp.async) made visible to
// the asynchronous proxy that wgmma and the TMA unit read through; a block
// (or warp) barrier after it makes every thread's writes visible
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a barrier of `threads` threads (a multiple of 32) on named barrier `id`
// (1..15; 0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// Tensor-core building blocks (bf16 operands, fp32 accumulators).
// D += A B for one m16n8k16 tile: A row-major 16 x 16, B column-major
// 16 x 8, both as packed bf16 pairs in the mma fragment layout.
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
// two tiles: lanes 0-15 give the row addresses (the other lanes' are unused)
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// an 8 x 8 b16 matrix held one pair a thread in the mma fragment layout
// (lane l: row l / 4, columns 2 (l % 4), + 1), transposed across the warp:
// lane l then holds row l / 4 of the transpose
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
}
// the two bf16 of a packed register (low half first) as floats
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}
__device__ __forceinline__ float2 load_bf16x2(const uint16_t* p) {
  return unpack_bf16x2(*reinterpret_cast<const uint32_t*>(p));
}
// sum over the 4 threads of an mma quad (lanes that share lane >> 2)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

}  // namespace pvrl
