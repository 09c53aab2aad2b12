// Spatial (per-frame) attention of the divided space-time block, with the
// CLS token as a separate stream: forward (K1f), forward that also writes
// the probabilities (K1sp), the pipelined forward (K1p), the backward from
// the saved probabilities (K1b), the backward that recomputes them (K1br)
// and the backward from the saved probabilities with delta_i = g_i . o_i in
// place of the jacobian row sums (K1bd).
//
// Replaces the TPU kernels procedurevrl_tpu/ops/pallas_attention.py:
//   K1f  _fwd_cls_qkv_kernel     (via _flash_cls_qkv_fwd, the primal forward
//        of flash_attention_cls_qkv);
//   K1sp _fwd_cls_qkv_kernel_sp  (via _flash_cls_qkv_fwd_sp, the forward
//        under grad on one device, SPATIAL_SAVE_PROBS=1);
//   K1b  _bwd_cls_qkv_kernel_sp  (via _flash_cls_qkv_bwd_sp, its backward,
//        rowsum form of the softmax jacobian);
//   K1p  _pipe_kernel            (via _flash_cls_qkv_fwd_pipe, SPATIAL_PIPE=1:
//        the manually pipelined forward);
//   K1br _bwd_cls_qkv_kernel     (via _flash_cls_qkv_bwd, the recompute
//        backward: SPATIAL_SAVE_PROBS=0, or more than one device);
//   K1bd _bwd_cls_qkv_kernel_sp_delta (via _flash_cls_qkv_bwd_sp_delta,
//        SPATIAL_DELTA=1).
//
// Contract (one call per TimeSformer block):
//   qkv   [BT, N, 3C]  fused projection output, columns [q | k | v], heads
//                      interleaved inside each third (head h owns columns
//                      h*64 .. h*64+63 of its third);
//   qkv_c [BT, 1, 3C]  the CLS row of every frame, same columns;
//   out   [BT, N, C], out_c [BT, 1, C];
//   probs [BT, H, L, LS] (K1sp output, K1b/K1bd input), L = N + 1 rows in
//                      the order [patches; CLS], LS = L rounded up to 8 so
//                      rows are 16-byte aligned; p[i, j] is the probability
//                      of query i on key j after the cast to the value
//                      dtype, exactly the p that multiplies V; columns
//                      L..LS-1 are written as zeros;
//   g [BT, N, C], gc [BT, 1, C] -> dqkv [BT, N, 3C], dqkv_c [BT, 1, 3C].
// Forward: each of the L queries attends over the L keys [patches; CLS]:
// s = (q.k) * scale in fp32, p = exp(min(s, 80)) / sum, p cast to the value
// dtype, o = sum p*v accumulated in fp32.  The exponent is the softmax
// shift SPATIAL_SHIFT, a compile-time switch of every kernel that forms it
// (enum Shift, common.cuh): the clamp min(s, 80) above, max s - m with m
// the row's max (a quad_max of the row before the exp; the bf16 kernels
// take exp2(s scale log2e - m scale log2e), one FMA), none s; K1br's
// recompute keeps each row's shift beside 1 / l for its second pass, so
// its p stays K1sp's bit for bit under every shift.  The CLS row sits at row N of the
// staged tile, as the TPU kernel splices it into its padding row (K1p copies
// it there straight from qkv_c, as the TPU's _pipe_kernel DMAs it; the
// 8-row gap of its _softmax_probs_gap is a Mosaic alignment rule the card
// does not have).
// Backward (per frame and head): dv = p^T g with p in the value dtype;
// dp = g v^T in fp32; ds = p * (dp - D_i) in fp32, cast to the value dtype,
// with D_i = sum_j dp*p (K1b, K1br) or delta_i = sum_d g_id o_id from the
// saved output rows (K1bd); dq = scale * ds k, dk = scale * ds^T q,
// accumulated in fp32.  Like the TPU kernels it is the softmax jacobian: it
// ignores the clamp.  K1br's p is the forward's own: the bf16 tile comes
// from softmax_tile, the device function K1f, K1sp and K1p use, so K1br
// equals K1b on K1sp's probabilities bit for bit.
//
// Bounds on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) at the training shape
// (BT = 144, N = 196, C = 768, 12 heads, bf16):
//   K1f  reads 130.7 MB of qkv, writes 43.6 MB:          ~52 us (bytes);
//   K1sp the same plus 136.2 MB of probs (LS = 200):     ~93 us (bytes),
//        17.2 GFLOP, ~17 us at the tensor-core peak;
//   K1b  reads qkv, g (43.6 MB) and probs, writes 130.7 MB of dqkv:
//        441 MB, ~132 us (bytes); 34.3 GFLOP, ~35 us;
//   K1br K1b's bytes less the probs, 305 MB, ~91 us; 42.9 GFLOP, ~43 us;
//   K1bd K1b's bytes plus 43.6 MB of o, 485 MB, ~145 us.
// All are memory-bound.  Design: every input byte is read from device
// memory once, and the L x L logits never reach device memory.
//   * bf16 forward (K1f, K1sp, K1p: spatial_wg_kernel, for Hopper):
//     persistent CTAs walk the (frame, head) items.  A copying warpgroup
//     fills a ring of stages, each q, k and v of one item in the
//     core-matrix layout of wgmma.cuh (3 x 208 x 64 bf16 = 78 KB), with
//     cp.async under mbarriers (full: the copies have landed; empty: the
//     computing warpgroups are done with the stage), so the copies, which
//     wait on the memory system, never hold up the products; it gives its
//     registers to the two computing warpgroups (setmaxnreg).  The item's
//     four 64-row query tiles (197 rows: 3 x 64 + 5) go two to each
//     computing warpgroup; a tile's logits against all 208 keys are one
//     wgmma group (m64n208k16; its fp32 logits are mma.sync m16n8k16's bit
//     for bit on the card, so K1br's softmax_tile recomputes K1sp's p
//     exactly, which chip_smoke.py holds), the clamp softmax runs in
//     registers in softmax_tile's order (ex2.approx.ftz of the
//     log2(e)-scaled argument, one reciprocal per row; 8-key blocks wholly
//     inside L take no column test), and P V is a wgmma with p as the
//     register A operand.  K1sp writes each tile's bf16 p rows to a staging
//     tile in shared memory and stores them with one bulk copy (the item's
//     [L, LS] block of probs is contiguous), which runs under the next
//     tile.  K1f and K1sp run a ring of 2; K1p, the TPU's manually
//     pipelined forward, is the same kernel with the depth SPATIAL_PIPE_NBUF
//     asks for, clamped to what fits in 227 KB (2 at the TimeSformer shape,
//     up to 8 for short sequences), so its outputs equal K1f's bit for bit.
//     Not done: TMA (a head's rows are 128-byte pieces 4.6 KB apart, which
//     cp.async moves into the layout wgmma reads without a tensor map), and
//     two tiles of a warpgroup in flight at once (their logits alone would
//     take 208 registers a thread).
//   * K1p in float32: persistent CTAs of eight warps and a cp.async ring of
//     scalar stages (3 x L x 66 floats), the scalar forward's item code.
//   * bf16 backward (K1b, K1br, K1bd: spatial_bwd_wg_kernel, for Hopper):
//     persistent CTAs walk the items; a copying warpgroup fills a ring of
//     two stages, each q, k, v and g of one item in the core-matrix layout
//     (4 x 208 x 64 bf16 = 104 KB), under mbarriers, so the next item lands
//     while the current one's products run; two computing warpgroups split
//     each pass's four 64-row windows.  Two stages leave no room for p, so
//     p never enters shared memory: K1b and K1bd read the saved rows into
//     registers, K1br recomputes them in both passes (pass 2 forms s^T =
//     k q^T, the same fp32 logits, and takes 1 / l from pass 1).  Pass 1
//     (query windows): dp = g v^T, D_i = sum_j dp*p or delta_i (shared
//     memory), ds in bf16 as the register A operand of dq = ds k.  Pass 2
//     (key windows): dp^T = v g^T, p^T (the saved rows' 8 x 8 blocks
//     transposed in registers by movmatrix), ds^T, and dk = ds^T q, dv =
//     p^T g.  Every product is a wgmma; each output tile leaves through a
//     staging tile as whole 128-byte rows.  Short sequences (L <= 64) keep
//     the mma.sync kernel of one item per CTA (spatial_bwd_mma_kernel<64>).
//   * fp32: scalar FMA paths (the tensor cores have no exact fp32 mode); one
//     warp per query row (forward, backward pass 1) or key row (backward
//     pass 2), lanes over keys for the logits and over the head dimension
//     for the products with V, K, Q and G; expf and a true division.  K1br's
//     fp32 path writes its recomputed p rows to a scratch buffer the wrapper
//     allocates (they do not fit in shared memory beside q, k, v and g).

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using namespace pvrl;

constexpr int WARPS = 4;
constexpr int PIPE_WARPS = 8;
constexpr int MAX_DEPTH = 8;
constexpr int MAX_LEN = 208;  // n + 1 tokens per frame, every K1 kernel
constexpr size_t MAX_SMEM = 232448;  // a CTA's shared memory on Hopper

// backward variants: p copied from the saved probabilities (K1b),
// recomputed (K1br), or copied with delta_i = g_i . o_i (K1bd)
enum BwdMode { BWD_SAVED = 0, BWD_RECOMPUTE = 1, BWD_DELTA = 2 };

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

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// ------------------------------------------------- fp32 (scalar) kernels

// Shared-memory row stride in elements: 66 keeps the per-lane row reads of
// the logits loop on distinct banks (2-word float2 accesses).
constexpr int SC_STRIDE = HEAD_DIM + 2;

// Stage q, k, v of head h of frame bt as element pairs into three
// [L x SC_STRIDE] tiles at dst (cp.async, not waited for).
template <typename T>
__device__ __forceinline__ void stage_scalar(T* dst, const T* qkv,
                                             const T* qkv_c, int bt, int h,
                                             int n, int heads) {
  const int L = n + 1, c = heads * HEAD_DIM, c3 = 3 * c;
  for (int idx = threadIdx.x; idx < L * (HEAD_DIM / 2); idx += blockDim.x) {
    const int r = idx / (HEAD_DIM / 2), e = 2 * (idx % (HEAD_DIM / 2));
    const T* src = seq_row(qkv, qkv_c, bt, r, n, c3) + h * HEAD_DIM + e;
#pragma unroll
    for (int part = 0; part < 3; ++part)
      cp_async_pair(dst + (size_t)part * L * SC_STRIDE + (size_t)r * SC_STRIDE + e,
                    src + part * c);
  }
}

// One (frame, head) item of the scalar forward from the staged q, k, v;
// p_all holds a padded probability row per warp.
template <typename T, bool SAVE_P, int S>
__device__ __forceinline__ void scalar_item(const T* q_s, const T* k_s,
                                            const T* v_s, float* p_all,
                                            T* out, T* out_c, T* p_dst, int bt,
                                            int h, int n, int heads,
                                            float scale, int nwarps) {
  const int L = n + 1, c = heads * HEAD_DIM;
  const int lp = (L + 31) & ~31;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* p_s = p_all + warp * lp;
  for (int i = warp; i < L; i += nwarps) {
    float qf[HEAD_DIM];
#pragma unroll
    for (int m = 0; m < HEAD_DIM / 2; ++m) {
      const float2 t = load2(q_s + (size_t)i * SC_STRIDE + 2 * m);
      qf[2 * m] = t.x;
      qf[2 * m + 1] = t.y;
    }
    // the scaled logit of key j
    auto logit = [&](int j) {
      const T* kr = k_s + (size_t)j * SC_STRIDE;
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < HEAD_DIM / 2; ++m) {
        const float2 kk = load2(kr + 2 * m);
        s = fmaf(qf[2 * m], kk.x, s);
        s = fmaf(qf[2 * m + 1], kk.y, s);
      }
      return s * scale;
    };
    // kMax: the logits to p_s first, and their row max
    float mx = 0.f;
    if constexpr (S == kMax) {
      mx = -INFINITY;
      for (int j = lane; j < L; j += 32) {
        p_s[j] = logit(j);
        mx = fmaxf(mx, p_s[j]);
      }
      mx = warp_max(mx);
    }
    // keys lane, lane+32, ...: the shifted exp; row sum
    float part_sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(shift_arg<S>(S == kMax ? p_s[j] : logit(j), mx));
      p_s[j] = e;
      part_sum += e;
    }
    const float denom = warp_sum(part_sum);
    for (int j = lane; j < L; j += 32) p_s[j] = round_to(p_s[j] / denom, q_s);
    if constexpr (SAVE_P) {
      // this lane wrote p_s[j] itself just above: no sync needed
      const int ls = probs_stride(L);
      T* prow = p_dst + (size_t)i * ls;
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

template <typename T, bool SAVE_P, int S>
__global__ void __launch_bounds__(WARPS * 32)
spatial_scalar_kernel(const T* __restrict__ qkv, const T* __restrict__ qkv_c,
                      T* __restrict__ out, T* __restrict__ out_c,
                      T* __restrict__ probs, int n, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = n + 1;
  const int bt = blockIdx.x / heads, h = blockIdx.x % heads;
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = q_s + (size_t)L * SC_STRIDE;
  T* v_s = k_s + (size_t)L * SC_STRIDE;
  float* p_all = reinterpret_cast<float*>(v_s + (size_t)L * SC_STRIDE);
  stage_scalar(q_s, qkv, qkv_c, bt, h, n, heads);
  cp_async_wait_all();
  __syncthreads();
  T* p_dst = SAVE_P ? probs + (size_t)blockIdx.x * L * probs_stride(L) : nullptr;
  scalar_item<T, SAVE_P, S>(q_s, k_s, v_s, p_all, out, out_c, p_dst, bt, h,
                            n, heads, scale, WARPS);
}

// fp32 backward.  Shared memory: q, k, v, g rows [L x 66], the row sums D_i
// [lp], and per warp two rows [lp] (ds and p of the row in hand).  p comes
// from `probs` (K1b, K1bd) or, for K1br, from `scratch`, which pass 0 fills
// with the forward's probabilities (not __restrict__: written and read back
// by the same block, ordered by __syncthreads).
template <int MODE, int S>
__global__ void __launch_bounds__(WARPS * 32)
spatial_bwd_scalar_kernel(const float* __restrict__ qkv,
                          const float* __restrict__ qkv_c,
                          const float* probs, float* scratch,
                          const float* __restrict__ o,
                          const float* __restrict__ oc,
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
  const float* pb = (MODE == BWD_RECOMPUTE ? scratch : probs) +
                    (size_t)blockIdx.x * L * ls;
  float* ds_w = d_s + lp + warp * 2 * lp;
  float* p_w = ds_w + lp;

  if constexpr (MODE == BWD_RECOMPUTE) {
    // pass 0: the forward's probabilities (scalar_item's arithmetic) into
    // this item's scratch rows
    float* pr = scratch + (size_t)blockIdx.x * L * ls;
    for (int i = warp; i < L; i += WARPS) {
      auto logit = [&](int j) {
        float s = 0.f;
#pragma unroll
        for (int m = 0; m < HEAD_DIM / 2; ++m) {
          const float2 qq = load2(q_s + (size_t)i * SC_STRIDE + 2 * m);
          const float2 kk = load2(k_s + (size_t)j * SC_STRIDE + 2 * m);
          s = fmaf(qq.x, kk.x, s);
          s = fmaf(qq.y, kk.y, s);
        }
        return s * scale;
      };
      float mx = 0.f;
      if constexpr (S == kMax) {
        mx = -INFINITY;
        for (int j = lane; j < L; j += 32) {
          pr[(size_t)i * ls + j] = logit(j);
          mx = fmaxf(mx, pr[(size_t)i * ls + j]);
        }
        mx = warp_max(mx);
      }
      float part_sum = 0.f;
      for (int j = lane; j < L; j += 32) {
        const float e = expf(
            shift_arg<S>(S == kMax ? pr[(size_t)i * ls + j] : logit(j), mx));
        pr[(size_t)i * ls + j] = e;
        part_sum += e;
      }
      const float denom = warp_sum(part_sum);
      for (int j = lane; j < L; j += 32)
        pr[(size_t)i * ls + j] = pr[(size_t)i * ls + j] / denom;
    }
    __syncthreads();
  }

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
    if constexpr (MODE == BWD_DELTA) {
      // delta_i = g_i . o_i: lane over head-dim pairs
      const float2 gg = load2(g_s + (size_t)i * SC_STRIDE + 2 * lane);
      const float2 oo = load2(seq_row(o, oc, bt, i, n, c) + h * HEAD_DIM + 2 * lane);
      part = fmaf(gg.x, oo.x, gg.y * oo.y);
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

// q, k and v of head h of frame bt into three consecutive tiles at dst
__device__ __forceinline__ void stage_qkv(uint16_t* dst, const uint16_t* x,
                                          const uint16_t* x_c, int bt, int h,
                                          int n, int heads, int LP) {
  const int c = heads * HEAD_DIM;
#pragma unroll
  for (int part = 0; part < 3; ++part)
    stage_rows(dst + part * LP * MMA_STRIDE, x, x_c, bt, n, 3 * c,
               part * c + h * HEAD_DIM, LP);
}

// The forward's logits and softmax under shift S for query tile mt (rows
// mt*16 .. mt*16+15) against the LP staged keys, in the calling warp:
// s[nt][e] = exp(min(q.k * scale, 80)) (kClamp; kMax exp((q.k - m) scale)
// with m the row max, kNone exp(q.k * scale)) for key columns < L and 0
// past them,
// in the m16n8 accumulator layout (rows r0 = mt*16 + lane/4 and r1 = r0 + 8,
// columns nt*8 + 2*(lane%4) + (e & 1)), and the reciprocals of the two rows'
// sums.  p = s * inv rounded to bf16 is K1br's probability, and bit for
// bit that of K1f, K1sp and K1p (wg_tile, the same arithmetic on wgmma).
template <int LP, int S>
__device__ __forceinline__ void softmax_tile(const uint16_t* q_s,
                                             const uint16_t* k_s, int mt,
                                             int L, float scale,
                                             float (&s)[LP / 8][4],
                                             float& inv0, float& inv1) {
  constexpr int NT = LP / 8;
  const int lane = threadIdx.x % 32, tig = lane & 3;
  // ldmatrix: this lane addresses row (lane % 8) of tile (lane / 8)
  const int lrow = lane & 7, ltile = lane >> 3;
  const float scale2 = scale * LOG2E;
  // A fragments of the 16 x 64 query tile: tiles (rows 0-7 | 8-15) x
  // (cols 0-7 | 8-15) of each 16-column step
  uint32_t qa[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldsm_x4(qa[ks], q_s + (mt * 16 + (ltile & 1) * 8 + lrow) * MMA_STRIDE +
                        ks * 16 + (ltile >> 1) * 8);
  // S = Q K^T over all LP keys, fp32 accumulators; one ldmatrix gives the
  // B fragments of two 16-deep steps (K rows are the n index)
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
  // kMax: -(row max) * scale2 of each row over the valid keys (the quad)
  float nm0 = 0.f, nm1 = 0.f;
  if constexpr (S == kMax) {
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (nt * 8 + 2 * tig + (e & 1) < L) {
          if (e < 2) m0 = fmaxf(m0, s[nt][e]); else m1 = fmaxf(m1, s[nt][e]);
        }
    nm0 = -quad_max(m0) * scale2;
    nm1 = -quad_max(m1) * scale2;
  }
  // the softmax over the valid keys (columns < L): under the clamp
  // exp(min(s*scale, 80)) = 2^(min(s*scale*log2e, 80*log2e)); each row's
  // sum is spread over the 4 threads of a quad
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = nt * 8 + 2 * tig + (e & 1);
      const float x =
          col < L ? exp2_ftz(shift_arg2<S>(s[nt][e], scale2,
                                           e < 2 ? nm0 : nm1))
                  : 0.f;
      s[nt][e] = x;
      if (e < 2) sum0 += x; else sum1 += x;
    }
  }
  inv0 = 1.f / quad_sum(sum0);
  inv1 = 1.f / quad_sum(sum1);
}

// ------------------------------------------ bf16 forward (wgmma) kernel

// K1f, K1sp and K1p in bf16 (spatial_wg_kernel): persistent CTAs walk the
// (frame, head) items blockIdx.x, blockIdx.x + gridDim.x, ...; the k-th item
// of a CTA lands in ring stage k % depth.  A stage holds q, k and v rows
// [0, LP) of the item in the core-matrix layout of wgmma.cuh (LP x 64 each,
// rows >= L zero: they are zeroed once and never copied over).  The item's
// 64-row query tiles go to the CTA's computing warpgroups in turn (LP =
// 208: four tiles over two warpgroups; the last tile's rows past LP read
// the stage's first k rows, which only feed rows past L, never stored).  A
// warpgroup forms the logits of its tile against all LP keys with one
// wgmma group (m64nLPk16; its fp32 logits equal mma.sync m16n8k16's bit for
// bit, so softmax_tile, K1br's recompute, gives the same p), the clamp
// softmax in registers in softmax_tile's order, and P V with p as the
// register A operand.  K1sp stages the tile's bf16 p rows in shared memory
// and writes them with one bulk copy (the item's [L, LS] block is
// contiguous in probs), which runs under the next tile.
constexpr int FWD_DEPTH = 2;  // the ring of K1f and K1sp

__host__ __device__ constexpr int fwd_wgs(int lp) { return lp == 64 ? 1 : 2; }
__host__ __device__ constexpr int fwd_qtiles(int lp) { return lp == 64 ? 1 : 4; }
// the computing warpgroups and the copying warpgroup
__host__ __device__ constexpr int fwd_threads(int lp) {
  return (fwd_wgs(lp) + 1) * 128;
}

// the forward's shared memory: `depth` stages of q, k, v, and beside them
// per warpgroup a p staging tile of 64 x LP (used by K1sp) and the ring's
// full and empty mbarriers
struct FwdShape {
  int lp;
  size_t stage, extra;
};

FwdShape fwd_shape(int n, bool save_p) {
  const int lp = n + 1 <= 64 ? 64 : MAX_LEN;
  const size_t staging =
      save_p ? (size_t)fwd_wgs(lp) * 64 * lp * sizeof(uint16_t) : 0;
  return {lp, (size_t)3 * lp * HEAD_DIM * sizeof(uint16_t),
          staging + 2 * MAX_DEPTH * sizeof(uint64_t)};
}

// ring depth: the requested one, at least 1, clamped to what fits
int fwd_depth(int n, bool save_p, int nbuf) {
  if (n + 1 > MAX_LEN || n < 1) return 0;
  const FwdShape s = fwd_shape(n, save_p);
  const int fits = (int)((MAX_SMEM - s.extra) / s.stage);
  int d = nbuf < 1 ? 1 : nbuf;
  d = d > fits ? fits : d;
  return d > MAX_DEPTH ? MAX_DEPTH : d;
}

// the logits of a 64-row query tile against the LP staged keys
template <int LP>
__device__ __forceinline__ void wg_logits(float (&s)[LP / 2], uint64_t da,
                                          uint64_t db, int acc);
template <>
__device__ __forceinline__ void wg_logits<64>(float (&s)[32], uint64_t da,
                                              uint64_t db, int acc) {
  wgmma_ss64(s, da, db, acc);
}
template <>
__device__ __forceinline__ void wg_logits<208>(float (&s)[104], uint64_t da,
                                               uint64_t db, int acc) {
  wgmma_ss208(s, da, db, acc);
}

// kMax: -(row max) * scale2 of this thread's two rows of a 64 x LP logit
// tile (accumulator layout) over the key columns < L, from its quad
template <int NS>
__device__ __forceinline__ void wg_row_max(const float (&s)[NS], int L,
                                           float scale2, float& nm0,
                                           float& nm1) {
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    const bool inside = 8 * j + 8 <= L;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (inside || acc_col(j, e) < L) {
        if (e < 2) m0 = fmaxf(m0, s[4 * j + e]);
        else m1 = fmaxf(m1, s[4 * j + e]);
      }
  }
  nm0 = -quad_max(m0) * scale2;
  nm1 = -quad_max(m1) * scale2;
}

// Query tile t (rows 64 t .. 64 t + 63) of the item staged at st, in the
// calling warpgroup: out rows < L, and with SAVE_P the p rows to p_dst (the
// item's [L, LS] block) through the warpgroup's staging tile p_st.
template <int LP, bool SAVE_P, int S>
__device__ __forceinline__ void wg_tile(const uint16_t* st, int t,
                                        uint16_t* p_st, uint16_t* out,
                                        uint16_t* out_c, uint16_t* p_dst,
                                        int bt, int h, int n, int heads,
                                        float scale) {
  constexpr int NB = LP / 8, KK = LP / 16;
  const int L = n + 1, c = heads * HEAD_DIM, ls = probs_stride(L);
  // the warp within the warpgroup, broadcast so that the compiler sees a
  // warp-uniform branch on it (a divergent one would serialize the wgmma)
  const int tid = threadIdx.x & 127;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const uint16_t* q_s = st + t * 64 * HEAD_DIM;
  const uint16_t* k_s = st + LP * HEAD_DIM;
  const uint16_t* v_s = st + 2 * LP * HEAD_DIM;
  float s[NB * 4];
#pragma unroll
  for (int i = 0; i < NB * 4; ++i) s[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < HEAD_DIM / 16; ++ks)
    wg_logits<LP>(s, kmajor<HEAD_DIM>(q_s, ks), kmajor<HEAD_DIM>(k_s, ks),
                  ks > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  // softmax_tile's softmax, same order: a warp whose 16 rows all lie past
  // L forms no exponentials (its p is zero)
  const float scale2 = scale * LOG2E;
  float inv0 = 0.f, inv1 = 0.f;
  if (t * 64 + 16 * warp < L) {
    float nm0 = 0.f, nm1 = 0.f;
    if constexpr (S == kMax) wg_row_max(s, L, scale2, nm0, nm1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const bool inside = 8 * j + 8 <= L;  // uniform: no column test
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x =
            inside || acc_col(j, e) < L
                ? exp2_ftz(shift_arg2<S>(s[4 * j + e], scale2,
                                         e < 2 ? nm0 : nm1))
                : 0.f;
        s[4 * j + e] = x;
        if (e < 2) sum0 += x; else sum1 += x;
      }
    }
    inv0 = 1.f / quad_sum(sum0);
    inv1 = 1.f / quad_sum(sum1);
  } else {
#pragma unroll
    for (int i = 0; i < NB * 4; ++i) s[i] = 0.f;
  }
  // p = e / l rounded to bf16: the A operand of P V, k-step kk = key
  // blocks 2 kk, 2 kk + 1 (the accumulator layout of mma_16816's A)
  uint32_t pa[KK][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    pa[kk][0] = pack_bf16x2(s[8 * kk] * inv0, s[8 * kk + 1] * inv0);
    pa[kk][1] = pack_bf16x2(s[8 * kk + 2] * inv1, s[8 * kk + 3] * inv1);
    pa[kk][2] = pack_bf16x2(s[8 * kk + 4] * inv0, s[8 * kk + 5] * inv0);
    pa[kk][3] = pack_bf16x2(s[8 * kk + 6] * inv1, s[8 * kk + 7] * inv1);
  }
  if constexpr (SAVE_P) {
    // the tile's p rows into the staging tile (row stride LS; columns
    // L..LS-1 hold the zeros of the masked keys) once the previous tile's
    // bulk store has read it; no divergent code may sit inside the P V
    // group below (ptxas would serialize its products)
    if (tid == 0) bulk_wait_read();
    bar_sync(1 + (threadIdx.x >> 7), 128);
    const int r0 = acc_row(0), r1 = r0 + 8;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = acc_col(2 * kk + u, 0);
        if (col >= ls) continue;
        *reinterpret_cast<uint32_t*>(p_st + r0 * ls + col) = pa[kk][2 * u];
        *reinterpret_cast<uint32_t*>(p_st + r1 * ls + col) = pa[kk][2 * u + 1];
      }
    }
    fence_async_smem();
  }
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
    wgmma_rs<HEAD_DIM>(o, pa[kk], mnmajor<HEAD_DIM>(v_s, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  if constexpr (SAVE_P) {
    // one bulk store of the tile's rows < L, which runs under what follows
    bar_sync(1 + (threadIdx.x >> 7), 128);
    if (tid == 0) {
      const int rows = min(64, L - t * 64);
      bulk_store(p_dst + (size_t)t * 64 * ls, p_st,
                 (unsigned)(rows * ls * sizeof(uint16_t)));
      bulk_commit();
    }
  }
  // rows < n are patches, row n is the CLS query, rows past it padding
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = t * 64 + acc_row(2 * half);
    if (r > n) continue;
    uint16_t* dst = seq_row(out, out_c, bt, r, n, c) + h * HEAD_DIM;
#pragma unroll
    for (int j = 0; j < HEAD_DIM / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + acc_col(j, 0)) =
          pack_bf16x2(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
  }
}

// LP: 64 (L <= 64) or 208.  SAVE_P: K1sp.  depth: the ring's stages.
// Warpgroups 0 .. WGS-1 compute; the warpgroup after them copies the
// items' rows into the ring: stage k % depth takes item k
// once the computing warpgroups have released item k - depth (mbarrier
// empty), and the landed copies report through cp.async's own arrive
// (mbarrier full), so the copies, which wait on the memory system, never
// hold up the products, and the computing warpgroups run out of step.  At
// LP = 208 the copying warpgroup gives up its registers (setmaxnreg) to the
// computing ones, whose logits and probabilities take ~200 a thread.
template <int LP, bool SAVE_P, int S>
__global__ void __launch_bounds__(fwd_threads(LP), 1)
spatial_wg_kernel(const uint16_t* __restrict__ qkv,
                  const uint16_t* __restrict__ qkv_c,
                  uint16_t* __restrict__ out, uint16_t* __restrict__ out_c,
                  uint16_t* __restrict__ probs, int n, int heads, int items,
                  int depth, float scale) {
  constexpr int WGS = fwd_wgs(LP), QT = fwd_qtiles(LP);
  constexpr int TILE = LP * HEAD_DIM, STAGE = 3 * TILE;  // elements
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem_raw);
  const int L = n + 1, c = heads * HEAD_DIM, ls = probs_stride(L);
  const int wg = warpgroup();
  uint16_t* p_st = ring + depth * STAGE + wg * 64 * LP;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ring + depth * STAGE + (SAVE_P ? WGS * 64 * LP : 0));
  uint64_t* empty = full + MAX_DEPTH;

  // rows L .. LP-1 of every stage's q, k and v: zero, never copied over
  for (int idx = threadIdx.x; idx < depth * 3 * LP * 8; idx += blockDim.x) {
    int r, cc;
    chunk_rc<HEAD_DIM>(idx % (LP * 8), r, cc);
    if (r >= L)
      *reinterpret_cast<uint4*>(ring + (size_t)idx * 8) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x == 0) {
    for (int st = 0; st < depth; ++st) {
      mbar_init(full + st, 128);  // the copying warpgroup's threads
      mbar_init(empty + st, WGS);   // one thread of each warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == WGS) {  // the copying warpgroup
    if constexpr (LP == MAX_LEN) setmaxnreg_dec<40>();
    const int lane = threadIdx.x & 127;
    for (int k = 0; blockIdx.x + k * gridDim.x < items; ++k) {
      const int item = blockIdx.x + k * gridDim.x, slot = k % depth;
      if (k >= depth) mbar_wait(empty + slot, (k / depth - 1) & 1);
      uint16_t* st = ring + slot * STAGE;
      const int bt = item / heads, h = item % heads;
      for (int idx = lane; idx < 3 * LP * 8; idx += 128) {
        const int part = idx / (LP * 8), i = idx % (LP * 8);
        int r, cc;
        chunk_rc<HEAD_DIM>(i, r, cc);
        if (r < L)
          cp_async16(st + part * TILE + i * 8,
                     seq_row(qkv, qkv_c, bt, r, n, 3 * c) + part * c +
                         h * HEAD_DIM + cc);
      }
      cp_async_mbar_arrive(full + slot);
    }
    cp_async_wait_all();
    return;
  }
  if constexpr (LP == MAX_LEN) setmaxnreg_inc<232>();
  for (int k = 0; blockIdx.x + k * gridDim.x < items; ++k) {
    const int item = blockIdx.x + k * gridDim.x, slot = k % depth;
    mbar_wait(full + slot, (k / depth) & 1);  // item k's rows have landed
    fence_async_smem();
    const uint16_t* st = ring + slot * STAGE;
    uint16_t* p_dst =
        SAVE_P ? probs + (size_t)item * L * ls : nullptr;
    for (int t = wg; t < QT && t * 64 < L; t += WGS)
      wg_tile<LP, SAVE_P, S>(st, t, p_st, out, out_c, p_dst, item / heads,
                             item % heads, n, heads, scale);
    // every warp of the warpgroup is past its products on the stage
    bar_sync(1 + wg, 128);
    if ((threadIdx.x & 127) == 0) mbar_arrive(empty + slot);
  }
  if constexpr (SAVE_P) {
    if ((threadIdx.x & 127) == 0) bulk_wait();
  }
}

// K1p in float32: persistent CTAs walk the items (frame, head) = blockIdx.x,
// blockIdx.x + gridDim.x, ...; the k-th item of a CTA is staged into ring
// slot k % depth by one cp.async group, issued depth - 1 items ahead;
// per-warp probability rows after the ring.
template <int S>
__global__ void __launch_bounds__(PIPE_WARPS * 32)
spatial_pipe_kernel(const float* __restrict__ qkv,
                    const float* __restrict__ qkv_c, float* __restrict__ out,
                    float* __restrict__ out_c, int n, int heads, int items,
                    int depth, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = n + 1;
  const size_t stage = (size_t)3 * L * SC_STRIDE;  // elements
  float* ring = reinterpret_cast<float*>(smem_raw);
  float* p_all = ring + depth * stage;

  auto issue = [&](int k) {
    const int item = blockIdx.x + k * gridDim.x;
    if (item < items)
      stage_scalar(ring + (k % depth) * stage, qkv, qkv_c, item / heads,
                   item % heads, n, heads);
    cp_async_commit();  // an empty group past the last item keeps the count
  };
  for (int k = 0; k < depth - 1; ++k) issue(k);
  for (int k = 0; blockIdx.x + k * gridDim.x < items; ++k) {
    issue(k + depth - 1);  // into the slot item k - 1 freed
    cp_async_wait_pending(depth - 1);
    __syncthreads();  // item k's rows are in its slot for every thread
    const int item = blockIdx.x + k * gridDim.x;
    const float* slot = ring + (k % depth) * stage;
    scalar_item<float, false, S>(slot, slot + (size_t)L * SC_STRIDE,
                              slot + (size_t)2 * L * SC_STRIDE, p_all, out,
                              out_c, nullptr, item / heads, item % heads, n,
                              heads, scale, PIPE_WARPS);
    __syncthreads();  // every warp is done with the slot before its refill
  }
  cp_async_wait_all();
}

// Backward of short sequences (L <= 64, LP = 64; the Hopper kernel below
// takes LP = 208) on mma.sync: one item per CTA.  The probability tile
// has PSTR = LP + 8 columns (144-byte rows: conflict-free ldmatrix and
// 4-byte row reads).  MODE: BWD_SAVED (K1b), BWD_RECOMPUTE (K1br: probs,
// o and oc unused), BWD_DELTA (K1bd).
template <int LP, int MODE, int S>
__global__ void __launch_bounds__(WARPS * 32)
spatial_bwd_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                       const __nv_bfloat16* __restrict__ qkv_c,
                       const __nv_bfloat16* __restrict__ probs,
                       const __nv_bfloat16* __restrict__ o,
                       const __nv_bfloat16* __restrict__ oc,
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
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int lrow = lane & 7, ltile = lane >> 3;

  stage_qkv(q_s, x, x_c, bt, h, n, heads, LP);
  stage_rows(g_s, reinterpret_cast<const uint16_t*>(g),
             reinterpret_cast<const uint16_t*>(gc), bt, n, c, h * HEAD_DIM, LP);
  if constexpr (MODE != BWD_RECOMPUTE) {
    // the saved L x LS block; zero past it (columns LS.., rows L..)
    const uint16_t* pg = reinterpret_cast<const uint16_t*>(probs) +
                         (size_t)blockIdx.x * L * ls;
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
  }
  cp_async_wait_all();
  __syncthreads();
  if constexpr (MODE == BWD_RECOMPUTE) {
    // the forward's probabilities, as K1sp stores them: columns >= L and
    // rows >= L zero (columns LP.. of the tile are never read)
    for (int mt = warp; mt < MT; mt += WARPS) {
      const int r0 = mt * 16 + gid, r1 = r0 + 8;
      float e[NT][4];
      float i0, i1;
      softmax_tile<LP, S>(q_s, k_s, mt, L, scale, e, i0, i1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = nt * 8 + 2 * tig;
        *reinterpret_cast<uint32_t*>(p_s + r0 * PSTR + col) =
            r0 < L ? pack_bf16x2(e[nt][0] * i0, e[nt][1] * i0) : 0u;
        *reinterpret_cast<uint32_t*>(p_s + r1 * PSTR + col) =
            r1 < L ? pack_bf16x2(e[nt][2] * i1, e[nt][3] * i1) : 0u;
      }
    }
    __syncthreads();
  }

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
    float d0 = 0.f, d1 = 0.f;
    if constexpr (MODE == BWD_DELTA) {
      // delta_i = g_i . o_i in fp32: the quad's threads take 16 columns each
      // of rows r0 and r1, o straight from device memory; rows >= L give 0
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? r1 : r0;
        if (r >= L) continue;
        const uint16_t* orow =
            seq_row(reinterpret_cast<const uint16_t*>(o),
                    reinterpret_cast<const uint16_t*>(oc), bt, r, n, c) +
            h * HEAD_DIM + tig * 16;
        const uint16_t* grow = g_s + r * MMA_STRIDE + tig * 16;
        float acc = 0.f;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * v);
          const uint4 gv = *reinterpret_cast<const uint4*>(grow + 8 * v);
          const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
          const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const float2 a = unpack_bf16x2(gw[w]), b = unpack_bf16x2(ow[w]);
            acc = fmaf(a.x, b.x, fmaf(a.y, b.y, acc));
          }
        }
        if (half) d1 = acc; else d0 = acc;
      }
    } else {
      // D_i = sum_j dp_ij p_ij: p read in the accumulator layout
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = nt * 8 + 2 * tig;
        const float2 p0 = load_bf16x2(p_s + r0 * PSTR + col);
        const float2 p1 = load_bf16x2(p_s + r1 * PSTR + col);
        d0 = fmaf(dp[nt][0], p0.x, fmaf(dp[nt][1], p0.y, d0));
        d1 = fmaf(dp[nt][2], p1.x, fmaf(dp[nt][3], p1.y, d1));
      }
    }
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);
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

// ------------------------------------------ bf16 backward (wgmma) kernel

// K1b, K1br and K1bd in bf16 at LP = 208 (spatial_bwd_wg_kernel<MODE>):
// persistent CTAs walk the (frame, head) items as the forward does.  A
// copying warpgroup fills a ring of two stages, each q, k, v and g of one
// item in the core-matrix layout (4 x 208 x 64 bf16 = 104 KB), with cp.async
// under full / empty mbarriers, so the next item lands while the current
// one's products run; it gives its registers to the two computing
// warpgroups (setmaxnreg).  Two stages fill 208 KB, so p never goes to
// shared memory: K1b and K1bd read the saved rows straight into registers,
// and K1br recomputes them.  The item's 208 rows are cut into four 64-row
// windows, the last starting at row 144 so that every operand stays inside
// its tile (it owns rows 192..207 only); the windows go two to each
// computing warpgroup.
//   * pass 1, query window i: (K1br: s = q k^T, one wgmma group m64n208k16,
//     and the forward's clamp softmax in softmax_tile's order, so p is
//     K1sp's bit for bit; 1 / l_i to shared memory), dp = g v^T (m64n208k16),
//     D_i = sum_j dp p (K1b, K1br) or g_i . o_i (K1bd) to shared memory,
//     ds = p (dp - D) rounded to bf16 as the register A operand of dq = ds k
//     (k as the MN-major B);
//   * pass 2, once both warpgroups have stored D, key window j: dp^T = v g^T
//     (m64n208k16), p^T (K1br: s^T = k q^T, the same fp32 logits, times the
//     stored 1 / l; K1b, K1bd: 8 x 8 blocks of the saved rows read in the
//     fragment layout and transposed in registers, movmatrix), ds^T =
//     p^T (dp^T - D) in bf16, and dk = ds^T q, dv = p^T g with q and g as the
//     MN-major B;
//   * each 64 x 64 output tile goes through a warpgroup staging tile in
//     shared memory (16-byte chunks XOR-swizzled by row) and leaves as one
//     128-byte piece per row.
constexpr int BWD_WGS = 2;                    // computing warpgroups
constexpr int BWD_THREADS = (BWD_WGS + 1) * 128;
constexpr int BWD_DEPTH = 2;                  // ring stages of whole items
constexpr int BWD_TILE = MAX_LEN * HEAD_DIM;  // elements of a 208 x 64 tile
constexpr int BWD_STAGE = 4 * BWD_TILE;       // q, k, v, g
constexpr int BWD_OUT = 64 * HEAD_DIM;        // a warpgroup's output staging
constexpr int BWD_NB = MAX_LEN / 8, BWD_KK = MAX_LEN / 16;
// the ring, the staging tiles, D and 1 / l per row (and under kMax the
// recompute's row shifts), the mbarriers
__host__ __device__ constexpr int bwd_stats(int S) {
  return S == kMax ? 3 : 2;
}
constexpr size_t bwd_smem(int S) {
  return ((size_t)BWD_DEPTH * BWD_STAGE + BWD_WGS * BWD_OUT) *
             sizeof(uint16_t) +
         bwd_stats(S) * MAX_LEN * sizeof(float) +
         2 * BWD_DEPTH * sizeof(uint64_t);
}

// the first row of 64-row window t (t = 0..3) of an item's 208 rows
__device__ __forceinline__ int bwd_window(int t) {
  return t < 3 ? 64 * t : MAX_LEN - 64;
}

// A warpgroup's 64 x 64 fp32 accumulator of window rows w0.., times mul and
// rounded to bf16, to rows [lo, L) of x's [patches; CLS] rows (width
// `width`), columns col0..col0+63, through the warpgroup's staging tile st
// (barrier wgbar): each row leaves as one 128-byte piece.  The 16-byte
// chunks of a staged row are XOR-swizzled by the row, so the accumulator
// writes and the row reads are free of bank conflicts.
__device__ __forceinline__ void bwd_store(const float (&acc)[32], float mul,
                                          uint16_t* st, uint16_t* x,
                                          uint16_t* x_c, int bt, int n,
                                          int width, int col0, int w0, int lo,
                                          int wgbar) {
  const int tid = threadIdx.x & 127, L = n + 1;
  bar_sync(wgbar, 128);  // the previous tile's rows have been read out
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = acc_row(2 * half);
#pragma unroll
    for (int j = 0; j < HEAD_DIM / 8; ++j)
      *reinterpret_cast<uint32_t*>(st + r * HEAD_DIM + ((j ^ (r & 7)) << 3) +
                                   2 * (tid & 3)) =
          pack_bf16x2(acc[4 * j + 2 * half] * mul,
                      acc[4 * j + 2 * half + 1] * mul);
  }
  bar_sync(wgbar, 128);
  for (int ch = tid; ch < 64 * 8; ch += 128) {
    const int r = ch >> 3, e = ch & 7, row = w0 + r;
    if (row < lo || row >= L) continue;
    *reinterpret_cast<uint4*>(seq_row(x, x_c, bt, row, n, width) + col0 +
                              8 * e) =
        *reinterpret_cast<const uint4*>(st + r * HEAD_DIM +
                                        ((e ^ (r & 7)) << 3));
  }
}

// Pass 1 over query window t of the item staged at st, in the calling
// warpgroup: D_i (and for K1br 1 / l_i, under kMax also -m_i scale2) of the
// rows it owns into d_s (inv_s, nm_s), and their dq.  pg: the item's saved
// [L, LS] p block (K1b, K1bd).
template <int MODE, int S>
__device__ __forceinline__ void bwd_rows(const uint16_t* st, int t,
                                         const uint16_t* pg,
                                         const uint16_t* o, const uint16_t* oc,
                                         float* d_s, float* inv_s, float* nm_s,
                                         uint16_t* out_st, uint16_t* dx,
                                         uint16_t* dx_c, int bt, int h, int n,
                                         int heads, float scale, int wgbar) {
  constexpr int NB = BWD_NB, KK = BWD_KK;
  const int L = n + 1, c = heads * HEAD_DIM, ls = probs_stride(L);
  const int w0 = bwd_window(t), lo = 64 * t, tig = threadIdx.x & 3;
  const uint16_t* q_s = st;
  const uint16_t* k_s = st + BWD_TILE;
  const uint16_t* v_s = st + 2 * BWD_TILE;
  const uint16_t* g_s = st + 3 * BWD_TILE;
  const int r0 = w0 + acc_row(0), r1 = r0 + 8;
  // p of rows r0 and r1 at key columns 8 j + 2 tig, + 1: bf16 pairs
  uint32_t p0[NB], p1[NB];
  if constexpr (MODE == BWD_RECOMPUTE) {
    float s[NB * 4];
#pragma unroll
    for (int i = 0; i < NB * 4; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HEAD_DIM / 16; ++ks)
      wgmma_ss208(s, kmajor<HEAD_DIM>(q_s + w0 * HEAD_DIM, ks),
                  kmajor<HEAD_DIM>(k_s, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    // wg_tile's softmax, same order, so p is K1sp's bit for bit
    const float scale2 = scale * LOG2E;
    float nm0 = 0.f, nm1 = 0.f;
    if constexpr (S == kMax) wg_row_max(s, L, scale2, nm0, nm1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const bool inside = 8 * j + 8 <= L;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x =
            inside || acc_col(j, e) < L
                ? exp2_ftz(shift_arg2<S>(s[4 * j + e], scale2,
                                         e < 2 ? nm0 : nm1))
                : 0.f;
        s[4 * j + e] = x;
        if (e < 2) sum0 += x; else sum1 += x;
      }
    }
    const float inv0 = 1.f / quad_sum(sum0), inv1 = 1.f / quad_sum(sum1);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      p0[j] = pack_bf16x2(s[4 * j] * inv0, s[4 * j + 1] * inv0);
      p1[j] = pack_bf16x2(s[4 * j + 2] * inv1, s[4 * j + 3] * inv1);
    }
    // pass 2 rebuilds p^T from the logits and 1 / l (zero past L), and
    // under kMax the rows' shifts
    if (tig == 0) {
      if (r0 >= lo) inv_s[r0] = r0 < L ? inv0 : 0.f;
      if (r1 >= lo) inv_s[r1] = r1 < L ? inv1 : 0.f;
      if constexpr (S == kMax) {
        if (r0 >= lo) nm_s[r0] = r0 < L ? nm0 : 0.f;
        if (r1 >= lo) nm_s[r1] = r1 < L ? nm1 : 0.f;
      }
    }
  } else {
    // the saved rows (zero past L and past LS), issued before the products
    const uint16_t* a0 = pg + (size_t)r0 * ls + 2 * tig;
    const uint16_t* a1 = pg + (size_t)r1 * ls + 2 * tig;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const bool in = 8 * j + 2 * tig < ls;
      p0[j] = r0 < L && in ? *reinterpret_cast<const uint32_t*>(a0 + 8 * j) : 0u;
      p1[j] = r1 < L && in ? *reinterpret_cast<const uint32_t*>(a1 + 8 * j) : 0u;
    }
  }
  float dp[NB * 4];
#pragma unroll
  for (int i = 0; i < NB * 4; ++i) dp[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < HEAD_DIM / 16; ++ks)
    wgmma_ss208(dp, kmajor<HEAD_DIM>(g_s + w0 * HEAD_DIM, ks),
                kmajor<HEAD_DIM>(v_s, ks), ks > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dp);
  float d0 = 0.f, d1 = 0.f;
  if constexpr (MODE == BWD_DELTA) {
    // delta_i = g_i . o_i in fp32: the quad's threads take 16 columns each
    // of rows r0 and r1, o straight from device memory; rows >= L give 0
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (r >= L) continue;
      const uint16_t* orow = seq_row(o, oc, bt, r, n, c) + h * HEAD_DIM +
                             tig * 16;
      float acc = 0.f;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * v);
        const uint4 gv = *reinterpret_cast<const uint4*>(
            g_s + (((r >> 3) * 8 + 2 * tig + v) << 6) + ((r & 7) << 3));
        const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
        const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 a = unpack_bf16x2(gw[w]), b = unpack_bf16x2(ow[w]);
          acc = fmaf(a.x, b.x, fmaf(a.y, b.y, acc));
        }
      }
      (half ? d1 : d0) = acc;
    }
  } else {
    // D_i = sum_j dp_ij p_ij
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float2 a = unpack_bf16x2(p0[j]), b = unpack_bf16x2(p1[j]);
      d0 = fmaf(dp[4 * j], a.x, fmaf(dp[4 * j + 1], a.y, d0));
      d1 = fmaf(dp[4 * j + 2], b.x, fmaf(dp[4 * j + 3], b.y, d1));
    }
  }
  d0 = quad_sum(d0);
  d1 = quad_sum(d1);
  if (tig == 0) {
    if (r0 >= lo) d_s[r0] = d0;
    if (r1 >= lo) d_s[r1] = d1;
  }
  // ds = p (dp - D), rounded to bf16: the A operand of dq = ds k
  uint32_t da[KK][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = 2 * kk + u;
      const float2 a = unpack_bf16x2(p0[j]), b = unpack_bf16x2(p1[j]);
      da[kk][2 * u] = pack_bf16x2(a.x * (dp[4 * j] - d0),
                                  a.y * (dp[4 * j + 1] - d0));
      da[kk][2 * u + 1] = pack_bf16x2(b.x * (dp[4 * j + 2] - d1),
                                      b.y * (dp[4 * j + 3] - d1));
    }
  }
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
    wgmma_rs<HEAD_DIM>(dq, da[kk], mnmajor<HEAD_DIM>(k_s, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dq);
  bwd_store(dq, scale, out_st, dx, dx_c, bt, n, 3 * c, h * HEAD_DIM, w0, lo,
            wgbar);
}

// Pass 2 over key window t of the item staged at st, in the calling
// warpgroup: dk and dv of the key rows it owns, from D (and for K1br
// 1 / l, under kMax also -m scale2) of every query row.
template <int MODE, int S>
__device__ __forceinline__ void bwd_keys(const uint16_t* st, int t,
                                         const uint16_t* pg, const float* d_s,
                                         const float* inv_s,
                                         const float* nm_s, uint16_t* out_st,
                                         uint16_t* dx, uint16_t* dx_c, int bt,
                                         int h, int n, int heads, float scale,
                                         int wgbar) {
  constexpr int NB = BWD_NB, KK = BWD_KK;
  const int L = n + 1, c = heads * HEAD_DIM, ls = probs_stride(L);
  const int w0 = bwd_window(t), lo = 64 * t;
  const uint16_t* q_s = st;
  const uint16_t* k_s = st + BWD_TILE;
  const uint16_t* v_s = st + 2 * BWD_TILE;
  const uint16_t* g_s = st + 3 * BWD_TILE;
  // p^T of key rows r0 and r1 at query columns 8 j + 2 tig, + 1
  uint32_t pt0[NB], pt1[NB];
  if constexpr (MODE != BWD_RECOMPUTE) {
    // 8 x 8 blocks of the saved rows (queries 8 j.., the warp's two blocks
    // of 8 keys) in the fragment layout, issued before the products and
    // transposed once they are done; zero past L and past LS
    const int lane = threadIdx.x & 31;
    const int i = lane >> 2;
    const int kb = w0 + 16 * ((threadIdx.x & 127) >> 5) + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const uint16_t* row = pg + (size_t)(8 * j + i) * ls + kb;
      const bool in = 8 * j + i < L;
      pt0[j] = in && kb < ls ? *reinterpret_cast<const uint32_t*>(row) : 0u;
      pt1[j] = in && kb + 8 < ls ? *reinterpret_cast<const uint32_t*>(row + 8)
                                 : 0u;
    }
  }
  if constexpr (MODE == BWD_RECOMPUTE) {
    // s^T = k q^T: the fp32 logits of pass 1, so p^T = bf16(e / l) is the
    // same p (1 / l is zero past L)
    float s[NB * 4];
#pragma unroll
    for (int i = 0; i < NB * 4; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HEAD_DIM / 16; ++ks)
      wgmma_ss208(s, kmajor<HEAD_DIM>(k_s + w0 * HEAD_DIM, ks),
                  kmajor<HEAD_DIM>(q_s, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    const float scale2 = scale * LOG2E;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float2 inv = *reinterpret_cast<const float2*>(inv_s + acc_col(j, 0));
      float2 nm = make_float2(0.f, 0.f);
      if constexpr (S == kMax)
        nm = *reinterpret_cast<const float2*>(nm_s + acc_col(j, 0));
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[e] = exp2_ftz(
            shift_arg2<S>(s[4 * j + e], scale2, (e & 1) ? nm.y : nm.x));
      pt0[j] = pack_bf16x2(x[0] * inv.x, x[1] * inv.y);
      pt1[j] = pack_bf16x2(x[2] * inv.x, x[3] * inv.y);
    }
  }
  float dpt[NB * 4];
#pragma unroll
  for (int i = 0; i < NB * 4; ++i) dpt[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < HEAD_DIM / 16; ++ks)
    wgmma_ss208(dpt, kmajor<HEAD_DIM>(v_s + w0 * HEAD_DIM, ks),
                kmajor<HEAD_DIM>(g_s, ks), ks > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dpt);
  if constexpr (MODE != BWD_RECOMPUTE) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      pt0[j] = movmatrix_t(pt0[j]);
      pt1[j] = movmatrix_t(pt1[j]);
    }
  }
  // ds^T = p^T (dp^T - D) in bf16, and p^T: the A operands of dk and dv
  uint32_t da[KK][4], pa[KK][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = 2 * kk + u;
      const float2 D = *reinterpret_cast<const float2*>(d_s + acc_col(j, 0));
      const float2 a = unpack_bf16x2(pt0[j]), b = unpack_bf16x2(pt1[j]);
      da[kk][2 * u] = pack_bf16x2(a.x * (dpt[4 * j] - D.x),
                                  a.y * (dpt[4 * j + 1] - D.y));
      da[kk][2 * u + 1] = pack_bf16x2(b.x * (dpt[4 * j + 2] - D.x),
                                      b.y * (dpt[4 * j + 3] - D.y));
      pa[kk][2 * u] = pt0[j];
      pa[kk][2 * u + 1] = pt1[j];
    }
  }
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    wgmma_rs<HEAD_DIM>(dk, da[kk], mnmajor<HEAD_DIM>(q_s, kk), kk > 0);
    wgmma_rs<HEAD_DIM>(dv, pa[kk], mnmajor<HEAD_DIM>(g_s, kk), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dk);
  fence_regs(dv);
  bwd_store(dk, scale, out_st, dx, dx_c, bt, n, 3 * c, c + h * HEAD_DIM, w0,
            lo, wgbar);
  bwd_store(dv, 1.f, out_st, dx, dx_c, bt, n, 3 * c, 2 * c + h * HEAD_DIM, w0,
            lo, wgbar);
}

// MODE: BWD_SAVED (K1b), BWD_RECOMPUTE (K1br: probs, o and oc unused),
// BWD_DELTA (K1bd).  Warpgroups 0 and 1 compute, warpgroup 2 copies: stage
// k % 2 takes the CTA's item k once the computing warpgroups have released
// item k - 2 (mbarrier empty); the landed copies report through cp.async's
// own arrive (mbarrier full).
template <int MODE, int S>
__global__ void __launch_bounds__(BWD_THREADS, 1)
spatial_bwd_wg_kernel(const uint16_t* __restrict__ qkv,
                      const uint16_t* __restrict__ qkv_c,
                      const uint16_t* __restrict__ probs,
                      const uint16_t* __restrict__ o,
                      const uint16_t* __restrict__ oc,
                      const uint16_t* __restrict__ g,
                      const uint16_t* __restrict__ gc,
                      uint16_t* __restrict__ dqkv,
                      uint16_t* __restrict__ dqkv_c, int n, int heads,
                      int items, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem_raw);
  const int L = n + 1, c = heads * HEAD_DIM, ls = probs_stride(L);
  const int wg = warpgroup();
  uint16_t* out_st = ring + BWD_DEPTH * BWD_STAGE + wg * BWD_OUT;
  float* d_s = reinterpret_cast<float*>(ring + BWD_DEPTH * BWD_STAGE +
                                        BWD_WGS * BWD_OUT);
  float* inv_s = d_s + MAX_LEN;
  float* nm_s = inv_s + MAX_LEN;  // kMax only
  uint64_t* full =
      reinterpret_cast<uint64_t*>(d_s + bwd_stats(S) * MAX_LEN);
  uint64_t* empty = full + BWD_DEPTH;

  // rows L .. 207 of every stage's tiles: zero, never copied over; D and
  // 1 / l zero, so rows past L (never written) add nothing
  for (int idx = threadIdx.x; idx < BWD_DEPTH * 4 * MAX_LEN * 8;
       idx += blockDim.x) {
    int r, cc;
    chunk_rc<HEAD_DIM>(idx % (MAX_LEN * 8), r, cc);
    if (r >= L)
      *reinterpret_cast<uint4*>(ring + (size_t)idx * 8) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = threadIdx.x; i < bwd_stats(S) * MAX_LEN; i += blockDim.x)
    d_s[i] = 0.f;
  fence_async_smem();
  if (threadIdx.x == 0) {
    for (int st = 0; st < BWD_DEPTH; ++st) {
      mbar_init(full + st, 128);  // the copying warpgroup's threads
      mbar_init(empty + st, 1);   // one thread once both warpgroups are done
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == BWD_WGS) {  // the copying warpgroup
    setmaxnreg_dec<40>();
    const int lane = threadIdx.x & 127;
    for (int k = 0; blockIdx.x + k * gridDim.x < items; ++k) {
      const int item = blockIdx.x + k * gridDim.x, slot = k % BWD_DEPTH;
      if (k >= BWD_DEPTH) mbar_wait(empty + slot, (k / BWD_DEPTH - 1) & 1);
      uint16_t* st = ring + slot * BWD_STAGE;
      const int bt = item / heads, h = item % heads;
      for (int idx = lane; idx < 4 * MAX_LEN * 8; idx += 128) {
        const int part = idx / (MAX_LEN * 8), i = idx % (MAX_LEN * 8);
        int r, cc;
        chunk_rc<HEAD_DIM>(i, r, cc);
        if (r >= L) continue;
        const uint16_t* src = part < 3
            ? seq_row(qkv, qkv_c, bt, r, n, 3 * c) + part * c
            : seq_row(g, gc, bt, r, n, c);
        cp_async16(st + part * BWD_TILE + i * 8, src + h * HEAD_DIM + cc);
      }
      cp_async_mbar_arrive(full + slot);
      // K1b: the item's saved p block (contiguous), which the computing
      // warpgroups read straight into registers, into L2 now (K1bd, whose
      // first pass also reads the o rows, ran 2 % slower with it)
      if constexpr (MODE == BWD_SAVED) {
        if (lane == 0)
          prefetch_l2(probs + (size_t)item * L * ls,
                      (unsigned)(L * ls * sizeof(uint16_t)));
      }
    }
    cp_async_wait_all();
    return;
  }
  setmaxnreg_inc<232>();
  const int wgbar = 1 + wg;
  for (int k = 0; blockIdx.x + k * gridDim.x < items; ++k) {
    const int item = blockIdx.x + k * gridDim.x, slot = k % BWD_DEPTH;
    mbar_wait(full + slot, (k / BWD_DEPTH) & 1);  // item k's rows have landed
    fence_async_smem();
    const uint16_t* st = ring + slot * BWD_STAGE;
    const int bt = item / heads, h = item % heads;
    const uint16_t* pg =
        MODE == BWD_RECOMPUTE ? nullptr : probs + (size_t)item * L * ls;
    for (int t = wg; t < 4 && 64 * t < L; t += BWD_WGS)
      bwd_rows<MODE, S>(st, t, pg, o, oc, d_s, inv_s, nm_s, out_st, dqkv,
                        dqkv_c, bt, h, n, heads, scale, wgbar);
    bar_sync(3, BWD_WGS * 128);  // every D_i (and 1 / l_i) is stored
    for (int t = wg; t < 4 && 64 * t < L; t += BWD_WGS)
      bwd_keys<MODE, S>(st, t, pg, d_s, inv_s, nm_s, out_st, dqkv, dqkv_c,
                        bt, h, n, heads, scale, wgbar);
    // both warpgroups are done with the stage and with D before the next
    // item rewrites D and the copying warpgroup refills the stage
    bar_sync(3, BWD_WGS * 128);
    if (threadIdx.x == 0) mbar_arrive(empty + slot);
  }
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

// the bf16 forward (K1f, K1sp, K1p) with a ring of `depth` stages
template <int LP, bool SAVE_P, int S>
cudaError_t launch_wg(const void* qkv, const void* qkv_c, void* out,
                      void* out_c, void* probs, int bt, int n, int heads,
                      int depth, float scale, cudaStream_t stream) {
  const FwdShape s = fwd_shape(n, SAVE_P);
  const size_t smem = depth * s.stage + s.extra;
  const int items = bt * heads, threads = fwd_threads(LP);
  int ctas = 0;
  cudaError_t err = persistent_ctas(spatial_wg_kernel<LP, SAVE_P, S>,
                                    threads, smem, items, ctas);
  if (err != cudaSuccess) return err;
  spatial_wg_kernel<LP, SAVE_P, S><<<ctas, threads, smem, stream>>>(
      static_cast<const uint16_t*>(qkv), static_cast<const uint16_t*>(qkv_c),
      static_cast<uint16_t*>(out), static_cast<uint16_t*>(out_c),
      static_cast<uint16_t*>(probs), n, heads, items, depth, scale);
  return cudaGetLastError();
}

template <bool SAVE_P, int S>
cudaError_t launch_scalar(const void* qkv, const void* qkv_c, void* out,
                          void* out_c, void* probs, int bt, int n, int heads,
                          float scale, cudaStream_t stream) {
  const int L = n + 1, lp = (L + 31) & ~31;
  const size_t smem = (size_t)3 * L * SC_STRIDE * sizeof(float) +
                      (size_t)WARPS * lp * sizeof(float);
  cudaError_t err = set_smem(spatial_scalar_kernel<float, SAVE_P, S>, smem);
  if (err != cudaSuccess) return err;
  spatial_scalar_kernel<float, SAVE_P, S><<<bt * heads, WARPS * 32, smem,
                                            stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(qkv_c),
      static_cast<float*>(out), static_cast<float*>(out_c),
      static_cast<float*>(probs), n, heads, scale);
  return cudaGetLastError();
}

// The forward: K1f / K1sp (SAVE_P) in float32 on the scalar kernel, in
// bf16 on spatial_wg_kernel with `nbuf` ring stages asked for (clamped by
// fwd_depth), under shift S
template <bool SAVE_P, int S>
int forward(const void* qkv, const void* qkv_c, void* out, void* out_c,
            void* probs, int bt, int n, int heads, int dtype, int nbuf,
            float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int L = n + 1;
  if (L > MAX_LEN || n < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_scalar<SAVE_P, S>(qkv, qkv_c, out, out_c, probs, bt,
                                         n, heads, scale, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const int depth = fwd_depth(n, SAVE_P, nbuf);
  if (depth < 1) return (int)cudaErrorInvalidValue;
  if (L <= 64)
    return (int)launch_wg<64, SAVE_P, S>(qkv, qkv_c, out, out_c, probs, bt,
                                         n, heads, depth, scale, st);
  return (int)launch_wg<MAX_LEN, SAVE_P, S>(qkv, qkv_c, out, out_c, probs, bt,
                                            n, heads, depth, scale, st);
}

// K1p's float32 ring: the bytes of one stage and of the per-warp rows
// beside it
struct PipeShape {
  size_t stage, extra;
};

PipeShape pipe_shape(int n) {
  const int L = n + 1;
  return {(size_t)3 * L * SC_STRIDE * sizeof(float),
          (size_t)PIPE_WARPS * ((L + 31) & ~31) * sizeof(float)};
}

// K1p's ring depth: the requested one, at least 1, clamped to what fits
// (bf16: the forward's rule)
int pipe_depth(int n, int dtype, int nbuf) {
  if (n + 1 > MAX_LEN || n < 1) return 0;
  if (dtype == 1) return fwd_depth(n, false, nbuf);
  const PipeShape s = pipe_shape(n);
  if (s.stage + s.extra > MAX_SMEM) return 0;
  const int fits = (int)((MAX_SMEM - s.extra) / s.stage);
  int d = nbuf < 1 ? 1 : nbuf;
  d = d > fits ? fits : d;
  return d > MAX_DEPTH ? MAX_DEPTH : d;
}

template <int S>
cudaError_t launch_pipe(const void* qkv, const void* qkv_c, void* out,
                        void* out_c, int bt, int n, int heads, int depth,
                        float scale, cudaStream_t stream) {
  const PipeShape s = pipe_shape(n);
  const size_t smem = depth * s.stage + s.extra;
  const int items = bt * heads;
  int ctas = 0;
  cudaError_t err = persistent_ctas(spatial_pipe_kernel<S>, PIPE_WARPS * 32,
                                    smem, items, ctas);
  if (err != cudaSuccess) return err;
  spatial_pipe_kernel<S><<<ctas, PIPE_WARPS * 32, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(qkv_c),
      static_cast<float*>(out), static_cast<float*>(out_c), n, heads, items,
      depth, scale);
  return cudaGetLastError();
}

template <int LP, int MODE, int S>
cudaError_t launch_bwd_mma(const void* qkv, const void* qkv_c,
                           const void* probs, const void* o, const void* oc,
                           const void* g, const void* gc, void* dqkv,
                           void* dqkv_c, int bt, int n, int heads, float scale,
                           cudaStream_t stream) {
  const size_t smem = (size_t)4 * LP * MMA_STRIDE * sizeof(uint16_t) +
                      (size_t)LP * (LP + 8) * sizeof(uint16_t) +
                      (size_t)LP * sizeof(float);
  cudaError_t err = set_smem(spatial_bwd_mma_kernel<LP, MODE, S>, smem);
  if (err != cudaSuccess) return err;
  using bf = __nv_bfloat16;
  spatial_bwd_mma_kernel<LP, MODE, S><<<bt * heads, WARPS * 32, smem,
                                        stream>>>(
      static_cast<const bf*>(qkv), static_cast<const bf*>(qkv_c),
      static_cast<const bf*>(probs), static_cast<const bf*>(o),
      static_cast<const bf*>(oc), static_cast<const bf*>(g),
      static_cast<const bf*>(gc), static_cast<bf*>(dqkv),
      static_cast<bf*>(dqkv_c), n, heads, scale);
  return cudaGetLastError();
}

// the bf16 backward at LP = 208 on persistent CTAs
template <int MODE, int S>
cudaError_t launch_bwd_wg(const void* qkv, const void* qkv_c,
                          const void* probs, const void* o, const void* oc,
                          const void* g, const void* gc, void* dqkv,
                          void* dqkv_c, int bt, int n, int heads, float scale,
                          cudaStream_t stream) {
  const int items = bt * heads;
  int ctas = 0;
  constexpr size_t smem = bwd_smem(S);
  cudaError_t err = persistent_ctas(spatial_bwd_wg_kernel<MODE, S>,
                                    BWD_THREADS, smem, items, ctas);
  if (err != cudaSuccess) return err;
  using u16 = uint16_t;
  spatial_bwd_wg_kernel<MODE, S><<<ctas, BWD_THREADS, smem, stream>>>(
      static_cast<const u16*>(qkv), static_cast<const u16*>(qkv_c),
      static_cast<const u16*>(probs), static_cast<const u16*>(o),
      static_cast<const u16*>(oc), static_cast<const u16*>(g),
      static_cast<const u16*>(gc), static_cast<u16*>(dqkv),
      static_cast<u16*>(dqkv_c), n, heads, items, scale);
  return cudaGetLastError();
}

// The backward of MODE under shift S (BWD_SAVED and BWD_DELTA read p and
// take kClamp only)
template <int MODE, int S>
int backward(const void* qkv, const void* qkv_c, const void* probs,
             void* scratch, const void* o, const void* oc, const void* g,
             const void* gc, void* dqkv, void* dqkv_c, int bt, int n,
             int heads, int dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int L = n + 1;
  if (L > MAX_LEN) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    const int lp = (L + 31) & ~31;
    const size_t smem = (size_t)4 * L * SC_STRIDE * sizeof(float) +
                        (size_t)(1 + 2 * WARPS) * lp * sizeof(float);
    cudaError_t err = set_smem(spatial_bwd_scalar_kernel<MODE, S>, smem);
    if (err != cudaSuccess) return (int)err;
    spatial_bwd_scalar_kernel<MODE, S><<<bt * heads, WARPS * 32, smem, st>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(qkv_c),
        static_cast<const float*>(probs), static_cast<float*>(scratch),
        static_cast<const float*>(o), static_cast<const float*>(oc),
        static_cast<const float*>(g), static_cast<const float*>(gc),
        static_cast<float*>(dqkv), static_cast<float*>(dqkv_c), n, heads,
        scale);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (L <= 64)
    return (int)launch_bwd_mma<64, MODE, S>(qkv, qkv_c, probs, o, oc, g, gc,
                                            dqkv, dqkv_c, bt, n, heads, scale,
                                            st);
  return (int)launch_bwd_wg<MODE, S>(qkv, qkv_c, probs, o, oc, g, gc, dqkv,
                                     dqkv_c, bt, n, heads, scale, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Head dim is 64.  shift: the softmax
// shift (enum Shift: 0 clamp, 1 max, 2 none; K1b and K1bd read p and take
// none).  Each entry point returns the CUDA error code of its launch (0 on
// success).

// K1f.  Sequences of up to MAX_LEN = 208 tokens with the CLS (n + 1 <=
// 208, the backward's limit); longer ones take flash_attention.cu's pair.
extern "C" int spatial_attention_fwd(const void* qkv, const void* qkv_c,
                                     void* out, void* out_c, int bt, int n,
                                     int heads, int dtype, int shift,
                                     float scale, void* stream) {
  return with_shift(shift, [&](auto s) {
    return forward<false, decltype(s)::value>(qkv, qkv_c, out, out_c, nullptr,
                                              bt, n, heads, dtype, FWD_DEPTH,
                                              scale, stream);
  });
}

// K1sp: K1f that also writes probs [bt, heads, n + 1, LS] (LS = n + 1
// rounded up to 8).  Same limits as K1f.
extern "C" int spatial_attention_fwd_probs(const void* qkv, const void* qkv_c,
                                           void* out, void* out_c, void* probs,
                                           int bt, int n, int heads, int dtype,
                                           int shift, float scale,
                                           void* stream) {
  return with_shift(shift, [&](auto s) {
    return forward<true, decltype(s)::value>(qkv, qkv_c, out, out_c, probs, bt,
                                             n, heads, dtype, FWD_DEPTH, scale,
                                             stream);
  });
}

// The ring depth K1p runs for a requested depth nbuf (0: the shape does
// not fit).
extern "C" int spatial_attention_pipe_depth(int n, int dtype, int nbuf) {
  return dtype == 0 || dtype == 1 ? pipe_depth(n, dtype, nbuf) : 0;
}

// K1p: K1f's contract through persistent CTAs and a ring of
// spatial_attention_pipe_depth(n, dtype, nbuf) stages (bf16: K1f's kernel,
// so its outputs equal K1f's bit for bit).
extern "C" int spatial_attention_fwd_pipe(const void* qkv, const void* qkv_c,
                                          void* out, void* out_c, int bt,
                                          int n, int heads, int dtype,
                                          int nbuf, int shift, float scale,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_shift(shift, [&](auto s) {
    constexpr int S = decltype(s)::value;
    if (dtype == 1)
      return forward<false, S>(qkv, qkv_c, out, out_c, nullptr, bt, n, heads,
                               dtype, nbuf, scale, stream);
    if (dtype != 0 || n + 1 > MAX_LEN || n < 1)
      return (int)cudaErrorInvalidValue;
    const int depth = pipe_depth(n, dtype, nbuf);
    if (depth < 1) return (int)cudaErrorInvalidValue;
    return (int)launch_pipe<S>(qkv, qkv_c, out, out_c, bt, n, heads, depth,
                               scale, st);
  });
}

// K1b: dqkv [bt, n, 3C], dqkv_c [bt, 1, 3C] from qkv, qkv_c, the K1sp
// probabilities and the output gradients g [bt, n, C], gc [bt, 1, C].
// n + 1 <= 208 (bf16: 210 KB of shared memory at 208; fp32: 228 KB).
extern "C" int spatial_attention_bwd(const void* qkv, const void* qkv_c,
                                     const void* probs, const void* g,
                                     const void* gc, void* dqkv, void* dqkv_c,
                                     int bt, int n, int heads, int dtype,
                                     float scale, void* stream) {
  return backward<BWD_SAVED, kClamp>(qkv, qkv_c, probs, nullptr, nullptr,
                                     nullptr, g, gc, dqkv, dqkv_c, bt, n,
                                     heads, dtype, scale, stream);
}

// K1br: K1b with the probabilities recomputed from qkv, qkv_c under the
// shift.  fp32 needs a scratch [bt, heads, n + 1, LS] float buffer (bf16:
// unused, may be null).
extern "C" int spatial_attention_bwd_recompute(
    const void* qkv, const void* qkv_c, const void* g, const void* gc,
    void* dqkv, void* dqkv_c, void* scratch, int bt, int n, int heads,
    int dtype, int shift, float scale, void* stream) {
  return with_shift(shift, [&](auto s) {
    return backward<BWD_RECOMPUTE, decltype(s)::value>(
        qkv, qkv_c, nullptr, scratch, nullptr, nullptr, g, gc, dqkv, dqkv_c,
        bt, n, heads, dtype, scale, stream);
  });
}

// K1bd: K1b with delta_i = g_i . o_i from the forward's outputs
// out [bt, n, C], out_c [bt, 1, C] in place of the jacobian row sums.
extern "C" int spatial_attention_bwd_delta(
    const void* qkv, const void* qkv_c, const void* probs, const void* out,
    const void* out_c, const void* g, const void* gc, void* dqkv,
    void* dqkv_c, int bt, int n, int heads, int dtype, float scale,
    void* stream) {
  return backward<BWD_DELTA, kClamp>(qkv, qkv_c, probs, nullptr, out, out_c,
                                     g, gc, dqkv, dqkv_c, bt, n, heads, dtype,
                                     scale, stream);
}
