// MViT's depthwise 3x3x3 attention pool: the forward (K8f, which the
// stride-1 backward also runs for dx, on the output gradient with the tap
// table reversed) and the stride-1 weight gradient (K8dw), both on a
// shared-memory window of the input.
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
// (stride 1), fp32 [27, C], the same bits on every run.
//
// Bounds on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores).  The pool of MViT-v2-S block 0 at the 18-clip training step
// ([18, 8, 56, 56, 96], bf16) reads 86.7 MB and writes 86.7 MB: 52 us; its
// 1.05 G fused multiply-adds (27 an output, less the padding's) take 31 us
// at the fp32 peak, so the FMA floor sits close under the byte bound.
// K8dw reads x and g, the same bytes and products.  Each K8f output sums
// 27 products of inputs that 27 outputs share, so a kernel that fetches a
// tap's input from device memory per product moves 27x the bytes through
// L1/L2, and one that reads each from shared memory per product spends
// more on the reads than on the FMAs.
//
// Design (the TPU kernel's rolling window in VMEM, thought again for SMs):
//   * a CTA owns (b, a band of output rows, a tile of output columns, a
//     32-channel slice) and walks t.  Each input plane of its window (the
//     band's rows and columns with a one-element halo, (band + 2) / band of
//     the band's bytes at stride 1) lands once in a ring of shared-memory
//     slots as one TMA box (cp.async.bulk.tensor on a 5-d tensor map of x
//     through its row and batch strides, issued by one thread, completed on
//     the slot's mbarrier), the halo outside the grid zero-filled by the
//     TMA unit: that is the padding, so no tap is bounds-checked.  A first
//     design staged the box by 16-byte cp.async from every thread; its
//     address arithmetic cost ~230 instructions a thread and plane beside
//     ~600 for the taps, and the TMA box took K8f at block 0 from 0.129 to
//     0.097 ms on an H100 SXM (PERF.md).  K8f keeps two planes in flight
//     behind the one it reads;
//   * a K8f thread owns 2 channels of a strip of SW = 7 neighbouring
//     outputs along w (7 divides MViT's widths 56, 28, 14 and 7; odd, so
//     the two half-warps of a warp, on neighbouring strips or rows of an
//     odd pitch, read other banks) and keeps their sums for the output
//     planes t-1, t and t+1 in registers (42): input plane t adds its dt =
//     2, 1 and 0 taps to them, in tap-row order, and output plane t-1 is
//     then complete and stored.  So each staged value is read from shared
//     memory once per (dh, strip) and feeds up to 3 x 3 taps: ~4.5 reads an
//     output instead of 27.  The fp32 weights sit in shared memory, 18 of
//     them in registers for a tap row (54 would spill under the 128-register
//     cap of 512-thread CTAs).  dx is this kernel on g reading the tap rows
//     in reverse order;
//   * K8dw walks the same window with the output gradient's band beside
//     it (a second box on the slot's mbarrier), a thread on one channel of
//     a strip (so its 27 fp32 tap sums and the 3 x 7 g values below fit its
//     registers): x plane t-1 meets g planes t, t-1 and t-2 (dt = 0, 1, 2),
//     held in registers as the forward holds its sums, and the tap sums
//     stay in registers across all the positions the thread owns.  The CTA
//     adds its warps once at the end, in order through shared memory, into
//     one fp32 partial [27, 32] of its (b, band, tile); a second kernel adds
//     the partials in a fixed order, 32 lanes side by side.  No atomics:
//     the result is deterministic;
//   * positions are CTA-relative 32-bit indices; the band and tile sizes
//     come from the wrapper's planner (ops/depthwise_pool.py:pool_plan),
//     checked here: at most 512 threads, boxes of at most 256 along each
//     axis, and the ring within the card's shared memory.

#include "common.cuh"
#include "tma.cuh"

namespace {

using namespace pvrl;

constexpr int KTAPS = 27;
constexpr int VEC = 8;          // channel and stride multiple (16 bytes of bf16)
constexpr int SW = 7;           // output columns of a thread's strip
constexpr int CS = 32;          // channels of a CTA's slice
constexpr int FWD_LANES = CS / 2;  // K8f threads across a slice, 2 channels each
constexpr int MAX_THREADS = 512;
constexpr int MAX_BOX = 256;    // a TMA box's extent along each dimension
constexpr int FWD_SLOTS = 3;    // K8f: plane t read while t+1 and t+2 land
constexpr int DW_SLOTS = 4;     // K8dw: slots t-1 (x) and t (g) read,
constexpr int DW_AHEAD = DW_SLOTS - 2;  // while the planes ahead land
constexpr int RED_LANES = 32;   // partials added side by side in K8dw's pass 2
constexpr int SMEM_MAX = 232448;
constexpr int BAR_BYTES = 128;  // the ring's mbarriers, ahead of the rest
constexpr int W_BYTES = KTAPS * CS * 4;  // K8f's fp32 weights in shared memory

struct Geo {
  int b, t, h, w, c, s, ho, wo;
  int band, strips;           // a CTA's output rows and strips of SW columns
  int bands, tiles, slices;   // CTAs along H', W' and C
  int rows, pitch;            // its staged input rows; columns (odd)
  int gpitch;                 // K8dw: columns of the staged g band (odd)
  unsigned xbox, gbox;        // bytes of a staged x and g box
  int xslot, slot;            // bytes of a ring slot's x part and of a slot
};

__host__ __device__ constexpr int round128(long long n) {
  return (int)((n + 127) / 128 * 128);
}

// A CTA's tile and a thread's place in it.
struct Place {
  int b, ho0, wo0, c0, part;  // part: the K8dw partial of (b, band, tile)
  int p, st, rr;              // lane in the slice, strip, row in the band
  int ho, w0, c;              // the thread's output row, first column, channel
  bool active;                // the thread owns at least one output
};

// lanes: threads across a slice (FWD_LANES for K8f, CS for K8dw)
__device__ __forceinline__ Place place(const Geo& g, int lanes) {
  Place P;
  int cta = blockIdx.x;
  const int tile = cta % g.tiles;
  cta /= g.tiles;
  const int bnd = cta % g.bands;
  cta /= g.bands;
  const int slice = cta % g.slices;
  P.b = cta / g.slices;
  P.ho0 = bnd * g.band;
  P.wo0 = tile * g.strips * SW;
  P.c0 = slice * CS;
  P.part = (P.b * g.bands + bnd) * g.tiles + tile;
  P.p = threadIdx.x % lanes;
  const int q = threadIdx.x / lanes;
  P.st = q % g.strips;
  P.rr = q / g.strips;
  P.ho = P.ho0 + P.rr;
  P.w0 = P.wo0 + P.st * SW;
  P.c = P.c0 + P.p * (CS / lanes);
  P.active = P.rr < g.band && P.ho < g.ho && P.w0 < g.wo && P.c < g.c;
  return P;
}

// the ring's mbarriers (one per slot, count 1: the thread that stages),
// ready for every thread after the CTA barrier that follows
__device__ __forceinline__ uint64_t* ring_bars(unsigned char* smem,
                                               int slots) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  if (threadIdx.x == 0) {
    for (int i = 0; i < slots; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
  }
  return bars;
}

// two consecutive channels as floats
template <typename T>
__device__ __forceinline__ void load_pair(const T* p, float (&v)[2]) {
  const float2 f = load2(p);
  v[0] = f.x;
  v[1] = f.y;
}

template <typename T, int S>
__global__ void __launch_bounds__(MAX_THREADS, 1)
dwpool_fwd_win(const __grid_constant__ CUtensorMap xmap,
               const T* __restrict__ w27, T* __restrict__ out, Geo g,
               int flip) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = ring_bars(smem, FWD_SLOTS);
  float* w_s = reinterpret_cast<float*>(smem + BAR_BYTES);  // [27][CS]
  unsigned char* ring = smem + BAR_BYTES + W_BYTES;
  const Place P = place(g, FWD_LANES);
  // plane t of the window into a slot: rows from ho0*S - 1, columns from
  // wo0*S - 1, the outside zero-filled by the TMA unit (the padding)
  auto stage = [&](int t, int slot) {
    mbar_expect_tx(bars + slot, g.xbox);
    tma_load_5d(ring + slot * g.slot, &xmap, bars + slot, P.c0,
                P.wo0 * S - 1, P.ho0 * S - 1, t, P.b);
  };
  if (threadIdx.x == 0)
    for (int t = 0; t < FWD_SLOTS - 1 && t < g.t; ++t) stage(t, t);
  for (int i = threadIdx.x; i < KTAPS * CS; i += blockDim.x) {
    const int r = i / CS, cc = P.c0 + i % CS;
    const int src = flip ? KTAPS - 1 - r : r;  // dx: the taps reversed
    w_s[i] = cc < g.c ? load1(w27 + (size_t)src * g.c + cc) : 0.f;
  }
  __syncthreads();  // the mbarriers are initialised, the weights stored
  T* ob = out + (((size_t)P.b * g.t * g.ho + P.ho) * g.wo + P.w0) * g.c + P.c;
  const size_t oplane = (size_t)g.ho * g.wo * g.c;
  using Acc = float[SW][2];
  auto store = [&](int t, const Acc& a) {
#pragma unroll
    for (int k = 0; k < SW; ++k)
      if (P.w0 + k < g.wo)
        store2(ob + t * oplane + (size_t)k * g.c, a[k][0], a[k][1]);
  };
  // Step ti: plane ti adds its dt = 2, 1, 0 taps to the sums of output
  // planes ti - 1 (pv), ti (cu) and ti + 1 (nx); pv is then complete,
  // stored, and zeroed to serve as the next step's nx (the loop below
  // hands the three sums round, so no sum is moved).
  auto step = [&](int ti, Acc& pv, Acc& cu, Acc& nx) {
    const int slot = ti % FWD_SLOTS;
    mbar_wait(bars + slot, (ti / FWD_SLOTS) & 1);  // plane ti has landed
    __syncthreads();  // and every thread is done with plane ti - 1's slot
    const int nxt = ti + FWD_SLOTS - 1;
    if (threadIdx.x == 0 && nxt < g.t) stage(nxt, nxt % FWD_SLOTS);
    if (P.active) {
      const T* pl = reinterpret_cast<const T*>(ring + slot * g.slot) +
                    (P.rr * S * g.pitch + P.st * SW * S) * CS + 2 * P.p;
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        float wt[3][3][2];  // [dt][dw] of this dh
#pragma unroll
        for (int dt = 0; dt < 3; ++dt)
#pragma unroll
          for (int dw = 0; dw < 3; ++dw)
            load_pair(w_s + (dt * 9 + dh * 3 + dw) * CS + 2 * P.p, wt[dt][dw]);
#pragma unroll
        for (int j = 0; j < (SW - 1) * S + 3; ++j) {
          // a column no output of the strip reads is never loaded
          float v[2];
          load_pair(pl + (dh * g.pitch + j) * CS, v);
#pragma unroll
          for (int k = 0; k < SW; ++k) {
            const int dw = j - k * S;
            if (dw < 0 || dw > 2) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              pv[k][e] = fmaf(v[e], wt[2][dw][e], pv[k][e]);
              cu[k][e] = fmaf(v[e], wt[1][dw][e], cu[k][e]);
              nx[k][e] = fmaf(v[e], wt[0][dw][e], nx[k][e]);
            }
          }
        }
      }
      if (ti > 0) store(ti - 1, pv);
      if (ti == g.t - 1) store(ti, cu);  // its plane t + 1 is the padding
    }
#pragma unroll
    for (int k = 0; k < SW; ++k)
#pragma unroll
      for (int e = 0; e < 2; ++e) pv[k][e] = 0.f;
  };
  Acc a0, a1, a2;
#pragma unroll
  for (int k = 0; k < SW; ++k)
#pragma unroll
    for (int e = 0; e < 2; ++e) a0[k][e] = a1[k][e] = a2[k][e] = 0.f;
  for (int ti = 0; ti < g.t; ti += 3) {
    step(ti, a0, a1, a2);
    if (ti + 1 < g.t) step(ti + 1, a1, a2, a0);
    if (ti + 2 < g.t) step(ti + 2, a2, a0, a1);
  }
}

// K8dw, pass 1: the CTA's fp32 partial [27, its 32 channels] of (b, band,
// tile), into partial[part].  A thread owns one channel of a strip.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 1)
dwpool_dw_win(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap gmap,
              float* __restrict__ partial, Geo g) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = ring_bars(smem, DW_SLOTS);
  unsigned char* ring = smem + BAR_BYTES;
  const Place P = place(g, CS);
  // x plane t of the window (rows from ho0 - 1, columns from wo0 - 1) and
  // g plane t of the band into a slot
  auto stage = [&](int t, int slot) {
    unsigned char* dst = ring + slot * g.slot;
    mbar_expect_tx(bars + slot, g.xbox + g.gbox);
    tma_load_5d(dst, &xmap, bars + slot, P.c0, P.wo0 - 1, P.ho0 - 1, t, P.b);
    tma_load_5d(dst + g.xslot, &gmap, bars + slot, P.c0, P.wo0, P.ho0, t,
                P.b);
  };
  __syncthreads();  // the mbarriers are initialised
  if (threadIdx.x == 0)
    for (int t = 0; t < DW_AHEAD && t < g.t; ++t) stage(t, t);
  float acc[KTAPS];
#pragma unroll
  for (int r = 0; r < KTAPS; ++r) acc[r] = 0.f;
  // g planes t-2, t-1 (gp, gc) and t (gn) of the strip
  float gp[SW], gc[SW], gn[SW];
#pragma unroll
  for (int k = 0; k < SW; ++k) gp[k] = gc[k] = 0.f;
  // step it reads g plane it and x plane it - 1 (a slot read a step
  // earlier too), while planes it + 1 .. it + DW_AHEAD land
  for (int it = 0; it <= g.t; ++it) {
    if (it < g.t) mbar_wait(bars + it % DW_SLOTS, (it / DW_SLOTS) & 1);
    __syncthreads();  // and every thread is done with plane it - 2's slot
    const int nxt = it + DW_AHEAD;
    if (threadIdx.x == 0 && nxt < g.t) stage(nxt, nxt % DW_SLOTS);
    if (!P.active) continue;
    if (it < g.t) {
      const T* gs =
          reinterpret_cast<const T*>(ring + (it % DW_SLOTS) * g.slot +
                                     g.xslot) +
          (P.rr * g.gpitch + P.st * SW) * CS + P.p;
#pragma unroll
      for (int k = 0; k < SW; ++k) gn[k] = load1(gs + k * CS);
    } else {
#pragma unroll
      for (int k = 0; k < SW; ++k) gn[k] = 0.f;
    }
    if (it > 0) {
      const T* xs =
          reinterpret_cast<const T*>(ring + ((it - 1) % DW_SLOTS) * g.slot) +
          (P.rr * g.pitch + P.st * SW) * CS + P.p;
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
        for (int j = 0; j < SW + 2; ++j) {
          const float v = load1(xs + (dh * g.pitch + j) * CS);
#pragma unroll
          for (int k = 0; k < SW; ++k) {
            const int dw = j - k;
            if (dw < 0 || dw > 2) continue;
            const int r = dh * 3 + dw;
            acc[r] = fmaf(v, gn[k], acc[r]);
            acc[9 + r] = fmaf(v, gc[k], acc[9 + r]);
            acc[18 + r] = fmaf(v, gp[k], acc[18 + r]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < SW; ++k) {
      gp[k] = gc[k];
      gc[k] = gn[k];
    }
  }
  // the CTA's lanes, once: the warps (one strip each) in order through
  // shared memory (the ring is free: every box has landed and been read)
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // [warps][27][CS]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < KTAPS; ++r) red[(warp * KTAPS + r) * CS + lane] = acc[r];
  __syncthreads();
  const int warps = blockDim.x / 32;
  float* pb = partial + (size_t)P.part * KTAPS * g.c;
  for (int i = threadIdx.x; i < KTAPS * CS; i += blockDim.x) {
    const int r = i / CS, cc = i % CS;
    if (P.c0 + cc >= g.c) continue;
    float s = 0.f;
    for (int wi = 0; wi < warps; ++wi) s += red[(wi * KTAPS + r) * CS + cc];
    pb[(size_t)r * g.c + P.c0 + cc] = s;
  }
}

// K8dw, pass 2: dw[o] = the sum of the partials, lane l of RED_LANES adding
// partials l, l + RED_LANES, ... in order, then the lanes in order.
__global__ void __launch_bounds__(32 * RED_LANES)
dwpool_dw_reduce(const float* __restrict__ partial, float* __restrict__ dw,
                 int nparts, int n) {
  __shared__ float lanes[RED_LANES][32];
  const int o = blockIdx.x * 32 + threadIdx.x % 32, l = threadIdx.x / 32;
  float s = 0.f;
  if (o < n)
    for (int k = l; k < nparts; k += RED_LANES) s += partial[(size_t)k * n + o];
  lanes[l][threadIdx.x % 32] = s;
  __syncthreads();
  if (threadIdx.x >= 32 || o >= n) return;
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < RED_LANES; ++i) t += lanes[i][threadIdx.x];
  dw[o] = t;
}

// threads of a K8f (dw false: 2 channels a thread) or K8dw CTA (1 channel)
int threads_of(const Geo& g, bool dw) {
  return (g.band * g.strips * (dw ? CS : FWD_LANES) + 31) / 32 * 32;
}

// shared memory of a K8f or K8dw CTA, in bytes
long long smem_of(const Geo& g, bool dw) {
  if (!dw) return BAR_BYTES + W_BYTES + (long long)FWD_SLOTS * g.slot;
  const long long ring = (long long)DW_SLOTS * g.slot;
  const long long red = (long long)(threads_of(g, true) / 32) * KTAPS * CS * 4;
  return BAR_BYTES + (ring > red ? ring : red);
}

// The geometry of a launch, or false where the kernels do not take it.
bool make_geo(int b, int t, int h, int w, int c, int s, int band, int strips,
              long long row, long long sb, bool dw, int esize, Geo& g) {
  if (!(b > 0 && t > 0 && h > 0 && w > 0 && c > 0 && c % VEC == 0 &&
        (s == 1 || s == 2 || s == 4 || s == 8) && row >= c && row % VEC == 0 &&
        sb % VEC == 0 && band > 0 && strips > 0))
    return false;
  g.b = b;
  g.t = t;
  g.h = h;
  g.w = w;
  g.c = c;
  g.s = s;
  g.ho = (h - 1) / s + 1;
  g.wo = (w - 1) / s + 1;
  g.band = band;
  g.strips = strips;
  g.bands = (g.ho + band - 1) / band;
  g.tiles = ((g.wo + SW - 1) / SW + strips - 1) / strips;
  g.slices = (c + CS - 1) / CS;
  const long long rows = (long long)(band - 1) * s + 3;
  const long long pitch = ((long long)(strips * SW - 1) * s + 3) | 1;
  const long long gpitch = (strips * SW) | 1;
  if (rows > MAX_BOX || pitch > MAX_BOX || (dw && gpitch > MAX_BOX))
    return false;
  g.rows = (int)rows;
  g.pitch = (int)pitch;
  g.gpitch = (int)gpitch;
  g.xbox = (unsigned)(rows * pitch * CS * esize);
  g.gbox = dw ? (unsigned)(band * gpitch * CS * esize) : 0u;
  g.xslot = round128(g.xbox);
  g.slot = g.xslot + round128(g.gbox);
  const long long ctas = (long long)b * g.slices * g.bands * g.tiles;
  return threads_of(g, dw) <= MAX_THREADS && smem_of(g, dw) <= SMEM_MAX &&
         ctas < (1LL << 31);
}

// The tensor map of [b, t, h, w, c] at `base` (token-row stride `row`, batch
// stride `sb`, in elements) read in boxes of [1, 1, rows, cols, CS].
bool tensor_map(CUtensorMap* map, const void* base, int esize, const Geo& g,
                long long row, long long sb, int rows, int cols) {
  const cuuint64_t dims[5] = {(cuuint64_t)g.c, (cuuint64_t)g.w,
                              (cuuint64_t)g.h, (cuuint64_t)g.t,
                              (cuuint64_t)g.b};
  const cuuint64_t strides[4] = {
      (cuuint64_t)(row * esize), (cuuint64_t)(row * esize * g.w),
      (cuuint64_t)(row * esize * g.w * g.h), (cuuint64_t)(sb * esize)};
  const cuuint32_t box[5] = {CS, (cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  return tensor_map_5d(map, base, esize, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <typename K, typename... Args>
int launch(K kernel, unsigned ctas, int threads, long long smem,
           cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<ctas, threads, (size_t)smem, st>>>(args...);
  return (int)cudaGetLastError();
}

unsigned ctas_of(const Geo& g) {
  return (unsigned)((long long)g.b * g.slices * g.bands * g.tiles);
}

template <typename T>
int launch_fwd(const Geo& g, const CUtensorMap& xmap, const void* w27,
               void* out, int flip, cudaStream_t st) {
  const unsigned ctas = ctas_of(g);
  const int threads = threads_of(g, false);
  const long long smem = smem_of(g, false);
  const T* wp = static_cast<const T*>(w27);
  T* op = static_cast<T*>(out);
  switch (g.s) {
    case 1: return launch(dwpool_fwd_win<T, 1>, ctas, threads, smem, st, xmap, wp, op, g, flip);
    case 2: return launch(dwpool_fwd_win<T, 2>, ctas, threads, smem, st, xmap, wp, op, g, flip);
    case 4: return launch(dwpool_fwd_win<T, 4>, ctas, threads, smem, st, xmap, wp, op, g, flip);
    default: return launch(dwpool_fwd_win<T, 8>, ctas, threads, smem, st, xmap, wp, op, g, flip);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  band and strips: a CTA's output rows
// and strips of 7 output columns (ops/depthwise_pool.py:pool_plan).  x (and
// g) 16-byte aligned.  Each entry point returns the CUDA error code of its
// launches (0 on success; cudaErrorInvalidValue for a geometry the kernels
// do not take or a tensor map the driver refuses).

// K8f: out [b, t, h', w', c] (contiguous, the dtype of x); flip 1 reads
// tap r of w27 at row 26 - r (dx: K8f on g with the taps reversed).
extern "C" int depthwise_pool3d_fwd(const void* x, const void* w27, void* out,
                                    int b, int t, int h, int w, int c, int s,
                                    int band, int strips, long long row,
                                    long long sb, int flip, int dtype,
                                    void* stream) {
  const int esize = dtype == 1 ? 2 : 4;
  Geo g;
  CUtensorMap xmap;
  if ((dtype != 0 && dtype != 1) || !bind_context() ||
      !make_geo(b, t, h, w, c, s, band, strips, row, sb, false, esize, g) ||
      !tensor_map(&xmap, x, esize, g, row, sb, g.rows, g.pitch))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_fwd<__nv_bfloat16>(g, xmap, w27, out, flip, st)
                    : launch_fwd<float>(g, xmap, w27, out, flip, st);
}

// K8dw (stride 1): dw [27, c] fp32 from x and the output gradient g [b, t,
// h, w, c] (contiguous, the dtype of x); partial [b * bands * tiles, 27, c]
// fp32 is scratch.
extern "C" int depthwise_pool3d_dw(const void* x, const void* g, void* partial,
                                   void* dw, int b, int t, int h, int w, int c,
                                   int band, int strips, long long row,
                                   long long sb, int dtype, void* stream) {
  const int esize = dtype == 1 ? 2 : 4;
  Geo geo;
  CUtensorMap xmap, gmap;
  if ((dtype != 0 && dtype != 1) || !bind_context() ||
      !make_geo(b, t, h, w, c, 1, band, strips, row, sb, true, esize, geo) ||
      !tensor_map(&xmap, x, esize, geo, row, sb, geo.rows, geo.pitch) ||
      !tensor_map(&gmap, g, esize, geo, c, (long long)t * h * w * c,
                  geo.band, geo.gpitch))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = threads_of(geo, true);
  const long long smem = smem_of(geo, true);
  const int rc =
      dtype == 1
          ? launch(dwpool_dw_win<__nv_bfloat16>, ctas_of(geo), threads, smem,
                   st, xmap, gmap, static_cast<float*>(partial), geo)
          : launch(dwpool_dw_win<float>, ctas_of(geo), threads, smem, st, xmap,
                   gmap, static_cast<float*>(partial), geo);
  if (rc != 0) return rc;
  const int n = KTAPS * c;
  const int nparts = b * geo.bands * geo.tiles;
  dwpool_dw_reduce<<<(n + 31) / 32, 32 * RED_LANES, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), nparts, n);
  return (int)cudaGetLastError();
}
