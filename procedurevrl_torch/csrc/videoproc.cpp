// Native host-side video preprocessing for the data pipeline: the PyTorch
// port's copy of native/videoproc.cpp, built by g++ with the same flags
// (procedurevrl_torch/ops/_build.py:build_host), so both libraries round
// alike.
//
// The reference's per-sample post-decode chain (normalize -> resize ->
// crop -> flip; reference lib/datasets/utils.py:110-161,309-326 and
// lib/datasets/transform.py) makes three float passes over every frame on
// the data workers. This library fuses the whole chain into ONE pass per
// output pixel, reading the decoded uint8 frame directly and writing the
// final normalized float32 crop: bilinear-sample u8 -> (x/255 - mean)/std,
// with optional horizontal flip folded into the sample coordinates.
// Frames are processed in parallel with std::thread.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Bilinear sample (align_corners=false convention, matching
// torch F.interpolate and cv2.INTER_LINEAR) of channel c at output pixel
// (oy, ox) for an HxW source scaled to new_h x new_w.
struct SampleCtx {
  const uint8_t* src;
  int H, W;
  float scale_y, scale_x;
};

inline void sample_row_setup(float oy, const SampleCtx& ctx, int* y0, int* y1,
                             float* wy) {
  float sy = (oy + 0.5f) * ctx.scale_y - 0.5f;
  sy = clampf(sy, 0.0f, (float)(ctx.H - 1));
  *y0 = (int)sy;
  *y1 = std::min(*y0 + 1, ctx.H - 1);
  *wy = sy - (float)(*y0);
}

}  // namespace

extern "C" {

// Fused resize(new_h,new_w) -> crop(crop_h,crop_w at y0,x0) -> flip ->
// normalize for one clip.
//   frames: uint8 [T, H, W, 3]
//   out:    float32 [T, crop_h, crop_w, 3]
// Returns 0 on success.
int vp_fused_preprocess(const uint8_t* frames, int T, int H, int W,
                        int new_h, int new_w, int crop_y, int crop_x,
                        int crop_h, int crop_w, int flip,
                        const float* mean, const float* stdv, float* out,
                        int n_threads) {
  if (!frames || !out || T <= 0 || H <= 0 || W <= 0) return 1;
  if (crop_y < 0 || crop_x < 0 || crop_y + crop_h > new_h ||
      crop_x + crop_w > new_w)
    return 2;

  const float scale_y = (float)H / (float)new_h;
  const float scale_x = (float)W / (float)new_w;
  const float inv255 = 1.0f / 255.0f;
  float scale_c[3], bias_c[3];
  for (int c = 0; c < 3; ++c) {
    // (x/255 - mean) / std  ==  x * (1/(255*std)) - mean/std
    scale_c[c] = inv255 / stdv[c];
    bias_c[c] = -mean[c] / stdv[c];
  }

  auto work = [&](int t_begin, int t_end) {
    // Precompute x sampling coordinates once per thread (same for every
    // frame/row): output col -> (x0, x1, wx) in source space.
    std::vector<int> xs0(crop_w), xs1(crop_w);
    std::vector<float> wxs(crop_w);
    for (int ox = 0; ox < crop_w; ++ox) {
      int gx = flip ? (crop_x + crop_w - 1 - ox) : (crop_x + ox);
      float sx = ((float)gx + 0.5f) * scale_x - 0.5f;
      sx = clampf(sx, 0.0f, (float)(W - 1));
      xs0[ox] = (int)sx;
      xs1[ox] = std::min(xs0[ox] + 1, W - 1);
      wxs[ox] = sx - (float)xs0[ox];
    }
    SampleCtx ctx{nullptr, H, W, scale_y, scale_x};
    for (int t = t_begin; t < t_end; ++t) {
      const uint8_t* src = frames + (size_t)t * H * W * 3;
      float* dst = out + (size_t)t * crop_h * crop_w * 3;
      ctx.src = src;
      for (int oy = 0; oy < crop_h; ++oy) {
        int y0, y1;
        float wy;
        sample_row_setup((float)(crop_y + oy), ctx, &y0, &y1, &wy);
        const uint8_t* row0 = src + (size_t)y0 * W * 3;
        const uint8_t* row1 = src + (size_t)y1 * W * 3;
        float* orow = dst + (size_t)oy * crop_w * 3;
        for (int ox = 0; ox < crop_w; ++ox) {
          const int x0 = xs0[ox] * 3, x1 = xs1[ox] * 3;
          const float wx = wxs[ox];
          const float w00 = (1 - wy) * (1 - wx), w01 = (1 - wy) * wx;
          const float w10 = wy * (1 - wx), w11 = wy * wx;
          for (int c = 0; c < 3; ++c) {
            float v = w00 * row0[x0 + c] + w01 * row0[x1 + c] +
                      w10 * row1[x0 + c] + w11 * row1[x1 + c];
            orow[ox * 3 + c] = v * scale_c[c] + bias_c[c];
          }
        }
      }
    }
  };

  int threads = std::max(1, std::min(n_threads, T));
  if (threads == 1) {
    work(0, T);
  } else {
    std::vector<std::thread> pool;
    int per = (T + threads - 1) / threads;
    for (int i = 0; i < threads; ++i) {
      int b = i * per, e = std::min(T, b + per);
      if (b >= e) break;
      pool.emplace_back(work, b, e);
    }
    for (auto& th : pool) th.join();
  }
  return 0;
}

// Plain bilinear resize u8 -> f32 [0,255] (parity/testing entry).
int vp_resize_bilinear(const uint8_t* frames, int T, int H, int W, int new_h,
                       int new_w, float* out, int n_threads) {
  const float mean[3] = {0.f, 0.f, 0.f};
  // std = 1/255 makes the normalize a no-op back to [0,255]
  const float stdv[3] = {1.0f / 255.0f, 1.0f / 255.0f, 1.0f / 255.0f};
  return vp_fused_preprocess(frames, T, H, W, new_h, new_w, 0, 0, new_h,
                             new_w, 0, mean, stdv, out, n_threads);
}

}  // extern "C"
