// Native image preprocessing for the data loader's workers (the port's own
// copy of paddlemix_tpu/native/preprocess.cpp, built by
// paddlemix_tpu_torch/native/__init__.py with g++ into build/native/).
//
// Three functions with a plain C interface, bound with ctypes: a bilinear
// resize of uint8 HWC to float32 HWC fused with the rescale and the
// per-channel normalisation; a centre crop of float32 HWC; and the Qwen2-VL
// patch layout. They run on the host, beside PIL's decode.
//
// Build: g++ -O3 -shared -fPIC preprocess.cpp -o libpmixpre.so

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>

extern "C" {

// Bilinear resize uint8 HWC -> float32 HWC in one pass, optional
// rescale (1/255) + per-channel normalize: out = (x*scale - mean) / std.
void resize_bilinear_normalize_u8(
    const uint8_t* src, int64_t sh, int64_t sw, int64_t c,
    float* dst, int64_t dh, int64_t dw,
    const float* mean, const float* std_, float scale) {
  const float ry = dh > 1 ? (float)(sh) / (float)(dh) : 0.f;
  const float rx = dw > 1 ? (float)(sw) / (float)(dw) : 0.f;
  for (int64_t y = 0; y < dh; ++y) {
    float fy = ((float)y + 0.5f) * ry - 0.5f;
    if (fy < 0) fy = 0;
    int64_t y0 = (int64_t)fy;
    int64_t y1 = std::min(y0 + 1, sh - 1);
    float wy = fy - (float)y0;
    for (int64_t x = 0; x < dw; ++x) {
      float fx = ((float)x + 0.5f) * rx - 0.5f;
      if (fx < 0) fx = 0;
      int64_t x0 = (int64_t)fx;
      int64_t x1 = std::min(x0 + 1, sw - 1);
      float wx = fx - (float)x0;
      const uint8_t* p00 = src + (y0 * sw + x0) * c;
      const uint8_t* p01 = src + (y0 * sw + x1) * c;
      const uint8_t* p10 = src + (y1 * sw + x0) * c;
      const uint8_t* p11 = src + (y1 * sw + x1) * c;
      float* out = dst + (y * dw + x) * c;
      for (int64_t ch = 0; ch < c; ++ch) {
        float v0 = (float)p00[ch] * (1.f - wx) + (float)p01[ch] * wx;
        float v1 = (float)p10[ch] * (1.f - wx) + (float)p11[ch] * wx;
        float v = v0 * (1.f - wy) + v1 * wy;
        out[ch] = (v * scale - mean[ch]) / std_[ch];
      }
    }
  }
}

// Center crop float32 HWC.
void center_crop_f32(const float* src, int64_t sh, int64_t sw, int64_t c,
                     float* dst, int64_t ch_, int64_t cw) {
  int64_t top = std::max((sh - ch_) / 2, (int64_t)0);
  int64_t left = std::max((sw - cw) / 2, (int64_t)0);
  for (int64_t y = 0; y < ch_; ++y) {
    const float* row = src + ((y + top) * sw + left) * c;
    std::memcpy(dst + y * cw * c, row, sizeof(float) * cw * c);
  }
}

// Extract non-overlapping patches (merge-grouped 2x2 order, temporal dup) from
// a float32 HWC image — the Qwen2-VL patch layout
// (processors/qwen2_vl_processing.extract_patches) in native code.
void extract_patches_f32(const float* src, int64_t h, int64_t w, int64_t c,
                         float* dst, int64_t ps, int64_t merge, int64_t tp) {
  const int64_t gh = h / ps, gw = w / ps;
  const int64_t patch_elems = c * tp * ps * ps;
  int64_t out_idx = 0;
  for (int64_t bh = 0; bh < gh / merge; ++bh)
    for (int64_t bw = 0; bw < gw / merge; ++bw)
      for (int64_t mh = 0; mh < merge; ++mh)
        for (int64_t mw = 0; mw < merge; ++mw) {
          const int64_t py = (bh * merge + mh) * ps;
          const int64_t px = (bw * merge + mw) * ps;
          float* out = dst + out_idx * patch_elems;
          // layout: (tp, C, ps, ps) flattened
          for (int64_t t = 0; t < tp; ++t)
            for (int64_t ch = 0; ch < c; ++ch)
              for (int64_t yy = 0; yy < ps; ++yy)
                for (int64_t xx = 0; xx < ps; ++xx)
                  out[((t * c + ch) * ps + yy) * ps + xx] =
                      src[((py + yy) * w + (px + xx)) * c + ch];
          ++out_idx;
        }
}

}  // extern "C"
