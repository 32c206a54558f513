// Native image preprocessing kernel: batched bilinear resize + rescale +
// normalize (HWC uint8 -> HWC float32), multithreaded across images.
//
// This is the host-side data-loader hot path of the framework (the
// reference delegates it to HF ViTImageProcessor / PIL, which is
// python-serial; SURVEY §3.2 marks the host->device image collate as a
// boundary).  Coordinates use half-pixel centers, matching
// msvit_tpu.data.pipeline._resize_bilinear_np and jax.image.resize.
//
// A copy of the JAX package's msvit_tpu/native/preprocess.cpp.  Built on
// demand by msvit_tpu_torch/native/__init__.py (g++ -O3 -shared) and
// called through ctypes — no pybind11 dependency.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

inline void resize_normalize_one(const uint8_t* src, int ih, int iw, int ic,
                                 float* dst, int s, const float* mean,
                                 const float* std_inv) {
  for (int y = 0; y < s; ++y) {
    float fy = (y + 0.5f) * ih / s - 0.5f;
    int y0 = std::max(0, std::min(ih - 1, (int)std::floor(fy)));
    int y1 = std::min(ih - 1, y0 + 1);
    float ty = std::max(0.0f, std::min(1.0f, fy - y0));
    for (int x = 0; x < s; ++x) {
      float fx = (x + 0.5f) * iw / s - 0.5f;
      int x0 = std::max(0, std::min(iw - 1, (int)std::floor(fx)));
      int x1 = std::min(iw - 1, x0 + 1);
      float tx = std::max(0.0f, std::min(1.0f, fx - x0));
      for (int c = 0; c < 3; ++c) {
        int cs = c < ic ? c : ic - 1;  // tolerate grayscale
        float a = src[(y0 * iw + x0) * ic + cs];
        float b = src[(y0 * iw + x1) * ic + cs];
        float d = src[(y1 * iw + x0) * ic + cs];
        float e = src[(y1 * iw + x1) * ic + cs];
        float top = a * (1 - tx) + b * tx;
        float bot = d * (1 - tx) + e * tx;
        float v = top * (1 - ty) + bot * ty;
        dst[(y * s + x) * 3 + c] = (v / 255.0f - mean[c]) * std_inv[c];
      }
    }
  }
}

}  // namespace

extern "C" {

// srcs: array of B pointers to HWC uint8 images; dims: [B][3] = (h, w, c);
// dst: [B, s, s, 3] float32 (preallocated); mean/std: [3].
void preprocess_batch(const uint8_t** srcs, const int* dims, int batch,
                      float* dst, int s, const float* mean,
                      const float* std) {
  float std_inv[3] = {1.0f / std[0], 1.0f / std[1], 1.0f / std[2]};
  int n_threads = std::min<int>(batch, std::thread::hardware_concurrency());
  n_threads = std::max(1, n_threads);
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    threads.emplace_back([=]() {
      for (int i = t; i < batch; i += n_threads) {
        resize_normalize_one(srcs[i], dims[i * 3], dims[i * 3 + 1],
                             dims[i * 3 + 2], dst + (size_t)i * s * s * 3, s,
                             mean, std_inv);
      }
    });
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
