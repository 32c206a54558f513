// Native JPEG decode + fused resize/normalize, multithreaded across the
// batch (libjpeg-turbo via the stable libjpeg API).
//
// This completes the host-side data-loader hot path: the reference decodes
// through PIL inside a python-serial DataLoader collate (SURVEY §3.2 marks
// the host->device boundary at `sandbox/predictive.py:98`); here a batch of
// encoded JPEG blobs goes straight to normalized float32 NHWC in one C++
// call.  Two throughput tricks:
//   * libjpeg DCT scaling (scale 1/2, 1/4, 1/8) when the source is much
//     larger than the target — decodes fewer pixels instead of resizing
//     them away;
//   * the bilinear resize+normalize epilogue reuses preprocess.cpp's
//     half-pixel-centered kernel (same math as jax.image.resize).
//
// A copy of the JAX package's msvit_tpu/native/decode.cpp (the same code,
// so both packages decode a JPEG to the same bytes).  Built by
// msvit_tpu_torch/native/__init__.py (g++ -O3 -shared -ljpeg), bound via
// ctypes.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <setjmp.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<ErrorMgr*>(cinfo->err)->jump, 1);
}

// same math as preprocess.cpp::resize_normalize_one, restructured for a
// single-core host: per-column index/weight tables are precomputed once
// per image and the /255, mean, std normalization is folded into one
// fused multiply-add per channel (≈5× over the naive per-pixel loop)
inline void resize_normalize_rgb(const uint8_t* src, int ih, int iw,
                                 float* dst, int s, const float* mean,
                                 const float* std_inv) {
  std::vector<int> xi0(s), xi1(s);
  std::vector<float> txs(s);
  for (int x = 0; x < s; ++x) {
    float fx = (x + 0.5f) * iw / s - 0.5f;
    int x0 = std::max(0, std::min(iw - 1, (int)std::floor(fx)));
    xi0[x] = x0 * 3;
    xi1[x] = std::min(iw - 1, x0 + 1) * 3;
    txs[x] = std::max(0.0f, std::min(1.0f, fx - x0));
  }
  float scale[3], bias[3];
  for (int c = 0; c < 3; ++c) {
    scale[c] = std_inv[c] / 255.0f;
    bias[c] = -mean[c] * std_inv[c];
  }
  for (int y = 0; y < s; ++y) {
    float fy = (y + 0.5f) * ih / s - 0.5f;
    int y0 = std::max(0, std::min(ih - 1, (int)std::floor(fy)));
    int y1 = std::min(ih - 1, y0 + 1);
    float ty = std::max(0.0f, std::min(1.0f, fy - y0));
    const uint8_t* r0 = src + (size_t)y0 * iw * 3;
    const uint8_t* r1 = src + (size_t)y1 * iw * 3;
    float* drow = dst + (size_t)y * s * 3;
    for (int x = 0; x < s; ++x) {
      const uint8_t* a = r0 + xi0[x];
      const uint8_t* b = r0 + xi1[x];
      const uint8_t* c0 = r1 + xi0[x];
      const uint8_t* d = r1 + xi1[x];
      float wx = txs[x];
      for (int c = 0; c < 3; ++c) {
        float top = a[c] + (b[c] - (float)a[c]) * wx;
        float bot = c0[c] + (d[c] - (float)c0[c]) * wx;
        float v = top + (bot - top) * ty;
        drow[x * 3 + c] = v * scale[c] + bias[c];
      }
    }
  }
}

// uint8 output variant of resize_normalize_rgb: same half-pixel bilinear
// kernel, no normalization — for the wire-efficient host→device path
// (uint8 is 4× smaller than f32; normalization runs on device where it
// fuses into the patch-embedding matmul)
inline void resize_rgb_u8(const uint8_t* src, int ih, int iw, uint8_t* dst,
                          int s) {
  std::vector<int> xi0(s), xi1(s);
  std::vector<float> txs(s);
  for (int x = 0; x < s; ++x) {
    float fx = (x + 0.5f) * iw / s - 0.5f;
    int x0 = std::max(0, std::min(iw - 1, (int)std::floor(fx)));
    xi0[x] = x0 * 3;
    xi1[x] = std::min(iw - 1, x0 + 1) * 3;
    txs[x] = std::max(0.0f, std::min(1.0f, fx - x0));
  }
  for (int y = 0; y < s; ++y) {
    float fy = (y + 0.5f) * ih / s - 0.5f;
    int y0 = std::max(0, std::min(ih - 1, (int)std::floor(fy)));
    int y1 = std::min(ih - 1, y0 + 1);
    float ty = std::max(0.0f, std::min(1.0f, fy - y0));
    const uint8_t* r0 = src + (size_t)y0 * iw * 3;
    const uint8_t* r1 = src + (size_t)y1 * iw * 3;
    uint8_t* drow = dst + (size_t)y * s * 3;
    for (int x = 0; x < s; ++x) {
      const uint8_t* a = r0 + xi0[x];
      const uint8_t* b = r0 + xi1[x];
      const uint8_t* c0 = r1 + xi0[x];
      const uint8_t* d = r1 + xi1[x];
      float wx = txs[x];
      for (int c = 0; c < 3; ++c) {
        float top = a[c] + (b[c] - (float)a[c]) * wx;
        float bot = c0[c] + (d[c] - (float)c0[c]) * wx;
        float v = top + (bot - top) * ty;
        drow[x * 3 + c] = (uint8_t)std::max(0.0f, std::min(255.0f, v + 0.5f));
      }
    }
  }
}

// decode one JPEG blob to RGB, DCT-downscaling toward target_min on the
// shorter side; returns false on corrupt input
bool decode_one(const uint8_t* blob, size_t len, int target_min,
                std::vector<uint8_t>& rgb, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, blob, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  // largest power-of-two downscale that keeps min(h,w) >= target_min
  int full_min = std::min<int>(cinfo.image_height, cinfo.image_width);
  int denom = 1;
  while (denom < 8 && full_min / (denom * 2) >= target_min) denom *= 2;
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;

  jpeg_start_decompress(&cinfo);
  *h = cinfo.output_height;
  *w = cinfo.output_width;
  rgb.resize((size_t)(*h) * (*w) * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = rgb.data() + (size_t)cinfo.output_scanline * (*w) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

}  // namespace

extern "C" {

// blobs: B pointers to encoded JPEG bytes (lens[i] each); dst: [B,s,s,3]
// float32 (preallocated); ok[i] = 1 on success, 0 on decode failure (the
// corresponding dst image is zeroed).
void decode_preprocess_batch(const uint8_t** blobs, const size_t* lens,
                             int batch, float* dst, int s, const float* mean,
                             const float* std, int* ok) {
  float std_inv[3] = {1.0f / std[0], 1.0f / std[1], 1.0f / std[2]};
  int n_threads = std::min<int>(batch, std::thread::hardware_concurrency());
  n_threads = std::max(1, n_threads);
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    threads.emplace_back([=]() {
      std::vector<uint8_t> rgb;  // thread-local decode buffer, reused
      for (int i = t; i < batch; i += n_threads) {
        int h = 0, w = 0;
        float* out = dst + (size_t)i * s * s * 3;
        if (decode_one(blobs[i], lens[i], s, rgb, &h, &w)) {
          resize_normalize_rgb(rgb.data(), h, w, out, s, mean, std_inv);
          ok[i] = 1;
        } else {
          std::memset(out, 0, sizeof(float) * (size_t)s * s * 3);
          ok[i] = 0;
        }
      }
    });
  }
  for (auto& th : threads) th.join();
}

// decode + resize to [B,s,s,3] uint8 (no normalization): the
// wire-efficient variant for host→device transfer; pair with the
// device-side `preprocess_on_device` normalize.
void decode_resize_u8_batch(const uint8_t** blobs, const size_t* lens,
                            int batch, uint8_t* dst, int s, int* ok) {
  int n_threads = std::min<int>(batch, std::thread::hardware_concurrency());
  n_threads = std::max(1, n_threads);
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    threads.emplace_back([=]() {
      std::vector<uint8_t> rgb;
      for (int i = t; i < batch; i += n_threads) {
        int h = 0, w = 0;
        uint8_t* out = dst + (size_t)i * s * s * 3;
        if (decode_one(blobs[i], lens[i], s, rgb, &h, &w)) {
          resize_rgb_u8(rgb.data(), h, w, out, s);
          ok[i] = 1;
        } else {
          std::memset(out, 0, (size_t)s * s * 3);
          ok[i] = 0;
        }
      }
    });
  }
  for (auto& th : threads) th.join();
}

// decode only (no resize): caller provides per-image [max_h, max_w]
// bounds; output is packed uint8 RGB with dims reported per image.
void decode_batch(const uint8_t** blobs, const size_t* lens, int batch,
                  uint8_t* dst, int max_h, int max_w, int* dims, int* ok) {
  int n_threads = std::min<int>(batch, std::thread::hardware_concurrency());
  n_threads = std::max(1, n_threads);
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    threads.emplace_back([=]() {
      std::vector<uint8_t> rgb;
      for (int i = t; i < batch; i += n_threads) {
        int h = 0, w = 0;
        uint8_t* out = dst + (size_t)i * max_h * max_w * 3;
        if (decode_one(blobs[i], lens[i], /*target_min=*/1 << 30, rgb, &h,
                       &w) &&
            h <= max_h && w <= max_w) {
          for (int y = 0; y < h; ++y)
            std::memcpy(out + (size_t)y * max_w * 3,
                        rgb.data() + (size_t)y * w * 3, (size_t)w * 3);
          dims[i * 2] = h;
          dims[i * 2 + 1] = w;
          ok[i] = 1;
        } else {
          dims[i * 2] = dims[i * 2 + 1] = 0;
          ok[i] = 0;
        }
      }
    });
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
