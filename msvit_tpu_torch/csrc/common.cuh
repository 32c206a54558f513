// Helpers shared by the attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace msvit {

// Query rows per block (one thread each) and key/value rows per staged
// tile; the tile halves where two tiles would pass 48 KB of static shared
// memory (f32 at head size 128).
constexpr int kRows = 64;
constexpr int kKv = 64;

// Mask operand: none, bool (one byte per entry, true = attend) or
// additive f32; shaped [B|1, 1|H, N, N], last two dims contiguous.
enum MaskKind { kNoMask = 0, kBoolMask = 1, kAddMask = 2 };

template <typename T, int DHT>
__host__ __device__ constexpr int kv_rows() {
  return 2 * kKv * DHT * static_cast<int>(sizeof(T)) <= 48 * 1024 ? kKv
                                                                  : kKv / 2;
}

// Threads per query (or key) row in the backward kernels: each holds a
// slice of at most 32 head elements in f32 registers, so that a thread of
// the dK/dV kernel keeps k, v, dk and dv (4 x 32 floats) without spilling
// at any head size; dot products are summed across the row's threads with
// shuffles.
template <int DHT>
__host__ __device__ constexpr int row_threads() {
  return DHT > 32 ? DHT / 32 : 1;
}

// Sum over the `TPR` neighbouring lanes of one row (TPR a power of two
// dividing 32; every lane of the warp must take part).
template <int TPR>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Round an f32 value to T and back: the compute-dtype casts of the TPU
// kernels' probability and score-gradient panels.
template <typename T>
__device__ __forceinline__ float round_to(float x);

template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Eight consecutive elements <-> eight floats, as one or two 16-byte moves.
template <typename T>
struct Vec8;

template <>
struct Vec8<float> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

template <>
struct Vec8<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(h[t]);
      o[2 * t] = f.x;
      o[2 * t + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int t = 0; t < 4; ++t) h[t] = __floats2bfloat162_rn(v[2 * t], v[2 * t + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// The backward kernels' view of one row: the row's index, this thread's
// slice and the slice's first head element (row_threads() threads a row).
template <int DHT>
struct RowSlice {
  static constexpr int kTpr = row_threads<DHT>();
  static constexpr int kCh = DHT / kTpr;  // head elements per thread
  int row;
  int e0;
  __device__ RowSlice(int block_row0)
      : row(block_row0 + static_cast<int>(threadIdx.x) / kTpr),
        e0((static_cast<int>(threadIdx.x) % kTpr) * kCh) {}
};

template <typename T, int CH>
__device__ __forceinline__ void load_slice(const T* p, int e0, int dh,
                                           float* out) {
#pragma unroll
  for (int e = 0; e < CH; e += 8)
    if (e0 + e < dh) Vec8<T>::load(p + e0 + e, out + e);
}

template <typename T, int CH>
__device__ __forceinline__ void store_slice(T* p, int e0, int dh,
                                            const float* v, float scale) {
#pragma unroll
  for (int e = 0; e < CH; e += 8) {
    if (e0 + e < dh) {
      float r[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) r[t] = v[e + t] * scale;
      Vec8<T>::store(p + e0 + e, r);
    }
  }
}

// Partial dot products of a register slice with two shared-memory rows:
// a.x and b.y over this thread's slice of the head.
template <typename T, int CH>
__device__ __forceinline__ void dot2(const float* a, const T* x,
                                     const float* b, const T* y, int e0,
                                     int dh, float& ax, float& by) {
  ax = 0.f;
  by = 0.f;
#pragma unroll
  for (int e = 0; e < CH; e += 8) {
    if (e0 + e < dh) {
      float xf[8], yf[8];
      Vec8<T>::load(x + e0 + e, xf);
      Vec8<T>::load(y + e0 + e, yf);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        ax = fmaf(a[e + t], xf[t], ax);
        by = fmaf(b[e + t], yf[t], by);
      }
    }
  }
}

// acc += c * x over this thread's slice (x a shared-memory row).
template <typename T, int CH>
__device__ __forceinline__ void axpy(float* acc, float c, const T* x, int e0,
                                     int dh) {
#pragma unroll
  for (int e = 0; e < CH; e += 8) {
    if (e0 + e < dh) {
      float xf[8];
      Vec8<T>::load(x + e0 + e, xf);
#pragma unroll
      for (int t = 0; t < 8; ++t) acc[e + t] = fmaf(c, xf[t], acc[e + t]);
    }
  }
}

// A scaled score with the mask applied at element `at`: bool (where-valid
// with mask_value) or additive.
__device__ __forceinline__ float apply_mask(float s, int kind,
                                            const uint8_t* mb, const float* mf,
                                            long long at, float mask_value) {
  if (kind == kBoolMask) return mb[at] ? s : mask_value;
  if (kind == kAddMask) return s + mf[at];
  return s;
}

// Copy rows [row0, row0 + rows) of one head's `width`-byte column slice
// (starting `col_bytes` into each row of `row_bytes`) into shared memory,
// `Chunk`-sized moves, neighbouring threads on neighbouring chunks.  Rows
// past `n` are zero-filled.  All threads of the block take part.
template <typename Chunk>
__device__ __forceinline__ void stage_tile(char* dst, const char* img,
                                           long long row_bytes,
                                           long long col_bytes, int width,
                                           int row0, int rows, int n) {
  const int chunks = width / static_cast<int>(sizeof(Chunk));
  const int total = rows * chunks;
  for (int c = threadIdx.x; c < total; c += blockDim.x) {
    const int r = c / chunks;
    const int cc = c - r * chunks;
    const int j = row0 + r;
    Chunk v{};
    if (j < n) {
      v = *reinterpret_cast<const Chunk*>(img + j * row_bytes + col_bytes +
                                          cc * sizeof(Chunk));
    }
    reinterpret_cast<Chunk*>(dst + r * width)[cc] = v;
  }
}

}  // namespace msvit
