// Fully-int8 packed self-attention for the serving path.
//
// Replaces the TPU kernel `msvit_tpu/ops/packed_attention.py::
// packed_attention_int8` (body `_kernel_int8`).  Same contract: int8 q|k|v
// are column slices of the per-section requantized QKV GEMM output
// [B, N, 3D]; scores are int32 q.k times scale*s_q*s_k; the softmax is
// max-subtracted in f32; probabilities are quantized by a TRUNCATING
// p*127 cast (bias -0.5/254 per probability, as on the TPU); P.V runs in
// int32; the output o*(s_v/127)/l (l == 0 guarded) is written bf16, or
// int8 as clip(rint(o*inv_s_out), +-127) (rint is half-to-even, like
// jnp.round).  The four scales [s_q, s_k, s_v, inv_s_out] are read from a
// device buffer, the counterpart of the TPU kernel's SMEM operand, so the
// host never waits on them.  No mask, no gradient.
//
// What bounds it on the card: as for the bf16 kernel, the two products
// (2*2*N*N*dh ops per head at N=197, dh=64) dominate the int8 q/k/v bytes,
// so it is compute bound.  What the design does about it: the q.k products
// use __dp4a (four int8 products per instruction, packed words), int8 k/v
// tiles are staged in shared memory with coalesced 8-byte loads and read as
// broadcasts by all 64 query rows, and the [N, N] scores never leave
// registers.  The row max cannot be shaved here (the truncating cast needs
// each row to peak at exactly 127), so the kernel makes two passes over the
// kv tiles: the first finds the row max, the second recomputes the scores
// (cheaper than keeping N scores per thread) and accumulates.  Tensor-core
// int8 mma comes in a later change.

#include "common.cuh"

namespace msvit {
namespace {

// One block = (64 query rows, head, image); one thread = one query row.
template <int DHT>
__global__ void __launch_bounds__(kRows)
packed_attention_int8_kernel(const int8_t* __restrict__ qkv,
                             const float* __restrict__ sc,
                             void* __restrict__ out, int int8_out, int n,
                             int h_count, int dh, float scale) {
  constexpr int W = DHT / 4;  // packed int8x4 words per row
  __shared__ __align__(16) int8_t ks[kKv * DHT];
  __shared__ __align__(16) int8_t vs[kKv * DHT];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int i = blockIdx.x * kRows + threadIdx.x;
  const bool active = i < n;
  const int d = h_count * dh;
  const long long row = 3LL * d;  // bytes per token row
  const int8_t* img = qkv + static_cast<long long>(b) * n * row;
  const int words = dh / 4;

  const float s_q = sc[0];
  const float s_k = sc[1];
  const float s_v = sc[2];
  const float inv_s_out = sc[3];
  const float c = (scale * s_q) * s_k;

  int qw[W];
#pragma unroll
  for (int w = 0; w < W; ++w) qw[w] = 0;
  if (active) {
#pragma unroll
    for (int w = 0; w < W; w += 2) {
      if (w < words) {
        const uint2 u =
            *reinterpret_cast<const uint2*>(img + i * row + h * dh + 4 * w);
        qw[w] = static_cast<int>(u.x);
        qw[w + 1] = static_cast<int>(u.y);
      }
    }
  }
  auto score = [&](int j) {
    const int* kr = reinterpret_cast<const int*>(ks + j * dh);
    int a = 0;
#pragma unroll
    for (int w = 0; w < W; ++w)
      if (w < words) a = __dp4a(qw[w], kr[w], a);
    return static_cast<float>(a) * c;
  };

  // Pass 1: the row max.
  float m = -INFINITY;
  for (int kv0 = 0; kv0 < n; kv0 += kKv) {
    __syncthreads();
    stage_tile<uint2>(reinterpret_cast<char*>(ks),
                      reinterpret_cast<const char*>(img), row, d + h * dh, dh,
                      kv0, kKv, n);
    __syncthreads();
    if (!active) continue;
    const int cnt = min(kKv, n - kv0);
    for (int j = 0; j < cnt; ++j) m = fmaxf(m, score(j));
  }

  // Pass 2: p = exp(s - m), l = sum p, pq = trunc(127 p), acc = sum pq v.
  int acc[DHT];
#pragma unroll
  for (int e = 0; e < DHT; ++e) acc[e] = 0;
  float l = 0.f;
  for (int kv0 = 0; kv0 < n; kv0 += kKv) {
    __syncthreads();
    stage_tile<uint2>(reinterpret_cast<char*>(ks),
                      reinterpret_cast<const char*>(img), row, d + h * dh, dh,
                      kv0, kKv, n);
    stage_tile<uint2>(reinterpret_cast<char*>(vs),
                      reinterpret_cast<const char*>(img), row,
                      2 * d + h * dh, dh, kv0, kKv, n);
    __syncthreads();
    if (!active) continue;
    const int cnt = min(kKv, n - kv0);
    for (int j = 0; j < cnt; ++j) {
      const float p = expf(score(j) - m);
      l += p;
      const int pq = static_cast<int>(p * 127.f);  // truncating, p <= 1
      const int* vr = reinterpret_cast<const int*>(vs + j * dh);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (w < words) {
          const int word = vr[w];
#pragma unroll
          for (int t = 0; t < 4; ++t)
            acc[4 * w + t] += pq * ((word << (24 - 8 * t)) >> 24);
        }
      }
    }
  }
  if (!active) return;

  if (l == 0.f) l = 1.f;
  const float kv = s_v / 127.f;
  const long long o_off = (static_cast<long long>(b) * n + i) * d + h * dh;
  if (int8_out) {
    int* o = reinterpret_cast<int*>(static_cast<int8_t*>(out) + o_off);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (w < words) {
        unsigned packed = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float o_f = static_cast<float>(acc[4 * w + t]) * kv / l;
          const float r = fminf(fmaxf(rintf(o_f * inv_s_out), -127.f), 127.f);
          packed |= (static_cast<unsigned>(static_cast<int>(r)) & 0xffu)
                    << (8 * t);
        }
        o[w] = static_cast<int>(packed);
      }
    }
  } else {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + o_off;
#pragma unroll
    for (int e = 0; e < DHT; e += 8) {
      if (e < dh) {
        float r[8];
#pragma unroll
        for (int t = 0; t < 8; ++t)
          r[t] = static_cast<float>(acc[e + t]) * kv / l;
        Vec8<__nv_bfloat16>::store(o + e, r);
      }
    }
  }
}

template <int DHT>
void launch(const void* qkv, const void* sc, void* out, int int8_out, int b,
            int n, int h, int dh, float scale, cudaStream_t stream) {
  const dim3 grid((n + kRows - 1) / kRows, h, b);
  packed_attention_int8_kernel<DHT><<<grid, kRows, 0, stream>>>(
      static_cast<const int8_t*>(qkv), static_cast<const float*>(sc), out,
      int8_out, n, h, dh, scale);
}

}  // namespace
}  // namespace msvit

extern "C" {

// qkv: int8 [B, N, 3*h*dh]; scales: float32[4] on the device; out: int8 or
// bfloat16 [B, N, h*dh].  Returns cudaGetLastError() after the launch.
int msvit_packed_attention_int8(const void* qkv, const void* scales,
                                void* out, int int8_out, int b, int n, int h,
                                int dh, float scale, void* stream) {
  if (dh <= 0 || dh > 128 || dh % 8 != 0 || n <= 0 || b <= 0 || h <= 0 ||
      b > 65535 || h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 16) {
    msvit::launch<16>(qkv, scales, out, int8_out, b, n, h, dh, scale, s);
  } else if (dh <= 32) {
    msvit::launch<32>(qkv, scales, out, int8_out, b, n, h, dh, scale, s);
  } else if (dh <= 64) {
    msvit::launch<64>(qkv, scales, out, int8_out, b, n, h, dh, scale, s);
  } else {
    msvit::launch<128>(qkv, scales, out, int8_out, b, n, h, dh, scale, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
