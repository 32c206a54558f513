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
//
// K9, `msvit_tpu/ops/packed_attention.py::_packed_int8_grouped` (body
// `_kernel_int8_grouped`, its pallas_call), is the masked serving kernel of
// the multistate trunk (`attn_mode="int8"`): the same layout and two passes,
// with four differences from K3, each the TPU kernel's:
//   * a mask, bool (where-valid with mask_value) or additive, the additive
//     one read as bf16 (the wrapper casts it; the model's 0 / -100 soft
//     mask is bf16-exact), [B|1, 1|H, N, N] with the last two dims
//     contiguous, applied to the scaled scores before the row max;
//   * the exp is pre-scaled: pq = trunc(exp(s - m + ln 127)), 127 at the
//     row max (an f32 exp within an ulp of 127 there, so the card's expf
//     and the TPU's exp may truncate one step apart);
//   * l is the integer sum of the quantized pq, floored at 1, and
//     o = (pq . v) * (s_v / l): the division by the quantized sum cancels
//     the truncation bias that K3's f32 sum keeps;
//   * bf16 or int8 out, as K3.
// The TPU's head-pair grid and its VMEM gate do not carry over: any N.
// Its mask is read per query row from device memory (rows of neighbouring
// threads N * 2 bytes apart), twice (once per pass).

#include "common.cuh"

namespace msvit {
namespace {

// Write one row's int32 accumulators as bf16 (dequant(a)) or as int8,
// clip(rint(dequant(a) * inv_s_out), +-127) (rint is half-to-even, like
// jnp.round).
template <int DHT, typename F>
__device__ __forceinline__ void store_row(const int* acc, void* out,
                                          long long o_off, int int8_out,
                                          float inv_s_out, int dh, F dequant) {
  constexpr int W = DHT / 4;
  const int words = dh / 4;
  if (int8_out) {
    int* o = reinterpret_cast<int*>(static_cast<int8_t*>(out) + o_off);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (w < words) {
        unsigned packed = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float r = fminf(fmaxf(rintf(dequant(acc[4 * w + t]) * inv_s_out),
                                      -127.f), 127.f);
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
        for (int t = 0; t < 8; ++t) r[t] = dequant(acc[e + t]);
        Vec8<__nv_bfloat16>::store(o + e, r);
      }
    }
  }
}

constexpr float kLn127 = 4.8441870864585885f;  // exp(s - m + ln 127) = 127 p

// One block = (64 query rows, head, image); one thread = one query row.
// MASKED: K9 (mask, pre-scaled exp, integer l); otherwise K3.
template <int DHT, bool MASKED>
__global__ void __launch_bounds__(kRows)
packed_attention_int8_kernel(const int8_t* __restrict__ qkv,
                             const float* __restrict__ sc,
                             const void* __restrict__ mask,
                             void* __restrict__ out, int int8_out, int n,
                             int h_count, int dh, int mask_kind,
                             long long mask_sb, long long mask_sh, float scale,
                             float mask_value) {
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
  const long long moff =
      b * mask_sb + h * mask_sh + static_cast<long long>(i) * n;
  const uint8_t* mb = static_cast<const uint8_t*>(mask) + moff;
  const __nv_bfloat16* mf = static_cast<const __nv_bfloat16*>(mask) + moff;

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
  // the scaled score of key tile row j, key index `at`, with the mask
  auto score = [&](int j, int at) {
    const int* kr = reinterpret_cast<const int*>(ks + j * dh);
    int a = 0;
#pragma unroll
    for (int w = 0; w < W; ++w)
      if (w < words) a = __dp4a(qw[w], kr[w], a);
    float s = static_cast<float>(a) * c;
    if (MASKED) {
      if (mask_kind == kBoolMask) {
        s = mb[at] ? s : mask_value;
      } else if (mask_kind == kAddMask) {
        s += __bfloat162float(mf[at]);
      }
    }
    return s;
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
    for (int j = 0; j < cnt; ++j) m = fmaxf(m, score(j, kv0 + j));
  }

  // Pass 2, K3: p = exp(s - m), l = sum p, pq = trunc(127 p); K9:
  // pq = trunc(exp(s - m + ln 127)), lq = sum pq; both acc = sum pq v.
  int acc[DHT];
#pragma unroll
  for (int e = 0; e < DHT; ++e) acc[e] = 0;
  float l = 0.f;
  int lq = 0;
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
      int pq;  // truncating casts: the exponent is <= 0, so pq <= 127
      if (MASKED) {
        pq = static_cast<int>(expf(score(j, kv0 + j) - m + kLn127));
        lq += pq;
      } else {
        const float p = expf(score(j, kv0 + j) - m);
        l += p;
        pq = static_cast<int>(p * 127.f);
      }
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

  const long long o_off = (static_cast<long long>(b) * n + i) * d + h * dh;
  if (MASKED) {
    const float f = s_v / fmaxf(static_cast<float>(lq), 1.f);
    store_row<DHT>(acc, out, o_off, int8_out, inv_s_out, dh,
                   [&](int a) { return static_cast<float>(a) * f; });
  } else {
    if (l == 0.f) l = 1.f;
    const float kv = s_v / 127.f;
    store_row<DHT>(acc, out, o_off, int8_out, inv_s_out, dh,
                   [&](int a) { return static_cast<float>(a) * kv / l; });
  }
}

template <bool MASKED>
int run(const void* qkv, const void* sc, const void* mask, void* out,
        int int8_out, int b, int n, int h, int dh, int mask_kind,
        long long mask_sb, long long mask_sh, float scale, float mask_value,
        void* stream) {
  if (dh <= 0 || dh > 128 || dh % 8 != 0 || n <= 0 || b <= 0 || h <= 0 ||
      b > 65535 || h > 65535 || mask_kind < 0 || mask_kind > 2 ||
      (mask_kind != kNoMask && mask == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kRows - 1) / kRows, h, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(qkv);
  const float* f = static_cast<const float*>(sc);
#define MSVIT_INT8_LAUNCH(DHT)                                              \
  packed_attention_int8_kernel<DHT, MASKED><<<grid, kRows, 0, s>>>(         \
      x, f, mask, out, int8_out, n, h, dh, mask_kind, mask_sb, mask_sh,     \
      scale, mask_value)
  if (dh <= 16) {
    MSVIT_INT8_LAUNCH(16);
  } else if (dh <= 32) {
    MSVIT_INT8_LAUNCH(32);
  } else if (dh <= 64) {
    MSVIT_INT8_LAUNCH(64);
  } else {
    MSVIT_INT8_LAUNCH(128);
  }
#undef MSVIT_INT8_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace msvit

extern "C" {

// K3.  qkv: int8 [B, N, 3*h*dh]; scales: float32[4] on the device; out: int8
// or bfloat16 [B, N, h*dh].  Returns cudaGetLastError() after the launch.
int msvit_packed_attention_int8(const void* qkv, const void* scales,
                                void* out, int int8_out, int b, int n, int h,
                                int dh, float scale, void* stream) {
  return msvit::run<false>(qkv, scales, nullptr, out, int8_out, b, n, h, dh, 0,
                           0, 0, scale, 0.f, stream);
}

// K9: as msvit_packed_attention_int8, plus a mask.  mask_kind: 0 none, 1 bool
// (one byte per entry), 2 additive bfloat16; mask_sb / mask_sh its image
// and head strides in elements (0 where broadcast), its last two dims
// contiguous [N, N].
int msvit_packed_attention_int8_masked(const void* qkv, const void* scales,
                                       const void* mask, void* out,
                                       int int8_out, int b, int n, int h,
                                       int dh, int mask_kind, long long mask_sb,
                                       long long mask_sh, float scale,
                                       float mask_value, void* stream) {
  return msvit::run<true>(qkv, scales, mask, out, int8_out, b, n, h, dh,
                          mask_kind, mask_sb, mask_sh, scale, mask_value,
                          stream);
}

}  // extern "C"
