// Packed-layout self-attention, training forward with lse (bf16 / f32).
//
// Replaces the TPU kernel `msvit_tpu/ops/packed_attention.py::_packed_forward`
// with `with_lse=True` (body `_kernel_masked`, the training branch).  Same
// contract as the inference kernel (packed_attention.cu) for the operands:
// q|k|v are column slices of the QKV GEMM output [B, N, 3D], the output is
// written packed [B, N, D] at column h*dh, masks are bool (true = attend) or
// additive f32 [B|1, 1|H, N, N], applied to the f32 scores.  The softmax is
// the exact, max-subtracted one, and the kernel also writes the per-head
// log-sum-exp lse = m + log(l) [B, H, N] f32, the residual the backward
// (packed_attention_bwd.cu) rebuilds the probabilities from.  It is exact at
// any logit scale: no clamp.
//
// What bounds it on the card: as the inference kernel, the two products
// (2*2*N*N*dh FLOP per head) against 4*N*dh elements of q/k/v and out: it
// is compute bound, here on the CUDA cores in f32 FMAs (no tensor cores).
// What the design does about it: one pass over the kv tiles with an online
// softmax.  The running max m starts at -INFINITY; when a score passes it,
// l and the accumulator are rescaled by exp(m_old - m_new), which is 0 on
// the first score and never forms -inf - -inf.  For a row of N scores the
// max moves O(log N) times on random data, so the rescale is rare and the
// scores still never leave registers.  k/v tiles are staged once per block
// in shared memory (coalesced 16-byte loads) and read by all 64 query rows
// as broadcasts.  A fully masked bool row has every score at mask_value:
// it gives mean(V) and lse = mask_value + log N, as on the TPU.
//
// Deviation allowed by the port's contract: p stays f32 into the P.V sum,
// where the TPU kernel rounds it to the compute dtype first (the inference
// kernel's deviation too).  A row whose scores are all -inf (an additive
// -inf mask) gives NaN, as on the TPU.

#include "common.cuh"

namespace msvit {
namespace {

// One block = (64 query rows, head, image); one thread = one query row,
// holding q and the output accumulator in f32 registers.  DHT is the head
// size rounded up to a bucket; dh is the real one (a multiple of 8).
template <typename T, int DHT>
__global__ void __launch_bounds__(kRows)
packed_attention_lse_kernel(const T* __restrict__ qkv,
                            const void* __restrict__ mask,
                            T* __restrict__ out, float* __restrict__ lse,
                            int n, int h_count, int dh, int mask_kind,
                            long long mask_sb, long long mask_sh, float scale,
                            float mask_value) {
  constexpr int KV = kv_rows<T, DHT>();
  __shared__ __align__(16) T ks[KV * DHT];
  __shared__ __align__(16) T vs[KV * DHT];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int i = blockIdx.x * kRows + threadIdx.x;
  const bool active = i < n;
  const int d = h_count * dh;
  const long long row = 3LL * d;  // elements per token row
  const T* img = qkv + static_cast<long long>(b) * n * row;

  float q[DHT];
  float acc[DHT];
#pragma unroll
  for (int e = 0; e < DHT; ++e) {
    q[e] = 0.f;
    acc[e] = 0.f;
  }
  if (active) {
#pragma unroll
    for (int e = 0; e < DHT; e += 8)
      if (e < dh) Vec8<T>::load(img + i * row + h * dh + e, q + e);
  }
  const uint8_t* mb = nullptr;
  const float* mf = nullptr;
  const long long moff = b * mask_sb + h * mask_sh + static_cast<long long>(i) * n;
  if (mask_kind == kBoolMask) mb = static_cast<const uint8_t*>(mask) + moff;
  if (mask_kind == kAddMask) mf = static_cast<const float*>(mask) + moff;

  const int width = dh * static_cast<int>(sizeof(T));
  const long long row_bytes = row * static_cast<long long>(sizeof(T));
  float m = -INFINITY;
  float l = 0.f;
  for (int kv0 = 0; kv0 < n; kv0 += KV) {
    __syncthreads();  // the previous tile is consumed
    stage_tile<uint4>(reinterpret_cast<char*>(ks),
                      reinterpret_cast<const char*>(img), row_bytes,
                      static_cast<long long>(d + h * dh) * sizeof(T), width,
                      kv0, KV, n);
    stage_tile<uint4>(reinterpret_cast<char*>(vs),
                      reinterpret_cast<const char*>(img), row_bytes,
                      static_cast<long long>(2 * d + h * dh) * sizeof(T),
                      width, kv0, KV, n);
    __syncthreads();
    if (!active) continue;
    const int cnt = min(KV, n - kv0);
    for (int j = 0; j < cnt; ++j) {
      const T* kr = ks + j * dh;
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < DHT; e += 8) {
        if (e < dh) {
          float kf[8];
          Vec8<T>::load(kr + e, kf);
#pragma unroll
          for (int t = 0; t < 8; ++t) s = fmaf(q[e + t], kf[t], s);
        }
      }
      s *= scale;
      if (mask_kind == kBoolMask) {
        s = mb[kv0 + j] ? s : mask_value;
      } else if (mask_kind == kAddMask) {
        s += mf[kv0 + j];
      }
      if (s > m) {
        // new running max: rescale what was summed under the old one
        // (exp(-inf) = 0 on the first score)
        const float corr = expf(m - s);
        l *= corr;
#pragma unroll
        for (int e = 0; e < DHT; ++e) acc[e] *= corr;
        m = s;
      }
      // s == m == -inf only for -inf scores: they weigh nothing
      const float p = s == -INFINITY ? 0.f : expf(s - m);
      l += p;
      const T* vr = vs + j * dh;
#pragma unroll
      for (int e = 0; e < DHT; e += 8) {
        if (e < dh) {
          float vf[8];
          Vec8<T>::load(vr + e, vf);
#pragma unroll
          for (int t = 0; t < 8; ++t) acc[e + t] = fmaf(p, vf[t], acc[e + t]);
        }
      }
    }
  }
  if (!active) return;
  T* o = out + (static_cast<long long>(b) * n + i) * d + h * dh;
#pragma unroll
  for (int e = 0; e < DHT; e += 8) {
    if (e < dh) {
      float r[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) r[t] = acc[e + t] / l;
      Vec8<T>::store(o + e, r);
    }
  }
  lse[(static_cast<long long>(b) * h_count + h) * n + i] = m + logf(l);
}

template <typename T, int DHT>
void launch(const void* qkv, const void* mask, void* out, void* lse, int b,
            int n, int h, int dh, int mask_kind, long long sb, long long sh,
            float scale, float mask_value, cudaStream_t stream) {
  const dim3 grid((n + kRows - 1) / kRows, h, b);
  packed_attention_lse_kernel<T, DHT><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(qkv), mask, static_cast<T*>(out),
      static_cast<float*>(lse), n, h, dh, mask_kind, sb, sh, scale,
      mask_value);
}

template <typename T>
void dispatch(const void* qkv, const void* mask, void* out, void* lse, int b,
              int n, int h, int dh, int mask_kind, long long sb, long long sh,
              float scale, float mask_value, cudaStream_t stream) {
  if (dh <= 16) {
    launch<T, 16>(qkv, mask, out, lse, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  } else if (dh <= 32) {
    launch<T, 32>(qkv, mask, out, lse, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  } else if (dh <= 64) {
    launch<T, 64>(qkv, mask, out, lse, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  } else {
    launch<T, 128>(qkv, mask, out, lse, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  }
}

}  // namespace
}  // namespace msvit

extern "C" {

// As msvit_packed_attention, plus `lse`: [B, H, N] f32, written.
// Returns cudaGetLastError() after the launch.
int msvit_packed_attention_lse(const void* qkv, const void* mask, void* out,
                               void* lse, int dtype, int b, int n, int h,
                               int dh, int mask_kind, long long mask_sb,
                               long long mask_sh, float scale,
                               float mask_value, void* stream) {
  if (dh <= 0 || dh > 128 || dh % 8 != 0 || n <= 0 || b <= 0 || h <= 0 ||
      b > 65535 || h > 65535 || mask_kind < 0 || mask_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    msvit::dispatch<float>(qkv, mask, out, lse, b, n, h, dh, mask_kind,
                           mask_sb, mask_sh, scale, mask_value, s);
  } else if (dtype == 1) {
    msvit::dispatch<__nv_bfloat16>(qkv, mask, out, lse, b, n, h, dh,
                                   mask_kind, mask_sb, mask_sh, scale,
                                   mask_value, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
