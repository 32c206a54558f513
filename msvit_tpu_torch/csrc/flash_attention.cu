// Flash attention forward on [B, H, N, dh] operands (bf16 / f32): K7 and
// K7-lse.
//
// Replaces the TPU kernel `msvit_tpu/ops/flash_attention.py::_flash_forward`
// (body `_fwd_kernel`, its pallas_call): the exact online-softmax attention
// that the JAX package's "auto" takes once one head's score tile outgrows
// the single-pass fused kernel (the multistate trunk at 448 px, 3168
// tokens).  Entry points `msvit_flash_attention` (out) and
// `msvit_flash_attention_lse` (out and a compact lse [B, H, Nq] f32, 0
// where l == 0, the TPU kernel's `where(l > 0, m + log l, 0)`; the TPU's
// lane-replicated [B, H, Nq_pad, 128] layout does not carry over).  One
// kernel serves both: the lse is a pointer that may be null, and out is
// the same bits either way.
//
// Same contract as K5 (`fused_attention.cu`): q [B, H, Nq, dh], k, v
// [B, H, Nk, dh], Nq != Nk allowed, each read through its own image / head /
// row strides in elements with the last dim contiguous and every row
// 16-byte aligned (views of the QKV GEMM output need no copy); out written
// through strides.  Masks bool (true = attend) or additive f32,
// [B|1, 1|H, Nq, Nk] with the last two dims contiguous, applied in the TPU
// kernel's order: scale, add the additive mask, then where-valid with
// mask_value.  No N limit.  The softmax is the exact one: the online row
// max, p = exp(s - m), l summed from the unrounded p, P.V with p rounded to
// the compute dtype (the identity in f32), as the TPU kernel; a -inf score
// weighs nothing and a row with l == 0 (every score -inf) gives zeros and
// lse 0 (the TPU's l_inv guard).
//
// Fully masked rows: a bool row with every entry false has every score at
// mask_value, and the kernel gives mean(V) over the Nk real keys: keys past
// Nk are -inf, never mask_value.  The TPU kernel pads Nk to
// nk_pad = ceil(Nk / bk) * bk, bk = min(1024, ceil128(Nk)), and its padded
// keys (zero rows of V) enter l with p = 1 there: sum(V) / nk_pad, a padding
// artifact the port does not copy.
//
// What bounds it on the card: operations, 4*Nq*Nk*dh FLOP per head, against
// 2*(Nq + 2*Nk)*dh bytes of q/k/v/out plus the mask's Nq*Nk entries; at the
// 448-px trunk ([8, 12, 3168, 64], a soft mask of 8 x 3168^2 f32 = 321 MB
// broadcast over the heads) 0.2494 ms of operations against 0.096 ms of
// bytes, if the mask is read once.
//
// bf16 (flash_mma_kernel<DHT, false>, `attention_mma.cuh`): the tile body
// shared with K5 and K4 -- mma.sync tiles of 64 query rows fed by a
// cp.async ring of k/v and mask tiles, the online softmax in log2 units on
// the accumulator fragments, p rounded into P.V's A fragments, a head-first
// grid so that the 12 heads of a query tile meet their broadcast mask panel
// in L2 (the header says how and why).
//
// f32 (flash_forward_kernel): one thread per query row on the CUDA cores
// in f32 FMAs (TF32 would break the f32 bars), the [Nq, Nk] scores in
// registers; k/v tiles staged once per block in shared memory with
// coalesced 16-byte loads and read by all 64 rows as broadcasts; each
// [64 rows x KV] mask tile staged in shared memory with coalesced loads (a
// bool tile as 1/0 floats), its rows padded by one word.  A new running max
// rescales l and the accumulator by exp(m_old - m_new) (0 at the first
// score).

#include "attention_mma.cuh"

namespace msvit {
namespace {

// Key rows per staged tile: the k/v tiles and the padded f32 mask tile
// within 40 KB of static shared memory.
template <typename T, int DHT>
__host__ __device__ constexpr int flash_kv() {
  return 2 * kKv * DHT * static_cast<int>(sizeof(T)) + kRows * (kKv + 1) * 4 <=
                 40 * 1024
             ? kKv
             : kKv / 2;
}

// One block = (64 query rows, head, image); one thread = one query row.
template <typename T, int DHT>
__global__ void __launch_bounds__(kRows)
flash_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const void* __restrict__ mask,
                     T* __restrict__ out, float* __restrict__ lse, Strides st,
                     int nq, int nk, int dh, int mask_kind, long long mask_sb,
                     long long mask_sh, float scale, float mask_value) {
  constexpr int KV = flash_kv<T, DHT>();
  constexpr int MS = KV + 1;  // padded mask tile row
  __shared__ __align__(16) T ks[KV * DHT];
  __shared__ __align__(16) T vs[KV * DHT];
  __shared__ float ms[kRows * MS];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int i0 = blockIdx.x * kRows;
  const int i = i0 + threadIdx.x;
  const bool active = i < nq;
  const char* kimg = reinterpret_cast<const char*>(k + b * st.kb + h * st.kh);
  const char* vimg = reinterpret_cast<const char*>(v + b * st.vb + h * st.vh);
  const long long mbase = b * mask_sb + h * mask_sh;
  const uint8_t* mb = static_cast<const uint8_t*>(mask) + mbase;
  const float* mf = static_cast<const float*>(mask) + mbase;

  float qr[DHT];
  float acc[DHT];
#pragma unroll
  for (int e = 0; e < DHT; ++e) {
    qr[e] = 0.f;
    acc[e] = 0.f;
  }
  if (active) {
    const T* qrow = q + b * st.qb + h * st.qh + i * st.qn;
#pragma unroll
    for (int e = 0; e < DHT; e += 8)
      if (e < dh) Vec8<T>::load(qrow + e, qr + e);
  }

  const int width = dh * static_cast<int>(sizeof(T));
  const long long krow = st.kn * static_cast<long long>(sizeof(T));
  const long long vrow = st.vn * static_cast<long long>(sizeof(T));
  const float* mrow = ms + threadIdx.x * MS;
  float m = -INFINITY;
  float l = 0.f;
  for (int kv0 = 0; kv0 < nk; kv0 += KV) {
    const int cnt = min(KV, nk - kv0);
    __syncthreads();  // the previous tiles are consumed
    stage_tile<uint4>(reinterpret_cast<char*>(ks), kimg, krow, 0, width, kv0,
                      KV, nk);
    stage_tile<uint4>(reinterpret_cast<char*>(vs), vimg, vrow, 0, width, kv0,
                      KV, nk);
    if (mask_kind != kNoMask) {
      for (int e = threadIdx.x; e < kRows * KV; e += kRows) {
        const int r = e / KV;
        const int c = e - r * KV;
        float val = 0.f;
        if (i0 + r < nq && c < cnt) {
          const long long at = static_cast<long long>(i0 + r) * nk + kv0 + c;
          val = mask_kind == kBoolMask ? (mb[at] ? 1.f : 0.f) : mf[at];
        }
        ms[r * MS + c] = val;
      }
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < cnt; ++j) {
      const T* kr = ks + j * dh;
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < DHT; e += 8) {
        if (e < dh) {
          float kf[8];
          Vec8<T>::load(kr + e, kf);
#pragma unroll
          for (int t = 0; t < 8; ++t) s = fmaf(qr[e + t], kf[t], s);
        }
      }
      s *= scale;
      if (mask_kind == kBoolMask) {
        s = mrow[j] != 0.f ? s : mask_value;
      } else if (mask_kind == kAddMask) {
        s += mrow[j];
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
  if (lse != nullptr)
    lse[(static_cast<long long>(b) * gridDim.y + h) * nq + i] =
        l > 0.f ? m + logf(l) : 0.f;
  T* o = out + b * st.ob + h * st.oh + i * st.on;
  const float l_inv = l == 0.f ? 1.f : 1.f / l;  // the TPU kernel's guard
#pragma unroll
  for (int e = 0; e < DHT; e += 8) {
    if (e < dh) {
      float r[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) r[t] = acc[e + t] * l_inv;
      Vec8<T>::store(o + e, r);
    }
  }
}

template <typename T, int DHT>
void launch(const void* q, const void* k, const void* v, const void* mask,
            void* out, float* lse, const Strides& st, int b, int h, int nq,
            int nk, int dh, int mask_kind, long long sb, long long sh,
            float scale, float mask_value, cudaStream_t stream) {
  const dim3 grid((nq + kRows - 1) / kRows, h, b);
  flash_forward_kernel<T, DHT><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), lse, st, nq, nk, dh,
      mask_kind, sb, sh, scale, mask_value);
}

template <typename T>
void dispatch(const void* q, const void* k, const void* v, const void* mask,
              void* out, float* lse, const Strides& st, int b, int h, int nq,
              int nk, int dh, int mask_kind, long long sb, long long sh,
              float scale, float mask_value, cudaStream_t stream) {
  if (dh <= 16) {
    launch<T, 16>(q, k, v, mask, out, lse, st, b, h, nq, nk, dh, mask_kind, sb, sh, scale, mask_value, stream);
  } else if (dh <= 32) {
    launch<T, 32>(q, k, v, mask, out, lse, st, b, h, nq, nk, dh, mask_kind, sb, sh, scale, mask_value, stream);
  } else if (dh <= 64) {
    launch<T, 64>(q, k, v, mask, out, lse, st, b, h, nq, nk, dh, mask_kind, sb, sh, scale, mask_value, stream);
  } else {
    launch<T, 128>(q, k, v, mask, out, lse, st, b, h, nq, nk, dh, mask_kind, sb, sh, scale, mask_value, stream);
  }
}

int run(const void* q, const void* k, const void* v, const void* mask,
        void* out, float* lse, int dtype, int b, int h, int nq, int nk, int dh,
        const long long* strides, int mask_kind, long long mask_sb,
        long long mask_sh, float scale, float mask_value, void* stream) {
  if (dh <= 0 || dh > 128 || dh % 8 != 0 || nq <= 0 || nk <= 0 || b <= 0 ||
      h <= 0 || b > 65535 || h > 65535 || mask_kind < 0 || mask_kind > 2 ||
      (mask_kind != kNoMask && mask == nullptr) || strides == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dispatch<float>(q, k, v, mask, out, lse, st, b, h, nq, nk, dh, mask_kind,
                    mask_sb, mask_sh, scale, mask_value, s);
  } else if (dtype == 1) {
    return static_cast<int>(dispatch_mma<false>(q, k, v, mask, out, lse, st, b, h,
                                         nq, nk, dh, mask_kind, mask_sb,
                                         mask_sh, scale, mask_value, s));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace msvit

extern "C" {

// K7.  dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  strides: 12 element strides (host
// memory) of q, k, v, out, each (image, head, row); every row's dh elements
// contiguous and 16-byte aligned.  mask_kind: 0 none, 1 bool (one byte per
// entry), 2 additive float32; mask_sb / mask_sh the mask's image and head
// strides in elements (0 where broadcast), its last two dims contiguous
// [Nq, Nk].  Returns cudaGetLastError() after the launch.
int msvit_flash_attention(const void* q, const void* k, const void* v,
                          const void* mask, void* out, int dtype, int b,
                          int h, int nq, int nk, int dh,
                          const long long* strides, int mask_kind,
                          long long mask_sb, long long mask_sh, float scale,
                          float mask_value, void* stream) {
  return msvit::run(q, k, v, mask, out, nullptr, dtype, b, h, nq, nk, dh,
                    strides, mask_kind, mask_sb, mask_sh, scale, mask_value,
                    stream);
}

// K7-lse, the training forward: as msvit_flash_attention, plus lse
// [B, H, Nq] f32 (contiguous), written.
int msvit_flash_attention_lse(const void* q, const void* k, const void* v,
                              const void* mask, void* out, void* lse,
                              int dtype, int b, int h, int nq, int nk, int dh,
                              const long long* strides, int mask_kind,
                              long long mask_sb, long long mask_sh,
                              float scale, float mask_value, void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return msvit::run(q, k, v, mask, out, static_cast<float*>(lse), dtype, b, h,
                    nq, nk, dh, strides, mask_kind, mask_sb, mask_sh, scale,
                    mask_value, stream);
}

}  // extern "C"
