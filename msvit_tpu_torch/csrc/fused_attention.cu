// Per-head fused attention on [B, H, N, dh] operands (bf16 / f32): K4, K5
// and K5-lse.
//
// Replaces the TPU kernels of `msvit_tpu/ops/fused_attention.py`:
//   * K5 `_fused_forward` with `with_lse=False` (body `_kernel`): the exact,
//     max-subtracted softmax; entry point `msvit_fused_attention`;
//   * K5-lse, the same function with `with_lse=True`: the training forward,
//     which also writes lse = m + log(l) per query row (0 where l == 0, the
//     TPU kernel's `where(l > 0, ...)`) as a compact [B, H, Nq] f32; the TPU
//     kernel's lane-replicated [B, H, Nq_pad, 128] layout, of which its VJP
//     keeps lane 0 only, does not carry over; entry point
//     `msvit_fused_attention_lse`;
//   * K4 `_fused_inference` (body `_kernel_inference`): the shaved softmax
//     p = exp(clip(s, -80, 80)) with no row max, o = P.V / l; entry point
//     `msvit_fused_attention_inference`.
// Both take q [B, H, Nq, dh] and k, v [B, H, Nk, dh] (Nq != Nk allowed:
// cross-context K/V), each through its own image / head / row strides in
// elements with the last dim contiguous, so the wrapper hands over views of
// the QKV GEMM output [B, N, 3D] without a transpose copy, and writes out
// through strides too (the wrapper's out is [B, Nq, H, dh] in memory, the
// layout the output projection reads).  Masks are bool (true = attend) or
// additive f32, shaped [B|1, 1|H, Nq, Nk] with the last two dims
// contiguous, applied to the f32 scores in the TPU kernels' order: scale,
// add the additive mask, then where-valid with mask_value, then (K4) clip.
//
// What bounds it on the card: 4*Nq*Nk*dh FLOP per head against
// 2*(Nq + 2*Nk)*dh bytes of q/k/v/out plus the mask's Nq*Nk entries; at the
// multistate trunk ([8, 12, 816, 64] bf16 with the served partition's
// [8, 1, 816, 816] f32 soft mask) 0.0165 ms of operations against 0.0183 ms
// of bytes, with the mask read once: the tensor cores' rate and the mask's
// reads, shared by 12 heads, both count.
//
// bf16, on the tensor cores: `flash_mma_kernel` of `attention_mma.cuh`, the
// tile body K7 runs, instantiated here with SHAVED = false for K5 and K5-lse
// (the exact online softmax: at one head's whole score row it computes the
// TPU's single-pass softmax; the lse a pointer that may be null) and
// SHAVED = true for K4 (no max, x clamped to +-80 log2e, o / l).  What the
// design does about the bounds: mma.sync tiles of 64 query rows, k/v and
// mask tiles streamed through a cp.async ring, the scores never leave
// registers, p rounded into P.V's A fragments; the grid is (H, q tiles, B),
// head fastest, so that the 12 heads of a query tile meet their broadcast
// mask panel in L2 (the header has the details).  At 816 tokens: 13 query
// tiles (the last with 3 active warps of 4) and 13 key tiles (the last 48
// keys, three 16-key blocks).
//
// f32, on the CUDA cores (fused_attention_kernel; TF32 would break the f32
// bars): one thread per query row holding q and the output accumulator in
// f32 registers, k/v tiles staged once per block in shared memory with
// coalesced 16-byte loads and read by all 64 query rows as broadcasts; the
// [Nq, Nk] scores never leave registers.
//
// K5 runs an online softmax from m = -inf: a new running max rescales l and
// the accumulator by exp(m_old - m_new) (0 at the first score), and a -inf
// score weighs 0, so there is no N limit and -inf - -inf never forms; a row
// with l == 0 (every score -inf) gives zeros, the TPU kernel's l == 0 guard.
// K4 has no max: an additive -inf entry clamps to -80, as a masked one, so
// its all -inf row is mean(V), as the TPU's and the plain version's.
//
// Fully masked rows: a bool row with every entry false has every score at
// mask_value; both kernels then give mean(V) over the Nk real keys.  The
// TPU kernels pad Nk up to a multiple of 128 and count the padded keys in l
// (zero rows of V), so they give sum(V) / (ceil(Nk / 128) * 128) there: a
// padding artifact the port does not copy.
//
// Rounding, as the TPU kernels: p is rounded to the compute dtype into the
// P.V sum (`p.astype(v.dtype)`, `_pv_transposed`) and l is summed from the
// unrounded p (the identity in f32).  K5 and K5-lse round p against the
// running max, where the plain version rounds it against the row's max: a
// product can land one bf16 step apart.

#include "attention_mma.cuh"

namespace msvit {
namespace {

// One block = (64 query rows, head, image); one thread = one query row,
// holding q and the output accumulator in f32 registers.  DHT is the head
// size rounded up to a bucket; dh is the real one (a multiple of 8).
template <typename T, int DHT, bool SHAVED>
__global__ void __launch_bounds__(kRows)
fused_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const void* __restrict__ mask,
                       T* __restrict__ out, float* __restrict__ lse,
                       Strides st, int nq, int nk,
                       int dh, int mask_kind, long long mask_sb,
                       long long mask_sh, float scale, float mask_value) {
  constexpr int KV = kv_rows<T, DHT>();
  __shared__ __align__(16) T ks[KV * DHT];
  __shared__ __align__(16) T vs[KV * DHT];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int i = blockIdx.x * kRows + threadIdx.x;
  const bool active = i < nq;
  const char* kimg = reinterpret_cast<const char*>(k + b * st.kb + h * st.kh);
  const char* vimg = reinterpret_cast<const char*>(v + b * st.vb + h * st.vh);

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
  const uint8_t* mb = nullptr;
  const float* mf = nullptr;
  const long long moff =
      b * mask_sb + h * mask_sh + static_cast<long long>(i) * nk;
  if (mask_kind == kBoolMask) mb = static_cast<const uint8_t*>(mask) + moff;
  if (mask_kind == kAddMask) mf = static_cast<const float*>(mask) + moff;

  const int width = dh * static_cast<int>(sizeof(T));
  const long long krow = st.kn * static_cast<long long>(sizeof(T));
  const long long vrow = st.vn * static_cast<long long>(sizeof(T));
  float m = -INFINITY;  // running max (K5 only)
  float l = 0.f;
  for (int kv0 = 0; kv0 < nk; kv0 += KV) {
    __syncthreads();  // the previous tile is consumed
    stage_tile<uint4>(reinterpret_cast<char*>(ks), kimg, krow, 0, width, kv0,
                      KV, nk);
    stage_tile<uint4>(reinterpret_cast<char*>(vs), vimg, vrow, 0, width, kv0,
                      KV, nk);
    __syncthreads();
    if (!active) continue;
    const int cnt = min(KV, nk - kv0);
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
        s = mb[kv0 + j] ? s : mask_value;
      } else if (mask_kind == kAddMask) {
        s += mf[kv0 + j];
      }
      float p;
      if (SHAVED) {
        p = expf(fminf(fmaxf(s, -80.f), 80.f));
      } else {
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
        p = s == -INFINITY ? 0.f : expf(s - m);
      }
      l += p;  // unrounded; P.V takes p rounded to the compute dtype
      const float pr = round_to<T>(p);
      const T* vr = vs + j * dh;
#pragma unroll
      for (int e = 0; e < DHT; e += 8) {
        if (e < dh) {
          float vf[8];
          Vec8<T>::load(vr + e, vf);
#pragma unroll
          for (int t = 0; t < 8; ++t) acc[e + t] = fmaf(pr, vf[t], acc[e + t]);
        }
      }
    }
  }
  if (!active) return;
  if (lse != nullptr)  // K5-lse (never with SHAVED)
    lse[(static_cast<long long>(b) * gridDim.y + h) * nq + i] =
        l > 0.f ? m + logf(l) : 0.f;
  T* o = out + b * st.ob + h * st.oh + i * st.on;
  // K4: l >= Nk * exp(-80) > 0, divided as the TPU kernel divides; K5:
  // times 1/l, 1 where l == 0 (the TPU kernel's guard)
  const float l_inv = l == 0.f ? 1.f : 1.f / l;
#pragma unroll
  for (int e = 0; e < DHT; e += 8) {
    if (e < dh) {
      float r[8];
#pragma unroll
      for (int t = 0; t < 8; ++t)
        r[t] = SHAVED ? acc[e + t] / l : acc[e + t] * l_inv;
      Vec8<T>::store(o + e, r);
    }
  }
}

template <typename T, int DHT, bool SHAVED>
void launch(const void* q, const void* k, const void* v, const void* mask,
            void* out, float* lse, const Strides& st, int b, int h, int nq,
            int nk, int dh, int mask_kind, long long sb, long long sh,
            float scale, float mask_value, cudaStream_t stream) {
  const dim3 grid((nq + kRows - 1) / kRows, h, b);
  fused_attention_kernel<T, DHT, SHAVED><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), lse, st, nq, nk, dh,
      mask_kind, sb, sh, scale, mask_value);
}

template <typename T, bool SHAVED>
void dispatch(const void* q, const void* k, const void* v, const void* mask,
              void* out, float* lse, const Strides& st, int b, int h, int nq,
              int nk, int dh, int mask_kind, long long sb, long long sh,
              float scale, float mask_value, cudaStream_t stream) {
  if (dh <= 16) {
    launch<T, 16, SHAVED>(q, k, v, mask, out, lse, st, b, h, nq, nk, dh, mask_kind, sb, sh, scale, mask_value, stream);
  } else if (dh <= 32) {
    launch<T, 32, SHAVED>(q, k, v, mask, out, lse, st, b, h, nq, nk, dh, mask_kind, sb, sh, scale, mask_value, stream);
  } else if (dh <= 64) {
    launch<T, 64, SHAVED>(q, k, v, mask, out, lse, st, b, h, nq, nk, dh, mask_kind, sb, sh, scale, mask_value, stream);
  } else {
    launch<T, 128, SHAVED>(q, k, v, mask, out, lse, st, b, h, nq, nk, dh, mask_kind, sb, sh, scale, mask_value, stream);
  }
}

template <bool SHAVED>
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
    dispatch<float, SHAVED>(q, k, v, mask, out, lse, st, b, h, nq, nk, dh,
                            mask_kind, mask_sb, mask_sh, scale, mask_value, s);
  } else if (dtype == 1) {
    return static_cast<int>(dispatch_mma<SHAVED>(q, k, v, mask, out, lse, st,
                                                 b, h, nq, nk, dh, mask_kind,
                                                 mask_sb, mask_sh, scale,
                                                 mask_value, s));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace msvit

extern "C" {

// K5's forward.  dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor
// cores).  strides: 12 element strides (host memory) of q, k, v, out, each
// (image, head, row); every row's dh elements contiguous and 16-byte
// aligned.  mask_kind: 0 none, 1 bool (one byte per entry), 2 additive
// float32; mask_sb / mask_sh the mask's image and head strides in elements
// (0 where broadcast), its last two dims contiguous [Nq, Nk].  Returns
// cudaGetLastError() after the launch.
int msvit_fused_attention(const void* q, const void* k, const void* v,
                          const void* mask, void* out, int dtype, int b,
                          int h, int nq, int nk, int dh,
                          const long long* strides, int mask_kind,
                          long long mask_sb, long long mask_sh, float scale,
                          float mask_value, void* stream) {
  return msvit::run<false>(q, k, v, mask, out, nullptr, dtype, b, h, nq, nk, dh,
                           strides, mask_kind, mask_sb, mask_sh, scale,
                           mask_value, stream);
}

// K4, the shaved serving softmax; arguments as msvit_fused_attention.
int msvit_fused_attention_inference(const void* q, const void* k,
                                    const void* v, const void* mask,
                                    void* out, int dtype, int b, int h,
                                    int nq, int nk, int dh,
                                    const long long* strides, int mask_kind,
                                    long long mask_sb, long long mask_sh,
                                    float scale, float mask_value,
                                    void* stream) {
  return msvit::run<true>(q, k, v, mask, out, nullptr, dtype, b, h, nq, nk, dh,
                          strides, mask_kind, mask_sb, mask_sh, scale,
                          mask_value, stream);
}

// K5-lse, the training forward: as msvit_fused_attention, plus lse
// [B, H, Nq] f32 (contiguous), written.
int msvit_fused_attention_lse(const void* q, const void* k, const void* v,
                              const void* mask, void* out, void* lse,
                              int dtype, int b, int h, int nq, int nk, int dh,
                              const long long* strides, int mask_kind,
                              long long mask_sb, long long mask_sh,
                              float scale, float mask_value, void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return msvit::run<false>(q, k, v, mask, out, static_cast<float*>(lse),
                           dtype, b, h, nq, nk, dh, strides, mask_kind,
                           mask_sb, mask_sh, scale, mask_value, stream);
}

// Blocks of the bf16 tensor-core kernel of K4 (shaved = 1) or K5/K5-lse
// (shaved = 0) resident on one SM at head size dh (a multiple of 8, <= 128)
// and mask_kind, by the runtime's occupancy calculator, into *blocks.
int msvit_fused_attention_occupancy(int dh, int mask_kind, int shaved,
                                    int* blocks) {
  if (dh <= 0 || dh > 128 || dh % 8 != 0 || mask_kind < 0 || mask_kind > 2 ||
      blocks == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      shaved ? msvit::occupancy_mma<true>(dh, mask_kind, blocks)
             : msvit::occupancy_mma<false>(dh, mask_kind, blocks));
}

}  // extern "C"
