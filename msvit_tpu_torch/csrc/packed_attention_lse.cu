// Packed-layout self-attention, training forward with lse (bf16 / f32).
//
// Replaces the TPU kernel `msvit_tpu/ops/packed_attention.py::_packed_forward`
// with `with_lse=True` (body `_kernel_masked`, the training branch), and
// the same branch of the head-grouped `::_packed_forward_grouped`.  Same
// contract as the inference kernel (packed_attention.cu) for the operands:
// q|k|v are column slices of the QKV GEMM output [B, N, 3D], the output is
// written packed [B, N, D] at column h*dh, masks are bool (true = attend) or
// additive f32 [B|1, 1|H, N, N], applied to the f32 scores.  The softmax is
// the exact, max-subtracted one: l is summed from the unrounded f32 p, P.V
// takes p rounded to the compute dtype, as on the TPU.  The kernel also
// writes the per-head log-sum-exp lse = m + log(l) [B, H, N] f32, the
// residual the backward (packed_attention_bwd.cu) rebuilds the
// probabilities from.  It is exact at any logit scale: no clamp.  A fully
// masked bool row has every score at mask_value: it gives mean(V) and
// lse = mask_value + log N, as on the TPU.  A row whose scores are all -inf
// (an additive -inf mask) gives NaN, as on the TPU.
//
// What bounds it on the card: operations, two products of N*N*dh per head
// (4*N*N*dh FLOP) against 4*N*dh elements of q/k/v and out.
//
// bf16, on the tensor cores (packed_lse_mma_kernel): the FlashAttention-2
// scheme with warp-level mma.sync m16n8k16 (bf16 operands, f32
// accumulators).  A block of 4 warps takes 64 query rows (16 a warp) of
// one (head, image); the q fragments are loaded once (read from shared
// memory at each use at dh 128).  k/v tiles of 64 rows
// stream through a two-stage ring in shared memory filled by 16-byte
// cp.async copies, so the next tile is in flight while this one is
// multiplied.  Per tile: S = Q.K^T (k through ldmatrix), scale, mask and
// the ragged edge on the accumulator fragments (keys past N are -inf, so a
// zero-filled row weighs nothing; query rows past N are never written),
// the online row max across the 4 lanes of a quad (m starts at -inf, -inf
// scores weigh 0, l and O are rescaled by exp(m_old - m_new)), then p
// rounded to bf16 in registers becomes the A fragment of O += P.V (v
// through ldmatrix.trans): the scores never leave registers.  Shared rows
// are padded by 16 bytes, so the ldmatrix rows hit distinct banks, and a
// head size that is not a multiple of 16 is zero-padded in shared memory to
// its bucket (16/32/64/128): the pad columns are zeroed once, the copies
// never touch them.  Above 48 KB (dh 128) the tiles live in dynamic shared
// memory.  wgmma with TMA and warp specialisation is the later step.
//
// f32 (packed_attention_lse_kernel): one thread per query row on the CUDA
// cores in f32 FMAs (TF32 would break the f32 bars).  One pass over the kv
// tiles with an online softmax; the running max m starts at -INFINITY;
// when a score passes it, l and the accumulator are rescaled by
// exp(m_old - m_new), which is 0 on the first score and never forms
// -inf - -inf.  k/v tiles are staged once per block in shared memory
// (coalesced 16-byte loads) and read by all 64 query rows as broadcasts.

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

// One block = (64 query rows, head, image), 4 warps of 16 rows; bf16 only.
template <int DHT>
__global__ void __launch_bounds__(kMmaThreads)
packed_lse_mma_kernel(const bf16* __restrict__ qkv,
                      const void* __restrict__ mask, bf16* __restrict__ out,
                      float* __restrict__ lse, int n, int h_count, int dh,
                      int mask_kind, long long mask_sb, long long mask_sh,
                      float scale, float mask_value) {
  constexpr int LD = mma_ld<DHT>();
  constexpr int KT = kMmaTile;   // keys per staged tile
  constexpr int NT = KT / 8;     // score n-tiles per tile
  constexpr int OT = DHT / 8;    // output n-tiles
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [64][LD]
  bf16* ring = qs + kMmaRows * LD;           // [2][k, v][KT][LD]
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kMmaRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  const int d = h_count * dh;
  const long long row = 3LL * d;
  const bf16* img = qkv + static_cast<long long>(b) * n * row;

  if (dh < DHT) {  // pad columns of every tile: zero once
    zero_smem(smem, (kMmaRows + 4 * KT) * LD * static_cast<int>(sizeof(bf16)));
    __syncthreads();
  }
  const int tiles = (n + KT - 1) / KT;
  auto load_kv = [&](int t) {
    bf16* ks = ring + (t & 1) * 2 * KT * LD;
    async_tile<LD>(ks, img + d + h * dh, row, t * KT, KT, n, dh);
    async_tile<LD>(ks + KT * LD, img + 2 * d + h * dh, row, t * KT, KT, n, dh);
  };
  async_tile<LD>(qs, img + h * dh, row, row0, kMmaRows, n, dh);
  load_kv(0);
  cp_async_commit();

  // this thread's two accumulator rows (g and g + 8 of the warp's 16)
  const int i_lo = row0 + warp * 16 + gq;
  const int irow[2] = {i_lo, i_lo + 8};
  const uint8_t* mb = static_cast<const uint8_t*>(mask);
  const float* mf = static_cast<const float*>(mask);
  const long long moff = b * mask_sb + h * mask_sh;

  Resident<DHT> qf;
  float o[OT][4];
  zero_acc(o);
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's part of the row sums

  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) load_kv(t + 1);  // its stage was freed at t - 1's end
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and q) has landed for this thread
    __syncthreads();     // ... and for every thread
    if (t == 0) qf.load(qs + warp * 16 * LD, lane);
    const bf16* ks = ring + (t & 1) * 2 * KT * LD;
    const bf16* vs = ks + KT * LD;
    const int kv0 = t * KT;

    float s[NT][4];
    product_t<DHT, KT>(s, qf, ks, lane);

    // scale, mask, ragged edge; the tile's row max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + j * 8 + 2 * tq + (e & 1);
        const int i = irow[e >> 1];
        float v = s[j][e] * scale;
        if (col >= n) {
          v = -INFINITY;
        } else if (mask_kind != kNoMask && i < n) {
          v = apply_mask(v, mask_kind, mb, mf,
                         moff + static_cast<long long>(i) * n + col, mask_value);
        }
        s[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      // exp(-inf) = 0 rescales the empty start; an all -inf row keeps m
      // at -inf and subtracts 0, never -inf - -inf
      mu[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      const float corr = exp2f((m[r] - mu[r]) * kLog2e);
      m[r] = mx[r];
      l[r] *= corr;
#pragma unroll
      for (int j = 0; j < OT; ++j) {
        o[j][2 * r] *= corr;
        o[j][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[j][e] - mu[e >> 1]) * kLog2e);
        l[e >> 1] += p;  // the unrounded p
        s[j][e] = p;
      }
    }

    product_acc<DHT, KT>(o, s, vs, lane);  // O += P.V, p rounded to bf16
    __syncthreads();  // this stage is consumed: t + 1 may refill it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = row_sum<4>(l[r]);
    const int i = irow[r];
    if (i >= n) continue;
    bf16* orow = out + (static_cast<long long>(b) * n + i) * d + h * dh;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int col = j * 8 + 2 * tq;
      if (col < dh)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(o[j][2 * r] / lr, o[j][2 * r + 1] / lr);
    }
    if (tq == 0) lse[(static_cast<long long>(b) * h_count + h) * n + i] = m[r] + logf(lr);
  }
}

template <int DHT>
cudaError_t launch_mma(const void* qkv, const void* mask, void* out,
                       void* lse, int b, int n, int h, int dh, int mask_kind,
                       long long sb, long long sh, float scale,
                       float mask_value, cudaStream_t stream) {
  const int bytes = (kMmaRows + 4 * kMmaTile) * mma_ld<DHT>() *
                    static_cast<int>(sizeof(bf16));
  const cudaError_t err = cudaFuncSetAttribute(
      packed_lse_mma_kernel<DHT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kMmaRows - 1) / kMmaRows, h, b);
  packed_lse_mma_kernel<DHT><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const bf16*>(qkv), mask, static_cast<bf16*>(out),
      static_cast<float*>(lse), n, h, dh, mask_kind, sb, sh, scale,
      mask_value);
  return cudaGetLastError();
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

cudaError_t dispatch_mma(const void* qkv, const void* mask, void* out,
                         void* lse, int b, int n, int h, int dh,
                         int mask_kind, long long sb, long long sh,
                         float scale, float mask_value, cudaStream_t stream) {
  if (dh <= 16)
    return launch_mma<16>(qkv, mask, out, lse, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  if (dh <= 32)
    return launch_mma<32>(qkv, mask, out, lse, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  if (dh <= 64)
    return launch_mma<64>(qkv, mask, out, lse, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  return launch_mma<128>(qkv, mask, out, lse, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
}

}  // namespace
}  // namespace msvit

extern "C" {

// As msvit_packed_attention, plus `lse`: [B, H, N] f32, written.  bf16 runs
// on the tensor cores, f32 on the CUDA cores.
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
    return static_cast<int>(msvit::dispatch_mma(qkv, mask, out, lse, b, n, h,
                                                dh, mask_kind, mask_sb,
                                                mask_sh, scale, mask_value, s));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
