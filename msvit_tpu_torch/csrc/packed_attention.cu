// Packed-layout self-attention, inference forward (bf16 / f32): K1.
//
// Replaces the TPU kernel `msvit_tpu/ops/packed_attention.py::_packed_forward`
// (body `_kernel_masked`, inference branch without lse), and the same branch
// of the head-grouped `::_packed_forward_grouped` (K8a: 512 to ~1100 tokens,
// the ViT-B/8 pretrain's 785).  Same contract: q|k|v are read as column
// slices of the QKV GEMM output [B, N, 3D] and the output is written packed
// [B, N, D] at column h*dh, ready for the output projection; masks are bool
// (true = attend) or additive f32, shaped [B|1, 1|H, N, N], applied to the
// f32 scores; the softmax is the TPU kernel's shaved one,
// p = exp(clip(s, -80, 80)) with no row max, so rows whose logits pass +-80
// are flattened exactly as there.  Keys past N weigh exactly 0 (not
// exp(-80)): a fully masked bool row gives mean(V) over the N real keys.
// l >= N * exp(-80) > 0: no zero guard, as in the TPU kernel.
//
// What bounds it on the card: two products of N*N*dh per head (4*N*N*dh
// FLOP) against 4*N*dh elements of q/k/v and out: operations at the
// pretrain's 785 tokens (0.1225 ms against 0.092 ms of bytes at bs64),
// bytes at ViT-B/16's 197 (0.0231 ms against 0.0077).
//
// bf16 at head size 64 (every zoo trunk but vit-h14): the shaved
// instantiation of the Hopper kernel in attention_wgmma.cuh, wgmma fed by
// TMA, warp-specialised (K1-lse's design without the running max; the
// header says how).  Its 4-D maps read the packed qkv as [B, H, N, 64] views
// at element offsets 0, D and 2D (row pitch 3D*2 bytes, head pitch 128),
// the boxes K1-lse's 3-D map reads at columns h*64, D + h*64, 2D + h*64.
// The mma.sync kernel below issued small synchronous products from 4 warps
// fed by a two-stage cp.async ring: 0.84 ms at [64, 785, 2304] against the
// library's 0.44 (NVIDIA H100 80GB HBM3, 700 W).
//
// Other bf16 head sizes (packed_mma_kernel): K1-lse's mma.sync tiles
// (packed_attention_lse.cu) without the running max.  Warp-level mma.sync
// m16n8k16 (bf16 operands, f32 accumulators); a block of 4 warps takes 64
// query rows (16 a warp) of one (head, image), q fragments loaded once
// (read from shared memory at each use at dh 128); k/v tiles of 64 rows
// stream through a two-stage ring in shared memory filled by 16-byte
// cp.async copies, the next tile in flight while this one is multiplied.
// Per tile: S = Q.K^T (k through ldmatrix), scale and mask on the
// accumulator fragments, p = exp(clip(s, +-80)) rounded to bf16 in
// registers (in log2 units: one multiply by scale * log2e, exp2), packed
// once into the A fragments of O += P.V (v through ldmatrix.trans); the row
// sum l of that rounded p rides the tensor cores as one more product with
// a column of ones, the TPU's ones column through the MXU: one pass, no
// rescale, no per-score sum, the division at the end.  The last, partial
// tile alone checks its keys against N and skips its 16-key blocks past N;
// a warp whose rows all lie past N only helps copy.  Shared rows are padded by
// 16 bytes (ldmatrix rows in distinct banks); head sizes 8/24/40 are
// zero-padded in shared memory to their bucket (16/32/64), zeroed once a
// block.
//
// The route is the entry point's: bf16 at dh 64 takes the wgmma kernel,
// other bf16 head sizes the mma.sync kernel, f32 the CUDA cores; there is
// no fallback between them (a qkv TMA cannot map is refused).
//
// f32 (packed_attention_kernel): one thread per query row on the CUDA
// cores in f32 FMAs (TF32 would break the f32 bars); the [N, N] scores never
// leave registers, k/v tiles are staged once per block in shared memory with
// coalesced 16-byte loads and read by all 64 query rows as broadcasts.  In
// f32 p needs no rounding: the plain version's cast to f32 is the identity.

#include "attention_wgmma.cuh"

namespace msvit {
namespace {

// One block = (64 query rows, head, image); one thread = one query row,
// holding q and the output accumulator in f32 registers.  DHT is the head
// size rounded up to a bucket; dh is the real one (a multiple of 8).
template <typename T, int DHT>
__global__ void __launch_bounds__(kRows)
packed_attention_kernel(const T* __restrict__ qkv,
                        const void* __restrict__ mask, T* __restrict__ out,
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
      const float p = expf(fminf(fmaxf(s, -80.f), 80.f));
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
  // l >= N * exp(-80) > 0: no zero guard, as in the TPU kernel.
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
}

template <typename T, int DHT>
void launch(const void* qkv, const void* mask, void* out, int b, int n, int h,
            int dh, int mask_kind, long long sb, long long sh, float scale,
            float mask_value, cudaStream_t stream) {
  const dim3 grid((n + kRows - 1) / kRows, h, b);
  packed_attention_kernel<T, DHT><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(qkv), mask, static_cast<T*>(out), n, h, dh,
      mask_kind, sb, sh, scale, mask_value);
}

// The shaved probabilities of one 64-key tile, p = exp(clip(s * scale with
// the mask, +-80)) rounded to bf16, as the A fragments of P.V (k-step kk:
// n-tiles 2kk and 2kk + 1).  Computed in log2 units: x = s * scale * log2e
// (the additive mask times log2e, a masked bool entry at mask_value's
// clipped image), clipped at +-80 * log2e, p = exp2(x).  EDGE: the last,
// partial tile, whose keys past n weigh exactly 0.
template <bool EDGE, int NT>
__device__ __forceinline__ void shaved_probs(
    uint32_t (&pa)[NT / 2][4], const float (&s)[NT][4], int kv0, int tq, int n,
    const int (&irow)[2], int mask_kind, const uint8_t* mb, const float* mf,
    long long moff, float c2, float masked) {
  constexpr float kClip = 80.f * kLog2e;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = irow[r];
      float p[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = kv0 + j * 8 + 2 * tq + u;
        float x = s[j][2 * r + u] * c2;
        if (mask_kind != kNoMask && (!EDGE || col < n) && i < n) {
          const long long at = moff + static_cast<long long>(i) * n + col;
          if (mask_kind == kBoolMask) {
            if (!mb[at]) x = masked;
          } else {
            x = fmaf(mf[at], kLog2e, x);
          }
        }
        p[u] = exp2f(fminf(fmaxf(x, -kClip), kClip));
        if (EDGE && col >= n) p[u] = 0.f;  // not exp(-80)
      }
      pa[j / 2][(j & 1) * 2 + r] = pack_bf16(p[0], p[1]);
    }
  }
}

// One block = (64 query rows, head, image), 4 warps of 16 rows; bf16 only.
template <int DHT>
__global__ void __launch_bounds__(kMmaThreads)
packed_mma_kernel(const bf16* __restrict__ qkv, const void* __restrict__ mask,
                  bf16* __restrict__ out, int n, int h_count, int dh,
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
  const float c2 = scale * kLog2e;
  // a masked bool entry: mask_value clipped, in log2 units (mask_value *
  // log2e may overflow to -inf: the clip takes it to -80 * log2e)
  const float masked = fminf(fmaxf(mask_value * kLog2e, -80.f * kLog2e), 80.f * kLog2e);

  Resident<DHT> qf;
  float o[OT][4];
  zero_acc(o);
  float l[4] = {0.f, 0.f, 0.f, 0.f};  // row sums: l[0] row g, l[2] row g + 8

  // a warp whose 16 rows all lie past n (the last query tile) only helps
  // to copy the tiles
  const bool idle = row0 + warp * 16 >= n;
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) load_kv(t + 1);  // its stage was freed at t - 1's end
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and q) has landed for this thread
    __syncthreads();     // ... and for every thread
    const bf16* ks = ring + (t & 1) * 2 * KT * LD;
    const bf16* vs = ks + KT * LD;
    const int kv0 = t * KT;
    auto tile = [&](auto edge) {
      constexpr bool EDGE = decltype(edge)::value;
      // 16-key blocks holding keys below n: all 4 but in the last tile
      const int n16 = EDGE ? (n - kv0 + 15) / 16 : KT / 16;
      float s[NT][4];
      product_t<DHT, KT>(s, qf, ks, lane, n16);
      uint32_t pa[NT / 2][4];
      shaved_probs<EDGE, NT>(pa, s, kv0, tq, n, irow, mask_kind, mb, mf, moff, c2, masked);
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        if (kk >= n16) break;  // p = 0 past n
        pv_step<DHT>(o, pa[kk], vs, kk, lane);  // O += P.V
        mma_bf16(l, pa[kk], kOnes2, kOnes2);    // l += the rounded p's row sums
      }
    };
    if (!idle) {
      if (t == 0) qf.load(qs + warp * 16 * LD, lane);
      if (kv0 + KT <= n) {
        tile(Edge<false>{});
      } else {
        tile(Edge<true>{});
      }
    }
    __syncthreads();  // this stage is consumed: t + 1 may refill it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = l[2 * r];
    const int i = irow[r];
    if (i >= n) continue;  // (every row of an idle warp)
    bf16* orow = out + (static_cast<long long>(b) * n + i) * d + h * dh;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int col = j * 8 + 2 * tq;
      if (col < dh)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(o[j][2 * r] / lr, o[j][2 * r + 1] / lr);
    }
  }
}

template <int DHT>
cudaError_t launch_mma(const void* qkv, const void* mask, void* out, int b,
                       int n, int h, int dh, int mask_kind, long long sb,
                       long long sh, float scale, float mask_value,
                       cudaStream_t stream) {
  const int bytes = (kMmaRows + 4 * kMmaTile) * mma_ld<DHT>() *
                    static_cast<int>(sizeof(bf16));
  static std::atomic<unsigned long long> smem_set{0};  // this instantiation's
  const cudaError_t err = hopper::allow_smem_once(packed_mma_kernel<DHT>, bytes, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kMmaRows - 1) / kMmaRows, h, b);
  packed_mma_kernel<DHT><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const bf16*>(qkv), mask, static_cast<bf16*>(out), n, h, dh,
      mask_kind, sb, sh, scale, mask_value);
  return cudaGetLastError();
}

// The wgmma route (head size 64): q, k and v are the packed qkv's
// [B, H, N, 64] views at element offsets 0, D and 2D (image stride N*3D,
// head stride 64, row stride 3D); out is packed [B, N, D] at column h*64.
cudaError_t launch_wgmma(const void* qkv, const void* mask, void* out, int b, int n,
                         int h, int mask_kind, long long sb, long long sh, float scale,
                         float mask_value, cudaStream_t stream) {
  const long long d = 64LL * h;
  const long long row = 3 * d;
  const long long st[9] = {n * row, 64, row, n * row, 64, row, n * row, 64, row};
  const bf16* base = static_cast<const bf16*>(qkv);
  QkvMaps maps;
  const cudaError_t err = map_qkv(&maps, base, base + d, base + 2 * d, b, h, n, n, st);
  if (err != cudaSuccess) return err;
  const AttnArgs a{mask, static_cast<bf16*>(out), nullptr, n * d, 64, d, sb, sh, n,
                   b, h, n, n, mask_kind, scale, mask_value};
  return launch_attn_wgmma<kShaved>(maps, a, stream);
}

// bf16 on the tensor cores: wgmma at head size 64, else the mma.sync kernel
// of dh's bucket.
cudaError_t dispatch_mma(const void* qkv, const void* mask, void* out, int b,
                         int n, int h, int dh, int mask_kind, long long sb,
                         long long sh, float scale, float mask_value,
                         cudaStream_t stream) {
  if (dh == 64)
    return launch_wgmma(qkv, mask, out, b, n, h, mask_kind, sb, sh, scale, mask_value, stream);
  if (dh <= 16)
    return launch_mma<16>(qkv, mask, out, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  if (dh <= 32)
    return launch_mma<32>(qkv, mask, out, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  if (dh <= 64)
    return launch_mma<64>(qkv, mask, out, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  return launch_mma<128>(qkv, mask, out, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
}

template <typename T>
void dispatch(const void* qkv, const void* mask, void* out, int b, int n, int h,
             int dh, int mask_kind, long long sb, long long sh, float scale,
             float mask_value, cudaStream_t stream) {
  if (dh <= 16) {
    launch<T, 16>(qkv, mask, out, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  } else if (dh <= 32) {
    launch<T, 32>(qkv, mask, out, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  } else if (dh <= 64) {
    launch<T, 64>(qkv, mask, out, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  } else {
    launch<T, 128>(qkv, mask, out, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  }
}

}  // namespace
}  // namespace msvit

extern "C" {

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  mask_kind: 0 none, 1 bool (one byte
// per entry), 2 additive float32; mask_sb / mask_sh are the mask's image
// and head strides in elements (0 where broadcast), its last two dims
// contiguous [N, N].  Returns cudaGetLastError() after the launch.
int msvit_packed_attention(const void* qkv, const void* mask, void* out,
                           int dtype, int b, int n, int h, int dh,
                           int mask_kind, long long mask_sb, long long mask_sh,
                           float scale, float mask_value, void* stream) {
  if (dh <= 0 || dh > 128 || dh % 8 != 0 || n <= 0 || b <= 0 || h <= 0 ||
      b > 65535 || h > 65535 || mask_kind < 0 || mask_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    msvit::dispatch<float>(qkv, mask, out, b, n, h, dh, mask_kind, mask_sb,
                           mask_sh, scale, mask_value, s);
  } else if (dtype == 1) {
    return static_cast<int>(msvit::dispatch_mma(qkv, mask, out, b, n, h, dh,
                                                mask_kind, mask_sb, mask_sh,
                                                scale, mask_value, s));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* msvit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
