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
// bf16 at head size 64 (packed_lse_wgmma_kernel; every zoo trunk but
// vit-h14): Hopper's warpgroup products fed by TMA, warp-specialised.  The
// mma.sync kernel below issued small synchronous products from 4 warps
// that each stalled on ldmatrix and issued the copies they then waited on
// (a two-stage cp.async ring): 10-17% of the bound at 785 tokens.  Here a
// block of 384 threads takes 128 query rows of one (head, image): two
// consumer warpgroups of 64 rows and one producer warpgroup, of which one
// thread issues every load.  setmaxnreg hands the producer's registers (40
// a thread) to the consumers (232), but ptxas still fits the consumers'
// code in the launch's 168 (K2's dK/dV kernel spilled the same at 232 and
// at 240), so each warpgroup keeps its live registers under that.  TMA copies
// Q once and the 64-key K and V tiles through a 4-stage ring with
// full/empty mbarriers, from a 3-D tensor map over the packed [B, N, 3D]
// qkv (row pitch 3D*2 bytes, box (64, 64, 1) at column h*dh, D + h*dh,
// 2D + h*dh, 128-byte swizzle): a tile past N is zero-filled inside its
// own image.  Per tile each consumer warpgroup runs S = Q.K^T as 4
// wgmma.m64n64k16 from shared memory (both K-major), reads the mask (bool
// or additive, whose rows N = 197 or 785 are not 16-byte pitches TMA could
// take) straight into the accumulator's layout while the product runs,
// takes the online softmax on the accumulator (2^x as one ex2.approx.ftz:
// a p below 2^-126 is 0), rounds p to bf16 in registers and feeds it as
// the register A operand of O += P.V (V as the transposed B from shared
// memory): P never goes through shared memory.  S of tile t is issued
// beside P.V of tile t - 1, so one warpgroup's products run during its own
// softmax and the other's.  The epilogue writes out packed at column h*dh
// and the lse; rows past N are never written.
//
// Other bf16 head sizes (packed_lse_mma_kernel): the FlashAttention-2
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
// memory.
//
// The route is the entry point's: bf16 at dh 64 takes the wgmma kernel,
// other bf16 head sizes the mma.sync kernel, f32 the CUDA cores; there is
// no fallback between them (a qkv TMA cannot map is refused).
//
// f32 (packed_attention_lse_kernel): one thread per query row on the CUDA
// cores in f32 FMAs (TF32 would break the f32 bars).  One pass over the kv
// tiles with an online softmax; the running max m starts at -INFINITY;
// when a score passes it, l and the accumulator are rescaled by
// exp(m_old - m_new), which is 0 on the first score and never forms
// -inf - -inf.  k/v tiles are staged once per block in shared memory
// (coalesced 16-byte loads) and read by all 64 query rows as broadcasts.

#include "common.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------- wgmma route --

constexpr int kWgRows = 128;  // query rows a block (two warpgroups of 64)
constexpr int kWgStages = 4;  // K/V ring depth

__host__ __device__ constexpr int lse_wgmma_smem_bytes() {
  // Q [128][64], the K and V rings, the barriers; 1 KB of alignment slack
  return 2 * hopper::kTileBytes + 2 * kWgStages * hopper::kTileBytes +
         (1 + 3 * kWgStages) * 8 + 1024;
}

// The online softmax of one tile on its score accumulator: scale, mask,
// ragged edge, the new row max (m), p = exp(s - m) in place of the
// scores, l rescaled and summed from the unrounded p; returns in corr the
// factors O must be rescaled by.  PLAIN: no mask and every key inside the
// image (all tiles but the last, unmasked), so no test per score.
template <bool PLAIN>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], const float (&mv)[32],
                                             int mask_kind, int kv0, int n, int tq,
                                             float scale, float mask_value,
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = kv0 + j * 8 + 2 * tq + (e & 1);
      float v = sc[4 * j + e] * scale;
      if (PLAIN) {
      } else if (col >= n) {
        v = -INFINITY;
      } else if (mask_kind == kBoolMask) {
        v = mv[4 * j + e] != 0.f ? v : mask_value;
      } else if (mask_kind == kAddMask) {
        v += mv[4 * j + e];
      }
      sc[4 * j + e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
  }
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    // exp(-inf) = 0 rescales the empty start; an all -inf row keeps m at
    // -inf and subtracts 0, never -inf - -inf
    mu[r] = mx[r] == -INFINITY ? 0.f : mx[r];
    corr[r] = hopper::ex2((m[r] - mu[r]) * kLog2e);
    m[r] = mx[r];
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = hopper::ex2((sc[4 * j + e] - mu[e >> 1]) * kLog2e);
      l[e >> 1] += p;  // the unrounded p
      sc[4 * j + e] = p;
    }
  }
}

// One block = (128 query rows, head, image); bf16, head size 64.  Per
// consumer warpgroup the products of two tiles overlap the softmax: S of
// tile t runs beside O += P.V of tile t - 1 while the thread waits for S,
// and the softmax of tile t runs while P.V of tile t - 1 finishes; only
// O's rescale waits for it.
__global__ void __launch_bounds__(hopper::kThreads, 1)
packed_lse_wgmma_kernel(const __grid_constant__ CUtensorMap qkv_map,
                        const void* __restrict__ mask, bf16* __restrict__ out,
                        float* __restrict__ lse, int n, int h_count,
                        int mask_kind, long long mask_sb, long long mask_sh,
                        float scale, float mask_value) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(smem);    // [128][64]
  bf16* ks = qs + 2 * 64 * 64;                 // [stages][64][64]
  bf16* vs = ks + kWgStages * 64 * 64;         // [stages][64][64]
  uint64_t* qfull = reinterpret_cast<uint64_t*>(vs + kWgStages * 64 * 64);
  uint64_t* kfull = qfull + 1;
  uint64_t* vfull = kfull + kWgStages;
  uint64_t* empty = vfull + kWgStages;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kWgRows;
  const int d = h_count * 64;
  const int tiles = (n + 63) / 64;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(kfull + s, 1);
      mbar_init(vfull + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup, provably uniform across each warp (the role branch below)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == 2) {  // the producer: one thread issues every copy
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(qfull, 2 * kTileBytes);
      tma_load_3d(qs, &qkv_map, qfull, h * 64, row0, b);
      tma_load_3d(qs + 64 * 64, &qkv_map, qfull, h * 64, row0 + 64, b);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % kWgStages;
        mbar_wait(empty + s, ((t / kWgStages) & 1) ^ 1);
        mbar_expect_tx(kfull + s, kTileBytes);
        tma_load_3d(ks + s * 64 * 64, &qkv_map, kfull + s, d + h * 64, t * 64, b);
        mbar_expect_tx(vfull + s, kTileBytes);
        tma_load_3d(vs + s * 64 * 64, &qkv_map, vfull + s, 2 * d + h * 64, t * 64, b);
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x / 32) % 4;
    const int tq = lane % 4;
    // this thread's two accumulator rows
    const int i_lo = row0 + wg * 64 + warp * 16 + lane / 4;
    const int irow[2] = {i_lo, i_lo + 8};
    const long long moff = b * mask_sb + h * mask_sh;
    const uint64_t dq = desc(qs + wg * 64 * 64);

    float o[32], sc[32], mv[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      o[e] = 0.f;
      sc[e] = 0.f;
      mv[e] = 0.f;
    }
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this lane's part of the row sums
    float corr[2];
    uint32_t pa[4][4];  // p of the previous tile in bf16: the A operand of 4 k-steps
    auto softmax = [&](int kv0) {
      if (mask_kind == kNoMask && kv0 + 64 <= n)
        softmax_tile<true>(sc, mv, mask_kind, kv0, n, tq, scale, mask_value, m, l, corr);
      else
        softmax_tile<false>(sc, mv, mask_kind, kv0, n, tq, scale, mask_value, m, l, corr);
    };
    mbar_wait(qfull, 0);

    // tile 0: S, then its softmax
    mbar_wait(kfull, 0);
    fence_acc(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc, dq + kstep_k(kk), desc(ks) + kstep_k(kk), kk);
    wgmma_commit();
    if (mask_kind != kNoMask) load_mask_tile(mv, mask_kind, mask, moff, irow, 0, n, tq);
    wgmma_wait<0>();
    fence_acc(sc);
    softmax(0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(pa[kk], sc, kk);

    for (int t = 1; t < tiles; ++t) {
      const int s = t % kWgStages;
      const int sp = (t - 1) % kWgStages;  // the previous tile's stage
      mbar_wait(kfull + s, (t / kWgStages) & 1);
      mbar_wait(vfull + sp, ((t - 1) / kWgStages) & 1);
      fence_acc(sc);
      fence_acc(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(sc, dq + kstep_k(kk), desc(ks + s * 64 * 64) + kstep_k(kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_t(o, pa[kk], desc(vs + sp * 64 * 64) + kstep_mn(kk));
      wgmma_commit();
      if (mask_kind != kNoMask) load_mask_tile(mv, mask_kind, mask, moff, irow, t * 64, n, tq);
      wgmma_wait<1>();  // S of tile t
      fence_acc(sc);
      softmax(t * 64);
      wgmma_wait<0>();  // P.V of tile t - 1
      fence_acc(o);
      if (lane == 0) mbar_arrive(empty + sp);  // this warp is done with its stage
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(pa[kk], sc, kk);
    }

    // P.V of the last tile
    const int sl = (tiles - 1) % kWgStages;
    mbar_wait(vfull + sl, ((tiles - 1) / kWgStages) & 1);
    fence_acc(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_t(o, pa[kk], desc(vs + sl * 64 * 64) + kstep_mn(kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = row_sum<4>(l[r]);
      const int i = irow[r];
      if (i < n) {
        bf16* orow = out + (static_cast<long long>(b) * n + i) * d + h * 64;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * tq) =
              pack_bf16(o[4 * j + 2 * r] / lr, o[4 * j + 2 * r + 1] / lr);
        if (tq == 0)
          lse[(static_cast<long long>(b) * h_count + h) * n + i] = m[r] + logf(lr);
      }
    }
  }
}

std::atomic<unsigned long long> lse_wgmma_smem_set{0};

cudaError_t launch_wgmma(const void* qkv, const void* mask, void* out,
                         void* lse, int b, int n, int h, int mask_kind,
                         long long sb, long long sh, float scale,
                         float mask_value, cudaStream_t stream) {
  CUtensorMap map;
  cudaError_t err = hopper::map_rows(&map, qkv, b, n, 3LL * h * 64);
  if (err != cudaSuccess) return err;
  constexpr int bytes = lse_wgmma_smem_bytes();
  err = hopper::allow_smem_once(packed_lse_wgmma_kernel, bytes, lse_wgmma_smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kWgRows - 1) / kWgRows, h, b);
  packed_lse_wgmma_kernel<<<grid, hopper::kThreads, bytes, stream>>>(
      map, mask, static_cast<bf16*>(out), static_cast<float*>(lse), n, h,
      mask_kind, sb, sh, scale, mask_value);
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
  if (dh == 64)
    return launch_wgmma(qkv, mask, out, lse, b, n, h, mask_kind, sb, sh, scale, mask_value, stream);
  if (dh <= 16)
    return launch_mma<16>(qkv, mask, out, lse, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  if (dh <= 32)
    return launch_mma<32>(qkv, mask, out, lse, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  if (dh <= 64)
    return launch_mma<64>(qkv, mask, out, lse, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  return launch_mma<128>(qkv, mask, out, lse, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
}

template <int DHT>
cudaError_t mma_blocks_per_sm(int* blocks) {
  const int bytes = (kMmaRows + 4 * kMmaTile) * mma_ld<DHT>() *
                    static_cast<int>(sizeof(bf16));
  const cudaError_t err = cudaFuncSetAttribute(
      packed_lse_mma_kernel<DHT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, packed_lse_mma_kernel<DHT>,
                                                       kMmaThreads, bytes);
}

cudaError_t occupancy(int wgmma, int dh, int* blocks) {
  if (wgmma) {
    constexpr int bytes = lse_wgmma_smem_bytes();
    const cudaError_t err =
        hopper::allow_smem_once(packed_lse_wgmma_kernel, bytes, lse_wgmma_smem_set);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, packed_lse_wgmma_kernel, hopper::kThreads, bytes);
  }
  if (dh <= 16) return mma_blocks_per_sm<16>(blocks);
  if (dh <= 32) return mma_blocks_per_sm<32>(blocks);
  if (dh <= 64) return mma_blocks_per_sm<64>(blocks);
  return mma_blocks_per_sm<128>(blocks);
}

}  // namespace
}  // namespace msvit

extern "C" {

// Blocks of K1-lse's bf16 kernel resident on one SM, by the runtime's
// occupancy calculator (registers and shared memory), into *blocks:
// wgmma = 1 the wgmma kernel (head size 64), 0 the mma.sync kernel of dh's
// bucket.
int msvit_packed_attention_lse_occupancy(int wgmma, int dh, int* blocks) {
  if (dh <= 0 || dh > 128 || dh % 8 != 0 || (wgmma && dh != 64) || blocks == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(msvit::occupancy(wgmma, dh, blocks));
}

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
