// Packed-layout self-attention, training backward (bf16 / f32).
//
// Replaces the TPU kernel `msvit_tpu/ops/packed_attention.py::
// _packed_backward` (body `_kernel_packed_bwd`), and the head-grouped
// `::_packed_backward_grouped`, which computes the same on another grid.
// Same contract: from the forward's residuals (qkv [B, N, 3D], mask, out
// [B, N, D], the per-head lse [B, H, N] f32) and the output cotangent g
// [B, N, D], it rebuilds the probabilities as exp(s - lse) and runs the
// five-product attention backward per head, writing dqkv packed
// [B, N, 3D]: dq at column h*dh, dk at D + h*dh, dv at 2D + h*dh.  The
// arithmetic mirrors the TPU kernel's: delta = sum(g*o) in f32; pb =
// exp(s - lse) rounded to the compute dtype; dv = pb^T g; dp = g v^T; ds =
// pb*(dp - delta) rounded to the compute dtype; dq = ds k * scale; dk =
// ds^T q * scale.  Masks as in the forward.
//
// The TPU kernel holds one image's [N, N] panels per program and loops over
// the heads in order.  Blocks on the card run in no order, so the work is
// split the flash way, into two kernels launched in turn on one stream:
//
// * dQ: a block per (64 query rows, head, image).  It first forms delta =
//   sum(g*o) for its rows and writes it to a small f32 scratch [B, H, N];
//   then it walks the k/v tiles, recomputing s, pb, dp and ds, and
//   accumulates dq.
// * dK/dV: a block per (64 key rows, head, image).  It walks the query
//   tiles of q and g (with their lse and delta), recomputing s, pb, dp and
//   ds, and accumulates dk and dv.  It reads the delta the dQ kernel wrote,
//   so it is launched after it.
//
// Every output element is written by exactly one thread: no atomics, so
// two calls give the same bits.
//
// What bounds it on the card: operations, 2*5*N*N*dh FLOP per head (the
// split recomputes s and dp in the second kernel: 7 products in all)
// against a few N*dh elements.  The split stays: FlashAttention-3's single
// pass (5 products) adds each key tile's dq into global memory by atomics
// in an order that changes from run to run, which would break the
// same-bits property; the two extra products buy determinism.
//
// bf16 at head size 64 (packed_bwd_dq_wgmma_kernel,
// packed_bwd_dkv_wgmma_kernel; every zoo trunk but vit-h14): Hopper's
// warpgroup products fed by TMA, warp-specialised, the forward's design
// (packed_attention_lse.cu).  The mma.sync kernels below stalled each warp
// on ldmatrix before every small product, issued their own copies into a
// two-stage ring and held 240 registers at dh 64 in the dK/dV kernel
// (10-17% of the bound at 785 tokens).  Here a block of 384 threads has two
// consumer warpgroups of 64 rows and a producer warpgroup, one thread of
// which issues every TMA load (setmaxnreg as in the forward: the
// consumers' code stays within 168 registers); the tiles come from 3-D
// tensor maps over qkv [B, N, 3D] and g [B, N, D] (box (64, 64, 1) at the
// head's column, 128-byte swizzle, zero-filled past N inside the image).
// * dQ: a block per (128 query rows, head, image).  The consumers first
//   form delta = sum(g*o) for its rows and write it to the scratch; Q and
//   dO arrive once; the K/V tiles of 64 keys stream through a 4-stage
//   ring.  Per tile: S = Q.K^T and dP = dO.V^T by wgmma from shared memory
//   (K-major), pb and ds in registers, dQ += ds.K with ds the register A
//   operand and K the transposed B; S and dP of tile t run beside dQ of
//   tile t - 1, and the mask is read into the accumulators' layout while
//   they do.
// * dK/dV: a block per (128 key rows, head, image).  K and V stay in
//   shared memory; Q and dO stream through the ring by TMA, the tile's lse
//   and delta beside them (copied by the producer's warp: N f32 rows are
//   not the 16-byte pitches TMA takes, and a 1-D box at an odd offset
//   faulted).  Per tile: S^T = K.Q^T and dP^T = V.dO^T by wgmma, pb^T and
//   ds^T in registers, dV += pb^T.dO and dK += ds^T.Q with register A
//   operands.  These four accumulators leave no registers for running two
//   tiles' products at once: a warpgroup's products run one group at a
//   time, the other warpgroup's beside them.
//
// Other bf16 head sizes (packed_bwd_dq_mma_kernel,
// packed_bwd_dkv_mma_kernel): warp-level mma.sync m16n8k16 (bf16 operands,
// f32 accumulators), 4 warps of 16 rows a block.  The dQ kernel keeps its
// q and g fragments and the dq accumulator; per 64-key tile it forms S =
// Q.K^T and dP = dO.V^T, then pb and ds in registers, and dQ += ds.K.  The
// dK/dV kernel keeps its k and v fragments and the dk, dv accumulators;
// per 64-query tile it forms S^T = K.Q^T and dP^T = V.dO^T, pb^T and ds^T
// (lse and delta of the tile's queries staged beside it), then dV +=
// pb^T.dO and dK += ds^T.Q.  Each product's f32 accumulator fragment is
// rounded to bf16 where the plain version rounds (pb before dv and ds, ds
// before both its products) and paired into the A fragment of the next
// product, in registers; the transposed operands come from ldmatrix.trans,
// so neither kernel transposes in shared memory.  The streamed tiles pass
// through a two-stage ring filled by 16-byte cp.async copies (the next
// tile in flight while this one is multiplied), in dynamic shared memory
// with rows padded by 16 bytes (ldmatrix rows in distinct banks); a head
// size below its bucket is zero-padded there.  Keys and queries past N get
// s = -inf, so pb = 0 there.  At dh 128 the resident fragments would not
// fit the registers beside the accumulators: they are read from shared
// memory at each use instead.
//
// The route is the entry point's: bf16 at dh 64 takes the wgmma kernels,
// other bf16 head sizes the mma.sync kernels, f32 the CUDA cores; there is
// no fallback between them (a tensor TMA cannot map is refused).
//
// f32 (packed_bwd_dq_kernel, packed_bwd_dkv_kernel): the CUDA cores in f32
// FMAs (TF32 would break the f32 bars).  k/v (dQ) and q/g (dK/dV) tiles are
// staged in shared memory with coalesced 16-byte loads and read as
// broadcasts.  A dK/dV thread holding k, v, dk and dv at dh = 64 in f32
// would need 256 registers, so each row is split over row_threads()
// neighbouring threads (1 at dh <= 32, 2 at 64, 4 at 128), each holding a
// slice of at most 32 head elements, and the two dot products per (query,
// key) pair are summed across the slice threads with shuffles.

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace msvit {
namespace {

template <typename T, int DHT>
__global__ void __launch_bounds__(kRows * row_threads<DHT>())
packed_bwd_dq_kernel(const T* __restrict__ qkv, const void* __restrict__ mask,
                     const T* __restrict__ out, const float* __restrict__ lse,
                     const T* __restrict__ g, float* __restrict__ delta,
                     T* __restrict__ dqkv, int n, int h_count, int dh,
                     int mask_kind, long long mask_sb, long long mask_sh,
                     float scale, float mask_value) {
  using RS = RowSlice<DHT>;
  constexpr int CH = RS::kCh;
  constexpr int KV = kv_rows<T, DHT>();
  __shared__ __align__(16) T ks[KV * DHT];
  __shared__ __align__(16) T vs[KV * DHT];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const RS rs(blockIdx.x * kRows);
  const int i = rs.row;
  const bool active = i < n;
  const int d = h_count * dh;
  const long long row = 3LL * d;
  const T* img = qkv + static_cast<long long>(b) * n * row;
  const long long tok = static_cast<long long>(b) * n + i;  // [B, N] index

  float q[CH], go[CH], dq[CH];
#pragma unroll
  for (int e = 0; e < CH; ++e) {
    q[e] = 0.f;
    go[e] = 0.f;
    dq[e] = 0.f;
  }
  float dl = 0.f;  // delta = sum(g * o), this thread's part
  if (active) {
    load_slice<T, CH>(img + i * row + h * dh, rs.e0, dh, q);
    load_slice<T, CH>(g + tok * d + h * dh, rs.e0, dh, go);
    float o[CH];
    load_slice<T, CH>(out + tok * d + h * dh, rs.e0, dh, o);
#pragma unroll
    for (int e = 0; e < CH; ++e)
      if (rs.e0 + e < dh) dl = fmaf(go[e], o[e], dl);
  }
  dl = row_sum<RS::kTpr>(dl);
  const long long li = (static_cast<long long>(b) * h_count + h) * n + i;
  const float lse_i = active ? lse[li] : 0.f;
  if (active && rs.e0 == 0) delta[li] = dl;

  const uint8_t* mb = static_cast<const uint8_t*>(mask);
  const float* mf = static_cast<const float*>(mask);
  const long long moff = b * mask_sb + h * mask_sh + static_cast<long long>(i) * n;
  const int width = dh * static_cast<int>(sizeof(T));
  const long long row_bytes = row * static_cast<long long>(sizeof(T));
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
    const int cnt = min(KV, n - kv0);
    for (int j = 0; j < cnt; ++j) {
      // every lane takes part in the shuffles, active or not
      float s, dp;
      dot2<T, CH>(q, ks + j * dh, go, vs + j * dh, rs.e0, dh, s, dp);
      s = row_sum<RS::kTpr>(s);
      dp = row_sum<RS::kTpr>(dp);
      if (!active) continue;
      s = apply_mask(s * scale, mask_kind, mb, mf, moff + kv0 + j, mask_value);
      const float pb = round_to<T>(expf(s - lse_i));
      const float ds = round_to<T>(pb * (dp - dl));
      axpy<T, CH>(dq, ds, ks + j * dh, rs.e0, dh);
    }
  }
  if (active) store_slice<T, CH>(dqkv + tok * row + h * dh, rs.e0, dh, dq, scale);
}

template <typename T, int DHT>
__global__ void __launch_bounds__(kRows * row_threads<DHT>())
packed_bwd_dkv_kernel(const T* __restrict__ qkv, const void* __restrict__ mask,
                      const float* __restrict__ lse, const T* __restrict__ g,
                      const float* __restrict__ delta, T* __restrict__ dqkv,
                      int n, int h_count, int dh, int mask_kind,
                      long long mask_sb, long long mask_sh, float scale,
                      float mask_value) {
  using RS = RowSlice<DHT>;
  constexpr int CH = RS::kCh;
  constexpr int QT = kv_rows<T, DHT>();  // query rows per staged tile
  __shared__ __align__(16) T qs[QT * DHT];
  __shared__ __align__(16) T gs[QT * DHT];
  __shared__ float lses[QT];
  __shared__ float deltas[QT];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const RS rs(blockIdx.x * kRows);
  const int j = rs.row;  // this thread's key row
  const bool active = j < n;
  const int d = h_count * dh;
  const long long row = 3LL * d;
  const T* img = qkv + static_cast<long long>(b) * n * row;
  const T* gimg = g + static_cast<long long>(b) * n * d;
  const long long stat0 = (static_cast<long long>(b) * h_count + h) * n;

  float k[CH], v[CH], dk[CH], dv[CH];
#pragma unroll
  for (int e = 0; e < CH; ++e) {
    k[e] = 0.f;
    v[e] = 0.f;
    dk[e] = 0.f;
    dv[e] = 0.f;
  }
  if (active) {
    load_slice<T, CH>(img + j * row + d + h * dh, rs.e0, dh, k);
    load_slice<T, CH>(img + j * row + 2 * d + h * dh, rs.e0, dh, v);
  }
  const uint8_t* mb = static_cast<const uint8_t*>(mask);
  const float* mf = static_cast<const float*>(mask);
  const long long moff = b * mask_sb + h * mask_sh + j;  // column j
  const int width = dh * static_cast<int>(sizeof(T));
  for (int i0 = 0; i0 < n; i0 += QT) {
    __syncthreads();  // the previous tile is consumed
    stage_tile<uint4>(reinterpret_cast<char*>(qs),
                      reinterpret_cast<const char*>(img),
                      row * static_cast<long long>(sizeof(T)),
                      static_cast<long long>(h * dh) * sizeof(T), width, i0,
                      QT, n);
    stage_tile<uint4>(reinterpret_cast<char*>(gs),
                      reinterpret_cast<const char*>(gimg),
                      static_cast<long long>(d) * sizeof(T),
                      static_cast<long long>(h * dh) * sizeof(T), width, i0,
                      QT, n);
    for (int r = threadIdx.x; r < QT; r += blockDim.x) {
      const bool in = i0 + r < n;
      lses[r] = in ? lse[stat0 + i0 + r] : 0.f;
      deltas[r] = in ? delta[stat0 + i0 + r] : 0.f;
    }
    __syncthreads();
    const int cnt = min(QT, n - i0);
    for (int r = 0; r < cnt; ++r) {
      const T* qr = qs + r * dh;
      const T* gr = gs + r * dh;
      float s, dp;
      dot2<T, CH>(k, qr, v, gr, rs.e0, dh, s, dp);
      s = row_sum<RS::kTpr>(s);
      dp = row_sum<RS::kTpr>(dp);
      if (!active) continue;
      s = apply_mask(s * scale, mask_kind, mb, mf,
                     moff + static_cast<long long>(i0 + r) * n, mask_value);
      const float pb = round_to<T>(expf(s - lses[r]));
      axpy<T, CH>(dv, pb, gr, rs.e0, dh);
      const float ds = round_to<T>(pb * (dp - deltas[r]));
      axpy<T, CH>(dk, ds, qr, rs.e0, dh);
    }
  }
  if (!active) return;
  T* o = dqkv + (static_cast<long long>(b) * n + j) * row;
  store_slice<T, CH>(o + d + h * dh, rs.e0, dh, dk, scale);
  store_slice<T, CH>(o + 2 * d + h * dh, rs.e0, dh, dv, 1.f);
}

template <typename T, int DHT>
int launch(const void* qkv, const void* mask, const void* out,
           const void* lse, const void* g, void* delta, void* dqkv, int b,
           int n, int h, int dh, int mask_kind, long long sb, long long sh,
           float scale, float mask_value, cudaStream_t stream) {
  const dim3 grid((n + kRows - 1) / kRows, h, b);
  const int threads = kRows * row_threads<DHT>();
  packed_bwd_dq_kernel<T, DHT><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(qkv), mask, static_cast<const T*>(out),
      static_cast<const float*>(lse), static_cast<const T*>(g),
      static_cast<float*>(delta), static_cast<T*>(dqkv), n, h, dh, mask_kind,
      sb, sh, scale, mask_value);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_bwd_dkv_kernel<T, DHT><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(qkv), mask, static_cast<const float*>(lse),
      static_cast<const T*>(g), static_cast<const float*>(delta),
      static_cast<T*>(dqkv), n, h, dh, mask_kind, sb, sh, scale, mask_value);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* qkv, const void* mask, const void* out,
             const void* lse, const void* g, void* delta, void* dqkv, int b,
             int n, int h, int dh, int mask_kind, long long sb, long long sh,
             float scale, float mask_value, cudaStream_t stream) {
  if (dh <= 16)
    return launch<T, 16>(qkv, mask, out, lse, g, delta, dqkv, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  if (dh <= 32)
    return launch<T, 32>(qkv, mask, out, lse, g, delta, dqkv, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  if (dh <= 64)
    return launch<T, 64>(qkv, mask, out, lse, g, delta, dqkv, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  return launch<T, 128>(qkv, mask, out, lse, g, delta, dqkv, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
}

template <int DHT>
__host__ __device__ constexpr int dq_smem_bytes() {
  // q, g; the k/v ring; delta of the block's rows
  return (2 * kMmaRows + 4 * kMmaTile) * mma_ld<DHT>() * 2 + kMmaRows * 4;
}

template <int DHT>
__host__ __device__ constexpr int dkv_smem_bytes() {
  // k, v; the q/g ring; lse and delta of each ring stage
  return (2 * kMmaRows + 4 * kMmaTile) * mma_ld<DHT>() * 2 + 4 * kMmaTile * 4;
}

template <int DHT>
__global__ void __launch_bounds__(kMmaThreads)
packed_bwd_dq_mma_kernel(const bf16* __restrict__ qkv,
                         const void* __restrict__ mask,
                         const bf16* __restrict__ out,
                         const float* __restrict__ lse,
                         const bf16* __restrict__ g, float* __restrict__ delta,
                         bf16* __restrict__ dqkv, int n, int h_count, int dh,
                         int mask_kind, long long mask_sb, long long mask_sh,
                         float scale, float mask_value) {
  constexpr int LD = mma_ld<DHT>();
  constexpr int KT = kMmaTile;
  constexpr int NT = KT / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [64][LD]
  bf16* gs = qs + kMmaRows * LD;             // [64][LD]
  bf16* ring = gs + kMmaRows * LD;           // [2][k, v][KT][LD]
  float* dls = reinterpret_cast<float*>(ring + 4 * KT * LD);  // [64]
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kMmaRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tq = lane % 4;
  const int d = h_count * dh;
  const long long row = 3LL * d;
  const bf16* img = qkv + static_cast<long long>(b) * n * row;
  const long long tok0 = static_cast<long long>(b) * n;  // [B, N] index of row 0
  const long long stat0 = (static_cast<long long>(b) * h_count + h) * n;

  if (dh < DHT) {
    zero_smem(smem, (2 * kMmaRows + 4 * KT) * LD * static_cast<int>(sizeof(bf16)));
    __syncthreads();
  }
  const int tiles = (n + KT - 1) / KT;
  auto load_kv = [&](int t) {
    bf16* ks = ring + (t & 1) * 2 * KT * LD;
    async_tile<LD>(ks, img + d + h * dh, row, t * KT, KT, n, dh);
    async_tile<LD>(ks + KT * LD, img + 2 * d + h * dh, row, t * KT, KT, n, dh);
  };
  async_tile<LD>(qs, img + h * dh, row, row0, kMmaRows, n, dh);
  async_tile<LD>(gs, g + tok0 * d + h * dh, d, row0, kMmaRows, n, dh);
  load_kv(0);
  cp_async_commit();

  // delta = sum(g * o) in f32: two threads a row, written once
  {
    const int r = threadIdx.x / 2;
    const int i = row0 + r;
    float dl = 0.f;
    if (i < n) {
      const bf16* gr = g + (tok0 + i) * d + h * dh;
      const bf16* orow = out + (tok0 + i) * d + h * dh;
      for (int e = (threadIdx.x % 2) * 8; e < dh; e += 16) {
        float gf[8], of[8];
        Vec8<bf16>::load(gr + e, gf);
        Vec8<bf16>::load(orow + e, of);
#pragma unroll
        for (int u = 0; u < 8; ++u) dl = fmaf(gf[u], of[u], dl);
      }
    }
    dl += __shfl_xor_sync(0xffffffffu, dl, 1);
    if (threadIdx.x % 2 == 0) {
      dls[r] = dl;
      if (i < n) delta[stat0 + i] = dl;
    }
  }

  const int r_lo = warp * 16 + lane / 4;  // this thread's rows in the block
  const int irow[2] = {row0 + r_lo, row0 + r_lo + 8};
  float lse_r[2];  // lse of the two rows (0 past N)
#pragma unroll
  for (int r = 0; r < 2; ++r) lse_r[r] = irow[r] < n ? lse[stat0 + irow[r]] : 0.f;
  const uint8_t* mb = static_cast<const uint8_t*>(mask);
  const float* mf = static_cast<const float*>(mask);
  const long long moff = b * mask_sb + h * mask_sh;

  Resident<DHT> qf, gf;
  float dl[2];
  float dq[DHT / 8][4];
  zero_acc(dq);

  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) load_kv(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
      qf.load(qs + warp * 16 * LD, lane);
      gf.load(gs + warp * 16 * LD, lane);
      dl[0] = dls[r_lo];
      dl[1] = dls[r_lo + 8];
    }
    const bf16* ks = ring + (t & 1) * 2 * KT * LD;
    const bf16* vs = ks + KT * LD;
    const int kv0 = t * KT;
    float s[NT][4], dp[NT][4];
    product_t<DHT, KT>(s, qf, ks, lane);
    product_t<DHT, KT>(dp, gf, vs, lane);
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
        // (s - lse) first: mask_value * log2(e) would overflow to -inf
        const float pb = round_to<bf16>(exp2f((v - lse_r[e >> 1]) * kLog2e));
        s[j][e] = round_to<bf16>(pb * (dp[j][e] - dl[e >> 1]));  // ds
      }
    }
    product_acc<DHT, KT>(dq, s, ks, lane);
    __syncthreads();
  }
  store_rows<DHT>(dqkv + tok0 * row + h * dh, row, dq, row0 + r_lo, n, dh, tq, scale);
}

template <int DHT>
__global__ void __launch_bounds__(kMmaThreads)
packed_bwd_dkv_mma_kernel(const bf16* __restrict__ qkv,
                          const void* __restrict__ mask,
                          const float* __restrict__ lse,
                          const bf16* __restrict__ g,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dqkv, int n, int h_count, int dh,
                          int mask_kind, long long mask_sb, long long mask_sh,
                          float scale, float mask_value) {
  constexpr int LD = mma_ld<DHT>();
  constexpr int QT = kMmaTile;  // query rows per staged tile
  constexpr int NT = QT / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [64][LD]
  bf16* vs = ks + kMmaRows * LD;             // [64][LD]
  bf16* ring = vs + kMmaRows * LD;           // [2][q, g][QT][LD]
  float* stats = reinterpret_cast<float*>(ring + 4 * QT * LD);  // [2][lse, delta][QT]
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kMmaRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tq = lane % 4;
  const int d = h_count * dh;
  const long long row = 3LL * d;
  const bf16* img = qkv + static_cast<long long>(b) * n * row;
  const bf16* gimg = g + static_cast<long long>(b) * n * d;
  const long long stat0 = (static_cast<long long>(b) * h_count + h) * n;

  if (dh < DHT) {
    zero_smem(smem, (2 * kMmaRows + 4 * QT) * LD * static_cast<int>(sizeof(bf16)));
    __syncthreads();
  }
  const int tiles = (n + QT - 1) / QT;
  auto load_q = [&](int t) {
    const int st = t & 1;
    bf16* qt = ring + st * 2 * QT * LD;
    async_tile<LD>(qt, img + h * dh, row, t * QT, QT, n, dh);
    async_tile<LD>(qt + QT * LD, gimg + h * dh, d, t * QT, QT, n, dh);
    // lse and delta of the tile's queries, 0 past N
    for (int c = threadIdx.x; c < 2 * QT; c += blockDim.x) {
      const int r = c % QT;
      const bool ok = t * QT + r < n;
      const float* src = (c < QT ? lse : delta) + stat0 + (ok ? t * QT + r : 0);
      cp_async4(stats + st * 2 * QT + c, src, ok);
    }
  };
  async_tile<LD>(ks, img + d + h * dh, row, row0, kMmaRows, n, dh);
  async_tile<LD>(vs, img + 2 * d + h * dh, row, row0, kMmaRows, n, dh);
  load_q(0);
  cp_async_commit();

  const int r_lo = warp * 16 + lane / 4;
  const int jrow[2] = {row0 + r_lo, row0 + r_lo + 8};  // this thread's keys
  const uint8_t* mb = static_cast<const uint8_t*>(mask);
  const float* mf = static_cast<const float*>(mask);
  const long long moff = b * mask_sb + h * mask_sh;

  Resident<DHT> kf, vf;
  float dk[DHT / 8][4], dv[DHT / 8][4];
  zero_acc(dk);
  zero_acc(dv);

  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) load_q(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
      kf.load(ks + warp * 16 * LD, lane);
      vf.load(vs + warp * 16 * LD, lane);
    }
    const bf16* qt = ring + (t & 1) * 2 * QT * LD;
    const bf16* gt = qt + QT * LD;
    const float* lses = stats + (t & 1) * 2 * QT;
    const float* dels = lses + QT;
    const int i0 = t * QT;
    float s[NT][4], dp[NT][4];
    product_t<DHT, QT>(s, kf, qt, lane);   // s^T: keys by queries
    product_t<DHT, QT>(dp, vf, gt, lane);  // dp^T
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * tq + (e & 1);  // query within the tile
        const int i = i0 + c;
        const int key = jrow[e >> 1];
        float v = s[j][e] * scale;
        if (i >= n || key >= n) {
          v = -INFINITY;
        } else if (mask_kind != kNoMask) {
          v = apply_mask(v, mask_kind, mb, mf,
                         moff + static_cast<long long>(i) * n + key, mask_value);
        }
        const float pb = round_to<bf16>(exp2f((v - lses[c]) * kLog2e));
        s[j][e] = pb;
        dp[j][e] = round_to<bf16>(pb * (dp[j][e] - dels[c]));  // ds^T
      }
    }
    product_acc<DHT, QT>(dv, s, gt, lane);
    product_acc<DHT, QT>(dk, dp, qt, lane);
    __syncthreads();
  }
  bf16* base = dqkv + static_cast<long long>(b) * n * row + h * dh;
  store_rows<DHT>(base + d, row, dk, row0 + r_lo, n, dh, tq, scale);
  store_rows<DHT>(base + 2 * d, row, dv, row0 + r_lo, n, dh, tq, 1.f);
}

template <int DHT>
int launch_mma(const void* qkv, const void* mask, const void* out,
               const void* lse, const void* g, void* delta, void* dqkv, int b,
               int n, int h, int dh, int mask_kind, long long sb,
               long long sh, float scale, float mask_value,
               cudaStream_t stream) {
  constexpr int dq_bytes = dq_smem_bytes<DHT>();
  constexpr int dkv_bytes = dkv_smem_bytes<DHT>();
  cudaError_t err = cudaFuncSetAttribute(packed_bwd_dq_mma_kernel<DHT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         dq_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(packed_bwd_dkv_mma_kernel<DHT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kMmaRows - 1) / kMmaRows, h, b);
  packed_bwd_dq_mma_kernel<DHT><<<grid, kMmaThreads, dq_bytes, stream>>>(
      static_cast<const bf16*>(qkv), mask, static_cast<const bf16*>(out),
      static_cast<const float*>(lse), static_cast<const bf16*>(g),
      static_cast<float*>(delta), static_cast<bf16*>(dqkv), n, h, dh,
      mask_kind, sb, sh, scale, mask_value);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_bwd_dkv_mma_kernel<DHT><<<grid, kMmaThreads, dkv_bytes, stream>>>(
      static_cast<const bf16*>(qkv), mask, static_cast<const float*>(lse),
      static_cast<const bf16*>(g), static_cast<const float*>(delta),
      static_cast<bf16*>(dqkv), n, h, dh, mask_kind, sb, sh, scale,
      mask_value);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------- wgmma route --

constexpr int kWgRows = 128;  // rows a block (two warpgroups of 64)
constexpr int kWgStages = 4;  // ring depth

__host__ __device__ constexpr int dq_wgmma_smem_bytes() {
  // Q and dO [128][64]; the K and V rings; delta of the block's rows; the
  // barriers; 1 KB of alignment slack
  return 4 * hopper::kTileBytes + 2 * kWgStages * hopper::kTileBytes +
         kWgRows * 4 + (1 + 3 * kWgStages) * 8 + 1024;
}

__host__ __device__ constexpr int dkv_wgmma_smem_bytes() {
  // K and V [128][64]; the Q and dO rings; lse and delta of each stage;
  // the barriers; 1 KB of alignment slack
  return 4 * hopper::kTileBytes + 2 * kWgStages * hopper::kTileBytes +
         kWgStages * 2 * 64 * 4 + (1 + 2 * kWgStages) * 8 + 1024;
}

// ds = round(pb * (dp - delta)) with pb = round(exp(s - lse)) of one
// 64-key tile of the dQ kernel, in place of the scores (the mask's entries
// in mv: bool 1 = attend).  PLAIN: no mask and every key inside the image.
template <bool PLAIN>
__device__ __forceinline__ void ds_tile(float (&sc)[32], const float (&dp)[32],
                                        const float (&mv)[32], int mask_kind,
                                        const int (&irow)[2], const float (&lse_r)[2],
                                        const float (&dl)[2], int kv0, int n, int tq,
                                        float scale, float mask_value) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = kv0 + j * 8 + 2 * tq + (e & 1);
      const int i = irow[e >> 1];
      float v = sc[4 * j + e] * scale;
      if (PLAIN) {
      } else if (col >= n) {
        v = -INFINITY;
      } else if (i < n && mask_kind == kBoolMask) {
        v = mv[4 * j + e] != 0.f ? v : mask_value;
      } else if (i < n && mask_kind == kAddMask) {
        v += mv[4 * j + e];
      }
      // (s - lse) first: mask_value * log2(e) would overflow to -inf
      const float pb = round_to<bf16>(hopper::ex2((v - lse_r[e >> 1]) * kLog2e));
      sc[4 * j + e] = round_to<bf16>(pb * (dp[4 * j + e] - dl[e >> 1]));
    }
  }
}

// One block = (128 query rows, head, image); bf16, head size 64.  Per
// consumer warpgroup, S and dP of tile t run beside dQ += ds.K of tile
// t - 1, and ds of tile t is formed while that product finishes.
__global__ void __launch_bounds__(hopper::kThreads, 1)
packed_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qkv_map,
                           const __grid_constant__ CUtensorMap g_map,
                           const void* __restrict__ mask,
                           const bf16* __restrict__ out,
                           const float* __restrict__ lse,
                           const bf16* __restrict__ g, float* __restrict__ delta,
                           bf16* __restrict__ dqkv, int n, int h_count,
                           int mask_kind, long long mask_sb, long long mask_sh,
                           float scale, float mask_value) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [128][64]
  bf16* gs = qs + 2 * 64 * 64;               // [128][64]
  bf16* ks = gs + 2 * 64 * 64;               // [stages][64][64]
  bf16* vs = ks + kWgStages * 64 * 64;       // [stages][64][64]
  float* dls = reinterpret_cast<float*>(vs + kWgStages * 64 * 64);  // [128]
  uint64_t* qfull = reinterpret_cast<uint64_t*>(dls + kWgRows);
  uint64_t* kfull = qfull + 1;
  uint64_t* vfull = kfull + kWgStages;
  uint64_t* empty = vfull + kWgStages;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kWgRows;
  const int d = h_count * 64;
  const int tiles = (n + 63) / 64;
  const long long tok0 = static_cast<long long>(b) * n;  // [B, N] index of row 0
  const long long stat0 = (static_cast<long long>(b) * h_count + h) * n;

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
      mbar_expect_tx(qfull, 4 * kTileBytes);
      tma_load_3d(qs, &qkv_map, qfull, h * 64, row0, b);
      tma_load_3d(qs + 64 * 64, &qkv_map, qfull, h * 64, row0 + 64, b);
      tma_load_3d(gs, &g_map, qfull, h * 64, row0, b);
      tma_load_3d(gs + 64 * 64, &g_map, qfull, h * 64, row0 + 64, b);
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
    // delta = sum(g * o) in f32: two threads a row, written once
    {
      const int r = threadIdx.x / 2;
      const int i = row0 + r;
      float dl = 0.f;
      if (i < n) {
        const bf16* gr = g + (tok0 + i) * d + h * 64;
        const bf16* orow = out + (tok0 + i) * d + h * 64;
        for (int e = (threadIdx.x % 2) * 32; e < (threadIdx.x % 2) * 32 + 32; e += 8) {
          float gf[8], of[8];
          Vec8<bf16>::load(gr + e, gf);
          Vec8<bf16>::load(orow + e, of);
#pragma unroll
          for (int u = 0; u < 8; ++u) dl = fmaf(gf[u], of[u], dl);
        }
      }
      dl += __shfl_xor_sync(0xffffffffu, dl, 1);
      if (threadIdx.x % 2 == 0) {
        dls[r] = dl;
        if (i < n) delta[stat0 + i] = dl;
      }
    }
    consumers_sync();

    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x / 32) % 4;
    const int tq = lane % 4;
    const int r_lo = wg * 64 + warp * 16 + lane / 4;  // this thread's rows in the block
    const int irow[2] = {row0 + r_lo, row0 + r_lo + 8};
    const float dl[2] = {dls[r_lo], dls[r_lo + 8]};
    float lse_r[2];  // lse of the two rows (0 past N)
#pragma unroll
    for (int r = 0; r < 2; ++r) lse_r[r] = irow[r] < n ? lse[stat0 + irow[r]] : 0.f;
    const long long moff = b * mask_sb + h * mask_sh;
    const uint64_t dqd = desc(qs + wg * 64 * 64);
    const uint64_t dgd = desc(gs + wg * 64 * 64);

    float acc[32], sc[32], dp[32], mv[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      acc[e] = 0.f;
      sc[e] = 0.f;
      dp[e] = 0.f;
      mv[e] = 0.f;
    }
    uint32_t da[4][4];  // ds of the previous tile: the A operand of 4 k-steps
    mbar_wait(qfull, 0);

    // S and dP of tile t (both committed as one group), the mask's entries
    // read meanwhile
    auto products = [&](int t) {
      const int s = t % kWgStages;
      const int ph = (t / kWgStages) & 1;
      mbar_wait(kfull + s, ph);
      mbar_wait(vfull + s, ph);
      fence_acc(sc);
      fence_acc(dp);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(sc, dqd + kstep_k(kk), desc(ks + s * 64 * 64) + kstep_k(kk), kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(dp, dgd + kstep_k(kk), desc(vs + s * 64 * 64) + kstep_k(kk), kk);
      wgmma_commit();
    };
    // dQ += ds.K of tile t (K as the transposed B)
    auto accumulate = [&](int t) {
      const int s = t % kWgStages;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_t(acc, da[kk], desc(ks + s * 64 * 64) + kstep_mn(kk));
      wgmma_commit();
    };

    auto form = [&](int kv0) {
      if (mask_kind == kNoMask && kv0 + 64 <= n)
        ds_tile<true>(sc, dp, mv, mask_kind, irow, lse_r, dl, kv0, n, tq, scale, mask_value);
      else
        ds_tile<false>(sc, dp, mv, mask_kind, irow, lse_r, dl, kv0, n, tq, scale, mask_value);
    };

    products(0);
    if (mask_kind != kNoMask) load_mask_tile(mv, mask_kind, mask, moff, irow, 0, n, tq);
    wgmma_wait<0>();
    fence_acc(sc);
    fence_acc(dp);
    form(0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(da[kk], sc, kk);
    for (int t = 1; t < tiles; ++t) {
      products(t);
      accumulate(t - 1);
      if (mask_kind != kNoMask) load_mask_tile(mv, mask_kind, mask, moff, irow, t * 64, n, tq);
      wgmma_wait<1>();  // S and dP of tile t
      fence_acc(sc);
      fence_acc(dp);
      form(t * 64);
      wgmma_wait<0>();  // dQ of tile t - 1
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty + (t - 1) % kWgStages);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(da[kk], sc, kk);
    }
    fence_acc(acc);
    wgmma_fence();
    accumulate(tiles - 1);
    wgmma_wait<0>();
    fence_acc(acc);

    const long long row = 3LL * d;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = irow[r];
      if (i < n) {
        bf16* dst = dqkv + (tok0 + i) * row + h * 64;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + j * 8 + 2 * tq) =
              pack_bf16(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
      }
    }
  }
}

// One block = (128 key rows, head, image); bf16, head size 64.
__global__ void __launch_bounds__(hopper::kThreads, 1)
packed_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qkv_map,
                            const __grid_constant__ CUtensorMap g_map,
                            const void* __restrict__ mask,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dqkv, int n, int h_count,
                            int mask_kind, long long mask_sb, long long mask_sh,
                            float scale, float mask_value) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [128][64]
  bf16* vs = ks + 2 * 64 * 64;               // [128][64]
  bf16* qs = vs + 2 * 64 * 64;               // [stages][64][64]
  bf16* gs = qs + kWgStages * 64 * 64;       // [stages][64][64]
  float* stats = reinterpret_cast<float*>(gs + kWgStages * 64 * 64);  // [stages][lse, delta][64]
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(stats + kWgStages * 2 * 64);
  uint64_t* full = kvfull + 1;
  uint64_t* empty = full + kWgStages;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kWgRows;
  const int d = h_count * 64;
  const int tiles = (n + 63) / 64;
  const long long stat0 = (static_cast<long long>(b) * h_count + h) * n;

  if (threadIdx.x == 0) {
    mbar_init(kvfull, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full + s, 1 + 32);  // the copies' bytes and the stats' 32 lanes
      mbar_init(empty + s, kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup, provably uniform across each warp (the role branch below)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == 2) {  // the producer: one thread issues the copies, its warp
                   // stages each tile's lse and delta (rows that TMA
                   // cannot take: N f32 is not a 16-byte pitch)
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x / 32 == 8) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_expect_tx(kvfull, 4 * kTileBytes);
        tma_load_3d(ks, &qkv_map, kvfull, d + h * 64, row0, b);
        tma_load_3d(ks + 64 * 64, &qkv_map, kvfull, d + h * 64, row0 + 64, b);
        tma_load_3d(vs, &qkv_map, kvfull, 2 * d + h * 64, row0, b);
        tma_load_3d(vs + 64 * 64, &qkv_map, kvfull, 2 * d + h * 64, row0 + 64, b);
      }
      for (int t = 0; t < tiles; ++t) {
        const int s = t % kWgStages;
        mbar_wait(empty + s, ((t / kWgStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full + s, 2 * kTileBytes);
          tma_load_3d(qs + s * 64 * 64, &qkv_map, full + s, h * 64, t * 64, b);
          tma_load_3d(gs + s * 64 * 64, &g_map, full + s, h * 64, t * 64, b);
        }
        float* st = stats + s * 128;
        for (int c = lane; c < 64; c += 32) {  // 0 past N
          const bool in = t * 64 + c < n;
          st[c] = in ? lse[stat0 + t * 64 + c] : 0.f;
          st[64 + c] = in ? delta[stat0 + t * 64 + c] : 0.f;
        }
        mbar_arrive(full + s);
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x / 32) % 4;
    const int tq = lane % 4;
    const int j_lo = row0 + wg * 64 + warp * 16 + lane / 4;
    const int jrow[2] = {j_lo, j_lo + 8};  // this thread's keys
    const uint8_t* mb = static_cast<const uint8_t*>(mask);
    const float* mf = static_cast<const float*>(mask);
    const long long moff = b * mask_sb + h * mask_sh;
    const uint64_t dkd = desc(ks + wg * 64 * 64);
    const uint64_t dvd = desc(vs + wg * 64 * 64);

    float dk[32], dv[32], sc[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      dk[e] = 0.f;
      dv[e] = 0.f;
      sc[e] = 0.f;
      dp[e] = 0.f;
    }
    uint32_t pa[4][4], da[4][4];  // pb^T and ds^T of the previous tile
    mbar_wait(kvfull, 0);

    // S^T = K.Q^T and dP^T = V.dO^T of query tile t, one group
    auto products = [&](int t) {
      const int s = t % kWgStages;
      fence_acc(sc);
      fence_acc(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(sc, dkd + kstep_k(kk), desc(qs + s * 64 * 64) + kstep_k(kk), kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(dp, dvd + kstep_k(kk), desc(gs + s * 64 * 64) + kstep_k(kk), kk);
      wgmma_commit();
    };
    // dV += pb^T.dO and dK += ds^T.Q of tile t (dO and Q as transposed B)
    auto accumulate = [&](int t) {
      const int s = t % kWgStages;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_t(dv, pa[kk], desc(gs + s * 64 * 64) + kstep_mn(kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_t(dk, da[kk], desc(qs + s * 64 * 64) + kstep_mn(kk));
      wgmma_commit();
    };
    // pb^T and ds^T of tile t in place of S^T and dP^T; PLAIN: no mask, and
    // every query of the tile and every key of the warpgroup inside the image
    auto form_tile = [&](int t, auto plain) {
      const int i0 = t * 64;
      const float* lses = stats + (t % kWgStages) * 128;
      const float* dels = lses + 64;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * tq + (e & 1);  // the query in the tile
          float pb = 0.f, ds = 0.f;  // queries or keys past N weigh nothing
          if (decltype(plain)::value || (i0 + c < n && jrow[e >> 1] < n)) {
            float v = sc[4 * j + e] * scale;
            if (!decltype(plain)::value)
              v = apply_mask(v, mask_kind, mb, mf,
                             moff + static_cast<long long>(i0 + c) * n + jrow[e >> 1],
                             mask_value);
            pb = round_to<bf16>(hopper::ex2((v - lses[c]) * kLog2e));
            ds = round_to<bf16>(pb * (dp[4 * j + e] - dels[c]));
          }
          sc[4 * j + e] = pb;
          dp[4 * j + e] = ds;
        }
      }
    };
    const bool keys_in = row0 + wg * 64 + 64 <= n;
    auto form = [&](int t) {
      if (mask_kind == kNoMask && keys_in && t * 64 + 64 <= n)
        form_tile(t, std::true_type());
      else
        form_tile(t, std::false_type());
    };

    // A warpgroup's products run one group at a time: S^T and dP^T of tile
    // t beside dV and dK of tile t - 1 would hold 192 accumulator and
    // operand registers, more than a thread has here (ptxas spilled them
    // and serialized the products); the other warpgroup's products run
    // while this one forms pb^T and ds^T.
    for (int t = 0; t < tiles; ++t) {
      mbar_wait(full + t % kWgStages, (t / kWgStages) & 1);
      if (t > 0) {
        fence_acc(dk);
        fence_acc(dv);
        wgmma_fence();
        accumulate(t - 1);
        wgmma_wait<0>();
        fence_acc(dk);
        fence_acc(dv);
        if (lane == 0) mbar_arrive(empty + (t - 1) % kWgStages);
      }
      products(t);
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);
      form(t);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc_to_a(pa[kk], sc, kk);
        acc_to_a(da[kk], dp, kk);
      }
    }
    fence_acc(dk);
    fence_acc(dv);
    wgmma_fence();
    accumulate(tiles - 1);
    wgmma_wait<0>();
    fence_acc(dk);
    fence_acc(dv);

    const long long row = 3LL * d;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = jrow[r];
      if (key < n) {
        bf16* dst = dqkv + (static_cast<long long>(b) * n + key) * row + h * 64;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = j * 8 + 2 * tq;
          *reinterpret_cast<uint32_t*>(dst + d + col) =
              pack_bf16(dk[4 * j + 2 * r] * scale, dk[4 * j + 2 * r + 1] * scale);
          *reinterpret_cast<uint32_t*>(dst + 2 * d + col) =
              pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

std::atomic<unsigned long long> dq_wgmma_smem_set{0};
std::atomic<unsigned long long> dkv_wgmma_smem_set{0};

cudaError_t allow_wgmma_smem() {
  const cudaError_t err = hopper::allow_smem_once(
      packed_bwd_dq_wgmma_kernel, dq_wgmma_smem_bytes(), dq_wgmma_smem_set);
  if (err != cudaSuccess) return err;
  return hopper::allow_smem_once(packed_bwd_dkv_wgmma_kernel, dkv_wgmma_smem_bytes(),
                                 dkv_wgmma_smem_set);
}

int launch_wgmma(const void* qkv, const void* mask, const void* out,
                 const void* lse, const void* g, void* delta, void* dqkv, int b,
                 int n, int h, int mask_kind, long long sb, long long sh,
                 float scale, float mask_value, cudaStream_t stream) {
  CUtensorMap qkv_map, g_map;
  cudaError_t err = hopper::map_rows(&qkv_map, qkv, b, n, 3LL * h * 64);
  if (err == cudaSuccess) err = hopper::map_rows(&g_map, g, b, n, 1LL * h * 64);
  if (err == cudaSuccess) err = allow_wgmma_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kWgRows - 1) / kWgRows, h, b);
  packed_bwd_dq_wgmma_kernel<<<grid, hopper::kThreads, dq_wgmma_smem_bytes(), stream>>>(
      qkv_map, g_map, mask, static_cast<const bf16*>(out),
      static_cast<const float*>(lse), static_cast<const bf16*>(g),
      static_cast<float*>(delta), static_cast<bf16*>(dqkv), n, h, mask_kind, sb,
      sh, scale, mask_value);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_bwd_dkv_wgmma_kernel<<<grid, hopper::kThreads, dkv_wgmma_smem_bytes(), stream>>>(
      qkv_map, g_map, mask, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dqkv), n, h, mask_kind, sb,
      sh, scale, mask_value);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_mma(const void* qkv, const void* mask, const void* out,
                 const void* lse, const void* g, void* delta, void* dqkv,
                 int b, int n, int h, int dh, int mask_kind, long long sb,
                 long long sh, float scale, float mask_value,
                 cudaStream_t stream) {
  if (dh == 64)
    return launch_wgmma(qkv, mask, out, lse, g, delta, dqkv, b, n, h, mask_kind, sb, sh, scale, mask_value, stream);
  if (dh <= 16)
    return launch_mma<16>(qkv, mask, out, lse, g, delta, dqkv, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  if (dh <= 32)
    return launch_mma<32>(qkv, mask, out, lse, g, delta, dqkv, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  if (dh <= 64)
    return launch_mma<64>(qkv, mask, out, lse, g, delta, dqkv, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  return launch_mma<128>(qkv, mask, out, lse, g, delta, dqkv, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
}

template <int DHT>
cudaError_t mma_blocks_per_sm(int which, int* blocks) {
  const int bytes = which == 0 ? dq_smem_bytes<DHT>() : dkv_smem_bytes<DHT>();
  cudaError_t err;
  if (which == 0) {
    err = cudaFuncSetAttribute(packed_bwd_dq_mma_kernel<DHT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, packed_bwd_dq_mma_kernel<DHT>, kMmaThreads, bytes);
  }
  err = cudaFuncSetAttribute(packed_bwd_dkv_mma_kernel<DHT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, packed_bwd_dkv_mma_kernel<DHT>, kMmaThreads, bytes);
}

cudaError_t occupancy(int wgmma, int which, int dh, int* blocks) {
  if (wgmma) {
    const cudaError_t err = allow_wgmma_smem();
    if (err != cudaSuccess) return err;
    return which == 0
               ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     blocks, packed_bwd_dq_wgmma_kernel, hopper::kThreads,
                     dq_wgmma_smem_bytes())
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     blocks, packed_bwd_dkv_wgmma_kernel, hopper::kThreads,
                     dkv_wgmma_smem_bytes());
  }
  if (dh <= 16) return mma_blocks_per_sm<16>(which, blocks);
  if (dh <= 32) return mma_blocks_per_sm<32>(which, blocks);
  if (dh <= 64) return mma_blocks_per_sm<64>(which, blocks);
  return mma_blocks_per_sm<128>(which, blocks);
}

}  // namespace
}  // namespace msvit

extern "C" {

// Blocks of K2's bf16 kernels resident on one SM, by the runtime's
// occupancy calculator (registers and shared memory), into *blocks: which
// = 0 the dQ kernel, 1 the dK/dV kernel; wgmma = 1 the wgmma kernels (head
// size 64), 0 the mma.sync kernels of dh's bucket.
int msvit_packed_attention_bwd_occupancy(int wgmma, int which, int dh, int* blocks) {
  if (dh <= 0 || dh > 128 || dh % 8 != 0 || (wgmma && dh != 64) || which < 0 ||
      which > 1 || blocks == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(msvit::occupancy(wgmma, which, dh, blocks));
}

// qkv [B, N, 3D], out and g [B, N, D] in `dtype` (0 = float32,
// 1 = bfloat16: the tensor-core kernels); lse [B, H, N] f32 from the
// forward; delta [B, H, N] f32 scratch (written by the dQ kernel, read by
// the dK/dV kernel); dqkv [B, N, 3D] in `dtype`, written.  Mask as
// msvit_packed_attention.  Returns cudaGetLastError() after the launches.
int msvit_packed_attention_bwd(const void* qkv, const void* mask,
                               const void* out, const void* lse,
                               const void* g, void* delta, void* dqkv,
                               int dtype, int b, int n, int h, int dh,
                               int mask_kind, long long mask_sb,
                               long long mask_sh, float scale,
                               float mask_value, void* stream) {
  if (dh <= 0 || dh > 128 || dh % 8 != 0 || n <= 0 || b <= 0 || h <= 0 ||
      b > 65535 || h > 65535 || mask_kind < 0 || mask_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return msvit::dispatch<float>(qkv, mask, out, lse, g, delta, dqkv, b, n,
                                  h, dh, mask_kind, mask_sb, mask_sh, scale,
                                  mask_value, s);
  if (dtype == 1)
    return msvit::dispatch_mma(qkv, mask, out, lse, g, delta, dqkv, b, n, h,
                               dh, mask_kind, mask_sb, mask_sh, scale,
                               mask_value, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
