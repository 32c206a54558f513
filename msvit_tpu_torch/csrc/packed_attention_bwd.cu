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
// against a few N*dh elements.
//
// bf16, on the tensor cores (packed_bwd_dq_mma_kernel,
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
// memory at each use instead.  wgmma with TMA is the later step.
//
// f32 (packed_bwd_dq_kernel, packed_bwd_dkv_kernel): the CUDA cores in f32
// FMAs (TF32 would break the f32 bars).  k/v (dQ) and q/g (dK/dV) tiles are
// staged in shared memory with coalesced 16-byte loads and read as
// broadcasts.  A dK/dV thread holding k, v, dk and dv at dh = 64 in f32
// would need 256 registers, so each row is split over row_threads()
// neighbouring threads (1 at dh <= 32, 2 at 64, 4 at 128), each holding a
// slice of at most 32 head elements, and the two dot products per (query,
// key) pair are summed across the slice threads with shuffles.

#include "common.cuh"

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

int dispatch_mma(const void* qkv, const void* mask, const void* out,
                 const void* lse, const void* g, void* delta, void* dqkv,
                 int b, int n, int h, int dh, int mask_kind, long long sb,
                 long long sh, float scale, float mask_value,
                 cudaStream_t stream) {
  if (dh <= 16)
    return launch_mma<16>(qkv, mask, out, lse, g, delta, dqkv, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  if (dh <= 32)
    return launch_mma<32>(qkv, mask, out, lse, g, delta, dqkv, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  if (dh <= 64)
    return launch_mma<64>(qkv, mask, out, lse, g, delta, dqkv, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  return launch_mma<128>(qkv, mask, out, lse, g, delta, dqkv, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
}

}  // namespace
}  // namespace msvit

extern "C" {

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
