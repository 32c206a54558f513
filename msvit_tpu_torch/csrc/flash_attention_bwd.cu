// Flash-attention backward on [B, H, N, dh] operands (bf16 / f32): K6.
//
// Replaces the TPU kernel `msvit_tpu/ops/flash_attention.py::
// flash_attention_bwd`: its two pallas_calls, `_bwd_dq_kernel` and
// `_bwd_dkv_kernel`, over the shared tile math `_recompute_p_ds`.  It is
// the backward of the multistate trunk's fused attention (JAX's `_fused`
// custom VJP; here `FusedAttentionFunction`, whose forward is K5-lse).  From
// the forward's residuals -- q [B, H, Nq, dh], k, v [B, H, Nk, dh], out
// [B, H, Nq, dh], the compact lse [B, H, Nq] f32 -- and the cotangent g of
// out (cast to q's dtype by the wrapper, as the TPU function casts it), it
// writes dq, dk and dv.  The arithmetic is the TPU kernels':
//   s = q.k^T * scale in f32, the mask applied as in the forward (additive,
//   or where-valid with mask_value); p = exp(s - lse), kept in f32;
//   dp = g.v^T and delta = sum(g * o) in f32; ds = p * (dp - delta) in f32;
//   dv = p^T g with p rounded to the compute dtype; dk = ds^T q * scale and
//   dq = ds k * scale with ds rounded to the compute dtype.
// (K2, the packed backward, rounds p before it forms ds; K6 does not.)
//
// Operands are read through their (image, head, row) element strides with
// the last dim contiguous, so views of the QKV GEMM output and a strided
// cotangent need no copy; dq, dk and dv are written through strides too.
// Masks are bool (true = attend) or additive f32, [B|1, 1|H, Nq, Nk] with
// the last two dims contiguous.  Nq != Nk is allowed (cross-context K/V).
//
// Blocks run in no order, so the TPU grid's sequential kv (dQ) and q (dK/dV)
// axes become loops inside a block, and the work is two kernels launched in
// turn on one stream:
// * dQ: a block per (64 query rows, head, image).  Each row first forms
//   delta = sum(g * o) and writes it to an f32 scratch [B, H, Nq] -- once
//   per row, where the TPU kernels recompute it in every tile -- then walks
//   the k/v tiles, recomputing s, p, dp and ds, and accumulates dq.  Its
//   mask reads walk one query row.
// * dK/dV: a block per (64 key rows, head, image).  Each key row walks the
//   query tiles of q and g, staged in shared memory with their lse and
//   delta (the dQ kernel's), and accumulates dk and dv.  Neighbouring
//   threads hold neighbouring keys, so a query row's mask entries are read
//   coalesced.
// Every output element is written by exactly one thread: no atomics.
//
// What bounds it on the card: 5 products of 2*Nq*Nk*dh FLOP per head (the
// dK/dV kernel recomputes s and dp: 7 are done) against a few N*dh
// elements per operand and the mask's Nq*Nk entries.  At the multistate
// trunk, [8, 12, 816, 64] with an f32 mask, that is 41 GFLOP against
// 102 MB: operations (0.0414 ms at the bf16 peak).
//
// bf16, on the tensor cores (flash_bwd_dq_mma_kernel,
// flash_bwd_dkv_mma_kernel): K2's pair (packed_attention_bwd.cu) on
// strided [B, H, N, dh] operands, with Nq != Nk, K7's staged mask tile and
// K6's own rounding.  Warp-level mma.sync m16n8k16 (bf16 operands, f32
// accumulators), 4 warps of 16 rows a block, tiles of 64 rows streamed
// through a two-stage ring in dynamic shared memory filled by cp.async
// (the next tile in flight while this one is multiplied), rows padded by
// 16 bytes (ldmatrix rows in distinct banks), a head size below its bucket
// (16/32/64/128) zero-padded there.  The grids are (H, 64-row tiles, B),
// the head fastest, so the 12 heads of one tile run together and meet a
// broadcast mask panel in L2; the [64 x 64] mask tile rides the ring at
// 16, 4 or 1 bytes a copy as its rows' alignment allows (`MaskStage`).
// * dQ: q and g fragments kept (at dh <= 64 staged in stage 1 of the ring
//   until they are in registers), delta written once per row; per key tile
//   S = Q.K^T and dP = G.V^T, then in registers p = exp2((s' - lse) *
//   log2e) with s' the scaled, masked score in f32 -- lse subtracted before
//   the change to log2 units, since mask_value * log2e overflows to -inf
//   and a fully masked bool row (lse = mask_value + log Nk, which rounds to
//   mask_value) must give p = 1 on every key, as the TPU's and the plain
//   version's; ds = p (dp - delta) in f32, rounded to bf16 once into the A
//   fragment (c_to_a) of dQ += dS.K.
// * dK/dV: k and v fragments kept; per query tile (with its lse and delta
//   staged beside it) S^T = K.Q^T and dP^T = V.G^T, so that p^T and ds^T
//   sit in accumulator layout with keys as rows; round(p^T) feeds
//   dV += P^T.G and round(ds^T) dK += dS^T.Q.  The mask tile is staged in
//   its [q, k] layout and read transposed, from rows padded so that those
//   reads hit distinct banks.
// Keys past Nk (dQ) and queries past Nq (dK/dV: a zero row with lse 0
// would give p = 1) weigh exactly 0; only the ragged last tile checks them
// and skips its 16-row blocks past the edge.  A row whose scores are all
// -inf has lse 0 and p = 0.  Each output element is written by one thread:
// two calls give the same bits.  At dh 128 the resident fragments are read
// from shared memory at each use.  wgmma with TMA is the later step.
//
// f32 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel): the CUDA cores in f32
// FMAs (TF32 would break the f32 bars).  k/v (dQ) and q/g (dK/dV) tiles are
// staged once per block with coalesced 16-byte loads and read by all rows
// as broadcasts; the [Nq, Nk] panels never leave registers; each row is
// split over row_threads() neighbouring threads (1 at dh <= 32, 2 at 64, 4
// at 128) holding at most 32 head elements each, so the dK/dV kernel's k,
// v, dk and dv stay in registers, and the two dot products per (query,
// key) pair are summed across a row's threads with shuffles.

#include "common.cuh"

namespace msvit {
namespace {

// Element strides (image, head, row) of the eight [B, H, N, dh] operands.
struct Strides {
  long long q[3], k[3], v[3], o[3], g[3], dq[3], dk[3], dv[3];
};

__device__ __forceinline__ long long offset(const long long* s, int b, int h,
                                            int row) {
  return b * s[0] + h * s[1] + row * s[2];
}

template <typename T, int DHT>
__global__ void __launch_bounds__(kRows * row_threads<DHT>())
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ out,
                    const T* __restrict__ g, const float* __restrict__ lse,
                    const void* __restrict__ mask, float* __restrict__ delta,
                    T* __restrict__ dq, Strides st, int nq, int nk, int dh,
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
  const bool active = i < nq;

  float qr[CH], go[CH], acc[CH];
#pragma unroll
  for (int e = 0; e < CH; ++e) {
    qr[e] = 0.f;
    go[e] = 0.f;
    acc[e] = 0.f;
  }
  float dl = 0.f;  // delta = sum(g * o), this thread's part
  if (active) {
    load_slice<T, CH>(q + offset(st.q, b, h, i), rs.e0, dh, qr);
    load_slice<T, CH>(g + offset(st.g, b, h, i), rs.e0, dh, go);
    float o[CH];
    load_slice<T, CH>(out + offset(st.o, b, h, i), rs.e0, dh, o);
#pragma unroll
    for (int e = 0; e < CH; ++e)
      if (rs.e0 + e < dh) dl = fmaf(go[e], o[e], dl);
  }
  dl = row_sum<RS::kTpr>(dl);
  const long long li = (static_cast<long long>(b) * gridDim.y + h) * nq + i;
  const float lse_i = active ? lse[li] : 0.f;
  if (active && rs.e0 == 0) delta[li] = dl;

  const uint8_t* mb = static_cast<const uint8_t*>(mask);
  const float* mf = static_cast<const float*>(mask);
  const long long moff =
      b * mask_sb + h * mask_sh + static_cast<long long>(i) * nk;
  const char* kimg = reinterpret_cast<const char*>(k + b * st.k[0] + h * st.k[1]);
  const char* vimg = reinterpret_cast<const char*>(v + b * st.v[0] + h * st.v[1]);
  const int width = dh * static_cast<int>(sizeof(T));
  const long long krow = st.k[2] * static_cast<long long>(sizeof(T));
  const long long vrow = st.v[2] * static_cast<long long>(sizeof(T));
  for (int kv0 = 0; kv0 < nk; kv0 += KV) {
    __syncthreads();  // the previous tile is consumed
    stage_tile<uint4>(reinterpret_cast<char*>(ks), kimg, krow, 0, width, kv0,
                      KV, nk);
    stage_tile<uint4>(reinterpret_cast<char*>(vs), vimg, vrow, 0, width, kv0,
                      KV, nk);
    __syncthreads();
    const int cnt = min(KV, nk - kv0);
    for (int j = 0; j < cnt; ++j) {
      // every lane takes part in the shuffles, active or not
      float s, dp;
      dot2<T, CH>(qr, ks + j * dh, go, vs + j * dh, rs.e0, dh, s, dp);
      s = row_sum<RS::kTpr>(s);
      dp = row_sum<RS::kTpr>(dp);
      if (!active) continue;
      s = apply_mask(s * scale, mask_kind, mb, mf, moff + kv0 + j, mask_value);
      const float p = expf(s - lse_i);
      const float ds = round_to<T>(p * (dp - dl));
      axpy<T, CH>(acc, ds, ks + j * dh, rs.e0, dh);
    }
  }
  if (active)
    store_slice<T, CH>(dq + offset(st.dq, b, h, i), rs.e0, dh, acc, scale);
}

template <typename T, int DHT>
__global__ void __launch_bounds__(kRows * row_threads<DHT>())
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const void* __restrict__ mask,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Strides st, int nq, int nk, int dh,
                     int mask_kind, long long mask_sb, long long mask_sh,
                     float scale, float mask_value) {
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
  const bool active = j < nk;

  float kr[CH], vr[CH], dkr[CH], dvr[CH];
#pragma unroll
  for (int e = 0; e < CH; ++e) {
    kr[e] = 0.f;
    vr[e] = 0.f;
    dkr[e] = 0.f;
    dvr[e] = 0.f;
  }
  if (active) {
    load_slice<T, CH>(k + offset(st.k, b, h, j), rs.e0, dh, kr);
    load_slice<T, CH>(v + offset(st.v, b, h, j), rs.e0, dh, vr);
  }
  const uint8_t* mb = static_cast<const uint8_t*>(mask);
  const float* mf = static_cast<const float*>(mask);
  const long long moff = b * mask_sb + h * mask_sh + j;  // column j
  const char* qimg = reinterpret_cast<const char*>(q + b * st.q[0] + h * st.q[1]);
  const char* gimg = reinterpret_cast<const char*>(g + b * st.g[0] + h * st.g[1]);
  const int width = dh * static_cast<int>(sizeof(T));
  const long long qrow = st.q[2] * static_cast<long long>(sizeof(T));
  const long long grow = st.g[2] * static_cast<long long>(sizeof(T));
  const long long stat0 = (static_cast<long long>(b) * gridDim.y + h) * nq;
  for (int i0 = 0; i0 < nq; i0 += QT) {
    __syncthreads();  // the previous tile is consumed
    stage_tile<uint4>(reinterpret_cast<char*>(qs), qimg, qrow, 0, width, i0,
                      QT, nq);
    stage_tile<uint4>(reinterpret_cast<char*>(gs), gimg, grow, 0, width, i0,
                      QT, nq);
    for (int r = threadIdx.x; r < QT; r += blockDim.x) {
      const bool in = i0 + r < nq;
      lses[r] = in ? lse[stat0 + i0 + r] : 0.f;
      deltas[r] = in ? delta[stat0 + i0 + r] : 0.f;
    }
    __syncthreads();
    const int cnt = min(QT, nq - i0);
    for (int r = 0; r < cnt; ++r) {
      const T* qt = qs + r * dh;
      const T* gt = gs + r * dh;
      float s, dp;
      dot2<T, CH>(kr, qt, vr, gt, rs.e0, dh, s, dp);
      s = row_sum<RS::kTpr>(s);
      dp = row_sum<RS::kTpr>(dp);
      if (!active) continue;
      s = apply_mask(s * scale, mask_kind, mb, mf,
                     moff + static_cast<long long>(i0 + r) * nk, mask_value);
      const float p = expf(s - lses[r]);
      axpy<T, CH>(dvr, round_to<T>(p), gt, rs.e0, dh);
      const float ds = round_to<T>(p * (dp - deltas[r]));
      axpy<T, CH>(dkr, ds, qt, rs.e0, dh);
    }
  }
  if (!active) return;
  store_slice<T, CH>(dk + offset(st.dk, b, h, j), rs.e0, dh, dkr, scale);
  store_slice<T, CH>(dv + offset(st.dv, b, h, j), rs.e0, dh, dvr, 1.f);
}

// ------------------------------------------------------------------------
// bf16 on the tensor cores.

// Shared memory of the dQ kernel: the k/v ring; q and g (in stage 1 of the
// ring while their fragments are loaded, at dh <= 64); delta of the
// block's rows; the mask ring.
template <int DHT>
__host__ __device__ constexpr int dq_head_rows() {
  return 4 * kMmaTile + (Resident<DHT>::kInRegs ? 0 : 2 * kMmaRows);
}

template <int DHT>
__host__ __device__ constexpr int dq_mma_bytes(int mask_kind) {
  return dq_head_rows<DHT>() * mma_ld<DHT>() * 2 + kMmaRows * 4 +
         2 * kMmaRows * mask_row_bytes(mask_kind);
}

// ... of the dK/dV kernel: the q/g ring; k and v (as q and g above); lse
// and delta of each ring stage's queries; the mask ring.
template <int DHT>
__host__ __device__ constexpr int dkv_mma_bytes(int mask_kind) {
  return dq_head_rows<DHT>() * mma_ld<DHT>() * 2 + 4 * kMmaTile * 4 +
         2 * kMmaTile * mask_row_bytes(mask_kind, true);
}

// One block = (head, 64 query rows, image), 4 warps of 16 rows.  The head
// is blockIdx.x: blocks that share a broadcast mask panel run together.
template <int DHT>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ out,
                        const bf16* __restrict__ g, const float* __restrict__ lse,
                        const void* __restrict__ mask, float* __restrict__ delta,
                        bf16* __restrict__ dq, Strides st, int h_count, int nq,
                        int nk, int dh, int mask_kind, long long mask_sb,
                        long long mask_sh, float scale, float mask_value) {
  constexpr int LD = mma_ld<DHT>();
  constexpr int KT = kMmaTile;  // keys per staged tile
  constexpr int NT = KT / 8;    // score n-tiles per tile
  constexpr bool kShare = Resident<DHT>::kInRegs;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // [2][k, v][KT][LD]
  bf16* qs = ring + (kShare ? 2 : 4) * KT * LD;  // [64][LD]
  bf16* gs = qs + kMmaRows * LD;                 // [64][LD]
  float* dls = reinterpret_cast<float*>(ring + dq_head_rows<DHT>() * LD);  // [64]
  unsigned char* mring = reinterpret_cast<unsigned char*>(dls + kMmaRows);
  const int h = blockIdx.x;
  const int row0 = blockIdx.y * kMmaRows;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tq = lane % 4;
  const long long stat0 = (static_cast<long long>(b) * h_count + h) * nq;
  const bf16* kimg = k + b * st.k[0] + h * st.k[1];
  const bf16* vimg = v + b * st.v[0] + h * st.v[1];
  const int mrow = mask_row_bytes(mask_kind);
  const MaskStage mstage(mask, mask_kind, nk, mask_sb, mask_sh, b, h);

  if (dh < DHT) {  // pad columns of every head tile: zero once
    zero_smem(smem, dq_head_rows<DHT>() * LD * static_cast<int>(sizeof(bf16)));
    __syncthreads();
  }
  const int tiles = (nk + KT - 1) / KT;
  auto load_tile = [&](int t) {
    bf16* ks = ring + (t & 1) * 2 * KT * LD;
    async_tile<LD>(ks, kimg, st.k[2], t * KT, KT, nk, dh);
    async_tile<LD>(ks + KT * LD, vimg, st.v[2], t * KT, KT, nk, dh);
    mstage.stage(mring + (t & 1) * kMmaRows * mrow, mrow, row0, nq, t * KT);
  };
  async_tile<LD>(qs, q + b * st.q[0] + h * st.q[1], st.q[2], row0, kMmaRows, nq, dh);
  async_tile<LD>(gs, g + b * st.g[0] + h * st.g[1], st.g[2], row0, kMmaRows, nq, dh);
  load_tile(0);
  cp_async_commit();

  // delta = sum(g * o) in f32: two threads a row, written once
  {
    const int r = threadIdx.x / 2;
    const int i = row0 + r;
    float dl = 0.f;
    if (i < nq) {
      const bf16* gr = g + offset(st.g, b, h, i);
      const bf16* orow = out + offset(st.o, b, h, i);
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
      if (i < nq) delta[stat0 + i] = dl;
    }
  }

  const int r_lo = warp * 16 + lane / 4;  // this thread's rows in the block
  const int irow[2] = {row0 + r_lo, row0 + r_lo + 8};
  float lse_r[2];  // lse of the two rows (0 past Nq)
#pragma unroll
  for (int r = 0; r < 2; ++r) lse_r[r] = irow[r] < nq ? lse[stat0 + irow[r]] : 0.f;

  Resident<DHT> qf, gf;
  float dl[2] = {0.f, 0.f};
  float acc[DHT / 8][4];
  zero_acc(acc);
  // a warp whose 16 rows all lie past nq (the last query tile) only helps
  // to copy the tiles
  const bool idle = row0 + warp * 16 >= nq;
  for (int t = 0; t < tiles; ++t) {
    if (kShare && t == 0) {  // q's and g's fragments first: tile 1 overwrites them
      cp_async_wait<0>();
      __syncthreads();
      if (!idle) {
        qf.load(qs + warp * 16 * LD, lane);
        gf.load(gs + warp * 16 * LD, lane);
      }
      __syncthreads();
    }
    if (t + 1 < tiles) load_tile(t + 1);  // its stage was freed at t - 1's end
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and q, g) has landed for this thread
    __syncthreads();     // ... and for every thread
    if (t == 0 && !idle) {
      if (!kShare) {
        qf.load(qs + warp * 16 * LD, lane);
        gf.load(gs + warp * 16 * LD, lane);
      }
      dl[0] = dls[r_lo];
      dl[1] = dls[r_lo + 8];
    }
    const bf16* ks = ring + (t & 1) * 2 * KT * LD;
    const bf16* vs = ks + KT * LD;
    const unsigned char* mt = mring + (t & 1) * kMmaRows * mrow;
    const int kv0 = t * KT;
    auto tile = [&](auto edge) {
      constexpr bool EDGE = decltype(edge)::value;
      // 16-key blocks holding keys below nk: all 4 but in the last tile
      const int n16 = EDGE ? (nk - kv0 + 15) / 16 : KT / 16;
      float s[NT][4], dp[NT][4];
      product_t<DHT, KT>(s, qf, ks, lane, n16);
      product_t<DHT, KT>(dp, gf, vs, lane, n16);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = j * 8 + 2 * tq;  // this lane's two keys: c, c + 1
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float add[2];
          bool keep[2];
          mask_pair(mt, mrow, r_lo + 8 * r, c, mask_kind, add, keep);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int e = 2 * r + u;
            const float x = keep[u] ? s[j][e] * scale + add[u] : mask_value;
            // (s - lse) first, then log2 units: mask_value * log2e would
            // overflow to -inf and a fully masked row's p = 1 would be lost
            float p = exp2f((x - lse_r[r]) * kLog2e);
            if (EDGE && kv0 + c + u >= nk) p = 0.f;  // keys past Nk weigh nothing
            s[j][e] = p * (dp[j][e] - dl[r]);        // ds, f32
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {  // dQ += ds.K, ds rounded to bf16
        if (kk >= n16) break;
        uint32_t da[4];
        c_to_a(da, s[2 * kk], s[2 * kk + 1]);
        pv_step<DHT>(acc, da, ks, kk, lane);
      }
    };
    if (!idle) {
      if (kv0 + KT <= nk) {
        tile(Edge<false>{});
      } else {
        tile(Edge<true>{});
      }
    }
    __syncthreads();  // this stage is consumed: t + 1 may refill it
  }
  store_rows<DHT>(dq + b * st.dq[0] + h * st.dq[1], st.dq[2], acc, row0 + r_lo, nq,
                  dh, tq, scale);
}

// One block = (head, 64 key rows, image), 4 warps of 16 key rows.  It keeps
// k and v, streams the query tiles (q, g, their lse and delta, the mask
// tile) and forms S^T = K.Q^T and dP^T = V.G^T: p^T and ds^T in
// accumulator layout with keys as rows, the A operands of dV += P^T.G and
// dK += dS^T.Q.
template <int DHT>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ g,
                         const float* __restrict__ lse,
                         const void* __restrict__ mask,
                         const float* __restrict__ delta, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, Strides st, int h_count, int nq,
                         int nk, int dh, int mask_kind, long long mask_sb,
                         long long mask_sh, float scale, float mask_value) {
  constexpr int LD = mma_ld<DHT>();
  constexpr int QT = kMmaTile;  // query rows per staged tile
  constexpr int NT = QT / 8;
  constexpr bool kShare = Resident<DHT>::kInRegs;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // [2][q, g][QT][LD]
  bf16* ks = ring + (kShare ? 2 : 4) * QT * LD;  // [64][LD]
  bf16* vs = ks + kMmaRows * LD;                 // [64][LD]
  float* stats = reinterpret_cast<float*>(ring + dq_head_rows<DHT>() * LD);  // [2][lse, delta][QT]
  unsigned char* mring = reinterpret_cast<unsigned char*>(stats + 4 * QT);
  const int h = blockIdx.x;
  const int row0 = blockIdx.y * kMmaRows;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tq = lane % 4;
  const long long stat0 = (static_cast<long long>(b) * h_count + h) * nq;
  const bf16* qimg = q + b * st.q[0] + h * st.q[1];
  const bf16* gimg = g + b * st.g[0] + h * st.g[1];
  const int mrow = mask_row_bytes(mask_kind, true);
  const int esize = mask_kind == kAddMask ? 4 : 1;
  const MaskStage mstage(mask, mask_kind, nk, mask_sb, mask_sh, b, h);

  if (dh < DHT) {
    zero_smem(smem, dq_head_rows<DHT>() * LD * static_cast<int>(sizeof(bf16)));
    __syncthreads();
  }
  const int tiles = (nq + QT - 1) / QT;
  auto load_tile = [&](int t) {
    const int sg = t & 1;
    bf16* qt = ring + sg * 2 * QT * LD;
    async_tile<LD>(qt, qimg, st.q[2], t * QT, QT, nq, dh);
    async_tile<LD>(qt + QT * LD, gimg, st.g[2], t * QT, QT, nq, dh);
    // lse and delta of the tile's queries, 0 past Nq
    for (int c = threadIdx.x; c < 2 * QT; c += blockDim.x) {
      const int r = c % QT;
      const bool ok = t * QT + r < nq;
      const float* src = (c < QT ? lse : delta) + stat0 + (ok ? t * QT + r : 0);
      cp_async4(stats + sg * 2 * QT + c, src, ok);
    }
    // queries [t * QT, t * QT + 64) x the block's keys [row0, row0 + 64)
    mstage.stage(mring + sg * QT * mrow, mrow, t * QT, nq, row0);
  };
  async_tile<LD>(ks, k + b * st.k[0] + h * st.k[1], st.k[2], row0, kMmaRows, nk, dh);
  async_tile<LD>(vs, v + b * st.v[0] + h * st.v[1], st.v[2], row0, kMmaRows, nk, dh);
  load_tile(0);
  cp_async_commit();

  const int r_lo = warp * 16 + lane / 4;  // this thread's key rows in the block
  Resident<DHT> kf, vf;
  float dka[DHT / 8][4], dva[DHT / 8][4];
  zero_acc(dka);
  zero_acc(dva);
  // a warp whose 16 key rows all lie past nk only helps to copy the tiles
  const bool idle = row0 + warp * 16 >= nk;
  for (int t = 0; t < tiles; ++t) {
    if (kShare && t == 0) {  // k's and v's fragments first: tile 1 overwrites them
      cp_async_wait<0>();
      __syncthreads();
      if (!idle) {
        kf.load(ks + warp * 16 * LD, lane);
        vf.load(vs + warp * 16 * LD, lane);
      }
      __syncthreads();
    }
    if (t + 1 < tiles) load_tile(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (!kShare && t == 0 && !idle) {
      kf.load(ks + warp * 16 * LD, lane);
      vf.load(vs + warp * 16 * LD, lane);
    }
    const bf16* qt = ring + (t & 1) * 2 * QT * LD;
    const bf16* gt = qt + QT * LD;
    const float* lses = stats + (t & 1) * 2 * QT;
    const float* dels = lses + QT;
    const unsigned char* mt = mring + (t & 1) * QT * mrow;
    const int i0 = t * QT;
    auto tile = [&](auto edge) {
      constexpr bool EDGE = decltype(edge)::value;
      // 16-query blocks holding queries below nq: all 4 but in the last tile
      const int n16 = EDGE ? (nq - i0 + 15) / 16 : QT / 16;
      float s[NT][4], dp[NT][4];
      product_t<DHT, QT>(s, kf, qt, lane, n16);   // s^T: keys by queries
      product_t<DHT, QT>(dp, vf, gt, lane, n16);  // dp^T
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = j * 8 + 2 * tq + u;  // query within the tile
          const unsigned char* mc = mt + c * mrow;
          const float ls = lses[c];
          const float de = dels[c];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int kr = r_lo + 8 * r;  // key within the block
            const int e = 2 * r + u;
            float x = s[j][e] * scale;
            if (mask_kind == kAddMask) {
              x += *reinterpret_cast<const float*>(mc + kr * esize);
            } else if (mask_kind == kBoolMask && mc[kr] == 0) {
              x = mask_value;
            }
            // (s - lse) first, as in the dQ kernel; a query past nq (a
            // zero row with lse 0) would give p = 1: it weighs nothing
            float p = exp2f((x - ls) * kLog2e);
            if (EDGE && i0 + c >= nq) p = 0.f;
            s[j][e] = p;                    // p^T, rounded into dV
            dp[j][e] = p * (dp[j][e] - de);  // ds^T, rounded into dK
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        if (kk >= n16) break;
        uint32_t a[4];
        c_to_a(a, s[2 * kk], s[2 * kk + 1]);
        pv_step<DHT>(dva, a, gt, kk, lane);  // dV += P^T.G
        c_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
        pv_step<DHT>(dka, a, qt, kk, lane);  // dK += dS^T.Q
      }
    };
    if (!idle) {
      if (i0 + QT <= nq) {
        tile(Edge<false>{});
      } else {
        tile(Edge<true>{});
      }
    }
    __syncthreads();
  }
  store_rows<DHT>(dk + b * st.dk[0] + h * st.dk[1], st.dk[2], dka, row0 + r_lo, nk,
                  dh, tq, scale);
  store_rows<DHT>(dv + b * st.dv[0] + h * st.dv[1], st.dv[2], dva, row0 + r_lo, nk,
                  dh, tq, 1.f);
}

struct Args {
  const void *q, *k, *v, *out, *g, *lse, *mask;
  void *delta, *dq, *dk, *dv;
  Strides st;
  int b, h, nq, nk, dh, mask_kind;
  long long mask_sb, mask_sh;
  float scale, mask_value;
};

template <typename T, int DHT>
int launch(const Args& a, cudaStream_t stream) {
  const int threads = kRows * row_threads<DHT>();
  const dim3 grid_q((a.nq + kRows - 1) / kRows, a.h, a.b);
  flash_bwd_dq_kernel<T, DHT><<<grid_q, threads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.out),
      static_cast<const T*>(a.g), static_cast<const float*>(a.lse), a.mask,
      static_cast<float*>(a.delta), static_cast<T*>(a.dq), a.st, a.nq, a.nk,
      a.dh, a.mask_kind, a.mask_sb, a.mask_sh, a.scale, a.mask_value);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_k((a.nk + kRows - 1) / kRows, a.h, a.b);
  flash_bwd_dkv_kernel<T, DHT><<<grid_k, threads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g),
      static_cast<const float*>(a.lse), a.mask,
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.st, a.nq, a.nk, a.dh, a.mask_kind, a.mask_sb,
      a.mask_sh, a.scale, a.mask_value);
  return static_cast<int>(cudaGetLastError());
}

template <int DHT>
int launch_mma(const Args& a, cudaStream_t stream) {
  const int dq_bytes = dq_mma_bytes<DHT>(a.mask_kind);
  const int dkv_bytes = dkv_mma_bytes<DHT>(a.mask_kind);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<DHT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         dq_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkv_mma_kernel<DHT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(a.h, (a.nq + kMmaRows - 1) / kMmaRows, a.b);
  flash_bwd_dq_mma_kernel<DHT><<<grid_q, kMmaThreads, dq_bytes, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.out),
      static_cast<const bf16*>(a.g), static_cast<const float*>(a.lse), a.mask,
      static_cast<float*>(a.delta), static_cast<bf16*>(a.dq), a.st, a.h, a.nq,
      a.nk, a.dh, a.mask_kind, a.mask_sb, a.mask_sh, a.scale, a.mask_value);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_k(a.h, (a.nk + kMmaRows - 1) / kMmaRows, a.b);
  flash_bwd_dkv_mma_kernel<DHT><<<grid_k, kMmaThreads, dkv_bytes, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.g),
      static_cast<const float*>(a.lse), a.mask,
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.st, a.h, a.nq, a.nk, a.dh, a.mask_kind,
      a.mask_sb, a.mask_sh, a.scale, a.mask_value);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_mma(const Args& a, cudaStream_t stream) {
  if (a.dh <= 16) return launch_mma<16>(a, stream);
  if (a.dh <= 32) return launch_mma<32>(a, stream);
  if (a.dh <= 64) return launch_mma<64>(a, stream);
  return launch_mma<128>(a, stream);
}

template <typename T>
int dispatch(const Args& a, cudaStream_t stream) {
  if (a.dh <= 16) return launch<T, 16>(a, stream);
  if (a.dh <= 32) return launch<T, 32>(a, stream);
  if (a.dh <= 64) return launch<T, 64>(a, stream);
  return launch<T, 128>(a, stream);
}

}  // namespace
}  // namespace msvit

extern "C" {

// K6.  q, k, v, out, g in `dtype` (0 = float32 on the CUDA cores,
// 1 = bfloat16 on the tensor cores), g already in
// q's dtype; lse [B, H, Nq] f32 from the forward (contiguous); delta
// [B, H, Nq] f32 scratch (written by the dQ kernel, read by the dK/dV
// kernel); dq [B, H, Nq, dh], dk and dv [B, H, Nk, dh] in `dtype`, written.
// strides: 24 element strides (host memory), (image, head, row) of q, k,
// v, out, g, dq, dk, dv in that order; every row's dh elements contiguous
// and 16-byte aligned.  mask_kind: 0 none, 1 bool (one byte per entry),
// 2 additive float32; mask_sb / mask_sh its image and head strides in
// elements (0 where broadcast), its last two dims contiguous [Nq, Nk].
// Returns cudaGetLastError() after the launches.
int msvit_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* out, const void* g,
                              const void* lse, const void* mask, void* delta,
                              void* dq, void* dk, void* dv, int dtype, int b,
                              int h, int nq, int nk, int dh,
                              const long long* strides, int mask_kind,
                              long long mask_sb, long long mask_sh,
                              float scale, float mask_value, void* stream) {
  if (dh <= 0 || dh > 128 || dh % 8 != 0 || nq <= 0 || nk <= 0 || b <= 0 ||
      h <= 0 || b > 65535 || h > 65535 || mask_kind < 0 || mask_kind > 2 ||
      strides == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  msvit::Args a{q, k, v, out, g, lse, mask, delta, dq, dk, dv, {},
                b, h, nq, nk, dh, mask_kind, mask_sb, mask_sh, scale,
                mask_value};
  long long* st[8] = {a.st.q, a.st.k, a.st.v, a.st.o,
                      a.st.g, a.st.dq, a.st.dk, a.st.dv};
  for (int t = 0; t < 8; ++t)
    for (int d = 0; d < 3; ++d) st[t][d] = strides[3 * t + d];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return msvit::dispatch<float>(a, s);
  if (dtype == 1) return msvit::dispatch_mma(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
