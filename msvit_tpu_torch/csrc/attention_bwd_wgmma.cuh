// K6's bf16 backward at head size 64 on Hopper: a dQ kernel and a dK/dV
// kernel on warpgroup products (wgmma) fed by TMA, warp-specialised
// (`flash_attention_bwd.cu` launches them; its header has the contract and
// the arithmetic).  It is K2's wgmma pair (`packed_attention_bwd.cu`,
// packed_bwd_dq_wgmma_kernel and packed_bwd_dkv_wgmma_kernel) where K6's
// contract is K2's, and differs where it is not:
// * Operands.  q, k, v and the cotangent g are 4-D TMA maps over
//   [B, H, N, 64] bf16 views through their element strides (image, head,
//   row), as `attention_wgmma.cuh` reads the forward's: dims (64, N, H, B),
//   box (64, 64, 1, 1), 128-byte swizzle, a box past N zero-filled inside
//   its own (head, image).  out is read through its strides for delta =
//   sum(g * o); dq, dk and dv are written through theirs.
// * Nq != Nk.  The dQ kernel walks the Nk keys, the dK/dV kernel the Nq
//   queries.  Keys past Nk weigh 0 in dQ; queries past Nq weigh 0 in dK/dV
//   (a zero row with lse 0 would give p = 1); rows past N are never written.
// * Masks.  Bool or additive f32, [B|1, 1|H, 1|Nq, Nk] with the last dim
//   contiguous, read through its image, head and row strides (row stride 0:
//   a key-only mask, one row, never expanded); one instantiation per kind.
//   Each thread reads its 32 entries of a tile straight into the
//   accumulator's layout, one tile ahead (the loads have a whole tile's
//   products to arrive in).  dQ reads rows of queries, two keys a load
//   where the layout keeps pairs aligned (`attn_mask_tile`, the forward's).
//   dK/dV holds S^T, keys as rows: it reads the mask transposed, one entry
//   a load, 8 neighbouring keys of 4 query rows a warp instruction.
// * Rounding: K6's, not K2's.  p = exp(s - lse) stays f32 into ds =
//   p (dp - delta); p is rounded to bf16 only as dV's A operand, ds once
//   for both dQ and dK (K2 rounds p before it forms ds).  lse is subtracted
//   before the change to log2 units: mask_value * log2e overflows to -inf,
//   and a fully masked bool row (lse = mask_value + log Nk, which rounds to
//   mask_value) must give p = 1 on every key, as the plain version; a row
//   whose scores are all -inf has lse 0 and gives p = 0.  ex2.approx.ftz
//   flushes a p below 2^-126 to 0, as in K7.
//
// The blocks.  384 threads: two consumer warpgroups of 64 rows and a
// producer warpgroup, one thread of which issues every TMA load (setmaxnreg
// hands the producer's registers to the consumers).  A block is persistent,
// one an SM, and walks the items (head, 128 rows, image) with the head
// fastest, so that the 12 heads of a tile run together and meet a mask
// panel broadcast over them in L2; its 4-stage ring runs on across items.
// * dQ: an item is 128 query rows.  Q and G arrive once an item (again as
//   soon as both warpgroups have issued the item's last products); each
//   thread forms delta for its two rows from g and out (a quarter row a
//   thread, summed over the row's four threads) and writes it to the
//   [B, H, Nq] f32 scratch.  The K/V tiles of 64 keys stream through the
//   ring.  Per tile: S = Q.K^T and dP = G.V^T from shared memory (K-major),
//   ds in registers, dQ += ds.K with ds the register A operand and K the
//   transposed B; S and dP of tile t run beside dQ of tile t - 1.
// * dK/dV: an item is 128 key rows.  K and V arrive once an item; the Q and
//   G tiles of 64 queries stream through the ring, the tile's lse and delta
//   (the dQ kernel's) beside them, copied by the producer's warp.  Per tile:
//   S^T = K.Q^T and dP^T = V.G^T, p^T and ds^T in registers, dV += p^T.G and
//   dK += ds^T.Q with register A operands.  S^T and dP^T of tile t are
//   issued beside dV and dK of tile t - 1, and p^T and ds^T of tile t are
//   formed while the second group runs (8-10% faster than one group at a
//   time, which K2's pair does: `tools/k6_variants_ab.py`).
// Two kernels and no atomics: every output element is written by one
// thread, and two calls give the same bits.
//
// Every template lives in an anonymous namespace: each translation unit
// that includes the header owns its instantiations.
#pragma once

#include "attention_wgmma.cuh"

namespace msvit {
namespace {

constexpr int kBwdRows = 128;  // rows an item (two consumer warpgroups of 64)
constexpr int kBwdStages = 4;  // ring depth

// q, k, v and g as 4-D TMA maps ([B, H, N, 64] through strides).
struct BwdMaps {
  CUtensorMap q, k, v, g;
};

// Everything else of one launch: element strides (image, head, row) of the
// tensors read or written through pointers.
struct BwdArgs {
  const void* mask;
  const bf16* out;
  const bf16* g;
  const float* lse;  // [B, H, Nq] f32, contiguous
  float* delta;      // [B, H, Nq] f32 scratch: written by dQ, read by dK/dV
  bf16 *dq, *dk, *dv;
  long long so[3], sg[3], sdq[3], sdk[3], sdv[3];
  long long msb, msh, msr;  // the mask's: image, head, query row (0: broadcast)
  int b, h, nq, nk, mask_kind;
  float scale, mask_value;
};

__device__ __forceinline__ long long at(const long long (&s)[3], int b, int h, int row) {
  return b * s[0] + h * s[1] + row * s[2];
}

__host__ __device__ constexpr int bwd_dq_smem_bytes() {
  // Q and G [128][64]; the K and V rings; the barriers; 1 KB of alignment
  // slack
  return 4 * hopper::kTileBytes + 2 * kBwdStages * hopper::kTileBytes +
         (2 + 2 * kBwdStages) * 8 + 1024;
}

__host__ __device__ constexpr int bwd_dkv_smem_bytes() {
  // K and V [128][64]; the Q and G rings; lse and delta of each stage; the
  // barriers; 1 KB of alignment slack
  return 4 * hopper::kTileBytes + 2 * kBwdStages * hopper::kTileBytes +
         kBwdStages * 2 * 64 * 4 + (2 + 2 * kBwdStages) * 8 + 1024;
}

// ds = p (dp - delta), p = exp(s - lse) in f32, of one 64-key tile of the
// dQ kernel in place of its scores (the mask's entries in mv: bool 1 =
// attend).  EDGE: the last tile, whose keys past Nk weigh 0.
template <int KIND, bool EDGE>
__device__ __forceinline__ void dq_ds_tile(float (&sc)[32], const float (&dp)[32],
                                           const float (&mv)[32], const float (&lse)[2],
                                           const float (&dl)[2], int kv0, int nk, int tq,
                                           float scale, float mask_value) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float x = sc[4 * j + e] * scale;
      if (KIND == kAddMask) x += mv[4 * j + e];
      if (KIND == kBoolMask && mv[4 * j + e] == 0.f) x = mask_value;
      // (s - lse) first, then log2 units
      float p = hopper::ex2((x - lse[r]) * kLog2e);
      if (EDGE && kv0 + j * 8 + 2 * tq + (e & 1) >= nk) p = 0.f;
      sc[4 * j + e] = p * (dp[4 * j + e] - dl[r]);
    }
  }
}

// p^T and ds^T of one 64-query tile of the dK/dV kernel in place of S^T
// and dP^T (keys as rows, queries as columns; the tile's lse and delta in
// `stats`).  EDGE: the last tile, whose queries past Nq weigh 0.
template <int KIND, bool EDGE>
__device__ __forceinline__ void dkv_p_ds_tile(float (&sc)[32], float (&dp)[32],
                                              const float (&mv)[32], const float* stats,
                                              int i0, int nq, int tq, float scale,
                                              float mask_value) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = j * 8 + 2 * tq + (e & 1);  // the query in the tile
      float x = sc[4 * j + e] * scale;
      if (KIND == kAddMask) x += mv[4 * j + e];
      if (KIND == kBoolMask && mv[4 * j + e] == 0.f) x = mask_value;
      float p = hopper::ex2((x - stats[c]) * kLog2e);
      if (EDGE && i0 + c >= nq) p = 0.f;
      sc[4 * j + e] = p;                                    // p^T, rounded into dV
      dp[4 * j + e] = p * (dp[4 * j + e] - stats[64 + c]);  // ds^T, rounded into dK
    }
  }
}

// The mask's entries of one 64-query tile in the layout of S^T (keys as
// rows): `mcol` the first entry of each of this thread's two key columns,
// `pitch` the bytes between query rows (0: a key-only mask).  EDGE: the
// last tile, whose queries past Nq read 0.
template <int KIND, bool EDGE>
__device__ __forceinline__ void attn_mask_tile_t(float (&mv)[32],
                                                 const unsigned char* const (&mcol)[2],
                                                 long long pitch, int i0, int nq, int tq) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + j * 8 + 2 * tq + (e & 1);
      float v = 0.f;
      if (!EDGE || i < nq) {
        const unsigned char* p = mcol[e >> 1] + i * pitch;
        v = KIND == kBoolMask ? (*p ? 1.f : 0.f) : *reinterpret_cast<const float*>(p);
      }
      mv[4 * j + e] = v;
    }
  }
}

// One persistent block of the dQ kernel: items (head, 128 query rows,
// image) w = blockIdx.x, blockIdx.x + gridDim.x, ..., the head fastest.
template <int KIND>
__global__ void __launch_bounds__(hopper::kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ BwdMaps maps, const BwdArgs a) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [128][64]
  bf16* gs = qs + 2 * 64 * 64;               // [128][64]
  bf16* ks = gs + 2 * 64 * 64;               // [stages][64][64]
  bf16* vs = ks + kBwdStages * 64 * 64;      // [stages][64][64]
  uint64_t* qfull = reinterpret_cast<uint64_t*>(vs + kBwdStages * 64 * 64);
  uint64_t* qempty = qfull + 1;
  uint64_t* full = qempty + 1;
  uint64_t* empty = full + kBwdStages;
  const int tiles = (a.nk + 63) / 64;
  const int qtiles = (a.nq + kBwdRows - 1) / kBwdRows;
  const int items = a.h * qtiles * a.b;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    mbar_init(qempty, kConsumerWarps);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full + s, 1);
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
      int g = 0;  // the block's tile count
      for (int w = blockIdx.x, i = 0; w < items; w += gridDim.x, ++i) {
        const int h = w % a.h;
        const int row0 = (w / a.h) % qtiles * kBwdRows;
        const int b = w / (a.h * qtiles);
        if (i > 0) mbar_wait(qempty, (i - 1) & 1);  // the last item's products are issued
        mbar_expect_tx(qfull, 4 * kTileBytes);
        tma_load_4d(qs, &maps.q, qfull, 0, row0, h, b);
        tma_load_4d(qs + 64 * 64, &maps.q, qfull, 0, row0 + 64, h, b);
        tma_load_4d(gs, &maps.g, qfull, 0, row0, h, b);
        tma_load_4d(gs + 64 * 64, &maps.g, qfull, 0, row0 + 64, h, b);
        for (int t = 0; t < tiles; ++t, ++g) {
          const int s = g % kBwdStages;
          mbar_wait(empty + s, ((g / kBwdStages) & 1) ^ 1);
          mbar_expect_tx(full + s, 2 * kTileBytes);
          tma_load_4d(ks + s * 64 * 64, &maps.k, full + s, 0, t * 64, h, b);
          tma_load_4d(vs + s * 64 * 64, &maps.v, full + s, 0, t * 64, h, b);
        }
      }
    }
    return;
  }

  reg_alloc<kConsumerRegs>();
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x / 32) % 4;
  const int tq = lane % 4;
  const int esize = KIND == kAddMask ? 4 : 1;
  const uint64_t dqd = desc(qs + wg * 64 * 64);
  const uint64_t dgd = desc(gs + wg * 64 * 64);
  int g = 0;  // the block's tile count, as the producer's

  for (int w = blockIdx.x, item = 0; w < items; w += gridDim.x, ++item) {
    const int h = w % a.h;
    const int row0 = (w / a.h) % qtiles * kBwdRows;
    const int b = w / (a.h * qtiles);
    const long long stat0 = (static_cast<long long>(b) * a.h + h) * a.nq;
    const int i_lo = row0 + wg * 64 + warp * 16 + lane / 4;
    const int irow[2] = {i_lo, i_lo + 8};  // this thread's accumulator rows
    // lse and delta of the two rows (0 past Nq); delta = sum(g * o) in f32
    // from a quarter of each row a thread, written once
    float lse_r[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = irow[r];
      float part = 0.f;
      if (i < a.nq) {
        const bf16* gr = a.g + at(a.sg, b, h, i) + tq * 16;
        const bf16* orow = a.out + at(a.so, b, h, i) + tq * 16;
#pragma unroll
        for (int e = 0; e < 16; e += 8) {
          float gf[8], of[8];
          Vec8<bf16>::load(gr + e, gf);
          Vec8<bf16>::load(orow + e, of);
#pragma unroll
          for (int u = 0; u < 8; ++u) part = fmaf(gf[u], of[u], part);
        }
      }
      dl[r] = row_sum<4>(part);
      lse_r[r] = i < a.nq ? a.lse[stat0 + i] : 0.f;
      if (tq == 0 && i < a.nq) a.delta[stat0 + i] = dl[r];
    }
    // this thread's two mask rows (a row past Nq reads row Nq - 1, never
    // used); every pair of keys aligned for one load where the base and
    // each stride keep it so
    const unsigned char* mrow[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mrow[r] = static_cast<const unsigned char*>(a.mask) +
                (b * a.msb + h * a.msh + min(irow[r], a.nq - 1) * a.msr) * esize;
    const bool pairs = (reinterpret_cast<uintptr_t>(mrow[0]) % (2 * esize) == 0 &&
                        a.msr % 2 == 0);

    float acc[32], sc[32], dp[32], mv[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      acc[e] = 0.f;
      sc[e] = 0.f;
      dp[e] = 0.f;
      mv[e] = 0.f;
    }
    uint32_t da[4][4];  // ds of the previous tile: the A operand of 4 k-steps
    auto load_mask = [&](int t) {
      const int kv0 = t * 64;
      if (KIND == kNoMask) return;
      if (kv0 + 64 > a.nk)
        attn_mask_tile<KIND, true, false>(mv, mrow, a.nk, kv0, tq);
      else if (pairs)
        attn_mask_tile<KIND, false, true>(mv, mrow, a.nk, kv0, tq);
      else
        attn_mask_tile<KIND, false, false>(mv, mrow, a.nk, kv0, tq);
    };
    auto form = [&](int t) {
      const int kv0 = t * 64;
      if (kv0 + 64 > a.nk)
        dq_ds_tile<KIND, true>(sc, dp, mv, lse_r, dl, kv0, a.nk, tq, a.scale, a.mask_value);
      else
        dq_ds_tile<KIND, false>(sc, dp, mv, lse_r, dl, kv0, a.nk, tq, a.scale, a.mask_value);
    };
    // S and dP of the block's tile gt (one group)
    auto products = [&](int gt) {
      const int s = gt % kBwdStages;
      mbar_wait(full + s, (gt / kBwdStages) & 1);
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
    // dQ += ds.K of the block's tile gt (K as the transposed B)
    auto accumulate = [&](int gt) {
      const int s = gt % kBwdStages;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_t(acc, da[kk], desc(ks + s * 64 * 64) + kstep_mn(kk));
      wgmma_commit();
    };
    // the item's last products are done: Q and G may be loaded again
    auto release_q = [&]() {
      if (lane == 0) mbar_arrive(qempty);
    };

    load_mask(0);
    mbar_wait(qfull, item & 1);
    products(g);
    wgmma_wait<0>();
    fence_acc(sc);
    fence_acc(dp);
    if (tiles == 1) release_q();
    form(0);
    if (tiles > 1) load_mask(1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(da[kk], sc, kk);
    for (int t = 1; t < tiles; ++t) {
      products(g + t);
      accumulate(g + t - 1);
      wgmma_wait<1>();  // S and dP of tile t
      fence_acc(sc);
      fence_acc(dp);
      if (t == tiles - 1) release_q();
      form(t);
      if (t + 1 < tiles) load_mask(t + 1);  // arrives during the next tile's products
      wgmma_wait<0>();  // dQ of tile t - 1
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty + (g + t - 1) % kBwdStages);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(da[kk], sc, kk);
    }
    fence_acc(acc);
    wgmma_fence();
    accumulate(g + tiles - 1);
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty + (g + tiles - 1) % kBwdStages);
    g += tiles;

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = irow[r];
      if (i >= a.nq) continue;
      bf16* dst = a.dq + at(a.sdq, b, h, i);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + j * 8 + 2 * tq) =
            pack_bf16(acc[4 * j + 2 * r] * a.scale, acc[4 * j + 2 * r + 1] * a.scale);
    }
  }
}

// One persistent block of the dK/dV kernel: items (head, 128 key rows,
// image), the head fastest.
template <int KIND>
__global__ void __launch_bounds__(hopper::kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ BwdMaps maps, const BwdArgs a) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [128][64]
  bf16* vs = ks + 2 * 64 * 64;               // [128][64]
  bf16* qs = vs + 2 * 64 * 64;               // [stages][64][64]
  bf16* gs = qs + kBwdStages * 64 * 64;      // [stages][64][64]
  float* stats = reinterpret_cast<float*>(gs + kBwdStages * 64 * 64);  // [stages][lse, delta][64]
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(stats + kBwdStages * 2 * 64);
  uint64_t* kvempty = kvfull + 1;
  uint64_t* full = kvempty + 1;
  uint64_t* empty = full + kBwdStages;
  const int tiles = (a.nq + 63) / 64;
  const int ktiles = (a.nk + kBwdRows - 1) / kBwdRows;
  const int items = a.h * ktiles * a.b;

  if (threadIdx.x == 0) {
    mbar_init(kvfull, 1);
    mbar_init(kvempty, kConsumerWarps);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full + s, 1 + 32);  // the copies' bytes and the stats' 32 lanes
      mbar_init(empty + s, kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup, provably uniform across each warp (the role branch below)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == 2) {  // the producer: one thread issues the copies, its warp
                  // stages each tile's lse and delta (Nq f32 rows are not
                  // the 16-byte pitches TMA takes)
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x / 32 == 8) {
      const int lane = threadIdx.x % 32;
      int g = 0;  // the block's tile count
      for (int w = blockIdx.x, i = 0; w < items; w += gridDim.x, ++i) {
        const int h = w % a.h;
        const int row0 = (w / a.h) % ktiles * kBwdRows;
        const int b = w / (a.h * ktiles);
        const long long stat0 = (static_cast<long long>(b) * a.h + h) * a.nq;
        if (i > 0) mbar_wait(kvempty, (i - 1) & 1);  // the last item's products are done
        if (lane == 0) {
          mbar_expect_tx(kvfull, 4 * kTileBytes);
          tma_load_4d(ks, &maps.k, kvfull, 0, row0, h, b);
          tma_load_4d(ks + 64 * 64, &maps.k, kvfull, 0, row0 + 64, h, b);
          tma_load_4d(vs, &maps.v, kvfull, 0, row0, h, b);
          tma_load_4d(vs + 64 * 64, &maps.v, kvfull, 0, row0 + 64, h, b);
        }
        for (int t = 0; t < tiles; ++t, ++g) {
          const int s = g % kBwdStages;
          mbar_wait(empty + s, ((g / kBwdStages) & 1) ^ 1);
          if (lane == 0) {
            mbar_expect_tx(full + s, 2 * kTileBytes);
            tma_load_4d(qs + s * 64 * 64, &maps.q, full + s, 0, t * 64, h, b);
            tma_load_4d(gs + s * 64 * 64, &maps.g, full + s, 0, t * 64, h, b);
          }
          float* st = stats + s * 128;
          for (int c = lane; c < 64; c += 32) {  // 0 past Nq
            const bool in = t * 64 + c < a.nq;
            st[c] = in ? a.lse[stat0 + t * 64 + c] : 0.f;
            st[64 + c] = in ? a.delta[stat0 + t * 64 + c] : 0.f;
          }
          mbar_arrive(full + s);
        }
      }
    }
    return;
  }

  reg_alloc<kConsumerRegs>();
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x / 32) % 4;
  const int tq = lane % 4;
  const int esize = KIND == kAddMask ? 4 : 1;
  const long long pitch = a.msr * esize;  // bytes between the mask's query rows
  const uint64_t dkd = desc(ks + wg * 64 * 64);
  const uint64_t dvd = desc(vs + wg * 64 * 64);
  int g = 0;  // the block's tile count, as the producer's

  for (int w = blockIdx.x, item = 0; w < items; w += gridDim.x, ++item) {
    const int h = w % a.h;
    const int row0 = (w / a.h) % ktiles * kBwdRows;
    const int b = w / (a.h * ktiles);
    const int j_lo = row0 + wg * 64 + warp * 16 + lane / 4;
    const int jrow[2] = {j_lo, j_lo + 8};  // this thread's keys
    // this thread's two mask columns (a key past Nk reads key Nk - 1,
    // never used)
    const unsigned char* mcol[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mcol[r] = static_cast<const unsigned char*>(a.mask) +
                (b * a.msb + h * a.msh + min(jrow[r], a.nk - 1)) * esize;

    float dk[32], dv[32], sc[32], dp[32], mv[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      dk[e] = 0.f;
      dv[e] = 0.f;
      sc[e] = 0.f;
      dp[e] = 0.f;
      mv[e] = 0.f;
    }
    uint32_t pa[4][4], da[4][4];  // p^T and ds^T of the previous tile
    auto load_mask = [&](int t) {
      const int i0 = t * 64;
      if (KIND == kNoMask) return;
      if (i0 + 64 > a.nq)
        attn_mask_tile_t<KIND, true>(mv, mcol, pitch, i0, a.nq, tq);
      else
        attn_mask_tile_t<KIND, false>(mv, mcol, pitch, i0, a.nq, tq);
    };
    auto form = [&](int t, int s) {
      const int i0 = t * 64;
      const float* st = stats + s * 128;
      if (i0 + 64 > a.nq)
        dkv_p_ds_tile<KIND, true>(sc, dp, mv, st, i0, a.nq, tq, a.scale, a.mask_value);
      else
        dkv_p_ds_tile<KIND, false>(sc, dp, mv, st, i0, a.nq, tq, a.scale, a.mask_value);
    };
    // S^T = K.Q^T and dP^T = V.G^T of the stage s (one group)
    auto products = [&](int s) {
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
    // dV += p^T.G and dK += ds^T.Q of the stage s (G and Q as transposed
    // B; one group)
    auto accumulate = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_t(dv, pa[kk], desc(gs + s * 64 * 64) + kstep_mn(kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_t(dk, da[kk], desc(qs + s * 64 * 64) + kstep_mn(kk));
      wgmma_commit();
    };
    // the products of the stage s are done: it is free
    auto release = [&](int s) {
      wgmma_wait<0>();
      fence_acc(dk);
      fence_acc(dv);
      if (lane == 0) mbar_arrive(empty + s);
    };

    load_mask(0);
    mbar_wait(kvfull, item & 1);
    for (int t = 0; t < tiles; ++t) {
      const int gt = g + t;
      const int s = gt % kBwdStages;
      mbar_wait(full + s, (gt / kBwdStages) & 1);
      fence_acc(dk);
      fence_acc(dv);
      products(s);
      if (t > 0) {
        accumulate((gt - 1) % kBwdStages);
        wgmma_wait<1>();  // S^T and dP^T of tile t
      } else {
        wgmma_wait<0>();
      }
      fence_acc(sc);
      fence_acc(dp);
      if (t == tiles - 1 && lane == 0) mbar_arrive(kvempty);  // K and V are read
      form(t, s);  // while dV and dK of tile t - 1 run
      if (t + 1 < tiles) load_mask(t + 1);  // arrives during the next tile's products
      if (t > 0) release((gt - 1) % kBwdStages);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc_to_a(pa[kk], sc, kk);
        acc_to_a(da[kk], dp, kk);
      }
    }
    fence_acc(dk);
    fence_acc(dv);
    wgmma_fence();
    accumulate((g + tiles - 1) % kBwdStages);
    release((g + tiles - 1) % kBwdStages);
    g += tiles;

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = jrow[r];
      if (key >= a.nk) continue;
      bf16* dkr = a.dk + at(a.sdk, b, h, key);
      bf16* dvr = a.dv + at(a.sdv, b, h, key);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = j * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(dkr + col) =
            pack_bf16(dk[4 * j + 2 * r] * a.scale, dk[4 * j + 2 * r + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dvr + col) =
            pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

// The blocks of a persistent launch: one an SM, fewer where there are
// fewer items.
inline int persistent_grid(long long items, int sms) {
  return static_cast<int>(items < sms ? items : sms);
}

template <int KIND>
cudaError_t launch_bwd_kind(const BwdMaps& maps, const BwdArgs& a, cudaStream_t stream) {
  static std::atomic<unsigned long long> dq_done{0}, dkv_done{0};
  cudaError_t err = hopper::allow_smem_once(flash_bwd_dq_wgmma_kernel<KIND>,
                                            bwd_dq_smem_bytes(), dq_done);
  if (err == cudaSuccess)
    err = hopper::allow_smem_once(flash_bwd_dkv_wgmma_kernel<KIND>, bwd_dkv_smem_bytes(),
                                  dkv_done);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long q_items =
      static_cast<long long>(a.h) * ((a.nq + kBwdRows - 1) / kBwdRows) * a.b;
  const long long k_items =
      static_cast<long long>(a.h) * ((a.nk + kBwdRows - 1) / kBwdRows) * a.b;
  flash_bwd_dq_wgmma_kernel<KIND>
      <<<persistent_grid(q_items, sms), hopper::kThreads, bwd_dq_smem_bytes(), stream>>>(
          maps, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_wgmma_kernel<KIND>
      <<<persistent_grid(k_items, sms), hopper::kThreads, bwd_dkv_smem_bytes(), stream>>>(
          maps, a);
  return cudaGetLastError();
}

// The two launches on `stream`, dQ then dK/dV, the instantiation of
// a.mask_kind; returns cudaGetLastError() after them.
inline cudaError_t launch_bwd_wgmma(const BwdMaps& maps, const BwdArgs& a,
                                    cudaStream_t stream) {
  if (a.mask_kind == kBoolMask) return launch_bwd_kind<kBoolMask>(maps, a, stream);
  if (a.mask_kind == kAddMask) return launch_bwd_kind<kAddMask>(maps, a, stream);
  return launch_bwd_kind<kNoMask>(maps, a, stream);
}

}  // namespace
}  // namespace msvit
