// The Hopper attention forward on [B, H, N, 64] bf16 operands, shared by
// K1 (`packed_attention.cu`, the shaved serving softmax), K4
// (`fused_attention.cu`, the shaved softmax with l summed in f32), K7 /
// K7-lse (`flash_attention.cu`, the exact online softmax) and K5 / K5-lse
// (`fused_attention.cu`, the same exact softmax: the TPU's two kernels
// compute one function): warpgroup products (wgmma) fed by TMA,
// warp-specialised.  It is K1-lse's design (`packed_attention_lse.cu`,
// packed_lse_wgmma_kernel), generalised to operands read through strides,
// Nq != Nk and broadcast masks.  K10's cluster-banded token rows run a
// sibling kernel on the same pipeline and K1's softmax,
// `banded_wgmma_kernel` in `banded_attention.cu` (it has one user, and a
// kernel that is not a template, written here, would be compiled into
// every source that includes this header).
//
// What bounds it on the card: operations, 4*Nq*Nk*64 FLOP per head against
// 2*(Nq + 2*Nk)*64 bytes of q/k/v/out plus the mask's entries (0.2494 ms of
// operations at K7's [8, 12, 3168, 64]; 0.1225 ms at K1's [64, 785, 2304]).
//
// Operands.  q, k and v are each a 4-D TMA map over a [B, H, N, 64] bf16
// view given by its element strides (image, head, row), the head's 64
// elements contiguous: dims (64, N, H, B), box (64, 64, 1, 1) = 64 rows of
// one (head, image), 128-byte swizzle.  A box past N is zero-filled inside
// its own (head, image).  K7's views of the QKV GEMM output ([B, N, 3D],
// row pitch 3D*2 bytes, head pitch 128) and contiguous tensors map alike;
// K1's packed qkv is the same view at element offsets 0, D and 2D, whose
// boxes are the ones K1-lse's 3-D map reads at columns h*64, D + h*64 and
// 2D + h*64.  The output is written through its own strides (K1: packed
// [B, N, D] at column h*64; K7: [B, Nq, H, 64] in memory); rows past Nq
// are never written.
//
// The block.  An item is 128 query rows of one (head, image): two consumer
// warpgroups of 64 rows and one producer warpgroup, of which one thread
// issues every load (Q, then the 64-key K and V tiles through a 4-stage
// ring with full/empty mbarriers).  setmaxnreg hands the producer's
// registers to the consumers.  Per tile each consumer warpgroup runs S =
// Q.K^T as 4 wgmma.m64n64k16 from shared memory, the softmax on the
// accumulator, and O += P.V with p rounded to bf16 in registers as the A
// operand (V the transposed B from shared memory).  S of tile t is issued
// beside P.V of tile t - 1, so one warpgroup's products run during its own
// softmax and the other's.  The block is persistent, one an SM: it walks
// the items with the head fastest, then the query tile, then the image, so
// that the heads of one query tile run together and meet a mask panel
// broadcast over them in L2 (K7's 448-px soft mask, [8, 1, 3168, 3168]
// f32, would cost ~1.15 ms read once per head); the ring runs on across
// items and the next item's Q is loaded as soon as this one's last S is
// done, so that a short item (K1's 197 tokens: 4 key tiles) does not wait
// for its loads at its start.
//
// The mask.  Bool (one byte, true = attend) or additive f32, [B|1, 1|H,
// 1|Nq, Nk] with the last dim contiguous, read through its image, head and
// row strides (row stride 0: a key-only mask, one row that every query row
// reads, never expanded).  The kernel is instantiated per mask kind.  Each
// thread loads its own 32 entries straight into the accumulator's layout
// from its two rows' pointers, and loads the next tile's entries as soon
// as this tile's softmax has read them, so that a load has a whole tile's
// products and softmax to arrive in.  A pair of keys is one 2-byte (bool)
// or 8-byte (f32) load where the mask's base, image, head and row strides
// keep every pair aligned (`pairs`), else two loads: a function of the
// mask's layout, the same values either way.  Only the last, partial tile
// checks its keys against Nk.
//
// Softmax (in log2 units: x = s * scale * log2e plus the additive mask
// times log2e; 2^x as one ex2.approx.ftz), the template's SOFTMAX:
// * Shaved (K1, kShaved): a false bool entry at mask_value * log2e
//   clipped; x clipped to +-80 * log2e; p = 2^x with no row max and no
//   rescale, rounded to bf16 into P.V, and l summed from the rounded p (the
//   TPU's column of ones through the MXU).  An additive -inf entry clips
//   to -80 * log2e (fmaf(-inf, log2e, x) is -inf, fmaxf clips it, no NaN).
//   K4 (kShavedF32Sum) is the same softmax with l summed from the
//   unrounded p in f32, as the TPU's `jnp.sum(p)` before `_pv_transposed`
//   rounds p for P.V.  Keys past Nk weigh exactly 0,
//   not e^-80 (TMA's zero-filled rows would give s = 0, p = 1): a fully
//   masked bool row is mean(V) over the real keys.  l >= Nk * e^-80 > 0: no
//   zero guard.  The clip keeps every p >= 2^-115.4 > 2^-126, so the
//   flush of ex2.approx.ftz never acts here.
// * Exact (K7 / K7-lse and K5 / K5-lse, kExact): the online row
//   max m; p = 2^(x - m), l summed from the unrounded p, p rounded to bf16
//   into P.V; a new max rescales l and O.  A -inf score weighs nothing; keys past Nk are
//   -inf; a row with l == 0 (every score -inf) gives zeros and lse 0 (the
//   TPU's l_inv guard).  A false bool entry sits at mask_value * log2e, or
//   at the most negative finite float where that overflows: a fully masked
//   row is mean(V) with lse = mask_value + log l.  ex2.approx.ftz flushes a
//   p below 2^-126 to 0 (it would weigh below 2^-126 of the row's largest).
//   The lse is compact [B, H, Nq] f32, written where the pointer is not
//   null; out is the same bits either way.
//
// Every template lives in an anonymous namespace: each translation unit
// that includes the header owns its instantiations.  `Unit` tags the
// kernel's name with the entry point that launches it, so that a profile
// tells K5 (`fused_attention.cu`, Unit = FusedUnit) and K4
// (FusedInferenceUnit) from K7 and K1 (void); it changes nothing else.
#pragma once

#include "hopper.cuh"

namespace msvit {
namespace {

constexpr int kAttnRows = 128;  // query rows a block (two warpgroups of 64)
constexpr int kAttnStages = 4;  // K/V ring depth

// The softmax of an instantiation (the header note).
constexpr int kExact = 0;         // K7 / K7-lse, K5 / K5-lse
constexpr int kShaved = 1;        // K1: l from the rounded p (K10 rounds as K1)
constexpr int kShavedF32Sum = 2;  // K4: l from the unrounded p

// q, k and v as 4-D TMA maps ([B, H, N, 64] through strides).
struct QkvMaps {
  CUtensorMap q, k, v;
};

// Everything else of one launch.
struct AttnArgs {
  const void* mask;
  bf16* out;
  float* lse;                    // null: no lse (exact softmax only)
  long long ob, oh, on;          // out's element strides: image, head, row
  long long msb, msh, msr;       // the mask's: image, head, query row (0: broadcast)
  int b, h, nq, nk, mask_kind;
  float scale, mask_value;
};

__host__ __device__ constexpr int attn_wgmma_smem_bytes() {
  // Q [128][64], the K and V rings, the barriers; 1 KB of alignment slack
  return 2 * hopper::kTileBytes + 2 * kAttnStages * hopper::kTileBytes +
         (2 + 3 * kAttnStages) * 8 + 1024;
}

// The mask's entries of one 64-key tile in the accumulator's layout (bool:
// 1 = attend), from this thread's two rows (`mrow`: each row's first entry;
// a row past Nq reads row Nq - 1, whose entries are never used).  EDGE:
// the last tile, whose keys past Nk read 0.  PAIRS: the two keys of a pair
// are one aligned load.
template <int KIND, bool EDGE, bool PAIRS>
__device__ __forceinline__ void attn_mask_tile(float (&mv)[32],
                                               const unsigned char* const (&mrow)[2],
                                               int nk, int kv0, int tq) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = kv0 + j * 8 + 2 * tq;  // even: this thread's keys col, col + 1
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v[2] = {0.f, 0.f};
      if (KIND == kBoolMask) {
        const uint8_t* p = mrow[r] + col;
        if (PAIRS && (!EDGE || col + 1 < nk)) {
          const uint16_t u = *reinterpret_cast<const uint16_t*>(p);
          v[0] = (u & 0xffu) ? 1.f : 0.f;
          v[1] = (u >> 8) ? 1.f : 0.f;
        } else {
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (!EDGE || col + u < nk) v[u] = p[u] ? 1.f : 0.f;
        }
      } else {
        const float* p = reinterpret_cast<const float*>(mrow[r]) + col;
        if (PAIRS && (!EDGE || col + 1 < nk)) {
          const float2 u = *reinterpret_cast<const float2*>(p);
          v[0] = u.x;
          v[1] = u.y;
        } else {
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (!EDGE || col + u < nk) v[u] = p[u];
        }
      }
      mv[4 * j + 2 * r] = v[0];
      mv[4 * j + 2 * r + 1] = v[1];
    }
  }
}

// The shaved probabilities of one tile in place of its scores, rounded to
// bf16 (kept as floats: acc_to_a packs them again, exactly), and l summed
// from the rounded p (kShaved) or the unrounded one (kShavedF32Sum).
// KIND: the mask's; EDGE: the last tile, whose keys past Nk weigh 0.
template <int KIND, bool EDGE, int SOFTMAX>
__device__ __forceinline__ void shaved_tile(float (&sc)[32], const float (&mv)[32],
                                            int kv0, int nk, int tq, float c2,
                                            float masked, float (&l)[2]) {
  constexpr float kClip = 80.f * kLog2e;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float p[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = 4 * j + 2 * r + u;
        float x = sc[e] * c2;
        if (KIND == kAddMask) x = fmaf(mv[e], kLog2e, x);
        if (KIND == kBoolMask && mv[e] == 0.f) x = masked;
        p[u] = hopper::ex2(fminf(fmaxf(x, -kClip), kClip));
        if (EDGE && kv0 + j * 8 + 2 * tq + u >= nk) p[u] = 0.f;  // not e^-80
      }
      const uint32_t pr = pack_bf16(p[0], p[1]);  // lo: the lower key
      const float lo = __uint_as_float(pr << 16);
      const float hi = __uint_as_float(pr & 0xffff0000u);
      l[r] += SOFTMAX == kShaved ? lo + hi : p[0] + p[1];  // the rounded p, or not
      sc[4 * j + 2 * r] = lo;
      sc[4 * j + 2 * r + 1] = hi;
    }
  }
}

// The exact online softmax of one tile on its score accumulator: scale,
// mask, ragged edge, the new row max m, p = 2^(x - m) in place of the
// scores, l rescaled and summed from the unrounded p; corr: the factors O
// is rescaled by.  KIND and EDGE as `shaved_tile`'s (keys past Nk -inf).
template <int KIND, bool EDGE>
__device__ __forceinline__ void exact_tile(float (&sc)[32], const float (&mv)[32],
                                           int kv0, int nk, int tq, float c2,
                                           float masked, float (&m)[2], float (&l)[2],
                                           float (&corr)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e] * c2;
      if (KIND == kAddMask) x = fmaf(mv[4 * j + e], kLog2e, x);
      if (KIND == kBoolMask && mv[4 * j + e] == 0.f) x = masked;
      if (EDGE && kv0 + j * 8 + 2 * tq + (e & 1) >= nk) x = -INFINITY;
      sc[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    // 2^-inf = 0 rescales the empty start; an all -inf row keeps m at -inf
    // and subtracts 0, never -inf - -inf
    mu[r] = mx[r] == -INFINITY ? 0.f : mx[r];
    corr[r] = hopper::ex2(m[r] - mu[r]);
    m[r] = mx[r];
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = hopper::ex2(sc[4 * j + e] - mu[e >> 1]);
      l[e >> 1] += p;  // the unrounded p
      sc[4 * j + e] = p;
    }
  }
}

// A persistent block: one an SM, walking the items (head, 128 query
// rows, image) w = blockIdx.x, blockIdx.x + gridDim.x, ... in the order of
// the head fastest, then the query tile, then the image; bf16, head size
// 64.  KIND: the mask's (kNoMask, kBoolMask, kAddMask; a.mask_kind).  The
// K/V ring runs on across items (tile g of the block sits in stage
// g % kAttnStages); Q is loaded again once both consumer warpgroups have
// issued their last S of the item before (qempty), so the next item's Q
// and first tiles arrive while they finish this one.  SOFTMAX: kExact,
// kShaved or kShavedF32Sum.
template <int SOFTMAX, int KIND, typename Unit>
__global__ void __launch_bounds__(hopper::kThreads, 1)
attention_wgmma_kernel(const __grid_constant__ QkvMaps maps, const AttnArgs a) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(smem);    // [128][64]
  bf16* ks = qs + 2 * 64 * 64;                 // [stages][64][64]
  bf16* vs = ks + kAttnStages * 64 * 64;       // [stages][64][64]
  uint64_t* qfull = reinterpret_cast<uint64_t*>(vs + kAttnStages * 64 * 64);
  uint64_t* qempty = qfull + 1;
  uint64_t* kfull = qempty + 1;
  uint64_t* vfull = kfull + kAttnStages;
  uint64_t* empty = vfull + kAttnStages;
  const int tiles = (a.nk + 63) / 64;
  const int qtiles = (a.nq + kAttnRows - 1) / kAttnRows;
  const int items = a.h * qtiles * a.b;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    mbar_init(qempty, kConsumerWarps);
    for (int s = 0; s < kAttnStages; ++s) {
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
      int g = 0;  // the block's tile count
      for (int w = blockIdx.x, i = 0; w < items; w += gridDim.x, ++i) {
        const int h = w % a.h;
        const int row0 = (w / a.h) % qtiles * kAttnRows;
        const int b = w / (a.h * qtiles);
        if (i > 0) mbar_wait(qempty, (i - 1) & 1);  // the last item's S are issued
        mbar_expect_tx(qfull, 2 * kTileBytes);
        tma_load_4d(qs, &maps.q, qfull, 0, row0, h, b);
        tma_load_4d(qs + 64 * 64, &maps.q, qfull, 0, row0 + 64, h, b);
        for (int t = 0; t < tiles; ++t, ++g) {
          const int s = g % kAttnStages;
          mbar_wait(empty + s, ((g / kAttnStages) & 1) ^ 1);
          mbar_expect_tx(kfull + s, kTileBytes);
          tma_load_4d(ks + s * 64 * 64, &maps.k, kfull + s, 0, t * 64, h, b);
          mbar_expect_tx(vfull + s, kTileBytes);
          tma_load_4d(vs + s * 64 * 64, &maps.v, vfull + s, 0, t * 64, h, b);
        }
      }
    }
    return;
  }

  reg_alloc<kConsumerRegs>();
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x / 32) % 4;
  const int tq = lane % 4;
  constexpr bool SHAVED = SOFTMAX != kExact;
  const int esize = KIND == kAddMask ? 4 : 1;
  const float c2 = a.scale * kLog2e;
  // a false bool entry in log2 units.  Shaved: mask_value clipped, as every
  // score.  Exact: mask_value * log2e overflows to -inf at the default
  // mask_value, where the TPU's entry is finite (a fully masked row is
  // mean(V)): the most negative finite float instead
  const float masked = SHAVED ? fminf(fmaxf(a.mask_value * kLog2e, -80.f * kLog2e),
                                      80.f * kLog2e)
                              : fmaxf(a.mask_value * kLog2e, -3.402823466e38f);
  const uint64_t dq = desc(qs + wg * 64 * 64);
  int g = 0;  // the block's tile count, as the producer's

  for (int w = blockIdx.x, item = 0; w < items; w += gridDim.x, ++item) {
    const int h = w % a.h;
    const int row0 = (w / a.h) % qtiles * kAttnRows;
    const int b = w / (a.h * qtiles);
    // this thread's two accumulator rows
    const int i_lo = row0 + wg * 64 + warp * 16 + lane / 4;
    const int irow[2] = {i_lo, i_lo + 8};
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

    float o[32], sc[32], mv[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      o[e] = 0.f;
      sc[e] = 0.f;
      mv[e] = 0.f;
    }
    float m[2] = {-INFINITY, -INFINITY};  // log2 units (exact)
    float l[2] = {0.f, 0.f};              // this lane's part of the row sums
    float corr[2] = {1.f, 1.f};
    uint32_t pa[4][4];  // p of the previous tile in bf16: the A operand of 4 k-steps
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
    auto softmax = [&](int t) {
      const int kv0 = t * 64;
      if (SHAVED) {
        if (kv0 + 64 > a.nk)
          shaved_tile<KIND, true, SOFTMAX>(sc, mv, kv0, a.nk, tq, c2, masked, l);
        else
          shaved_tile<KIND, false, SOFTMAX>(sc, mv, kv0, a.nk, tq, c2, masked, l);
      } else {
        if (kv0 + 64 > a.nk)
          exact_tile<KIND, true>(sc, mv, kv0, a.nk, tq, c2, masked, m, l, corr);
        else
          exact_tile<KIND, false>(sc, mv, kv0, a.nk, tq, c2, masked, m, l, corr);
      }
    };
    // the item's last S is issued and done: Q may be loaded again
    auto release_q = [&]() {
      if (lane == 0) mbar_arrive(qempty);
    };
    load_mask(0);
    mbar_wait(qfull, item & 1);

    // tile 0: S, then its softmax
    mbar_wait(kfull + g % kAttnStages, (g / kAttnStages) & 1);
    fence_acc(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(sc, dq + kstep_k(kk), desc(ks + g % kAttnStages * 64 * 64) + kstep_k(kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);
    if (tiles == 1) release_q();
    softmax(0);
    if (tiles > 1) load_mask(1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(pa[kk], sc, kk);

    for (int t = 1; t < tiles; ++t) {
      const int gt = g + t;
      const int s = gt % kAttnStages;
      const int sp = (gt - 1) % kAttnStages;  // the previous tile's stage
      mbar_wait(kfull + s, (gt / kAttnStages) & 1);
      mbar_wait(vfull + sp, ((gt - 1) / kAttnStages) & 1);
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
      wgmma_wait<1>();  // S of tile t
      fence_acc(sc);
      if (t == tiles - 1) release_q();
      softmax(t);
      if (t + 1 < tiles) load_mask(t + 1);  // arrives during the next tile's products
      wgmma_wait<0>();  // P.V of tile t - 1
      fence_acc(o);
      if (lane == 0) mbar_arrive(empty + sp);  // this warp is done with its stage
      if (!SHAVED) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[4 * j] *= corr[0];
          o[4 * j + 1] *= corr[0];
          o[4 * j + 2] *= corr[1];
          o[4 * j + 3] *= corr[1];
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(pa[kk], sc, kk);
    }

    // P.V of the last tile, then its stage is free
    const int gl = g + tiles - 1;
    const int sl = gl % kAttnStages;
    mbar_wait(vfull + sl, (gl / kAttnStages) & 1);
    fence_acc(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_t(o, pa[kk], desc(vs + sl * 64 * 64) + kstep_mn(kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    if (lane == 0) mbar_arrive(empty + sl);
    g += tiles;

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = row_sum<4>(l[r]);
      const int i = irow[r];
      if (i >= a.nq) continue;
      // shaved: o / l (l > 0); exact: o * (1 / l), 1 where l == 0
      const float l_inv = SHAVED ? 1.f / lr : (lr == 0.f ? 1.f : 1.f / lr);
      bf16* orow = a.out + b * a.ob + h * a.oh + i * a.on;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float c0 = o[4 * j + 2 * r], c1 = o[4 * j + 2 * r + 1];
        *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * tq) =
            SHAVED ? pack_bf16(c0 / lr, c1 / lr) : pack_bf16(c0 * l_inv, c1 * l_inv);
      }
      if (!SHAVED && a.lse != nullptr && tq == 0) {
        // back to natural units; a fully masked row's max is `masked`,
        // whose natural value is mask_value itself
        const float mn = m[r] == masked ? a.mask_value : m[r] * 0.6931471805599453f;
        a.lse[(static_cast<long long>(b) * a.h + h) * a.nq + i] =
            lr > 0.f ? mn + logf(lr) : 0.f;
      }
    }
  }
}

// The maps of q, k and v: [B, H, N, 64] bf16 views through element strides
// `st` (image, head, row of q, then k, then v).
inline cudaError_t map_qkv(QkvMaps* maps, const void* q, const void* k, const void* v,
                           int b, int h, int nq, int nk, const long long* st) {
  cudaError_t err = hopper::map_heads(&maps->q, q, b, h, nq, st[0], st[1], st[2]);
  if (err == cudaSuccess) err = hopper::map_heads(&maps->k, k, b, h, nk, st[3], st[4], st[5]);
  if (err == cudaSuccess) err = hopper::map_heads(&maps->v, v, b, h, nk, st[6], st[7], st[8]);
  return err;
}

// The kernel's dynamic shared memory, allowed once per device and
// instantiation.
template <int SOFTMAX, int KIND, typename Unit>
cudaError_t allow_attn_smem() {
  static std::atomic<unsigned long long> done{0};
  return hopper::allow_smem_once(attention_wgmma_kernel<SOFTMAX, KIND, Unit>,
                                 attn_wgmma_smem_bytes(), done);
}

// The SMs of the current device (read once per device).
inline cudaError_t sm_count(int* sms) {
  static std::atomic<int> known[64];  // zero-initialised: static storage
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  *sms = known[device & 63].load(std::memory_order_relaxed);
  if (*sms > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) known[device & 63].store(*sms, std::memory_order_relaxed);
  return err;
}

template <int SOFTMAX, int KIND, typename Unit>
cudaError_t launch_kind(const QkvMaps& maps, const AttnArgs& a, cudaStream_t stream) {
  cudaError_t err = allow_attn_smem<SOFTMAX, KIND, Unit>();
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long items =
      static_cast<long long>(a.h) * ((a.nq + kAttnRows - 1) / kAttnRows) * a.b;
  const int grid = static_cast<int>(items < sms ? items : sms);
  attention_wgmma_kernel<SOFTMAX, KIND, Unit>
      <<<grid, hopper::kThreads, attn_wgmma_smem_bytes(), stream>>>(maps, a);
  return cudaGetLastError();
}

// One launch on `stream`, the instantiation of a.mask_kind; returns
// cudaGetLastError() after it.
template <int SOFTMAX, typename Unit = void>
cudaError_t launch_attn_wgmma(const QkvMaps& maps, const AttnArgs& a, cudaStream_t stream) {
  if (a.mask_kind == kBoolMask) return launch_kind<SOFTMAX, kBoolMask, Unit>(maps, a, stream);
  if (a.mask_kind == kAddMask) return launch_kind<SOFTMAX, kAddMask, Unit>(maps, a, stream);
  return launch_kind<SOFTMAX, kNoMask, Unit>(maps, a, stream);
}

}  // namespace
}  // namespace msvit
