// The bf16 tensor-core tile body of the attention forwards on [B, H, N, dh]
// operands, shared by K7 and K7-lse (`flash_attention.cu`) and by K5, K5-lse
// and K4 (`fused_attention.cu`).
//
// Replaces the bf16 branch of three TPU kernels:
//   * `msvit_tpu/ops/flash_attention.py::_flash_forward` (K7, K7-lse): the
//     exact online softmax over key tiles, any N;
//   * `msvit_tpu/ops/fused_attention.py::_fused_forward` (K5, and K5-lse
//     with `with_lse=True`): the exact softmax of one head's whole score
//     row, which the online softmax computes too (SHAVED = false);
//   * `msvit_tpu/ops/fused_attention.py::_fused_inference` (K4): the shaved
//     serving softmax p = exp(clip(s, -80, 80)), no row max, o = P.V / l
//     (SHAVED = true).
// The TPU's tiling (Nq and Nk padded to 128, a head group's whole score
// panel in VMEM, the transposed P.V) does not carry over.
//
// What bounds it on the card: operations, 4*Nq*Nk*dh FLOP per head, against
// 2*(Nq + 2*Nk)*dh bytes of q/k/v/out plus the mask's Nq*Nk entries.  At the
// multistate trunk ([8, 12, 816, 64], the served partition's soft mask
// [8, 1, 816, 816] f32 broadcast over the heads) 0.0183 ms of bytes against
// 0.0165 ms of operations if the mask is read once; at 448 px ([8, 12, 3168,
// 64]) 0.2494 ms of operations against 0.096 ms of bytes.
//
// The design (flash_mma_kernel): warp-level mma.sync m16n8k16 (bf16
// operands, f32 accumulators); a block of 4 warps takes 64 query rows (16 a
// warp) of one (head, image), q fragments loaded once (read from shared
// memory at each use at dh 128).  k/v tiles of 64 rows and the [64 x 64]
// mask tile stream through a two-stage ring in dynamic shared memory filled
// by cp.async, so the next tile and its mask arrive while this one is
// multiplied.  Per tile: S = Q.K^T (k through ldmatrix), scale and mask on
// the accumulator fragments in log2 units (one multiply by scale * log2e,
// the mask tile read from shared memory at the fragments' positions; only
// the last, partial tile checks its keys against Nk and skips its 16-key
// blocks past Nk; a warp whose rows all lie past Nq only helps copy), then
// p rounded to bf16 in registers as the A fragment of O += P.V (v through
// ldmatrix.trans), l summed from the unrounded p, as the TPU kernels.
//   * Exact (SHAVED = false): the online row max across the 4 lanes of a
//     quad, p = exp2(x - m), a new max rescales l and O; a -inf score weighs
//     nothing and a row with l == 0 (every score -inf) gives zeros and lse 0
//     (the TPU's l_inv guard).  The lse goes back to natural units at the
//     end.  A masked bool entry sits at mask_value * log2e, or at the most
//     negative finite float where that overflows (the default mask_value),
//     and a fully masked row is mean(V) with lse mask_value + log l, as the
//     TPU's.
//   * Shaved (SHAVED = true): x clamped to +-80 * log2e after the mask, p =
//     exp2(x) with no max and no rescaling, o / l divided (l >= Nk * e^-80 >
//     0, no guard).  A masked bool entry and an additive -inf one both clamp
//     to e^-80, so such a row is mean(V).  p <= e^80 and l <= Nk * e^80 stay
//     finite in f32 at the TPU's bounded-logit contract; there is no max.
// Keys past Nk weigh exactly 0 in both (set to -inf after the clamp), never
// mask_value or e^-80: the TPU pads Nk and counts its padded keys (zero rows
// of V) in l, a padding artifact the port does not copy.
//
// The mask dominates the bytes: a broadcast mask read separately by each
// head's blocks would cost 12 x its size, so the grid is (H, q tiles, B),
// the head fastest: the 12 heads of one query tile run together and meet
// their mask panel in L2 (cp.async.cg keeps it out of L1).  Mask tile rows
// are padded (f32 72 words, bool 80 bytes), so that a warp's fragment reads
// hit distinct banks, and copied 16, 4 or 1 bytes at a time as the rows'
// alignment allows (`MaskStage`).  Shared memory at dh 64: 2 stages x (k
// 9 KB + v 9 KB + f32 mask 18 KB) = 72 KB, q staged in stage 1's k buffer
// until its fragments are in registers (46 KB with a bool mask, 36 KB with
// none): 3 blocks an SM with an f32 mask, 4 with a bool mask or none
// (registers bound them there).  At dh 128 q stays in its own buffer.  Head
// sizes 8/24/40 are zero-padded in shared memory to their bucket, zeroed
// once a block.  wgmma with TMA and warp specialisation is the later step.
//
// Every template here lives in an anonymous namespace, so each translation
// unit that includes the header owns its instantiations: the objects linked
// into one library share no kernel symbol.
#pragma once

#include "common.cuh"

namespace msvit {
namespace {

// Element strides of q, k, v and out: image, head, row.
struct Strides {
  long long qb, qh, qn, kb, kh, kn, vb, vh, vn, ob, oh, on;
};

constexpr float kLn2 = 0.6931471805599453f;
// The shaved softmax's clamp, +-80 in log2 units.
constexpr float kShave2 = 80.f * kLog2e;

// The scores of one 64-key tile in log2 units, x = s * scale * log2e with
// the staged mask tile `mt` (rows of `mrow` bytes; the additive mask times
// log2e, a masked bool entry at `masked`), read at the fragments'
// positions; SHAVED clamps x to +-kShave2, else mx takes the tile's row
// maxima.  EDGE: the last, partial tile, whose keys past nk are -inf (after
// the clamp: they weigh 0).
template <bool EDGE, bool SHAVED, int NT>
__device__ __forceinline__ void flash_scores(float (&s)[NT][4], float (&mx)[2],
                                             const unsigned char* mt, int mrow,
                                             int r_lo, int kv0, int tq, int nk,
                                             int mask_kind, float c2,
                                             float masked) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = j * 8 + 2 * tq;  // this lane's two columns: c, c + 1
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float add[2];
      bool keep[2];
      mask_pair(mt, mrow, r_lo + 8 * r, c, mask_kind, add, keep);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float x = fmaf(add[u], kLog2e, s[j][2 * r + u] * c2);
        if (!keep[u]) x = masked;
        if (SHAVED) x = fminf(fmaxf(x, -kShave2), kShave2);
        if (EDGE && kv0 + c + u >= nk) x = -INFINITY;  // keys past Nk weigh nothing
        s[j][2 * r + u] = x;
        if (!SHAVED) mx[r] = fmaxf(mx[r], x);
      }
    }
  }
}

// One block = (head, 64 query rows, image), 4 warps of 16 rows; bf16 only.
// The head is blockIdx.x: blocks that share a broadcast mask panel run
// together.  Where q's fragments live in registers (dh <= 64), q is staged
// in stage 1's k buffer, which tile 1 refills once they are loaded.  lse:
// null, or [B, H, Nq] f32 (exact softmax only).
template <int DHT, bool SHAVED>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const void* __restrict__ mask,
                 bf16* __restrict__ out, float* __restrict__ lse, Strides st,
                 int h_count, int nq, int nk, int dh, int mask_kind,
                 long long mask_sb, long long mask_sh, float scale,
                 float mask_value) {
  constexpr int LD = mma_ld<DHT>();
  constexpr int KT = kMmaTile;   // keys per staged tile
  constexpr int NT = KT / 8;     // score n-tiles per tile
  constexpr int OT = DHT / 8;    // output n-tiles
  constexpr bool kShareQ = Resident<DHT>::kInRegs;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // [2][k, v][KT][LD]
  bf16* qs = ring + (kShareQ ? 2 : 4) * KT * LD;  // [64][LD]
  unsigned char* mring = reinterpret_cast<unsigned char*>(
      ring + (kShareQ ? 4 * KT : 4 * KT + kMmaRows) * LD);
  const int h = blockIdx.x;
  const int row0 = blockIdx.y * kMmaRows;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  const bf16* kimg = k + b * st.kb + h * st.kh;
  const bf16* vimg = v + b * st.vb + h * st.vh;

  // the mask: staged rows of mrow bytes
  const int mrow = mask_row_bytes(mask_kind);
  const MaskStage mstage(mask, mask_kind, nk, mask_sb, mask_sh, b, h);

  if (dh < DHT) {  // pad columns of every head tile: zero once
    zero_smem(smem, (4 * KT + (kShareQ ? 0 : kMmaRows)) * LD *
                        static_cast<int>(sizeof(bf16)));
    __syncthreads();
  }
  const int tiles = (nk + KT - 1) / KT;
  auto load_tile = [&](int t) {
    bf16* ks = ring + (t & 1) * 2 * KT * LD;
    async_tile<LD>(ks, kimg, st.kn, t * KT, KT, nk, dh);
    async_tile<LD>(ks + KT * LD, vimg, st.vn, t * KT, KT, nk, dh);
    // rows [row0, row0 + 64) x keys [t * KT, t * KT + KT) of the mask; rows
    // past nq and keys past nk are zero-filled (never used)
    mstage.stage(mring + (t & 1) * kMmaRows * mrow, mrow, row0, nq, t * KT);
  };
  async_tile<LD>(qs, q + b * st.qb + h * st.qh, st.qn, row0, kMmaRows, nq, dh);
  load_tile(0);
  cp_async_commit();

  // this thread's two accumulator rows (g and g + 8 of the warp's 16), as
  // rows of the block's tile and as query indices
  const int r_lo = warp * 16 + gq;
  const int irow[2] = {row0 + r_lo, row0 + r_lo + 8};
  const float c2 = scale * kLog2e;
  // a masked bool entry in log2 units: mask_value * log2e overflows to -inf
  // at the default mask_value, where the TPU's entry is finite (a fully
  // masked row is mean(V)): the most negative finite float instead
  const float masked = fmaxf(mask_value * kLog2e, -3.402823466e38f);

  Resident<DHT> qf;
  float o[OT][4];
  zero_acc(o);
  float m[2] = {-INFINITY, -INFINITY};  // running row maxima, log2 units (exact)
  float l[2] = {0.f, 0.f};  // this lane's part of the row sums

  // a warp whose 16 rows all lie past nq (the last query tile) only helps
  // to copy the tiles
  const bool idle = row0 + warp * 16 >= nq;
  for (int t = 0; t < tiles; ++t) {
    if (kShareQ && t == 0) {  // q's fragments first: tile 1 overwrites q
      cp_async_wait<0>();
      __syncthreads();
      if (!idle) qf.load(qs + warp * 16 * LD, lane);
      __syncthreads();
    }
    if (t + 1 < tiles) load_tile(t + 1);  // its stage was freed at t - 1's end
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and q) has landed for this thread
    __syncthreads();     // ... and for every thread
    const bf16* ks = ring + (t & 1) * 2 * KT * LD;
    const bf16* vs = ks + KT * LD;
    const unsigned char* mt = mring + (t & 1) * kMmaRows * mrow;
    const int kv0 = t * KT;
    auto tile = [&](auto edge) {
      constexpr bool EDGE = decltype(edge)::value;
      // 16-key blocks holding keys below nk: all 4 but in the last tile
      const int n16 = EDGE ? (nk - kv0 + 15) / 16 : KT / 16;
      float s[NT][4];
      product_t<DHT, KT>(s, qf, ks, lane, n16);

      // scale, mask, (shave,) ragged edge; the tile's row max
      float mx[2] = {m[0], m[1]};
      flash_scores<EDGE, SHAVED, NT>(s, mx, mt, mrow, r_lo, kv0, tq, nk,
                                     mask_kind, c2, masked);
      float mu[2] = {0.f, 0.f};  // what p subtracts: 0 when shaved
      if (!SHAVED) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = quad_max(mx[r]);
          // exp(-inf) = 0 rescales the empty start; an all -inf row keeps m
          // at -inf and subtracts 0, never -inf - -inf
          mu[r] = mx[r] == -INFINITY ? 0.f : mx[r];
          const float corr = exp2f(m[r] - mu[r]);
          m[r] = mx[r];
          l[r] *= corr;
#pragma unroll
          for (int j = 0; j < OT; ++j) {
            o[j][2 * r] *= corr;
            o[j][2 * r + 1] *= corr;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[j][e] - mu[e >> 1]);
          l[e >> 1] += p;  // the unrounded p
          s[j][e] = p;
        }
      }
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {  // O += P.V, p rounded to bf16
        if (kk >= n16) break;  // p = 0 past nk
        uint32_t pa[4];
        c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        pv_step<DHT>(o, pa, vs, kk, lane);
      }
    };
    if (!idle) {
      if (!kShareQ && t == 0) qf.load(qs + warp * 16 * LD, lane);
      if (kv0 + KT <= nk) {
        tile(Edge<false>{});
      } else {
        tile(Edge<true>{});
      }
    }
    __syncthreads();  // this stage is consumed: t + 1 may refill it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = row_sum<4>(l[r]);
    const int i = irow[r];
    if (i >= nq) continue;  // (every row of an idle warp)
    const float l_inv = lr == 0.f ? 1.f : 1.f / lr;  // the TPU kernel's guard
    bf16* orow = out + b * st.ob + h * st.oh + i * st.on;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int col = j * 8 + 2 * tq;
      if (col < dh) {
        const float c0 = o[j][2 * r], c1 = o[j][2 * r + 1];
        // shaved: o / l, divided as the TPU kernel divides (l > 0)
        *reinterpret_cast<uint32_t*>(orow + col) =
            SHAVED ? pack_bf16(c0 / lr, c1 / lr)
                   : pack_bf16(c0 * l_inv, c1 * l_inv);
      }
    }
    if (!SHAVED && lse != nullptr && tq == 0) {
      // back to natural units; a fully masked row's max is `masked`, whose
      // natural value is mask_value itself
      const float mn = m[r] == masked ? mask_value : m[r] * kLn2;
      lse[(static_cast<long long>(b) * h_count + h) * nq + i] =
          lr > 0.f ? mn + logf(lr) : 0.f;
    }
  }
}

// Dynamic shared memory of one block: the k/v ring (and q's own buffer at
// dh 128) plus two mask tiles.
template <int DHT>
int mma_smem_bytes(int mask_kind) {
  const int rows = 4 * kMmaTile + (Resident<DHT>::kInRegs ? 0 : kMmaRows);
  return rows * mma_ld<DHT>() * static_cast<int>(sizeof(bf16)) +
         2 * kMmaRows * mask_row_bytes(mask_kind);
}

template <int DHT, bool SHAVED>
cudaError_t allow_smem(int bytes) {
  return cudaFuncSetAttribute(flash_mma_kernel<DHT, SHAVED>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int DHT, bool SHAVED>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* mask, void* out, float* lse,
                       const Strides& st, int b, int h, int nq, int nk, int dh,
                       int mask_kind, long long sb, long long sh, float scale,
                       float mask_value, cudaStream_t stream) {
  const int bytes = mma_smem_bytes<DHT>(mask_kind);
  const cudaError_t err = allow_smem<DHT, SHAVED>(bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(h, (nq + kMmaRows - 1) / kMmaRows, b);
  flash_mma_kernel<DHT, SHAVED><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), mask, static_cast<bf16*>(out), lse, st, h,
      nq, nk, dh, mask_kind, sb, sh, scale, mask_value);
  return cudaGetLastError();
}

// The bf16 forward on the tensor cores, by head-size bucket; returns
// cudaGetLastError() after the launch.
template <bool SHAVED>
cudaError_t dispatch_mma(const void* q, const void* k, const void* v,
                         const void* mask, void* out, float* lse,
                         const Strides& st, int b, int h, int nq, int nk,
                         int dh, int mask_kind, long long sb, long long sh,
                         float scale, float mask_value, cudaStream_t stream) {
  if (dh <= 16)
    return launch_mma<16, SHAVED>(q, k, v, mask, out, lse, st, b, h, nq, nk, dh, mask_kind, sb, sh, scale, mask_value, stream);
  if (dh <= 32)
    return launch_mma<32, SHAVED>(q, k, v, mask, out, lse, st, b, h, nq, nk, dh, mask_kind, sb, sh, scale, mask_value, stream);
  if (dh <= 64)
    return launch_mma<64, SHAVED>(q, k, v, mask, out, lse, st, b, h, nq, nk, dh, mask_kind, sb, sh, scale, mask_value, stream);
  return launch_mma<128, SHAVED>(q, k, v, mask, out, lse, st, b, h, nq, nk, dh, mask_kind, sb, sh, scale, mask_value, stream);
}

template <int DHT, bool SHAVED>
cudaError_t blocks_per_sm(int mask_kind, int* blocks) {
  const int bytes = mma_smem_bytes<DHT>(mask_kind);
  const cudaError_t err = allow_smem<DHT, SHAVED>(bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, flash_mma_kernel<DHT, SHAVED>, kMmaThreads, bytes);
}

// Blocks of the bf16 kernel resident on one SM at head size dh and this
// mask kind, by the runtime's occupancy calculator (registers and shared
// memory), into *blocks.
template <bool SHAVED>
cudaError_t occupancy_mma(int dh, int mask_kind, int* blocks) {
  if (dh <= 16) return blocks_per_sm<16, SHAVED>(mask_kind, blocks);
  if (dh <= 32) return blocks_per_sm<32, SHAVED>(mask_kind, blocks);
  if (dh <= 64) return blocks_per_sm<64, SHAVED>(mask_kind, blocks);
  return blocks_per_sm<128, SHAVED>(mask_kind, blocks);
}

}  // namespace
}  // namespace msvit
