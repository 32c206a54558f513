// K3 and K9 at head size 64 on Hopper: the fully-int8 serving attention on
// s8 warpgroup products (wgmma) fed by TMA, warp-specialised and
// persistent.  `packed_attention_int8.cu` launches it for dh 64 and keeps
// its mma.sync kernel for every other head size.
//
// Replaces, at dh 64, the TPU kernels `msvit_tpu/ops/packed_attention.py::
// _kernel_int8` (K3, wrapper `packed_attention_int8`) and
// `::_kernel_int8_grouped` (K9, wrapper `_packed_int8_grouped`), with the
// contract `packed_attention_int8.cu`'s note states: s = int32(q.k) *
// ((scale * s_q) * s_k) in f32, the exact row max before any probability
// is quantized (K3 from the int32 extremes, K9 on the scaled and masked f32
// scores), pq = trunc(127 * expf(s - m)) with an f32 l (K3) or pq =
// trunc(expf((s - m) + ln 127)) with l the integer sum of pq floored at 1
// (K9), o = int32(pq.v) scaled, written bf16 or int8 clip(rint(o *
// inv_s_out), +-127).  The f32 operations are the plain version's, in its
// order (__fmul_rn, __fsub_rn, __fadd_rn: no FMA), and the exponential is
// expf: a truncating cast turns an ulp into a whole step.  The four scales
// are read from the device buffer.
//
// What bounds it on the card: the function's one q.k and one P.V (4.6
// GOP at [64, 197, 2304], 9.8 at [8, 816, 2304]: 2.3 and 5.0 us at 1,979
// TOP/s) against the int8 q/k/v/out bytes plus K9's bf16 mask panel read
// once: bytes, 0.0116 ms and 0.0092 ms.  The second q.k (the row max must
// be exact before the truncating cast, so the keys are walked twice) is
// the kernel's own choice, and with it the products are still far under
// the bytes.  What the design does about it: every operand moves once
// from device memory by TMA into a shared-memory ring that a producer
// keeps full while the tensor cores run; the second walk re-reads K (and
// K9's mask tiles) from L2; the block is persistent, so the next item's Q
// and first tiles land while this one finishes.  What is left is the CUDA
// cores' f32 chain per score of walk 2 (multiply, subtract, expf,
// truncating cast, row sum: ~15-20 instructions, one of them on the
// special-function unit) and the latency of each tile's round trip through
// the tensor cores, on 128-row items padded to whole 64-key tiles.  The
// chain keeps the conversion unit (an eighth of the f32 rate) out: int32
// -> f32 and the truncation are exact additions of 1.5 * 2^23, and pq is
// packed from that sum's low byte.  A warp whose 16 rows lie past N skips
// the chain, and a block of 8 keys past N is skipped.
//
// The block (384 threads, one an SM): two consumer warpgroups of 64 query
// rows and one producer warpgroup, of which one thread issues every TMA
// load and warps 1-3 transpose V.  An item is 128 query rows of one (head,
// image); the block walks the items head-fastest, then the query tile, then
// the image, so that the 12 heads of a query tile meet K9's broadcast mask
// panel in L2.  Q has two slots (the next item's Q lands during this one),
// K a 6-stage ring (with K9's mask tiles), V a 4-stage ring as it lands
// and a 4-stage ring of V^T; full/empty mbarriers on each; setmaxnreg
// hands the producer's registers to the consumers.
//
// Tiles.  The one TMA map covers the packed int8 [B, N, 3D] qkv (box 64
// bytes x 64 rows, 64-byte swizzle: `hopper::map_rows_s8`): q at column
// h*64, k at D + h*64, v at 2D + h*64; a box past row N is zero-filled.
// S = Q.K^T is two wgmma.m64n64k32.s32.s8.s8 from shared memory (Q is A, K
// is B, both K-major as they land; 8-bit wgmma has no transpose).
//
// P.V.  A is pq in s8 registers, B is V^T in shared memory, K-major
// ([head column][key]).  The s32 accumulator gives lane (g, t) keys 8j+2t,
// 8j+2t+1, the s8 A fragment wants keys 4t..4t+3 and 16+4t..16+4t+3 of a
// 32-key step: each lane packs its own values with no shuffle (pack_s8_a's
// order: logical key 4t+i holds key (2t, 2t+1, 8+2t, 9+2t)[i], logical
// 16+4t+i key 16 + the same), and the transposing warps write V^T's keys in
// that order, byte for byte in the 64-byte swizzle.  P.V sums over keys, so
// the permutation is exact (`msvit_tpu_torch/ops/packed_attention.py::
// int8_pv_key_order` mirrors it; the CPU tests check it).  S of tile t is
// issued beside P.V of tile t - 1, so the products run during the
// quantization.
//
// The row sums.  K3's f32 l is summed by each lane and then across its quad
// (another order than the plain version's sum: its int8 out may move one
// step).  K9's integer l is summed on the CUDA cores, one integer add per
// score, exact in any order: the TPU's column of ones would widen P.V to
// N = 80 for a sum that costs less than the truncating cast beside it.
//
// The mask (K9).  Bool (one byte, true = attend) or the additive mask as
// bf16 (the wrapper's cast; the model's 0 / -100 soft mask is bf16-exact),
// [B|1, 1|H, N, N] through its row stride.  The producer loads the item's
// [128 rows][64 keys] tile of it by TMA with each K tile, into the same
// ring stage and on the same barriers (`hopper::map_mask`: 128-byte
// swizzle for bf16, 64-byte for bool; keys and rows past N zero-filled),
// in both walks; the consumers read their entries from shared memory as
// each tile's scores arrive, conflict-free through the swizzle, and
// release the stage after.  TMA needs rows of a multiple of 16 bytes: the
// wrapper pads its copy of the mask where N needs it
// (`int8_mask_operand`).  Entries read from device memory a tile ahead
// into registers, or staged by cp.async, left their L2 latency on every
// tile.  A fully masked bool row scores mask_value everywhere: pq = 127 on
// every real key, the row is mean(V).
//
// Edges.  Keys past N score 0 (TMA's zero fill): they stay out of the max
// and take pq = 0.  Rows past N are computed and never stored.  Output
// columns are natural: lane (g, t) stores columns 8j+2t, 8j+2t+1 of its
// rows at column h*64 of [B, N, D].
//
// ptxas names the kernel `packed_attention_int8_wgmma_kernel<MASKED,
// KIND>`: K9's instantiations carry MASKED's mangled `Lb1E`.
#pragma once

#include <limits.h>

#include "attention_wgmma.cuh"

namespace msvit {
namespace {

constexpr int kI8Rows = 128;         // query rows an item (two warpgroups of 64)
constexpr int kI8KStages = 6;        // the ring of K tiles (and K9's mask tiles)
constexpr int kI8VStages = 4;        // V as it lands, and V^T
constexpr int kI8Transposers = 96;   // warps 1-3 of the producer warpgroup
constexpr int kI8MaskTileBytes = kI8Rows * 64 * 2;  // [128 rows][64 keys] bf16
constexpr float kLn127 = 4.8441870864585885f;  // exp(s - m + ln 127) = 127 p

// One launch's arguments besides the map.
struct Int8Args {
  const float* sc;    // [s_q, s_k, s_v, inv_s_out] on the device
  const void* mask;   // K9: bool bytes or additive bf16, [B|1, 1|H, N, N]
  void* out;          // [B, N, D]: bf16, or int8 where int8_out
  long long msb, msh;  // the mask's image and head strides (elements; 0: broadcast)
  long long msr;       // its row stride (elements; N * esize a multiple of 16 bytes)
  int int8_out, b, n, h;
  float scale, mask_value;
};

__host__ __device__ constexpr int int8_wgmma_smem_bytes() {
  // two Q slots of 128 rows, the K ring with its mask tiles, V and V^T;
  // the barriers; 1 KB of alignment slack
  return (4 + kI8KStages + 2 * kI8VStages) * hopper::kTileBytesS8 +
         kI8KStages * kI8MaskTileBytes + (4 + 2 * kI8KStages + 4 * kI8VStages) * 8 + 1024;
}

// The mask entries of keys 8j + 2t, 8j + 2t + 1 of row `row` of a
// [128 rows][64 keys] mask tile as TMA lands it (bf16: 128-byte rows,
// 128-byte swizzle; bool: 64-byte rows, 64-byte swizzle): bool 1 = attend,
// additive the bf16 entry in f32.  The swizzle puts the 8 rows of one read
// in distinct banks.
template <int KIND>
__device__ __forceinline__ void int8_mask_pair(float (&v)[2], const unsigned char* tile,
                                               int row, int j, int tq) {
  if (KIND == kBoolMask) {
    const uint16_t u =
        *reinterpret_cast<const uint16_t*>(tile + hopper::swizzle64(row, 8 * j + 2 * tq));
    v[0] = (u & 0xffu) ? 1.f : 0.f;
    v[1] = (u >> 8) ? 1.f : 0.f;
  } else if (KIND == kAddMask) {  // bf16: the high half of an f32
    const uint32_t w = *reinterpret_cast<const uint32_t*>(
        tile + row * 128 + ((j ^ (row & 7)) << 4) + 4 * tq);
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  } else {
    v[0] = v[1] = 0.f;
  }
}

// float(a), exactly, for |a| < 2^22 (an s8 dot product over 64 head bytes
// is at most 2^20 in magnitude) without the conversion unit, which issues
// at an eighth of the f32 rate: a added to the bits of 1.5 * 2^23, then
// 1.5 * 2^23 subtracted.
__device__ __forceinline__ float s32_to_f32(int a) {
  return __fsub_rn(__int_as_float(0x4B400000 + a), 12582912.f);
}

// trunc(x) for 0 <= x < 256 (a NaN gives 0, as the conversion does)
// without the conversion unit: x added to 1.5 * 2^23 rounding toward zero
// keeps its integer part in the low bits, so the bits are 0x4B400000 +
// trunc(x) and their low byte is trunc(x), as pack_s8 takes it.
__device__ __forceinline__ int trunc_bits(float x) {
  return __float_as_int(__fadd_rz(fmaxf(x, 0.f), 12582912.f));
}

// K9's scaled score with its mask entry: s = float(a) * c rounded alone
// (never an FMA with the mask), then the additive entry, or mask_value
// where a bool entry is false.
template <int KIND>
__device__ __forceinline__ float int8_masked_score(int a, float c, float mv,
                                                   float mask_value) {
  float s = __fmul_rn(s32_to_f32(a), c);
  if (KIND == kAddMask) s = __fadd_rn(s, mv);
  if (KIND == kBoolMask && mv == 0.f) s = mask_value;
  return s;
}

// The first walk over one tile's scores: K3 (MASKED false) the int32
// extreme of this thread's keys that the row max comes from (the max
// where c >= 0, else the min: `hi`), K9 the f32 max of the scaled, masked
// scores.  EDGE: keys past N take no part (a block of 8 keys wholly past
// N is skipped).
template <bool MASKED, int KIND, bool EDGE>
__device__ __forceinline__ void int8_max_tile(const int (&s)[32], const unsigned char* mt,
                                              int mrow, int kv0, int n, int tq, float c,
                                              bool hi, float mask_value, int (&ext)[2],
                                              float (&mx)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (EDGE && kv0 + j * 8 >= n) break;
    float mv[2][2];  // [row g, g + 8][key 8j + 2t, + 1]
    int8_mask_pair<KIND>(mv[0], mt, mrow, j, tq);
    int8_mask_pair<KIND>(mv[1], mt, mrow + 8, j, tq);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (EDGE && kv0 + j * 8 + 2 * tq + (e & 1) >= n) continue;
      const int r = e >> 1;
      if (MASKED) {
        mx[r] = fmaxf(mx[r], int8_masked_score<KIND>(s[4 * j + e], c, mv[r][e & 1], mask_value));
      } else {
        ext[r] = hi ? max(ext[r], s[4 * j + e]) : min(ext[r], s[4 * j + e]);
      }
    }
  }
}

// The second walk over one tile: the quantized probabilities in place of
// the scores as `trunc_bits` (truncating casts: the exponent is <= 0, so
// pq <= 127), K3's f32 l and K9's integer l summed by this thread, the
// latter as the sum of those bits (each element adds 0x4B400000 + pq, the
// offsets taken off once at the end: exact modulo 2^32).  EDGE: keys past
// N weigh nothing (bits 0x4B400000: pq = 0).
template <bool MASKED, int KIND, bool EDGE>
__device__ __forceinline__ void int8_quantize_tile(int (&s)[32], const unsigned char* mt,
                                                   int mrow, int kv0, int n, int tq, float c,
                                                   float mask_value, const float (&m)[2],
                                                   float (&l)[2], uint32_t (&lq)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (EDGE && kv0 + j * 8 >= n) {  // 8 keys wholly past N
#pragma unroll
      for (int e = 0; e < 4; ++e) s[4 * j + e] = 0x4B400000;
      if (MASKED) {
        lq[0] += 2 * 0x4B400000u;
        lq[1] += 2 * 0x4B400000u;
      }
      continue;
    }
    float mv[2][2];  // [row g, g + 8][key 8j + 2t, + 1]
    int8_mask_pair<KIND>(mv[0], mt, mrow, j, tq);
    int8_mask_pair<KIND>(mv[1], mt, mrow + 8, j, tq);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      int pq = 0x4B400000;  // pq = 0
      if (!EDGE || kv0 + j * 8 + 2 * tq + (e & 1) < n) {
        if (MASKED) {
          const float x = int8_masked_score<KIND>(s[4 * j + e], c, mv[r][e & 1], mask_value);
          pq = trunc_bits(expf(__fadd_rn(__fsub_rn(x, m[r]), kLn127)));
        } else {
          const float p = expf(__fsub_rn(__fmul_rn(s32_to_f32(s[4 * j + e]), c), m[r]));
          l[r] += p;
          pq = trunc_bits(__fmul_rn(p, 127.f));
        }
      }
      if (MASKED) lq[r] += static_cast<uint32_t>(pq);
      s[4 * j + e] = pq;
    }
  }
}

// P.V's s8 A operand of k-step kk (keys 32kk..32kk+31) from the quantized
// probabilities in the accumulator's layout, in pack_s8_a's key order.
__device__ __forceinline__ void int8_acc_to_a(uint32_t (&a)[4], const int (&s)[32],
                                              int kk) {
  const int* c = s + 16 * kk;
  a[0] = pack_s8(c[0], c[1], c[4], c[5]);
  a[1] = pack_s8(c[2], c[3], c[6], c[7]);
  a[2] = pack_s8(c[8], c[9], c[12], c[13]);
  a[3] = pack_s8(c[10], c[11], c[14], c[15]);
}

// V^T of one 64-key V tile (both 64-byte swizzled): row n of `vt` is head
// column n, its 64 bytes the keys in int8_acc_to_a's order.  Unit u of 256:
// word w = u % 16 of a V^T row (k-step w / 8) for head columns 4cg..4cg+3
// (cg = u / 16); the four keys of that word are four V rows, whose words
// at byte 4cg a 4 x 4 byte transpose turns into the four columns' words.
// Threads `tid` of kI8Transposers take part.
__device__ __forceinline__ void int8_transpose_v(unsigned char* vt, const unsigned char* v,
                                                 int tid) {
  for (int u = tid; u < 256; u += kI8Transposers) {
    const int w = u & 15;
    const int cg = u >> 4;
    const int ww = w & 7;
    const int key = 32 * (w >> 3) + (ww < 4 ? 2 * ww : 8 + 2 * ww);
    const int rows[4] = {key, key + 1, key + 8, key + 9};
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = *reinterpret_cast<const uint32_t*>(v + hopper::swizzle64(rows[i], 4 * cg));
    const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
    const uint32_t col[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                             __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint32_t*>(vt + hopper::swizzle64(4 * cg + i, 4 * w)) = col[i];
  }
}

// The persistent block (the header note).  MASKED: K9 (pre-scaled exp,
// integer l) with the mask of KIND; otherwise K3 (KIND kNoMask).
template <bool MASKED, int KIND>
__global__ void __launch_bounds__(hopper::kThreads, 1)
packed_attention_int8_wgmma_kernel(const __grid_constant__ CUtensorMap map,
                                   const __grid_constant__ CUtensorMap mmap,
                                   const Int8Args a) {
  using namespace hopper;
  constexpr int T = kTileBytesS8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;                      // [2 slots][128][64]
  unsigned char* ks = qs + 4 * T;                // [stages][64 keys][64]
  unsigned char* vs = ks + kI8KStages * T;       // [stages][64 keys][64]
  unsigned char* vts = vs + kI8VStages * T;      // [stages][64 columns][64 keys]
  unsigned char* mks = vts + kI8VStages * T;     // [stages][128 rows][64 keys] mask
  uint64_t* qfull = reinterpret_cast<uint64_t*>(mks + kI8KStages * kI8MaskTileBytes);
  uint64_t* qempty = qfull + 2;
  uint64_t* kfull = qempty + 2;
  uint64_t* kempty = kfull + kI8KStages;
  uint64_t* vfull = kempty + kI8KStages;  // V landed
  uint64_t* vfree = vfull + kI8VStages;   // V read by the transposing warps
  uint64_t* tfull = vfree + kI8VStages;   // V^T written
  uint64_t* tempty = tfull + kI8VStages;  // V^T read by P.V
  const int n = a.n;
  const int d = a.h * 64;
  const int tiles = (n + 63) / 64;
  const int qtiles = (n + kI8Rows - 1) / kI8Rows;
  const int items = a.h * qtiles * a.b;
  constexpr bool STAGED = MASKED && KIND != kNoMask;  // K9 with a mask tile a step
  constexpr int MBYTES = STAGED ? kI8Rows * 64 * (KIND == kAddMask ? 2 : 1) : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(qfull + s, 1);
      mbar_init(qempty + s, kConsumerWarps);
    }
    for (int s = 0; s < kI8KStages; ++s) {
      mbar_init(kfull + s, 1);
      mbar_init(kempty + s, kConsumerWarps);
    }
    for (int s = 0; s < kI8VStages; ++s) {
      mbar_init(vfull + s, 1);
      mbar_init(vfree + s, kI8Transposers);
      mbar_init(tfull + s, kI8Transposers);
      mbar_init(tempty + s, kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup, provably uniform across each warp (the role branch below)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == 2) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 256) {  // every TMA load: Q, then K twice and V once a tile
      int gk = 0, gv = 0;
      for (int w = blockIdx.x, i = 0; w < items; w += gridDim.x, ++i) {
        const int h = w % a.h;
        const int row0 = (w / a.h) % qtiles * kI8Rows;
        const int b = w / (a.h * qtiles);
        const int slot = i & 1;
        if (i >= 2) mbar_wait(qempty + slot, ((i - 2) >> 1) & 1);
        mbar_expect_tx(qfull + slot, 2 * T);
        tma_load_3d(qs + slot * 2 * T, &map, qfull + slot, h * 64, row0, b);
        tma_load_3d(qs + slot * 2 * T + T, &map, qfull + slot, h * 64, row0 + 64, b);
        for (int u = 0; u < 2 * tiles; ++u, ++gk) {
          const int t = u < tiles ? u : u - tiles;
          const int s = gk % kI8KStages;
          mbar_wait(kempty + s, ((gk / kI8KStages) & 1) ^ 1);
          mbar_expect_tx(kfull + s, T + MBYTES);
          tma_load_3d(ks + s * T, &map, kfull + s, d + h * 64, t * 64, b);
          if (STAGED)  // the item's 128 rows x this tile's 64 keys
            tma_load_4d(mks + s * kI8MaskTileBytes, &mmap, kfull + s, t * 64, row0,
                        a.msh ? h : 0, a.msb ? b : 0);
          if (u >= tiles) {
            const int sv = gv % kI8VStages;
            mbar_wait(vfree + sv, ((gv / kI8VStages) & 1) ^ 1);
            mbar_expect_tx(vfull + sv, T);
            tma_load_3d(vs + sv * T, &map, vfull + sv, 2 * d + h * 64, t * 64, b);
            ++gv;
          }
        }
      }
    } else if (threadIdx.x >= 288) {  // warps 1-3: V -> V^T
      int gv = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        for (int t = 0; t < tiles; ++t, ++gv) {
          const int sv = gv % kI8VStages;
          const int ph = (gv / kI8VStages) & 1;
          mbar_wait(vfull + sv, ph);
          mbar_wait(tempty + sv, ph ^ 1);
          int8_transpose_v(vts + sv * T, vs + sv * T, threadIdx.x - 288);
          fence_proxy_async();  // V^T's bytes before P.V's (async) reads
          mbar_arrive(vfree + sv);
          mbar_arrive(tfull + sv);
        }
      }
    }
    return;
  }

  reg_alloc<kConsumerRegs>();
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x / 32) % 4;
  const int tq = lane % 4;
  const float s_q = a.sc[0];
  const float s_k = a.sc[1];
  const float s_v = a.sc[2];
  const float inv_s_out = a.sc[3];
  const float c = (a.scale * s_q) * s_k;
  const bool hi = c >= 0.f;  // K3's row max: from the largest int32 score, else the least
  const float kv = s_v / 127.f;
  int gk = 0, gv = 0;  // the block's K and V tile counts, as the producer's

  for (int w = blockIdx.x, item = 0; w < items; w += gridDim.x, ++item) {
    const int h = w % a.h;
    const int row0 = (w / a.h) % qtiles * kI8Rows;
    const int b = w / (a.h * qtiles);
    const int slot = item & 1;
    // this thread's two accumulator rows
    const int i_lo = row0 + wg * 64 + warp * 16 + lane / 4;
    const int irow[2] = {i_lo, i_lo + 8};
    const int wrow0 = row0 + wg * 64 + warp * 16;  // the warp's first row
    // a warp whose 16 rows all lie past N (the last query tile) takes part
    // in the products and the barriers only
    const bool live = wrow0 < n;
    const int mrow = wg * 64 + warp * 16 + lane / 4;  // this thread's row of a mask tile
    int sc[32], o[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0;
    const uint64_t dq = desc_s8(qs + slot * 2 * T + wg * T);
    // S = Q.K^T of the K tile in ring stage s into sc (issued, not waited)
    auto issue_s = [&](int s) {
      const uint64_t dk = desc_s8(ks + s * T);
      fence_acc(sc);
      wgmma_fence();
      wgmma_ss_s8(sc, dq, dk, 0);
      wgmma_ss_s8(sc, dq + 2, dk + 2, 1);
    };
    mbar_wait(qfull + slot, (item >> 1) & 1);

    // walk 1: the exact row maxima
    int ext[2] = {hi ? INT_MIN : INT_MAX, hi ? INT_MIN : INT_MAX};
    float mx[2] = {-INFINITY, -INFINITY};
    // tile t's scores into this thread's maxima, then its stage is released
    auto reduce = [&](int t) {
      const int s = (gk + t) % kI8KStages;
      if (live) {
        const unsigned char* mt = mks + s * kI8MaskTileBytes;
        const int kv0 = t * 64;
        if (kv0 + 64 > n)
          int8_max_tile<MASKED, KIND, true>(sc, mt, mrow, kv0, n, tq, c, hi, a.mask_value,
                                            ext, mx);
        else
          int8_max_tile<MASKED, KIND, false>(sc, mt, mrow, kv0, n, tq, c, hi, a.mask_value,
                                             ext, mx);
      }
      if (lane == 0) mbar_arrive(kempty + s);  // its K and mask tiles are read
    };
    auto wait_k = [&](int t) {
      mbar_wait(kfull + (gk + t) % kI8KStages, ((gk + t) / kI8KStages) & 1);
    };
    for (int t = 0; t < tiles; ++t) {
      wait_k(t);
      issue_s((gk + t) % kI8KStages);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      reduce(t);
    }
    gk += tiles;
    float m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (MASKED) {
        m[r] = quad_max(mx[r]);
      } else {  // c * (max a) where c >= 0, else c * (min a): the max f32 score
        int x = ext[r];
        x = hi ? max(x, __shfl_xor_sync(0xffffffffu, x, 1)) : min(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = hi ? max(x, __shfl_xor_sync(0xffffffffu, x, 2)) : min(x, __shfl_xor_sync(0xffffffffu, x, 2));
        m[r] = __fmul_rn(static_cast<float>(x), c);
      }
    }

    // walk 2: S again, pq, P.V
    float l[2] = {0.f, 0.f};  // K3: this lane's part of the f32 row sums
    uint32_t lq[2] = {0, 0};  // K9: this lane's part of sum pq (as trunc_bits)
    uint32_t pa[2][4];        // pq of the previous tile: the A operand of 2 k-steps
    // tile t's probabilities from the S and mask tiles of ring stage s,
    // then the stage is released
    auto quantize = [&](int t, int s) {
      if (live) {
        const unsigned char* mt = mks + s * kI8MaskTileBytes;
        const int kv0 = t * 64;
        if (kv0 + 64 > n)
          int8_quantize_tile<MASKED, KIND, true>(sc, mt, mrow, kv0, n, tq, c, a.mask_value,
                                                 m, l, lq);
        else
          int8_quantize_tile<MASKED, KIND, false>(sc, mt, mrow, kv0, n, tq, c, a.mask_value,
                                                  m, l, lq);
      }
      if (lane == 0) mbar_arrive(kempty + s);
    };
    // the item's last S is done: its Q slot may be loaded again
    auto release_q = [&]() {
      if (lane == 0) mbar_arrive(qempty + slot);
    };
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] = 0;
    {
      const int s = gk % kI8KStages;
      wait_k(0);
      issue_s(s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      if (tiles == 1) release_q();
      quantize(0, s);
      ++gk;
    }
    int8_acc_to_a(pa[0], sc, 0);
    int8_acc_to_a(pa[1], sc, 1);
    for (int t = 1; t < tiles; ++t, ++gk, ++gv) {
      const int s = gk % kI8KStages;
      const int sv = gv % kI8VStages;  // V^T of tile t - 1
      wait_k(0);
      mbar_wait(tfull + sv, (gv / kI8VStages) & 1);
      const uint64_t dv = desc_s8(vts + sv * T);
      fence_acc(o);
      issue_s(s);
      wgmma_commit();
      wgmma_rs_s8(o, pa[0], dv);
      wgmma_rs_s8(o, pa[1], dv + 2);
      wgmma_commit();
      wgmma_wait<1>();  // S of tile t
      fence_acc(sc);
      if (t == tiles - 1) release_q();
      quantize(t, s);
      wgmma_wait<0>();  // P.V of tile t - 1
      fence_acc(o);
      if (lane == 0) mbar_arrive(tempty + sv);
      int8_acc_to_a(pa[0], sc, 0);
      int8_acc_to_a(pa[1], sc, 1);
    }
    {  // P.V of the last tile
      const int sv = gv % kI8VStages;
      mbar_wait(tfull + sv, (gv / kI8VStages) & 1);
      const uint64_t dv = desc_s8(vts + sv * T);
      fence_acc(o);
      wgmma_fence();
      wgmma_rs_s8(o, pa[0], dv);
      wgmma_rs_s8(o, pa[1], dv + 2);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(o);
      if (lane == 0) mbar_arrive(tempty + sv);
      ++gv;
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = row_sum<4>(l[r]);  // (every lane of the warp takes part)
      // each lane added 16 elements of its row a tile (keys 8j + 2t, + 1)
      uint32_t lqr = lq[r] - static_cast<uint32_t>(tiles) * 16u * 0x4B400000u;
      lqr += __shfl_xor_sync(0xffffffffu, lqr, 1);
      lqr += __shfl_xor_sync(0xffffffffu, lqr, 2);
      const int i = irow[r];
      if (i >= n) continue;
      // K9: s_v / max(sum pq, 1); K3: the TPU kernel's l == 0 guard
      const float f = MASKED ? s_v / fmaxf(static_cast<float>(lqr), 1.f) : 0.f;
      if (lr == 0.f) lr = 1.f;
      const long long o_off = (static_cast<long long>(b) * n + i) * d + h * 64;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * tq;
        float v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int x = o[4 * j + 2 * r + u];
          v[u] = MASKED ? static_cast<float>(x) * f : static_cast<float>(x) * kv / lr;
        }
        if (a.int8_out) {
          int q[2];
#pragma unroll
          for (int u = 0; u < 2; ++u)  // clip(rint(y), +-127) = rint(clip(y, +-127))
            q[u] = __float_as_int(__fadd_rn(fminf(fmaxf(v[u] * inv_s_out, -127.f), 127.f),
                                            12582912.f)) - 0x4B400000;
          *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(a.out) + o_off + col) =
              static_cast<uint16_t>((q[0] & 0xff) | ((q[1] & 0xff) << 8));
        } else {
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.out) + o_off + col) =
              pack_bf16(v[0], v[1]);
        }
      }
    }
  }
}

template <bool MASKED, int KIND>
cudaError_t allow_int8_wgmma_smem() {
  static std::atomic<unsigned long long> done{0};
  return hopper::allow_smem_once(packed_attention_int8_wgmma_kernel<MASKED, KIND>,
                                 int8_wgmma_smem_bytes(), done);
}

template <bool MASKED, int KIND>
cudaError_t launch_int8_wgmma_kind(const CUtensorMap& map, const CUtensorMap& mmap,
                                   const Int8Args& a, cudaStream_t stream) {
  cudaError_t err = allow_int8_wgmma_smem<MASKED, KIND>();
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long items =
      static_cast<long long>(a.h) * ((a.n + kI8Rows - 1) / kI8Rows) * a.b;
  const int grid = static_cast<int>(items < sms ? items : sms);
  packed_attention_int8_wgmma_kernel<MASKED, KIND>
      <<<grid, hopper::kThreads, int8_wgmma_smem_bytes(), stream>>>(map, mmap, a);
  return cudaGetLastError();
}

// One launch of K3 (MASKED false) or K9 with `mask_kind` at head size 64
// on `stream`: the TMA maps over the packed qkv_q [B, N, 3D] and K9's mask
// (`hopper::map_mask`), then the instantiation; returns cudaGetLastError()
// after it (cudaErrorInvalidValue, nothing launched, where TMA cannot map
// qkv_q or the mask).
template <bool MASKED>
cudaError_t launch_int8_wgmma(const void* qkv, const Int8Args& a, int mask_kind,
                              cudaStream_t stream) {
  CUtensorMap map, mmap{};
  cudaError_t err = hopper::map_rows_s8(&map, qkv, a.b, a.n, 3LL * a.h * 64);
  if (err == cudaSuccess && MASKED && mask_kind != kNoMask)
    err = hopper::map_mask(&mmap, a.mask, mask_kind == kAddMask ? 2 : 1, a.msb ? a.b : 1,
                           a.msh ? a.h : 1, a.n, a.msb, a.msh, a.msr, kI8Rows);
  if (err != cudaSuccess) return err;
  if (!MASKED) return launch_int8_wgmma_kind<false, kNoMask>(map, mmap, a, stream);
  if (mask_kind == kBoolMask) return launch_int8_wgmma_kind<true, kBoolMask>(map, mmap, a, stream);
  if (mask_kind == kAddMask) return launch_int8_wgmma_kind<true, kAddMask>(map, mmap, a, stream);
  return launch_int8_wgmma_kind<true, kNoMask>(map, mmap, a, stream);
}

// Blocks of the instantiation resident on one SM (the runtime's occupancy
// calculator: 384 threads and the ring's shared memory).
template <bool MASKED>
cudaError_t int8_wgmma_blocks_per_sm(int mask_kind, int* blocks) {
  auto of = [&](auto kernel, cudaError_t allowed) {
    if (allowed != cudaSuccess) return allowed;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, hopper::kThreads,
                                                         int8_wgmma_smem_bytes());
  };
  if (!MASKED)
    return of(packed_attention_int8_wgmma_kernel<false, kNoMask>,
              allow_int8_wgmma_smem<false, kNoMask>());
  if (mask_kind == kBoolMask)
    return of(packed_attention_int8_wgmma_kernel<true, kBoolMask>,
              allow_int8_wgmma_smem<true, kBoolMask>());
  if (mask_kind == kAddMask)
    return of(packed_attention_int8_wgmma_kernel<true, kAddMask>,
              allow_int8_wgmma_smem<true, kAddMask>());
  return of(packed_attention_int8_wgmma_kernel<true, kNoMask>,
            allow_int8_wgmma_smem<true, kNoMask>());
}

}  // namespace
}  // namespace msvit
