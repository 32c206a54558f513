// Fully-int8 packed self-attention for the serving path: K3 and K9, on the
// int8 tensor cores (head size 64: `attention_int8_wgmma.cuh`).
//
// K3 replaces the TPU kernel `msvit_tpu/ops/packed_attention.py::
// packed_attention_int8` (body `_kernel_int8`).  Same contract: int8 q|k|v
// are column slices of the per-section requantized QKV GEMM output
// [B, N, 3D]; s = int32(q.k) * ((scale * s_q) * s_k) in f32; m = the exact
// row max; p = exp(s - m) and l = sum p in f32; probabilities are quantized
// by a TRUNCATING cast pq = trunc(127 p) (bias -0.5/254 per probability, as
// on the TPU); o = int32(pq.v) * (s_v / 127) / l (l == 0 guarded), written
// bf16, or int8 as clip(rint(o * inv_s_out), +-127) (rint is half-to-even,
// like jnp.round).  The four scales [s_q, s_k, s_v, inv_s_out] are read from
// a device buffer, the counterpart of the TPU kernel's SMEM operand, so the
// host never waits on them.  No mask, no gradient.
//
// K9, `msvit_tpu/ops/packed_attention.py::_packed_int8_grouped` (body
// `_kernel_int8_grouped`, its pallas_call), is the masked serving kernel of
// the multistate trunk (`attn_mode="int8"`): the same layout, with four
// differences from K3, each the TPU kernel's:
//   * a mask, bool (where-valid with mask_value) or additive, the additive
//     one read as bf16 (the wrapper casts it; the model's 0 / -100 soft
//     mask is bf16-exact), [B|1, 1|H, N, N] with the last two dims
//     contiguous, applied to the scaled scores before the row max;
//   * the exp is pre-scaled: pq = trunc(exp(s - m + ln 127)), 127 at the
//     row max (an f32 exp within an ulp of 127 there, so the card's expf
//     and the TPU's exp may truncate one step apart);
//   * l is the integer sum of the quantized pq, floored at 1, and
//     o = (pq . v) * (s_v / l): the division by the quantized sum cancels
//     the truncation bias that K3's f32 sum keeps;
//   * bf16 or int8 out, as K3.
// The TPU's head-pair grid and its VMEM gate do not carry over: any N,
// dh <= 128 with dh % 8 == 0.
//
// What bounds it on the card: three int8 products of N*N*dh per head (q.k
// twice, P.V once; 11.4 GOP at [64,197,2304], 24.5 at [8,816,2304]) against
// the int8 q/k/v/out bytes (and K9's bf16 mask panel): at 1,979 TOP/s and
// 3.35 TB/s the bytes bound both calls (0.0116 ms and 0.0092 ms), but the
// [N, N] f32 elementwise chain between the products (the exp, the
// truncating cast, the max) runs on the CUDA cores and is what the kernel
// spends most of its time on.
//
// The design at head sizes other than 64 (packed_attention_int8_kernel,
// both kernels, MASKED for K9):
// warp-level mma.sync m16n8k32 with s8 operands and s32 accumulators, so
// both products are exact integers whatever the order of their sums.  A
// block of 4 warps takes 64 query rows (16 a warp) of one (head, image); q
// fragments are loaded once into registers; 64-key tiles stream through a
// two-stage cp.async ring in dynamic shared memory, the next tile in flight
// while this one is multiplied.  The row max must be exact before any
// probability is quantized (the truncating cast needs each row to peak at
// exactly 127 / at p = 1), and no online rescaling can stand in for it:
// the block walks the key tiles twice.  Pass 1 streams k (and K9's mask
// tile) and computes q.k^T for the max only: K3 takes it on the int32
// scores (c = scale * s_q * s_k, max(c * max a, c * min a) is exactly the
// max of the f32 scores whatever c's sign), K9 on the scaled and masked f32
// scores.  Pass 2 streams k, v (and the mask) again, recomputes the scores,
// quantizes them and accumulates P.V; K9's integer l rides the tensor cores
// as one more product with a column of ones (the TPU's pq . ones dot), K3's
// f32 l is summed by each lane and across its quad at the end (another
// order than the plain version's sum: its int8 out may differ by a step).
// The f32 operations are the plain version's, in its order, with no
// contraction into an FMA: s = __fmul_rn(float(a), c), then + mask;
// expf(s - m) (K3) and expf((s - m) + ln 127) (K9), never exp2f: a
// truncating cast magnifies an ulp into a whole step.
//
// Where the trouble is, and what the design does about it:
//   1. The layout of V.  Int8 mma exists only as .row.col, so P.V's B
//      operand is V^T, and ldmatrix.trans moves 16-bit elements only.  The
//      v rows stay in shared memory as they land ([key][head byte]); one
//      ldmatrix.trans of four 8-key matrices hands each lane byte pairs of
//      two keys, and four prmt gather them into the B fragments of two
//      n-tiles, head columns 16dp + 2c and 16dp + 2c + 1 (`v_frags_s8`).
//      The output columns come out interleaved: a lane holds four
//      neighbouring head columns of its rows, stored as one word (int8)
//      or two (bf16).  No transpose pass, no v^T buffer, no extra barrier.
//   2. C -> A has no c_to_a.  The s32 C fragment of q.k^T gives lane (g, t)
//      keys 8j+2t, 8j+2t+1; the s8 A fragment wants keys 4t..4t+3 in one
//      register.  The key order inside each 32-key k-step is permuted
//      identically in P's A registers (`pack_s8_a`: a lane packs its own
//      four C values, no shuffle) and in V's B fragments (the same prmt,
//      for free); P.V sums over keys, so it is exact.  q and k need no
//      change: the non-transposed ldmatrix on int8 rows yields the s8 A
//      and B fragments directly.
//   3. The ragged edges.  Head sizes 8/16/24 pad to the 32-byte k-depth of
//      the bucket 32, 40/48/56 to 64, and so on: q's pad columns are zeroed
//      once a block (int8 garbage in k's pad times 0 is 0); v^T rows past
//      dh are never read into a stored column.  Keys past N score int32 0:
//      the last, partial tile (Edge<true>) leaves them out of the max and
//      gives them pq = 0 and p = 0 (else they would add exp(-m) to K3's l
//      and 127 to K9's); their v rows are zero-filled.  v's pad columns
//      (past dh) feed only output columns that are never stored.  A head slice starts h * dh bytes into a 3D-byte
//      row, 16-byte aligned only where dh % 16 == 0: elsewhere the ring
//      copies 8 bytes at a time (`async_tile_s8`).
//   4. K9's mask is staged as a [64 x 64] tile beside each k tile, by
//      `MaskStage` (bool, or the additive mask as bf16: 16 bytes a copy
//      where every row is 16-byte aligned, 4 where 4, else an entry at a
//      time), read from shared memory at the accumulator fragments'
//      positions, once per pass.  A fully masked bool row scores mask_value
//      everywhere, so pq = 127 on every real key and the row is mean(V), as
//      in the plain version and on the TPU; keys past N still weigh 0.
//   5. The block shape.  64 query rows a block, the grid (H, N / 64, B),
//      heads fastest (K9's broadcast mask panel is met in L2 by the heads
//      of one query tile).  At 197 tokens the fourth query tile holds 5
//      rows: its three idle warps only help copy, so 13 of 16 warps work
//      (768 heads, 3072 blocks); at 816, 51 of 52 (96 heads, 1248 blocks).
//      `msvit_packed_attention_int8_occupancy` reports the blocks per SM.
//   6. ptxas's report names this kernel `packed_attention_int8_kernel`
//      templated on <int DHT, bool MASKED>: K9's instantiations carry
//      MASKED's mangled `Lb1E`, which `chip_smoke.py` reads.
// Shared memory at dh 64: q 5 KB, two stages of k and v rows 20 KB, and
// K9's two mask tiles (bool 10 KB, bf16 18 KB).
//
// The route is the entry point's: head size 64 (every zoo trunk but
// vit-h14) takes `packed_attention_int8_wgmma_kernel`
// (`attention_int8_wgmma.cuh`: s8 wgmma fed by TMA, warp-specialised and
// persistent, the same contract; its note has the design), every other
// head size the mma.sync kernel below.  There is no fallback between them:
// a qkv_q that TMA cannot map is refused.  The mma.sync kernel took
// 0.1061-0.1080 ms alone at [64, 197, 2304] and 0.2197-0.2220 ms at
// [8, 816, 2304] with the 224 partition's soft mask (int8 out; NVIDIA H100
// 80GB HBM3, 700 W).

#include <limits.h>

#include <atomic>

#include "attention_int8_wgmma.cuh"

namespace msvit {
namespace {

constexpr uint32_t kOnes8 = 0x01010101u;       // an s8 B fragment of ones

// Bytes per shared row of an int8 head tile (q, k and the staged v rows):
// the head bucket plus 16, so that the 8 row addresses of one ldmatrix fall
// in distinct banks (as mma_ld's bf16 rows).
template <int DHT>
__host__ __device__ constexpr int s8_ld() {
  return DHT + 16;
}

// Dynamic shared memory of one block: q, the two-stage ring of k and v
// rows and (K9) two mask tiles.
template <int DHT, bool MASKED>
int smem_bytes(int mask_kind) {
  return (kMmaRows + 4 * kMmaTile) * s8_ld<DHT>() +
         (MASKED ? 2 * kMmaRows * mask_row_bytes(mask_kind, false, 2) : 0);
}

// A masked scaled score (K9): s = float(a) * c rounded alone (never an FMA
// with the mask), then the additive mask or mask_value where a bool entry
// is false.
__device__ __forceinline__ float masked_score(int a, float c, int kind,
                                              float add, bool keep,
                                              float mask_value) {
  float s = __fmul_rn(static_cast<float>(a), c);
  if (kind == kAddMask) s = __fadd_rn(s, add);
  if (kind == kBoolMask && !keep) s = mask_value;
  return s;
}

// One block = (head, 64 query rows, image), 4 warps of 16 rows.  MASKED:
// K9 (mask, pre-scaled exp, integer l); otherwise K3.
template <int DHT, bool MASKED>
__global__ void __launch_bounds__(kMmaThreads)
packed_attention_int8_kernel(const int8_t* __restrict__ qkv,
                             const float* __restrict__ sc,
                             const void* __restrict__ mask,
                             void* __restrict__ out, int int8_out, int n,
                             int h_count, int dh, int mask_kind,
                             long long mask_sb, long long mask_sh, long long mask_sr,
                             float scale, float mask_value) {
  constexpr int LDB = s8_ld<DHT>();
  constexpr int KT = kMmaTile;  // keys per staged tile
  constexpr int NT = KT / 8;    // score n-tiles per tile
  constexpr int OT = DHT / 8;   // output n-tiles
  constexpr int KS = DHT / 32;  // k-steps of q.k^T
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* qs = reinterpret_cast<int8_t*>(smem);  // [64][LDB]
  int8_t* ring = qs + kMmaRows * LDB;            // [2][k, v][KT][LDB]
  unsigned char* mring = smem + (kMmaRows + 4 * KT) * LDB;  // [2][64][mrow]
  const int h = blockIdx.x;
  const int row0 = blockIdx.y * kMmaRows;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  const int d = h_count * dh;
  const long long row = 3LL * d;  // bytes per token row
  const int8_t* img = qkv + static_cast<long long>(b) * n * row;
  const bool wide = dh % 16 == 0;
  const int mrow = MASKED ? mask_row_bytes(mask_kind, false, 2) : 0;
  const MaskStage mstage(mask, MASKED ? mask_kind : kNoMask, n, mask_sb, mask_sh, mask_sr,
                         b, h, 2);

  if (dh < DHT) {  // q's pad columns: zero once
    zero_smem(qs, kMmaRows * LDB);
    __syncthreads();
  }
  const int tiles = (n + KT - 1) / KT;
  // step u < tiles: pass 1, k tile u; u >= tiles: pass 2, k and v tile
  // u - tiles; the mask tile with both
  auto load_step = [&](int u) {
    const int t = u < tiles ? u : u - tiles;
    int8_t* ks = ring + (u & 1) * 2 * KT * LDB;
    async_tile_s8<LDB>(ks, img + d + h * dh, row, t * KT, KT, n, dh, wide);
    if (u >= tiles)
      async_tile_s8<LDB>(ks + KT * LDB, img + 2 * d + h * dh, row, t * KT, KT, n,
                         dh, wide);
    if (MASKED) mstage.stage(mring + (u & 1) * kMmaRows * mrow, mrow, row0, n, t * KT);
  };
  async_tile_s8<LDB>(qs, img + h * dh, row, row0, kMmaRows, n, dh, wide);
  load_step(0);
  cp_async_commit();

  const float s_q = sc[0];
  const float s_k = sc[1];
  const float s_v = sc[2];
  const float inv_s_out = sc[3];
  const float c = (scale * s_q) * s_k;
  // this thread's two accumulator rows (g and g + 8 of the warp's 16)
  const int r_lo = warp * 16 + gq;

  uint32_t qf[KS][4];
  // pass 1: K3's int32 extremes, K9's f32 max (this lane's keys)
  int amax[2] = {INT_MIN, INT_MIN};
  int amin[2] = {INT_MAX, INT_MAX};
  float mx[2] = {-INFINITY, -INFINITY};
  float m[2] = {0.f, 0.f};  // the rows' maxima, from pass 2 on
  // pass 2
  int o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0;
  float l[2] = {0.f, 0.f};  // K3: this lane's part of the f32 row sums
  int lq[4] = {0, 0, 0, 0};  // K9: sum pq, lq[0] row g, lq[2] row g + 8

  // S = Q.K^T of one staged k tile (its first n16 blocks of 16 keys)
  auto scores = [&](int (&s)[NT][4], const int8_t* ks, int n16) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        if (np >= n16) break;
        uint32_t bfr[4];
        bt_frag_bytes<LDB>(bfr, ks, np, kk, lane);
        mma_s8(s[2 * np], qf[kk], bfr[0], bfr[1]);
        mma_s8(s[2 * np + 1], qf[kk], bfr[2], bfr[3]);
      }
    }
  };

  // a warp whose 16 rows all lie past n (the last query tile) only helps
  // to copy the tiles
  const bool idle = row0 + warp * 16 >= n;
  for (int u = 0; u < 2 * tiles; ++u) {
    if (u + 1 < 2 * tiles) load_step(u + 1);  // its stage was freed at u - 1's end
    cp_async_commit();
    cp_async_wait<1>();  // step u (and q) has landed for this thread
    __syncthreads();     // ... and for every thread
    const int8_t* ks = ring + (u & 1) * 2 * KT * LDB;
    const unsigned char* mt = mring + (u & 1) * kMmaRows * mrow;
    const bool second = u >= tiles;
    const int kv0 = (second ? u - tiles : u) * KT;
    if (!idle) {
      if (u == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          a_frag_bytes<LDB>(qf[kk], qs + warp * 16 * LDB, kk, lane);
      }
      if (u == tiles) {  // the exact row maxima, over the quad's lanes
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (MASKED) {
            m[r] = quad_max(mx[r]);
          } else {
            int hi = amax[r], lo = amin[r];
            hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, 1));
            hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, 2));
            lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, 1));
            lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, 2));
            m[r] = fmaxf(__fmul_rn(static_cast<float>(hi), c),
                         __fmul_rn(static_cast<float>(lo), c));
          }
        }
      }
      auto pass1 = [&](auto edge) {
        constexpr bool EDGE = decltype(edge)::value;
        const int n16 = EDGE ? (n - kv0 + 15) / 16 : KT / 16;
        int s[NT][4];
        scores(s, ks, n16);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = j * 8 + 2 * tq;  // this lane's two keys: col, col + 1
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float add[2];
            bool keep[2];
            if (MASKED) mask_pair(mt, mrow, r_lo + 8 * r, col, mask_kind, add, keep, 2);
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              if (EDGE && kv0 + col + v >= n) continue;  // keys past n: no part
              const int a = s[j][2 * r + v];
              if (MASKED) {
                mx[r] = fmaxf(mx[r], masked_score(a, c, mask_kind, add[v], keep[v],
                                                  mask_value));
              } else {
                amax[r] = max(amax[r], a);
                amin[r] = min(amin[r], a);
              }
            }
          }
        }
      };
      auto pass2 = [&](auto edge) {
        constexpr bool EDGE = decltype(edge)::value;
        const int n16 = EDGE ? (n - kv0 + 15) / 16 : KT / 16;
        int s[NT][4];
        scores(s, ks, n16);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = j * 8 + 2 * tq;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float add[2];
            bool keep[2];
            if (MASKED) mask_pair(mt, mrow, r_lo + 8 * r, col, mask_kind, add, keep, 2);
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              int pq = 0;  // keys past n weigh nothing
              if (!EDGE || kv0 + col + v < n) {
                const int a = s[j][2 * r + v];
                // truncating casts: the exponent is <= 0, so pq <= 127
                if (MASKED) {
                  const float x = masked_score(a, c, mask_kind, add[v], keep[v],
                                               mask_value);
                  pq = static_cast<int>(expf(__fadd_rn(__fsub_rn(x, m[r]), kLn127)));
                } else {
                  const float p = expf(__fsub_rn(__fmul_rn(static_cast<float>(a), c), m[r]));
                  l[r] += p;
                  pq = static_cast<int>(__fmul_rn(p, 127.f));
                }
              }
              s[j][2 * r + v] = pq;
            }
          }
        }
#pragma unroll
        for (int kk = 0; kk < NT / 4; ++kk) {  // 32-key k-steps of P.V
          if (2 * kk >= n16) break;            // pq = 0 past n
          uint32_t pa[4];
          pack_s8_a(pa, s[4 * kk], s[4 * kk + 1], s[4 * kk + 2], s[4 * kk + 3]);
#pragma unroll
          for (int dp = 0; dp < DHT / 16; ++dp) {
            if (16 * dp >= dh) break;
            uint32_t even[2], odd[2];
            v_frags_s8<LDB>(even, odd, ks + KT * LDB, kk, dp, lane);
            mma_s8(o[2 * dp], pa, even[0], even[1]);  // head columns 16dp + 2c
            mma_s8(o[2 * dp + 1], pa, odd[0], odd[1]);  // and 16dp + 2c + 1
          }
          if (MASKED) mma_s8(lq, pa, kOnes8, kOnes8);  // l += sum pq
        }
      };
      const bool full = kv0 + KT <= n;
      if (!second) {
        if (full) {
          pass1(Edge<false>{});
        } else {
          pass1(Edge<true>{});
        }
      } else {
        if (full) {
          pass2(Edge<false>{});
        } else {
          pass2(Edge<true>{});
        }
      }
    }
    __syncthreads();  // this stage is consumed: u + 1 may refill it
  }

  const float kv = s_v / 127.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = row_sum<4>(l[r]);  // (every lane of the warp takes part)
    const int i = row0 + r_lo + 8 * r;
    if (idle || i >= n) continue;
    // K9: s_v / max(sum pq, 1); K3: the TPU kernel's l == 0 guard
    const float f = MASKED ? s_v / fmaxf(static_cast<float>(lq[2 * r]), 1.f) : 0.f;
    if (lr == 0.f) lr = 1.f;
    auto dequant = [&](int a) {
      return MASKED ? static_cast<float>(a) * f : static_cast<float>(a) * kv / lr;
    };
    const long long o_off = (static_cast<long long>(b) * n + i) * d + h * dh;
#pragma unroll
    for (int dp = 0; dp < DHT / 16; ++dp) {
      const int col = 16 * dp + 4 * tq;  // this lane's four head columns
      if (col >= dh) break;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = dequant(o[2 * dp + (e & 1)][2 * r + (e >> 1)]);
      if (int8_out) {
        int q[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          q[e] = static_cast<int>(fminf(fmaxf(rintf(v[e] * inv_s_out), -127.f), 127.f));
        *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(out) + o_off + col) =
            pack_s8(q[0], q[1], q[2], q[3]);
      } else {
        *reinterpret_cast<uint2*>(static_cast<bf16*>(out) + o_off + col) =
            make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
      }
    }
  }
}

// Raises an instantiation's dynamic shared memory ceiling to its largest
// size (K9's with the bf16 mask tiles), once per device: the CUDA runtime
// keeps the attribute, so only a device's first call pays for it.
template <int DHT, bool MASKED>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (device & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(packed_attention_int8_kernel<DHT, MASKED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<DHT, MASKED>(MASKED ? kAddMask : kNoMask));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int DHT, bool MASKED>
cudaError_t launch(const void* qkv, const float* sc, const void* mask, void* out,
                   int int8_out, int b, int n, int h, int dh, int mask_kind,
                   long long sb, long long sh, long long sr, float scale, float mask_value,
                   cudaStream_t stream) {
  const cudaError_t err = allow_smem<DHT, MASKED>();
  if (err != cudaSuccess) return err;
  const int bytes = smem_bytes<DHT, MASKED>(mask_kind);
  const dim3 grid(h, (n + kMmaRows - 1) / kMmaRows, b);
  packed_attention_int8_kernel<DHT, MASKED><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const int8_t*>(qkv), sc, mask, out, int8_out, n, h, dh, mask_kind,
      sb, sh, sr, scale, mask_value);
  return cudaGetLastError();
}

template <bool MASKED>
int run(const void* qkv, const void* sc, const void* mask, void* out,
        int int8_out, int b, int n, int h, int dh, int mask_kind,
        long long mask_sb, long long mask_sh, long long mask_sr, float scale,
        float mask_value, void* stream) {
  if (dh <= 0 || dh > 128 || dh % 8 != 0 || n <= 0 || b <= 0 || h <= 0 ||
      b > 65535 || (n + kMmaRows - 1) / kMmaRows > 65535 || mask_kind < 0 ||
      mask_kind > 2 || (mask_kind != kNoMask && (mask == nullptr || mask_sr < n)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(sc);
  if (dh == 64) {
    const Int8Args a{f, mask, out, mask_sb, mask_sh, mask_sr, int8_out, b, n, h, scale,
                     mask_value};
    return static_cast<int>(launch_int8_wgmma<MASKED>(qkv, a, mask_kind, s));
  }
  if (dh <= 32)
    return static_cast<int>(launch<32, MASKED>(qkv, f, mask, out, int8_out, b, n, h, dh, mask_kind, mask_sb, mask_sh, mask_sr, scale, mask_value, s));
  if (dh <= 64)
    return static_cast<int>(launch<64, MASKED>(qkv, f, mask, out, int8_out, b, n, h, dh, mask_kind, mask_sb, mask_sh, mask_sr, scale, mask_value, s));
  return static_cast<int>(launch<128, MASKED>(qkv, f, mask, out, int8_out, b, n, h, dh, mask_kind, mask_sb, mask_sh, mask_sr, scale, mask_value, s));
}

template <int DHT, bool MASKED>
cudaError_t blocks_per_sm(int mask_kind, int* blocks) {
  const cudaError_t err = allow_smem<DHT, MASKED>();
  if (err != cudaSuccess) return err;
  const int bytes = smem_bytes<DHT, MASKED>(mask_kind);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, packed_attention_int8_kernel<DHT, MASKED>, kMmaThreads, bytes);
}

template <bool MASKED>
cudaError_t occupancy(int dh, int mask_kind, int* blocks) {
  if (dh == 64) return int8_wgmma_blocks_per_sm<MASKED>(mask_kind, blocks);
  if (dh <= 32) return blocks_per_sm<32, MASKED>(mask_kind, blocks);
  if (dh <= 64) return blocks_per_sm<64, MASKED>(mask_kind, blocks);
  return blocks_per_sm<128, MASKED>(mask_kind, blocks);
}

}  // namespace
}  // namespace msvit

extern "C" {

// K3.  qkv: int8 [B, N, 3*h*dh], 16-byte aligned; scales: float32[4] on the
// device; out: int8 or bfloat16 [B, N, h*dh].  Head size 64 takes the wgmma
// kernel, every other head size the mma.sync one.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue, nothing
// launched, where TMA cannot map qkv at head size 64).
int msvit_packed_attention_int8(const void* qkv, const void* scales,
                                void* out, int int8_out, int b, int n, int h,
                                int dh, float scale, void* stream) {
  return msvit::run<false>(qkv, scales, nullptr, out, int8_out, b, n, h, dh, 0,
                           0, 0, 0, scale, 0.f, stream);
}

// K9: as msvit_packed_attention_int8, plus a mask.  mask_kind: 0 none, 1 bool
// (one byte per entry), 2 additive bfloat16; mask_sb / mask_sh / mask_sr its
// image, head and row strides in elements (image and head 0 where
// broadcast; row >= N), the keys of a row contiguous.  At head size 64 TMA
// reads it: its base on 16 bytes and its pitches multiples of 16 bytes,
// else cudaErrorInvalidValue.
int msvit_packed_attention_int8_masked(const void* qkv, const void* scales,
                                       const void* mask, void* out,
                                       int int8_out, int b, int n, int h,
                                       int dh, int mask_kind, long long mask_sb,
                                       long long mask_sh, long long mask_sr, float scale,
                                       float mask_value, void* stream) {
  return msvit::run<true>(qkv, scales, mask, out, int8_out, b, n, h, dh,
                          mask_kind, mask_sb, mask_sh, mask_sr, scale, mask_value,
                          stream);
}

// Blocks of K3 (masked 0) or K9 (masked 1, with this mask_kind) resident on
// one SM at head size dh (the wgmma kernel at 64, else the mma.sync one), by
// the runtime's occupancy calculator (registers and shared memory), into
// *blocks.
int msvit_packed_attention_int8_occupancy(int dh, int masked, int mask_kind,
                                          int* blocks) {
  if (dh <= 0 || dh > 128 || mask_kind < 0 || mask_kind > 2 || blocks == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(masked ? msvit::occupancy<true>(dh, mask_kind, blocks)
                                 : msvit::occupancy<false>(dh, 0, blocks));
}

}  // extern "C"
