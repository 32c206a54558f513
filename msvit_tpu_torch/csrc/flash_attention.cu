// Flash attention forward on [B, H, N, dh] operands (bf16 / f32): K7 and
// K7-lse.
//
// Replaces the TPU kernel `msvit_tpu/ops/flash_attention.py::_flash_forward`
// (body `_fwd_kernel`, its pallas_call): the exact online-softmax attention
// that the JAX package's "auto" takes once one head's score tile outgrows
// the single-pass fused kernel (the multistate trunk at 448 px, 3168
// tokens).  Entry points `msvit_flash_attention` (out) and
// `msvit_flash_attention_lse` (out and a compact lse [B, H, Nq] f32, 0
// where l == 0, the TPU kernel's `where(l > 0, m + log l, 0)`; the TPU's
// lane-replicated [B, H, Nq_pad, 128] layout does not carry over).  One
// kernel serves both: the lse is a pointer that may be null, and out is
// the same bits either way.
//
// Same contract as K5 (`fused_attention.cu`): q [B, H, Nq, dh], k, v
// [B, H, Nk, dh], Nq != Nk allowed, each read through its own image / head /
// row strides in elements with the last dim contiguous and every row
// 16-byte aligned (views of the QKV GEMM output need no copy); out written
// through strides.  Masks bool (true = attend) or additive f32,
// [B|1, 1|H, Nq, Nk] with the last two dims contiguous, applied in the TPU
// kernel's order: scale, add the additive mask, then where-valid with
// mask_value.  No N limit.  The softmax is the exact one: the online row
// max, p = exp(s - m), l summed from the unrounded p, P.V with p rounded to
// the compute dtype (the identity in f32), as the TPU kernel; a -inf score
// weighs nothing and a row with l == 0 (every score -inf) gives zeros and
// lse 0 (the TPU's l_inv guard).
//
// Fully masked rows: a bool row with every entry false has every score at
// mask_value, and the kernel gives mean(V) over the Nk real keys: keys past
// Nk are -inf, never mask_value.  The TPU kernel pads Nk to
// nk_pad = ceil(Nk / bk) * bk, bk = min(1024, ceil128(Nk)), and its padded
// keys (zero rows of V) enter l with p = 1 there: sum(V) / nk_pad, a padding
// artifact the port does not copy.
//
// What bounds it on the card: operations, 4*Nq*Nk*dh FLOP per head, against
// 2*(Nq + 2*Nk)*dh bytes of q/k/v/out plus the mask's Nq*Nk entries; at the
// 448-px trunk ([8, 12, 3168, 64], a soft mask of 8 x 3168^2 f32 = 321 MB
// broadcast over the heads) 0.2494 ms of operations against 0.096 ms of
// bytes, if the mask is read once.
//
// bf16, on the tensor cores (flash_mma_kernel): K1-lse's tiles
// (packed_attention_lse.cu) on strided operands.  Warp-level mma.sync
// m16n8k16 (bf16 operands, f32 accumulators); a block of 4 warps takes 64
// query rows (16 a warp) of one (head, image), q fragments loaded once
// (read from shared memory at each use at dh 128).  k/v tiles of 64 rows
// and the [64 x 64] mask tile stream through a two-stage ring in dynamic
// shared memory filled by cp.async, so the next tile and its mask arrive
// while this one is multiplied.  Per tile: S = Q.K^T (k through ldmatrix),
// scale and mask on the accumulator fragments in log2 units (one multiply
// by scale * log2e, the mask tile read from shared memory at the
// fragments' positions; only the last, partial tile checks its keys
// against Nk and skips its 16-key blocks past Nk; a warp whose rows all
// lie past Nq only helps copy), the online row max across the 4 lanes of a
// quad,
// p = exp2(x - m), p rounded to bf16 in registers as the A fragment of
// O += P.V (v through ldmatrix.trans); the lse goes back to natural units
// at the end.  A masked bool entry sits at mask_value * log2e, or at the
// most negative finite float where that overflows (the default
// mask_value), and a fully masked row's lse is mask_value + log l, as the
// TPU's.  The mask dominates the bytes: a
// broadcast mask read separately by each head's blocks would cost
// 12 x 321 MB at 448 px, so the grid is (H, q tiles, B), the head fastest:
// the 12 heads of one query tile run together and meet their mask panel
// in L2 (cp.async.cg keeps it out of L1).  Mask tile rows are padded (f32
// 72 words, bool 80 bytes), so that a warp's fragment reads hit distinct
// banks.  Mask rows are copied 16 bytes at a time where every row is
// 16-byte aligned (an f32 mask with Nk % 4 == 0, a bool one with
// Nk % 16 == 0), else 4 bytes (f32; bool with Nk % 4 == 0), else a byte at
// a time (bool); never a misaligned 16-byte cp.async.  Shared memory at
// dh 64: 2 stages x (k 9 KB + v 9 KB + f32 mask 18 KB) = 72 KB, q staged in
// stage 1's k buffer until its fragments are in registers (46 KB with a
// bool mask, 36 KB with none): 3 blocks an SM with an f32 mask (a separate
// q buffer, 81 KB, would allow 2), 4 with a bool mask or none (registers
// bound them there).  At dh 128 q stays in its own buffer (its fragments
// are read from it at each use).  Head sizes 8/24/40 are zero-padded in
// shared memory to their bucket, zeroed once a block.  wgmma with TMA and
// warp specialisation is the later step.
//
// f32 (flash_forward_kernel): one thread per query row on the CUDA cores
// in f32 FMAs (TF32 would break the f32 bars), the [Nq, Nk] scores in
// registers; k/v tiles staged once per block in shared memory with
// coalesced 16-byte loads and read by all 64 rows as broadcasts; each
// [64 rows x KV] mask tile staged in shared memory with coalesced loads (a
// bool tile as 1/0 floats), its rows padded by one word.  A new running max
// rescales l and the accumulator by exp(m_old - m_new) (0 at the first
// score).

#include "common.cuh"

namespace msvit {
namespace {

// Element strides of q, k, v and out: image, head, row.
struct Strides {
  long long qb, qh, qn, kb, kh, kn, vb, vh, vn, ob, oh, on;
};

// Key rows per staged tile: the k/v tiles and the padded f32 mask tile
// within 40 KB of static shared memory.
template <typename T, int DHT>
__host__ __device__ constexpr int flash_kv() {
  return 2 * kKv * DHT * static_cast<int>(sizeof(T)) + kRows * (kKv + 1) * 4 <=
                 40 * 1024
             ? kKv
             : kKv / 2;
}

// One block = (64 query rows, head, image); one thread = one query row.
template <typename T, int DHT>
__global__ void __launch_bounds__(kRows)
flash_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const void* __restrict__ mask,
                     T* __restrict__ out, float* __restrict__ lse, Strides st,
                     int nq, int nk, int dh, int mask_kind, long long mask_sb,
                     long long mask_sh, float scale, float mask_value) {
  constexpr int KV = flash_kv<T, DHT>();
  constexpr int MS = KV + 1;  // padded mask tile row
  __shared__ __align__(16) T ks[KV * DHT];
  __shared__ __align__(16) T vs[KV * DHT];
  __shared__ float ms[kRows * MS];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int i0 = blockIdx.x * kRows;
  const int i = i0 + threadIdx.x;
  const bool active = i < nq;
  const char* kimg = reinterpret_cast<const char*>(k + b * st.kb + h * st.kh);
  const char* vimg = reinterpret_cast<const char*>(v + b * st.vb + h * st.vh);
  const long long mbase = b * mask_sb + h * mask_sh;
  const uint8_t* mb = static_cast<const uint8_t*>(mask) + mbase;
  const float* mf = static_cast<const float*>(mask) + mbase;

  float qr[DHT];
  float acc[DHT];
#pragma unroll
  for (int e = 0; e < DHT; ++e) {
    qr[e] = 0.f;
    acc[e] = 0.f;
  }
  if (active) {
    const T* qrow = q + b * st.qb + h * st.qh + i * st.qn;
#pragma unroll
    for (int e = 0; e < DHT; e += 8)
      if (e < dh) Vec8<T>::load(qrow + e, qr + e);
  }

  const int width = dh * static_cast<int>(sizeof(T));
  const long long krow = st.kn * static_cast<long long>(sizeof(T));
  const long long vrow = st.vn * static_cast<long long>(sizeof(T));
  const float* mrow = ms + threadIdx.x * MS;
  float m = -INFINITY;
  float l = 0.f;
  for (int kv0 = 0; kv0 < nk; kv0 += KV) {
    const int cnt = min(KV, nk - kv0);
    __syncthreads();  // the previous tiles are consumed
    stage_tile<uint4>(reinterpret_cast<char*>(ks), kimg, krow, 0, width, kv0,
                      KV, nk);
    stage_tile<uint4>(reinterpret_cast<char*>(vs), vimg, vrow, 0, width, kv0,
                      KV, nk);
    if (mask_kind != kNoMask) {
      for (int e = threadIdx.x; e < kRows * KV; e += kRows) {
        const int r = e / KV;
        const int c = e - r * KV;
        float val = 0.f;
        if (i0 + r < nq && c < cnt) {
          const long long at = static_cast<long long>(i0 + r) * nk + kv0 + c;
          val = mask_kind == kBoolMask ? (mb[at] ? 1.f : 0.f) : mf[at];
        }
        ms[r * MS + c] = val;
      }
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < cnt; ++j) {
      const T* kr = ks + j * dh;
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < DHT; e += 8) {
        if (e < dh) {
          float kf[8];
          Vec8<T>::load(kr + e, kf);
#pragma unroll
          for (int t = 0; t < 8; ++t) s = fmaf(qr[e + t], kf[t], s);
        }
      }
      s *= scale;
      if (mask_kind == kBoolMask) {
        s = mrow[j] != 0.f ? s : mask_value;
      } else if (mask_kind == kAddMask) {
        s += mrow[j];
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
  if (lse != nullptr)
    lse[(static_cast<long long>(b) * gridDim.y + h) * nq + i] =
        l > 0.f ? m + logf(l) : 0.f;
  T* o = out + b * st.ob + h * st.oh + i * st.on;
  const float l_inv = l == 0.f ? 1.f : 1.f / l;  // the TPU kernel's guard
#pragma unroll
  for (int e = 0; e < DHT; e += 8) {
    if (e < dh) {
      float r[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) r[t] = acc[e + t] * l_inv;
      Vec8<T>::store(o + e, r);
    }
  }
}

template <typename T, int DHT>
void launch(const void* q, const void* k, const void* v, const void* mask,
            void* out, float* lse, const Strides& st, int b, int h, int nq,
            int nk, int dh, int mask_kind, long long sb, long long sh,
            float scale, float mask_value, cudaStream_t stream) {
  const dim3 grid((nq + kRows - 1) / kRows, h, b);
  flash_forward_kernel<T, DHT><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), lse, st, nq, nk, dh,
      mask_kind, sb, sh, scale, mask_value);
}

template <typename T>
void dispatch(const void* q, const void* k, const void* v, const void* mask,
              void* out, float* lse, const Strides& st, int b, int h, int nq,
              int nk, int dh, int mask_kind, long long sb, long long sh,
              float scale, float mask_value, cudaStream_t stream) {
  if (dh <= 16) {
    launch<T, 16>(q, k, v, mask, out, lse, st, b, h, nq, nk, dh, mask_kind, sb, sh, scale, mask_value, stream);
  } else if (dh <= 32) {
    launch<T, 32>(q, k, v, mask, out, lse, st, b, h, nq, nk, dh, mask_kind, sb, sh, scale, mask_value, stream);
  } else if (dh <= 64) {
    launch<T, 64>(q, k, v, mask, out, lse, st, b, h, nq, nk, dh, mask_kind, sb, sh, scale, mask_value, stream);
  } else {
    launch<T, 128>(q, k, v, mask, out, lse, st, b, h, nq, nk, dh, mask_kind, sb, sh, scale, mask_value, stream);
  }
}

constexpr float kLn2 = 0.6931471805599453f;

// The scores of one 64-key tile in log2 units, x = s * scale * log2e with
// the staged mask tile `mt` (rows of `mrow` bytes; the additive mask times
// log2e, a masked bool entry at `masked`), read at the fragments'
// positions; mx takes the tile's row maxima.  EDGE: the last, partial tile,
// whose keys past nk are -inf.
template <bool EDGE, int NT>
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
        if (EDGE && kv0 + c + u >= nk) x = -INFINITY;  // keys past Nk weigh nothing
        s[j][2 * r + u] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
  }
}

// One block = (head, 64 query rows, image), 4 warps of 16 rows; bf16 only.
// The head is blockIdx.x: blocks that share a broadcast mask panel run
// together.  Where q's fragments live in registers (dh <= 64), q is staged
// in stage 1's k buffer, which tile 1 refills once they are loaded.
template <int DHT>
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
  float m[2] = {-INFINITY, -INFINITY};  // running row maxima, log2 units
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

      // scale, mask, ragged edge; the tile's row max
      float mx[2] = {m[0], m[1]};
      flash_scores<EDGE, NT>(s, mx, mt, mrow, r_lo, kv0, tq, nk, mask_kind, c2, masked);
      float mu[2];
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
      if (col < dh)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(o[j][2 * r] * l_inv, o[j][2 * r + 1] * l_inv);
    }
    if (lse != nullptr && tq == 0) {
      // back to natural units; a fully masked row's max is `masked`, whose
      // natural value is mask_value itself
      const float mn = m[r] == masked ? mask_value : m[r] * kLn2;
      lse[(static_cast<long long>(b) * h_count + h) * nq + i] =
          lr > 0.f ? mn + logf(lr) : 0.f;
    }
  }
}

template <int DHT>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* mask, void* out, float* lse,
                       const Strides& st, int b, int h, int nq, int nk, int dh,
                       int mask_kind, long long sb, long long sh, float scale,
                       float mask_value, cudaStream_t stream) {
  const int rows = 4 * kMmaTile + (Resident<DHT>::kInRegs ? 0 : kMmaRows);
  const int bytes = rows * mma_ld<DHT>() * static_cast<int>(sizeof(bf16)) +
                    2 * kMmaRows * mask_row_bytes(mask_kind);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<DHT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(h, (nq + kMmaRows - 1) / kMmaRows, b);
  flash_mma_kernel<DHT><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), mask, static_cast<bf16*>(out), lse, st, h,
      nq, nk, dh, mask_kind, sb, sh, scale, mask_value);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v,
                         const void* mask, void* out, float* lse,
                         const Strides& st, int b, int h, int nq, int nk,
                         int dh, int mask_kind, long long sb, long long sh,
                         float scale, float mask_value, cudaStream_t stream) {
  if (dh <= 16)
    return launch_mma<16>(q, k, v, mask, out, lse, st, b, h, nq, nk, dh, mask_kind, sb, sh, scale, mask_value, stream);
  if (dh <= 32)
    return launch_mma<32>(q, k, v, mask, out, lse, st, b, h, nq, nk, dh, mask_kind, sb, sh, scale, mask_value, stream);
  if (dh <= 64)
    return launch_mma<64>(q, k, v, mask, out, lse, st, b, h, nq, nk, dh, mask_kind, sb, sh, scale, mask_value, stream);
  return launch_mma<128>(q, k, v, mask, out, lse, st, b, h, nq, nk, dh, mask_kind, sb, sh, scale, mask_value, stream);
}

int run(const void* q, const void* k, const void* v, const void* mask,
        void* out, float* lse, int dtype, int b, int h, int nq, int nk, int dh,
        const long long* strides, int mask_kind, long long mask_sb,
        long long mask_sh, float scale, float mask_value, void* stream) {
  if (dh <= 0 || dh > 128 || dh % 8 != 0 || nq <= 0 || nk <= 0 || b <= 0 ||
      h <= 0 || b > 65535 || h > 65535 || mask_kind < 0 || mask_kind > 2 ||
      (mask_kind != kNoMask && mask == nullptr) || strides == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dispatch<float>(q, k, v, mask, out, lse, st, b, h, nq, nk, dh, mask_kind,
                    mask_sb, mask_sh, scale, mask_value, s);
  } else if (dtype == 1) {
    return static_cast<int>(dispatch_mma(q, k, v, mask, out, lse, st, b, h,
                                         nq, nk, dh, mask_kind, mask_sb,
                                         mask_sh, scale, mask_value, s));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace msvit

extern "C" {

// K7.  dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  strides: 12 element strides (host
// memory) of q, k, v, out, each (image, head, row); every row's dh elements
// contiguous and 16-byte aligned.  mask_kind: 0 none, 1 bool (one byte per
// entry), 2 additive float32; mask_sb / mask_sh the mask's image and head
// strides in elements (0 where broadcast), its last two dims contiguous
// [Nq, Nk].  Returns cudaGetLastError() after the launch.
int msvit_flash_attention(const void* q, const void* k, const void* v,
                          const void* mask, void* out, int dtype, int b,
                          int h, int nq, int nk, int dh,
                          const long long* strides, int mask_kind,
                          long long mask_sb, long long mask_sh, float scale,
                          float mask_value, void* stream) {
  return msvit::run(q, k, v, mask, out, nullptr, dtype, b, h, nq, nk, dh,
                    strides, mask_kind, mask_sb, mask_sh, scale, mask_value,
                    stream);
}

// K7-lse, the training forward: as msvit_flash_attention, plus lse
// [B, H, Nq] f32 (contiguous), written.
int msvit_flash_attention_lse(const void* q, const void* k, const void* v,
                              const void* mask, void* out, void* lse,
                              int dtype, int b, int h, int nq, int nk, int dh,
                              const long long* strides, int mask_kind,
                              long long mask_sb, long long mask_sh,
                              float scale, float mask_value, void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return msvit::run(q, k, v, mask, out, static_cast<float*>(lse), dtype, b, h,
                    nq, nk, dh, strides, mask_kind, mask_sb, mask_sh, scale,
                    mask_value, stream);
}

}  // extern "C"
