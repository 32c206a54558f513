// Helpers shared by the attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace msvit {

// Query rows per block (one thread each) and key/value rows per staged
// tile; the tile halves where two tiles would pass 48 KB of static shared
// memory (f32 at head size 128).
constexpr int kRows = 64;
constexpr int kKv = 64;

// Mask operand: none, bool (one byte per entry, true = attend) or
// additive f32; shaped [B|1, 1|H, N, N], last two dims contiguous.
enum MaskKind { kNoMask = 0, kBoolMask = 1, kAddMask = 2 };

template <typename T, int DHT>
__host__ __device__ constexpr int kv_rows() {
  return 2 * kKv * DHT * static_cast<int>(sizeof(T)) <= 48 * 1024 ? kKv
                                                                  : kKv / 2;
}

// Threads per query (or key) row in the backward kernels: each holds a
// slice of at most 32 head elements in f32 registers, so that a thread of
// the dK/dV kernel keeps k, v, dk and dv (4 x 32 floats) without spilling
// at any head size; dot products are summed across the row's threads with
// shuffles.
template <int DHT>
__host__ __device__ constexpr int row_threads() {
  return DHT > 32 ? DHT / 32 : 1;
}

// Sum over the `TPR` neighbouring lanes of one row (TPR a power of two
// dividing 32; every lane of the warp must take part).
template <int TPR>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Round an f32 value to T and back: the compute-dtype casts of the TPU
// kernels' probability and score-gradient panels.
template <typename T>
__device__ __forceinline__ float round_to(float x);

template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Eight consecutive elements <-> eight floats, as one or two 16-byte moves.
template <typename T>
struct Vec8;

template <>
struct Vec8<float> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

template <>
struct Vec8<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(h[t]);
      o[2 * t] = f.x;
      o[2 * t + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int t = 0; t < 4; ++t) h[t] = __floats2bfloat162_rn(v[2 * t], v[2 * t + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// The backward kernels' view of one row: the row's index, this thread's
// slice and the slice's first head element (row_threads() threads a row).
template <int DHT>
struct RowSlice {
  static constexpr int kTpr = row_threads<DHT>();
  static constexpr int kCh = DHT / kTpr;  // head elements per thread
  int row;
  int e0;
  __device__ RowSlice(int block_row0)
      : row(block_row0 + static_cast<int>(threadIdx.x) / kTpr),
        e0((static_cast<int>(threadIdx.x) % kTpr) * kCh) {}
};

template <typename T, int CH>
__device__ __forceinline__ void load_slice(const T* p, int e0, int dh,
                                           float* out) {
#pragma unroll
  for (int e = 0; e < CH; e += 8)
    if (e0 + e < dh) Vec8<T>::load(p + e0 + e, out + e);
}

template <typename T, int CH>
__device__ __forceinline__ void store_slice(T* p, int e0, int dh,
                                            const float* v, float scale) {
#pragma unroll
  for (int e = 0; e < CH; e += 8) {
    if (e0 + e < dh) {
      float r[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) r[t] = v[e + t] * scale;
      Vec8<T>::store(p + e0 + e, r);
    }
  }
}

// Partial dot products of a register slice with two shared-memory rows:
// a.x and b.y over this thread's slice of the head.
template <typename T, int CH>
__device__ __forceinline__ void dot2(const float* a, const T* x,
                                     const float* b, const T* y, int e0,
                                     int dh, float& ax, float& by) {
  ax = 0.f;
  by = 0.f;
#pragma unroll
  for (int e = 0; e < CH; e += 8) {
    if (e0 + e < dh) {
      float xf[8], yf[8];
      Vec8<T>::load(x + e0 + e, xf);
      Vec8<T>::load(y + e0 + e, yf);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        ax = fmaf(a[e + t], xf[t], ax);
        by = fmaf(b[e + t], yf[t], by);
      }
    }
  }
}

// acc += c * x over this thread's slice (x a shared-memory row).
template <typename T, int CH>
__device__ __forceinline__ void axpy(float* acc, float c, const T* x, int e0,
                                     int dh) {
#pragma unroll
  for (int e = 0; e < CH; e += 8) {
    if (e0 + e < dh) {
      float xf[8];
      Vec8<T>::load(x + e0 + e, xf);
#pragma unroll
      for (int t = 0; t < 8; ++t) acc[e + t] = fmaf(c, xf[t], acc[e + t]);
    }
  }
}

// A scaled score with the mask applied at element `at`: bool (where-valid
// with mask_value) or additive.
__device__ __forceinline__ float apply_mask(float s, int kind,
                                            const uint8_t* mb, const float* mf,
                                            long long at, float mask_value) {
  if (kind == kBoolMask) return mb[at] ? s : mask_value;
  if (kind == kAddMask) return s + mf[at];
  return s;
}

// Copy rows [row0, row0 + rows) of one head's `width`-byte column slice
// (starting `col_bytes` into each row of `row_bytes`) into shared memory,
// `Chunk`-sized moves, neighbouring threads on neighbouring chunks.  Rows
// past `n` are zero-filled.  All threads of the block take part.
template <typename Chunk>
__device__ __forceinline__ void stage_tile(char* dst, const char* img,
                                           long long row_bytes,
                                           long long col_bytes, int width,
                                           int row0, int rows, int n) {
  const int chunks = width / static_cast<int>(sizeof(Chunk));
  const int total = rows * chunks;
  for (int c = threadIdx.x; c < total; c += blockDim.x) {
    const int r = c / chunks;
    const int cc = c - r * chunks;
    const int j = row0 + r;
    Chunk v{};
    if (j < n) {
      v = *reinterpret_cast<const Chunk*>(img + j * row_bytes + col_bytes +
                                          cc * sizeof(Chunk));
    }
    reinterpret_cast<Chunk*>(dst + r * width)[cc] = v;
  }
}

// ------------------------------------------------------------------------
// Tensor-core building blocks (bf16): warp-level mma.sync m16n8k16 with f32
// accumulators, operands from shared memory through ldmatrix, shared memory
// filled by 16-byte cp.async copies.  Fragment layouts (PTX ISA, "Matrix
// fragments for mma.m16n8k16"), with g = lane / 4 and t = lane % 4:
//   A 16x16 (4 regs of 2 bf16): a0 (row g, cols 2t, 2t+1), a1 (row g+8, same
//     cols), a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B 16x8 (2 regs): b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8, 2t+9, col g);
//   C 16x8 (4 f32): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same).
// So the C fragments of two neighbouring n-tiles are, once rounded to bf16
// and paired, the A fragment of the next product over those 16 columns: no
// trip through shared memory.

using bf16 = __nv_bfloat16;

// Rows per block of the mma kernels (16 per warp, 4 warps) and rows per
// staged tile of the other operand.
constexpr int kMmaRows = 64;
constexpr int kMmaThreads = 128;
constexpr int kMmaTile = 64;
constexpr float kLog2e = 1.4426950408889634f;

// Elements per shared-memory row of a head tile: the head bucket plus 16
// bytes, so that the 8 row addresses of one ldmatrix fall in distinct banks.
template <int DHT>
__host__ __device__ constexpr int mma_ld() {
  return DHT + 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (src is
// then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 8 bytes global -> shared, asynchronous; zero-filled when !valid.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronous; zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 matrices of 16-bit elements (8 rows of 16 bytes: bf16, or 16
// int8) from shared memory; lanes 8m..8m+7 give the row addresses of matrix
// m, register m receives it (transposed with _t).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b on the tensor cores (bf16 operands, f32 accumulators).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even) in one register, lo in the low
// half: the element of the lower column index.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment over columns 16c..16c+15 from C fragments of n-tiles 2c
// and 2c+1 (rounded to bf16).
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// The A fragment of rows 0-15 at k-step kk (bytes 32kk..32kk+31 of each
// row: 16 bf16 or 32 int8 columns) of a tile of LDB-byte rows (row major,
// e.g. q rows by head elements): non-transposed ldmatrix.
template <int LDB>
__device__ __forceinline__ void a_frag_bytes(uint32_t (&a)[4], const void* tile,
                                             int kk, int lane) {
  ldsm_x4(a, static_cast<const unsigned char*>(tile) +
                 ((lane & 7) + ((lane >> 3) & 1) * 8) * LDB + kk * 32 +
                 (lane >> 4) * 16);
}

// The bf16 A fragment of rows 0-15, columns 16*kk.. of a [rows][LD] tile.
template <int LD>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const bf16* tile,
                                       int kk, int lane) {
  a_frag_bytes<LD * 2>(a, tile, kk, lane);
}

// B fragments of two n-tiles (rows 16*np.., 8 each) at k-step kk (32
// bytes) of x . tile^T, tile of LDB-byte rows, row major (k or q rows by
// head elements): (b[0], b[1]) for tile rows 16np..16np+7, (b[2], b[3]) for
// the next 8.
template <int LDB>
__device__ __forceinline__ void bt_frag_bytes(uint32_t (&b)[4], const void* tile,
                                              int np, int kk, int lane) {
  ldsm_x4(b, static_cast<const unsigned char*>(tile) +
                 (np * 16 + (lane & 7) + (lane >> 4) * 8) * LDB + kk * 32 +
                 ((lane >> 3) & 1) * 16);
}

// The same for a bf16 tile [rows][LD].
template <int LD>
__device__ __forceinline__ void bt_frag(uint32_t (&b)[4], const bf16* tile,
                                        int np, int kk, int lane) {
  bt_frag_bytes<LD * 2>(b, tile, np, kk, lane);
}

// B fragments of two n-tiles (head elements 16*dp..) at k-step kk of
// p . tile, tile [rows][LD] row major (v rows by head elements): the
// transposed ldmatrix; (b[0], b[1]) for elements 16dp..16dp+7, (b[2], b[3])
// for the next 8.
template <int LD>
__device__ __forceinline__ void b_frag(uint32_t (&b)[4], const bf16* tile,
                                       int kk, int dp, int lane) {
  ldsm_x4_t(b, tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                   dp * 16 + (lane >> 4) * 8);
}

// Asynchronous copy of rows [row0, row0 + rows) of one head's dh-wide column
// slice (`src` at the slice's first element of row 0, `stride` elements
// between rows) into a [rows][LD] shared tile; rows past n are zero-filled,
// columns past dh are not touched.  All threads of the block take part.
template <int LD>
__device__ __forceinline__ void async_tile(bf16* dst, const bf16* src,
                                           long long stride, int row0,
                                           int rows, int n, int dh) {
  const int chunks = dh / 8;
  for (int c = threadIdx.x; c < rows * chunks; c += blockDim.x) {
    const int r = c / chunks;
    const int cc = c - r * chunks;
    const bool ok = row0 + r < n;
    cp_async16(dst + r * LD + cc * 8,
               src + (ok ? row0 + r : 0) * stride + cc * 8, ok);
  }
}

// Zero `bytes` (a multiple of 16) of shared memory; all threads take part.
__device__ __forceinline__ void zero_smem(void* p, int bytes) {
  uint4* q = static_cast<uint4*>(p);
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    q[i] = make_uint4(0u, 0u, 0u, 0u);
}

// Max over the 4 lanes of a quad (the threads that share an accumulator
// row; row_sum<4> sums over them).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return v;
}

// A-operand fragments of a warp's 16 resident rows (q in the forward; q
// and g in the dQ kernel, k and v in the dK/dV kernel): held in registers
// up to dh 64, read from the staged tile at each use at dh 128, where they
// would not fit the registers beside the accumulators.
template <int DHT>
struct Resident {
  static constexpr int kSteps = DHT / 16;
  static constexpr bool kInRegs = DHT <= 64;
  uint32_t f[kInRegs ? kSteps : 1][4];
  const bf16* tile;  // the warp's 16 rows

  __device__ __forceinline__ void load(const bf16* warp_rows, int lane) {
    tile = warp_rows;
    if constexpr (kInRegs) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) a_frag<mma_ld<DHT>()>(f[kk], tile, kk, lane);
    }
  }
  __device__ __forceinline__ void get(uint32_t (&a)[4], int kk, int lane) const {
    if constexpr (kInRegs) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = f[kk][e];
    } else {
      a_frag<mma_ld<DHT>()>(a, tile, kk, lane);
    }
  }
};

template <int NT>
__device__ __forceinline__ void zero_acc(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// c[16 rows][TILE cols] = A . tile^T: A resident (16 x DHT), tile [TILE][LD];
// only the first n16 blocks of 16 columns are computed (a ragged last tile),
// the others stay 0.
template <int DHT, int TILE>
__device__ __forceinline__ void product_t(float (&c)[TILE / 8][4],
                                          const Resident<DHT>& a,
                                          const bf16* tile, int lane,
                                          int n16 = TILE / 16) {
  zero_acc(c);
#pragma unroll
  for (int kk = 0; kk < DHT / 16; ++kk) {
    uint32_t af[4];
    a.get(af, kk, lane);
#pragma unroll
    for (int np = 0; np < TILE / 16; ++np) {
      if (np >= n16) break;
      uint32_t bf[4];
      bt_frag<mma_ld<DHT>()>(bf, tile, np, kk, lane);
      mma_bf16(c[2 * np], af, bf[0], bf[1]);
      mma_bf16(c[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[16 rows][DHT] += P[:, 16kk..16kk+15] . tile[16kk..16kk+15, :]: P's
// A fragment over those 16 columns, tile [rows][LD].
template <int DHT>
__device__ __forceinline__ void pv_step(float (&acc)[DHT / 8][4],
                                        const uint32_t (&pa)[4],
                                        const bf16* tile, int kk, int lane) {
#pragma unroll
  for (int dp = 0; dp < DHT / 16; ++dp) {
    uint32_t bf[4];
    b_frag<mma_ld<DHT>()>(bf, tile, kk, dp, lane);
    mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
    mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
  }
}

// acc[16 rows][DHT] += P . tile: P as TILE/8 C fragments (bf16 values),
// tile [TILE][LD].
template <int DHT, int TILE>
__device__ __forceinline__ void product_acc(float (&acc)[DHT / 8][4],
                                            const float (&p)[TILE / 8][4],
                                            const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    uint32_t pa[4];
    c_to_a(pa, p[2 * kk], p[2 * kk + 1]);
    pv_step<DHT>(acc, pa, tile, kk, lane);
  }
}

// bf16 1.0 in both halves: the B fragment of a column of ones, so that
// mma_bf16(c, a, kOnes2, kOnes2) adds the row sums of a's 16 columns to
// every column of c (c[0] row g, c[2] row g + 8), as the TPU sums its
// rounded probabilities, through the matrix unit.
constexpr uint32_t kOnes2 = 0x3f803f80u;

// Rows r0 and r0 + 8 of a 16-row accumulator, times `scale`, as bf16 pairs
// into `dst` (row i at dst + i * stride) for rows below n and columns below
// dh.
template <int DHT>
__device__ __forceinline__ void store_rows(bf16* dst, long long stride,
                                           const float (&acc)[DHT / 8][4],
                                           int r0, int n, int dh, int tq,
                                           float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + 8 * r;
    if (i >= n) continue;
#pragma unroll
    for (int j = 0; j < DHT / 8; ++j) {
      const int col = j * 8 + 2 * tq;
      if (col < dh)
        *reinterpret_cast<uint32_t*>(dst + i * stride + col) =
            pack_bf16(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
    }
  }
}

// Bytes of one row of a staged [64 x 64] mask tile (rows: queries,
// columns: keys), 16-byte multiples.  Read at the accumulator fragments'
// positions with queries as rows (K7, the dQ kernel, K9): KT f32 words plus
// 8 (float2 reads, 8 rows x 4 lanes in distinct banks per half warp), KT
// bf16 plus 8 (K9's additive mask: one word a pair, rows 36 words apart,
// so the 32 lanes hit 32 banks), or KT bytes plus 16 (bool).  Read
// transposed, keys as rows (the dK/dV kernel: lanes g on 8 neighbouring
// columns, lanes t on rows 2t apart): KT words plus 4, so that row 2t
// starts 8t banks on; bool as before.  add_bytes: 4 (f32) or 2 (bf16).
__host__ __device__ constexpr int mask_row_bytes(int kind, bool transposed = false,
                                                 int add_bytes = 4) {
  return kind == kAddMask ? (kMmaTile + (transposed ? 4 : 8)) * add_bytes
         : kind == kBoolMask ? kMmaTile + 16
                             : 0;
}

// The mask entries of columns c, c + 1 of row `row` of a staged mask tile
// (rows of `mrow` bytes) at an accumulator fragment's position: the
// additive values (0 without; f32 entries, or bf16 with add_bytes 2) and
// whether the two keys are attended.
__device__ __forceinline__ void mask_pair(const unsigned char* mt, int mrow,
                                          int row, int c, int kind,
                                          float (&add)[2], bool (&keep)[2],
                                          int add_bytes = 4) {
  const unsigned char* mr = mt + row * mrow;
  add[0] = add[1] = 0.f;
  keep[0] = keep[1] = true;
  if (kind == kAddMask && add_bytes == 2) {  // bf16 -> f32: the high half
    const uint32_t w = *reinterpret_cast<const uint32_t*>(mr + c * 2);
    add[0] = __uint_as_float(w << 16);
    add[1] = __uint_as_float(w & 0xffff0000u);
  } else if (kind == kAddMask) {
    const float2 a = *reinterpret_cast<const float2*>(mr + c * 4);
    add[0] = a.x;
    add[1] = a.y;
  } else if (kind == kBoolMask) {
    const unsigned w = *reinterpret_cast<const uint16_t*>(mr + c);
    keep[0] = (w & 0xffu) != 0;
    keep[1] = (w >> 8) != 0;
  }
}

// One (image, head)'s [Nq, Nk] panel of a mask [B|1, 1|H, Nq, Nk] (bool,
// one byte per entry, or additive f32, or additive bf16 with add_bytes 2;
// last two dims contiguous), staged a [64 x 64] tile at a time by cp.async:
// 16 bytes a copy where every row is 16-byte aligned (f32 with Nk % 4 == 0,
// bf16 with Nk % 8 == 0, bool with Nk % 16 == 0), else 4 (f32; bf16 with
// Nk % 2 == 0; bool with Nk % 4 == 0), else an entry at a time by plain
// loads (bf16 two bytes, bool one): never a misaligned cp.async.
struct MaskStage {
  const unsigned char* img;
  long long grow;  // bytes per panel row
  int esize;       // bytes per entry
  int chunk;       // bytes per copy; 0 without a mask

  __device__ MaskStage(const void* mask, int kind, int nk, long long sb,
                       long long sh, int b, int h, int add_bytes = 4)
      : img(static_cast<const unsigned char*>(mask)),
        grow(static_cast<long long>(nk) * (kind == kAddMask ? add_bytes : 1)),
        esize(kind == kAddMask ? add_bytes : 1),
        chunk(0) {
    img += (b * sb + h * sh) * esize;
    auto aligned = [&](int a) {
      return reinterpret_cast<uintptr_t>(mask) % a == 0 && grow % a == 0 &&
             (sb * esize) % a == 0 && (sh * esize) % a == 0;
    };
    if (kind != kNoMask)
      chunk = aligned(16) ? 16 : aligned(4) ? 4 : esize == 2 && aligned(2) ? 2 : 1;
  }

  // Rows [r0, r0 + 64) x columns [k0, k0 + 64) of the panel into `dst`
  // (rows of `row_bytes`); rows past nq and columns past Nk are
  // zero-filled.  All threads of the block take part.
  __device__ __forceinline__ void stage(unsigned char* dst, int row_bytes,
                                        int r0, int nq, int k0) const {
    if (chunk == 0) return;
    const long long c0 = static_cast<long long>(k0) * esize;
    const int per_row = kMmaTile * esize / chunk;
    for (int c = threadIdx.x; c < kMmaRows * per_row; c += blockDim.x) {
      const int r = c / per_row;
      const int off = (c - r * per_row) * chunk;
      const bool ok = r0 + r < nq && c0 + off < grow;
      const unsigned char* src =
          img + (ok ? static_cast<long long>(r0 + r) * grow + c0 + off : 0);
      unsigned char* to = dst + r * row_bytes + off;
      if (chunk == 16) {
        cp_async16(to, src, ok);
      } else if (chunk == 4) {
        cp_async4(to, src, ok);
      } else if (chunk == 2) {
        *reinterpret_cast<uint16_t*>(to) =
            ok ? *reinterpret_cast<const uint16_t*>(src) : uint16_t{0};
      } else {
        *to = ok ? *src : 0;
      }
    }
  }
};

// ------------------------------------------------------------------------
// Tensor-core building blocks (int8): warp-level mma.sync m16n8k32 with s8
// operands and s32 accumulators, so every integer product and sum is exact.
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k32", .s8),
// with g = lane / 4 and t = lane % 4:
//   A 16x32 (4 regs of 4 s8): a0 (row g, cols 4t..4t+3), a1 (row g+8, same
//     cols), a2 (row g, cols 16+4t..16+4t+3), a3 (row g+8, cols 16+4t..);
//   B 32x8 (2 regs): b0 (rows 4t..4t+3, col g), b1 (rows 16+4t.., col g);
//   C 16x8 (4 s32): as m16n8k16's, c0, c1 (row g, cols 2t, 2t+1), c2, c3
//     (row g+8).
// A k-step is 32 bytes, as bf16's, and the non-transposed ldmatrix gives
// lane (g, t) bytes 4t..4t+3 of row g of each 8 x 16-byte matrix: so
// a_frag_bytes and bt_frag_bytes on int8 tiles yield these A and B
// fragments as they yield bf16's.  The transposed ldmatrix moves byte
// pairs, not bytes (see v_frags_s8), and the C fragment is not the next A
// fragment (lane (g, t) holds keys 8j+2t, 8j+2t+1; A wants 4t..4t+3): see
// pack_s8_a.

// c += a . b on the tensor cores (s8 operands, s32 accumulators).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four values in [-128, 127] as the bytes of one register, x0 lowest.
__device__ __forceinline__ uint32_t pack_s8(int x0, int x1, int x2, int x3) {
  return __byte_perm(__byte_perm(x0, x1, 0x0040), __byte_perm(x2, x3, 0x0040),
                     0x5410);
}

// The A fragment of one 32-key k-step from the s32 C fragments of its four
// 8-key n-tiles c[0..3] (values in [-128, 127]), keys in a permuted order:
// register a0 holds row g's keys 2t, 2t+1, 8+2t, 9+2t (its own c0, c1 of
// n-tiles 0 and 1), a2 keys 16+2t, 17+2t, 24+2t, 25+2t (n-tiles 2 and 3),
// a1 and a3 the same keys of row g+8.  No shuffle: the product's other
// operand takes its keys in the same order (v_frags_s8), and a sum over
// keys does not depend on their order.
__device__ __forceinline__ void pack_s8_a(uint32_t (&a)[4], const int (&c0)[4],
                                          const int (&c1)[4], const int (&c2)[4],
                                          const int (&c3)[4]) {
  a[0] = pack_s8(c0[0], c0[1], c1[0], c1[1]);
  a[1] = pack_s8(c0[2], c0[3], c1[2], c1[3]);
  a[2] = pack_s8(c2[0], c2[1], c3[0], c3[1]);
  a[3] = pack_s8(c2[2], c2[3], c3[2], c3[3]);
}

// P.V's B fragments at k-step kk (keys 32kk..32kk+31) for head bytes
// 16dp..16dp+15, straight from v rows (row major [key][head byte], LDB-byte
// rows): int8 mma wants v^T, and ldmatrix.trans transposes 16-bit
// elements, so it hands lane (g, t) byte pairs (2g, 2g+1) of keys 8m+2t
// and 8m+2t+1 from each 8-key matrix m; prmt then gathers head byte 2g
// (`even`) and 2g+1 (`odd`) of keys 2t, 2t+1, 8+2t, 9+2t into b0, and of
// those keys plus 16 into b1: pack_s8_a's key order.  So the n-tile of
// `even` is head columns 16dp + 2c (c its C column), that of `odd`
// 16dp + 2c + 1, and lane (g, t) accumulates head columns 16dp + 4t ..
// 16dp + 4t + 3 of its rows: even c0, odd c0, even c1, odd c1.
template <int LDB>
__device__ __forceinline__ void v_frags_s8(uint32_t (&even)[2], uint32_t (&odd)[2],
                                           const int8_t* vs, int kk, int dp,
                                           int lane) {
  uint32_t m[4];
  ldsm_x4_t(m, vs + (32 * kk + lane) * LDB + 16 * dp);
  even[0] = __byte_perm(m[0], m[1], 0x6420);
  odd[0] = __byte_perm(m[0], m[1], 0x7531);
  even[1] = __byte_perm(m[2], m[3], 0x6420);
  odd[1] = __byte_perm(m[2], m[3], 0x7531);
}

// Asynchronous copy of rows [row0, row0 + rows) of one head's dh-byte int8
// column slice (`src` at the slice's first byte of row 0, `stride` bytes
// between rows) into a [rows][LDB] shared tile: 16 bytes a copy where the
// slices are 16-byte aligned (`wide`: dh % 16 == 0), else 8 (a head slice
// at h * dh is 8-byte aligned at dh 8, 24, 40, ...); rows past n are
// zero-filled, columns past dh are not touched.  All threads take part.
template <int LDB>
__device__ __forceinline__ void async_tile_s8(int8_t* dst, const int8_t* src,
                                              long long stride, int row0, int rows,
                                              int n, int dh, bool wide) {
  const int chunk = wide ? 16 : 8;
  const int chunks = dh / chunk;
  for (int c = threadIdx.x; c < rows * chunks; c += blockDim.x) {
    const int r = c / chunks;
    const int off = (c - r * chunks) * chunk;
    const bool ok = row0 + r < n;
    const int8_t* from = src + (ok ? row0 + r : 0) * stride + off;
    if (wide) {
      cp_async16(dst + r * LDB + off, from, ok);
    } else {
      cp_async8(dst + r * LDB + off, from, ok);
    }
  }
}

// A compile-time flag for a tile loop's body written as a generic lambda:
// body(Edge<false>{}) for a full tile, body(Edge<true>{}) for the ragged
// last one, each compiled on its own.
template <bool B>
struct Edge {
  static constexpr bool value = B;
};

}  // namespace msvit
