// Hopper (sm_90a) building blocks of the wgmma kernels: TMA tile loads
// into shared memory tracked by mbarriers, warpgroup matrix products
// (wgmma.mma_async) on 128-byte-swizzled tiles, and the register moves of
// warp specialisation (setmaxnreg).  PTX ISA 8.x: "Tensor Memory
// Accelerator", "mbarrier", "Asynchronous Warpgroup Level Matrix
// Multiply-Accumulate".
//
// Tiles.  Every shared-memory tile holds 64-element bf16 rows (one head,
// 128 bytes a row) as TMA writes them with CU_TENSOR_MAP_SWIZZLE_128B: the
// 16-byte chunk c of row r sits at chunk c ^ (r % 8), 8 rows make a
// 1024-byte atom, atoms follow each other.  A tile starts on a 1024-byte
// boundary, so the swizzle phase is the address's own (bits 4-6 XOR bits
// 7-9), which is what the wgmma descriptors below assume (base offset 0).
//
// Descriptors (`desc`): start address, leading and stride byte offsets in
// 16-byte units, layout 1 = 128-byte swizzle.  A tile of rows by head
// elements is
// * K-major when the product's reduction runs over the head (Q.K^T: Q is
//   A, K is B, both with the head contiguous): 8-row groups 1024 bytes
//   apart (stride offset); the k-step of 16 elements is +32 bytes on the
//   start address, inside the swizzle atom;
// * MN-major when the reduction runs over the rows (P.V: V is B, the head
//   is its N axis and contiguous): "transpose B" (imm-trans-b = 1), the
//   k-step of 16 rows is +2048 bytes (two 8-row groups, 1024 apart: the
//   stride offset); the head's 64 elements are one swizzle atom wide, so
//   the leading offset (the next 64 columns) is never taken.
//
// Accumulators (m64nN, f32): thread t of the warpgroup holds, for n8 block
// j, d[4j], d[4j+1] at row 16*(t/32) + (t%32)/4, columns 8j + 2(t%4) + {0,1},
// and d[4j+2], d[4j+3] at the row 8 below.  A register A operand (m64k16)
// has mma.sync's m16n8k16 A layout within each warp's 16 rows, so the
// accumulator's n8 blocks 2k and 2k+1, rounded to bf16 and paired, are the
// A operand of k-step k: the probabilities never go through shared memory.

#pragma once

#include <cuda.h>  // CUtensorMap and the driver's enums; no -lcuda (below)
#include <atomic>

#include "common.cuh"

namespace msvit {
namespace hopper {

// ------------------------------------------------------------- mbarrier --

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` more of TMA traffic on this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed (a fresh barrier
// is in phase 0, so waiting on parity 1 passes at once).  A wait that
// spins 2^28 times (seconds; a tile arrives in microseconds) traps: a
// pipeline fault ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  uint32_t spins = 0;
  do {
    if (++spins == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------------ TMA --

// One box of a 3-D map into shared memory; completion (its bytes) is
// reported to `bar`.  c0 is the element column, c1 the row, c2 the image.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------- wgmma --

// Bytes of one [64 rows][64 bf16] swizzled tile.
constexpr int kTileBytes = 64 * 128;

__device__ __forceinline__ uint64_t desc(const void* tile) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |  // leading: 16 B (unused)
         (uint64_t{1024 >> 4} << 32) |                   // stride: 8-row groups
         (uint64_t{1} << 62);                            // 128-byte swizzle
}

// Descriptor offsets (16-byte units) of k-step kk: K-major +32 bytes,
// MN-major +2048 bytes.
__device__ __forceinline__ uint64_t kstep_k(int kk) { return 2u * kk; }
__device__ __forceinline__ uint64_t kstep_mn(int kk) { return 128u * kk; }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define MSVIT_D32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define MSVIT_R32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], both from shared memory,
// K-major (A's rows and B's columns hold the reduction contiguous);
// `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MSVIT_R32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : MSVIT_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64]: A from registers (bf16 pairs in
// the layout of the header note), B from shared memory MN-major (rows of
// the reduction, the 64 columns contiguous: "transpose B").
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MSVIT_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : MSVIT_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Keeps the compiler from moving an accumulator's registers across the
// asynchronous products that write them (CUTLASS's
// warpgroup_fence_operand).
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#undef MSVIT_D32
#undef MSVIT_R32

// The A operand of k-step kk (16 columns) from an m64n64 accumulator,
// rounded to bf16 (nearest even).
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[32],
                                         int kk) {
  a[0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
  a[1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
  a[2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
  a[3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
}

// The mask's entries of one 64-key tile in the accumulator's layout (bool:
// 1 = attend; 0 outside the image), read while the tile's product runs.
__device__ __forceinline__ void load_mask_tile(float (&mv)[32], int mask_kind,
                                               const void* mask, long long moff,
                                               const int (&irow)[2], int kv0, int n,
                                               int tq) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = kv0 + j * 8 + 2 * tq + (e & 1);
      const int i = irow[e >> 1];
      const long long at = moff + static_cast<long long>(i) * n + col;
      mv[4 * j + e] = !(col < n && i < n) ? 0.f
                      : mask_kind == kBoolMask
                          ? (static_cast<const uint8_t*>(mask)[at] ? 1.f : 0.f)
                          : static_cast<const float*>(mask)[at];
    }
  }
}

// 2^x on the special-function unit, a result below 2^-126 flushed to 0 (it
// weighs nothing in a bf16 P.V or an f32 row sum): the one instruction of
// exp2f without its denormal range.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------- warp specialisation --

// Register budget of the two roles (a block of two consumer warpgroups and
// one producer warpgroup, one block per SM): 128 x 40 + 256 x 232 = 64,512
// of the SM's 65,536.
constexpr int kThreads = 384;
constexpr int kConsumerThreads = 256;
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// A barrier of the 256 consumer threads only (id 1; 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

// The dynamic shared memory rounded up to a 1024-byte boundary (the
// launch asks for 1 KB more).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// ------------------------------------------------------------ host side --

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that
// the library links no libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a packed bf16 tensor [B, N, W] (qkv: W = 3D; g: W = D): dims
// (W, N, B), pitches W*2 and N*W*2 bytes, box (64, 64, 1) = one head's
// columns of 64 rows, 128-byte swizzle.  A box past row N is zero-filled
// inside its own image: the bound of dim 1 is N.  TMA takes a base on 16
// bytes and pitches in multiples of 16 bytes: anything else is refused
// (cudaErrorInvalidValue), never read another way.
inline cudaError_t map_rows(CUtensorMap* map, const void* base, int b, int n,
                            long long w) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const long long pitch = w * 2;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || pitch % 16 != 0)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(pitch),
                                 static_cast<cuuint64_t>(pitch) * n};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(base), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// cudaFuncSetAttribute(kernel, max dynamic shared memory, bytes) once per
// device and kernel (`done` is the kernel's own bit set).
template <typename Kernel>
cudaError_t allow_smem_once(Kernel kernel, int bytes,
                            std::atomic<unsigned long long>& done) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (device & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace hopper
}  // namespace msvit
