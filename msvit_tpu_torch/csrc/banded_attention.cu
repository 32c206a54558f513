// Cluster-banded multistate attention, the token rows (bf16 / f32): K10.
//
// Replaces the TPU kernel `msvit_tpu/ops/banded_attention.py::
// _token_rows_banded` (body `_banded_kernel`, its pallas_call).  The
// multistate trunk's mask has block structure: with the patch tokens sorted
// by cluster id, a token attends the tokens of its own cluster (a contiguous
// run of the sorted axis) and one key off the band, its cluster's RX token
// (prefix row 2 * cid + 1).  No [S, S] mask exists anywhere.
//
// Operands: qkv [B, 2C + N, 3D], rows [2C prefix (TX_c at 2c, RX_c at
// 2c + 1) ++ N sorted tokens], the q third pre-scaled by the caller, read
// through its image and row strides in elements (each row's 3D elements
// contiguous, 16-byte aligned rows); cid [B, N] int32, ascending per image;
// band [B, 2, nQB] int32, for row block qb (64 sorted tokens) the inclusive
// range [kmin, kmax] of 64-key tiles that holds the tokens of clusters
// cid[first row] .. cid[last row] (`ops/banded_attention.py::band_limits`,
// torch searchsorted); out [B, N, D] contiguous, the token rows' attention
// output.  The prefix rows are plain torch (the JAX package leaves them to
// XLA).
//
// Per row: only the key tiles of the band, with a segment-id compare (a
// key of another cluster weighs exactly 0, as the TPU's `where`), then the
// one RX key.  The softmax is the packed kernels' shaved one:
// p = exp(clip(s, -80, 80)) with no row max and no rescale, so the band's
// contributions are a plain sum, and o = P.V / max(l, 1e-30).  Rounding in
// the TPU kernel's order: p is rounded to the compute dtype, and both l and
// P.V sum that rounded p (its pb . ones and pp . ones dots);
// `_token_rows_xla`, the JAX VJP's oracle, sums the unrounded p into l.
// The plain version follows the TPU kernel.
//
// What bounds it on the card: the products of each token with the tokens of
// its own cluster, 4 * sum_c n_c^2 * dh FLOP per head (N^2 for one cluster,
// the layers before the first clustering event: 242 GFLOP at
// [8, 32+3136, 2304], 0.2445 ms at the bf16 peak), against the qkv bytes
// (read once) and the output: operations.
//
// bf16, on the tensor cores (banded_mma_kernel): K1's tiles
// (packed_attention.cu) on the band.  Warp-level mma.sync m16n8k16 (bf16
// operands, f32 accumulators); a block of 4 warps takes 64 sorted token
// rows (16 a warp) of one (head, image), q fragments loaded once (read
// from shared memory at each use at dh 128).  The band's 64-key k/v tiles
// and their 64 key cluster ids stream through a two-stage ring in dynamic
// shared memory filled by cp.async, the next tile in flight while this one
// is multiplied; after the band come the C RX rows (prefix rows 2c + 1) as
// one more key tile per 64 clusters whose key c carries cluster id c, so
// that the same masked path gives each row exactly its own RX key.  Per
// tile: S = Q.K^T, then in registers p = 0 where the key's cluster id is
// not the row's (or the key lies past the band, past N or past C: an id
// no row has), else exp2(clip(s * log2e, +-80 * log2e)), rounded to bf16
// and packed once into P.V's A fragments (c_to_a's layout); the row sum l
// of that rounded p rides the tensor cores as one more product with a
// column of ones (kOnes2), as in K1.  Skipping work: ids ascend along both
// axes, so a warp's 16 rows span the clusters [id(first row), id(last
// row)] and a 16-key block [id(first key), id(last key)]; a warp skips the
// S and P.V products (and the exp) of every 16-key block whose range is
// disjoint from its own, which is what makes a many-cluster partition
// cheaper than the dense path; a warp whose rows all lie past N only helps
// copy.  Shared rows are padded by 16 bytes (ldmatrix rows in distinct
// banks); head sizes 8/24/40/72.. are zero-padded in shared memory to their
// bucket (16/32/64/128), zeroed once a block; at dh 128 the tiles take
// ~87 KB of dynamic shared memory (cudaFuncSetAttribute).  wgmma with TMA
// is the later step.
//
// f32 (banded_kernel): one thread per sorted query row on the CUDA cores in
// f32 FMAs (TF32 would break the f32 bars), q and its accumulator in
// registers; the block stages only its band's k/v tiles (coalesced 16-byte
// loads, read by all rows as broadcasts) and their cluster ids in shared
// memory; a row skips every key of another cluster before any product.
//
// The TPU kernel's structure (dense score rows over 1024-key chunks with
// only the exp chain predicated, the head-pair lane blocks) does not carry
// over.

#include "common.cuh"

namespace msvit {
namespace {

constexpr int kBandKeys = 64;  // keys per tile of the band table

// One block = (64 sorted token rows, head, image); one thread = one row.
template <typename T, int DHT>
__global__ void __launch_bounds__(kRows)
banded_kernel(const T* __restrict__ qkv, const int* __restrict__ cid,
              const int* __restrict__ band, T* __restrict__ out, long long sb,
              long long sn, int n, int pfx, int h_count, int dh) {
  constexpr int KV = kv_rows<T, DHT>();
  __shared__ __align__(16) T ks[KV * DHT];
  __shared__ __align__(16) T vs[KV * DHT];
  __shared__ int cs[KV];
  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nqb = gridDim.x;
  const int i = qb * kRows + threadIdx.x;
  const bool active = i < n;
  const int d = h_count * dh;
  const T* img = qkv + b * sb;
  const int* cimg = cid + static_cast<long long>(b) * n;

  float qr[DHT];
  float acc[DHT];
#pragma unroll
  for (int e = 0; e < DHT; ++e) {
    qr[e] = 0.f;
    acc[e] = 0.f;
  }
  int cq = -1;
  if (active) {
    const T* qrow = img + (pfx + i) * sn + h * dh;
#pragma unroll
    for (int e = 0; e < DHT; e += 8)
      if (e < dh) Vec8<T>::load(qrow + e, qr + e);
    cq = cimg[i];
  }
  auto score = [&](const T* kr) {
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
    return s;
  };
  float l = 0.f;
  auto take = [&](float s, const T* vr) {
    // the shaved softmax, p rounded to the compute dtype for l and P.V
    const float p = round_to<T>(expf(fminf(fmaxf(s, -80.f), 80.f)));
    l += p;
#pragma unroll
    for (int e = 0; e < DHT; e += 8) {
      if (e < dh) {
        float vf[8];
        Vec8<T>::load(vr + e, vf);
#pragma unroll
        for (int t = 0; t < 8; ++t) acc[e + t] = fmaf(p, vf[t], acc[e + t]);
      }
    }
  };

  // the band: key tokens [kmin * 64, min((kmax + 1) * 64, N))
  const int* bimg = band + static_cast<long long>(b) * 2 * nqb;
  const int k0 = bimg[qb] * kBandKeys;
  const int k1 = min((bimg[nqb + qb] + 1) * kBandKeys, n);
  const char* tok = reinterpret_cast<const char*>(img + pfx * sn);
  const long long row = sn * static_cast<long long>(sizeof(T));
  const int width = dh * static_cast<int>(sizeof(T));
  for (int kv0 = k0; kv0 < k1; kv0 += KV) {
    __syncthreads();  // the previous tile is consumed
    stage_tile<uint4>(reinterpret_cast<char*>(ks), tok, row,
                      static_cast<long long>(d + h * dh) * sizeof(T), width,
                      kv0, KV, k1);
    stage_tile<uint4>(reinterpret_cast<char*>(vs), tok, row,
                      static_cast<long long>(2 * d + h * dh) * sizeof(T),
                      width, kv0, KV, k1);
    for (int j = threadIdx.x; j < KV; j += blockDim.x)
      cs[j] = kv0 + j < k1 ? cimg[kv0 + j] : -1;
    __syncthreads();
    if (!active) continue;
    const int cnt = min(KV, k1 - kv0);
    for (int j = 0; j < cnt; ++j) {
      if (cs[j] != cq) continue;  // another cluster: outside the mask
      take(score(ks + j * dh), vs + j * dh);
    }
  }
  if (!active) return;
  // the one off-band key: this cluster's RX token, prefix row 2 * cid + 1
  const T* rx = img + (2 * cq + 1) * sn;
  take(score(rx + d + h * dh), rx + 2 * d + h * dh);

  T* o = out + (static_cast<long long>(b) * n + i) * d + h * dh;
  const float l_div = fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < DHT; e += 8) {
    if (e < dh) {
      float r[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) r[t] = acc[e + t] / l_div;
      Vec8<T>::store(o + e, r);
    }
  }
}

template <typename T, int DHT>
void launch(const void* qkv, const int* cid, const int* band, void* out,
            long long sb, long long sn, int b, int n, int pfx, int h, int dh,
            cudaStream_t stream) {
  const dim3 grid((n + kRows - 1) / kRows, h, b);
  banded_kernel<T, DHT><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(qkv), cid, band, static_cast<T*>(out), sb, sn, n,
      pfx, h, dh);
}

// A key id that no row has: keys past the band, past N or past C.
constexpr int kNoKey = 0x7fffffff;

// The 16-key blocks of a 64-key tile that may hold keys of the warp's
// clusters [wlo, whi], as bits: key ids ascend within a tile (kNoKey last).
__device__ __forceinline__ unsigned live_blocks(const int* cs, int wlo, int whi) {
  unsigned live = 0;
#pragma unroll
  for (int s = 0; s < kMmaTile / 16; ++s)
    if (cs[16 * s + 15] >= wlo && cs[16 * s] <= whi) live |= 1u << s;
  return live;
}

// One block = (64 sorted token rows, head, image), 4 warps of 16 rows; bf16
// only.  Tiles 0 .. band_tiles - 1 are the band's, the rest the RX rows'.
template <int DHT>
__global__ void __launch_bounds__(kMmaThreads)
banded_mma_kernel(const bf16* __restrict__ qkv, const int* __restrict__ cid,
                  const int* __restrict__ band, bf16* __restrict__ out,
                  long long sb, long long sn, int n, int pfx, int h_count,
                  int dh) {
  static_assert(kBandKeys == kMmaTile && kRows == kMmaRows,
                "the band table's blocks are the kernel's tiles");
  constexpr int LD = mma_ld<DHT>();
  constexpr int KT = kMmaTile;  // keys per staged tile
  constexpr int NT = KT / 8;    // score n-tiles per tile
  constexpr int OT = DHT / 8;   // output n-tiles
  constexpr float kClip = 80.f * kLog2e;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);                 // [64][LD]
  bf16* ring = qs + kMmaRows * LD;                          // [2][k, v][KT][LD]
  int* cring = reinterpret_cast<int*>(ring + 4 * KT * LD);  // [2][KT] key ids
  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nqb = gridDim.x;
  const int row0 = qb * kMmaRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  const int d = h_count * dh;
  const int clusters = pfx / 2;
  const bf16* img = qkv + b * sb;
  const bf16* tok = img + pfx * sn;
  const int* cimg = cid + static_cast<long long>(b) * n;

  if (dh < DHT) {  // pad columns of every head tile: zero once
    zero_smem(smem, (kMmaRows + 4 * KT) * LD * static_cast<int>(sizeof(bf16)));
    __syncthreads();
  }
  // the band: key tokens [k0, k1), tile-aligned at k0
  const int* bimg = band + static_cast<long long>(b) * 2 * nqb;
  const int k0 = bimg[qb] * KT;
  const int k1 = min((bimg[nqb + qb] + 1) * KT, n);
  const int band_tiles = (k1 - k0 + KT - 1) / KT;
  const int tiles = band_tiles + (clusters + KT - 1) / KT;
  auto load_tile = [&](int t) {
    bf16* ks = ring + (t & 1) * 2 * KT * LD;
    int* cs = cring + (t & 1) * KT;
    if (t < band_tiles) {
      const int kv0 = k0 + t * KT;
      async_tile<LD>(ks, tok + d + h * dh, sn, kv0, KT, k1, dh);
      async_tile<LD>(ks + KT * LD, tok + 2 * d + h * dh, sn, kv0, KT, k1, dh);
      for (int j = threadIdx.x; j < KT; j += blockDim.x) {
        if (kv0 + j < k1) {
          cp_async4(cs + j, cimg + kv0 + j, true);
        } else {
          cs[j] = kNoKey;
        }
      }
    } else {
      // RX_c = prefix row 2c + 1: rows c0.. of the view at row 1, stride 2
      const int c0 = (t - band_tiles) * KT;
      async_tile<LD>(ks, img + sn + d + h * dh, 2 * sn, c0, KT, clusters, dh);
      async_tile<LD>(ks + KT * LD, img + sn + 2 * d + h * dh, 2 * sn, c0, KT,
                     clusters, dh);
      for (int j = threadIdx.x; j < KT; j += blockDim.x)
        cs[j] = c0 + j < clusters ? c0 + j : kNoKey;
    }
  };
  async_tile<LD>(qs, tok + h * dh, sn, row0, kMmaRows, n, dh);
  load_tile(0);
  cp_async_commit();

  // this thread's two accumulator rows (g and g + 8 of the warp's 16) and
  // their cluster ids; the warp's cluster range
  const int i_lo = row0 + warp * 16 + gq;
  const int irow[2] = {i_lo, i_lo + 8};
  int rc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) rc[r] = irow[r] < n ? cimg[irow[r]] : -1;
  const int w0 = row0 + warp * 16;
  // a warp whose 16 rows all lie past n (the last row block) only helps to
  // copy the tiles
  const bool idle = w0 >= n;
  const int wlo = idle ? 0 : cimg[w0];
  const int whi = idle ? -1 : cimg[min(w0 + 15, n - 1)];

  Resident<DHT> qf;
  float o[OT][4];
  zero_acc(o);
  float l[4] = {0.f, 0.f, 0.f, 0.f};  // row sums: l[0] row g, l[2] row g + 8

  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) load_tile(t + 1);  // its stage was freed at t - 1's end
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and q) has landed for this thread
    __syncthreads();     // ... and for every thread
    const bf16* ks = ring + (t & 1) * 2 * KT * LD;
    const bf16* vs = ks + KT * LD;
    const int* cs = cring + (t & 1) * KT;
    if (!idle) {
      if (t == 0) qf.load(qs + warp * 16 * LD, lane);
      const unsigned live = live_blocks(cs, wlo, whi);  // warp-uniform
      if (live != 0) {
        // S = Q.K^T over the live 16-key blocks
        float s[NT][4];
        zero_acc(s);
#pragma unroll
        for (int kk = 0; kk < DHT / 16; ++kk) {
          uint32_t af[4];
          qf.get(af, kk, lane);
#pragma unroll
          for (int np = 0; np < KT / 16; ++np) {
            if (!(live >> np & 1u)) continue;
            uint32_t bf[4];
            bt_frag<LD>(bf, ks, np, kk, lane);
            mma_bf16(s[2 * np], af, bf[0], bf[1]);
            mma_bf16(s[2 * np + 1], af, bf[2], bf[3]);
          }
        }
        // p: 0 off the row's cluster, else the shaved exp, rounded to bf16
        // once into P.V's A fragments
        uint32_t pa[NT / 2][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (!(live >> (j / 2) & 1u)) continue;
          const int2 kc = *reinterpret_cast<const int2*>(cs + j * 8 + 2 * tq);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float p[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int key = u == 0 ? kc.x : kc.y;
              const float x = fminf(fmaxf(s[j][2 * r + u] * kLog2e, -kClip), kClip);
              p[u] = key == rc[r] ? exp2f(x) : 0.f;
            }
            pa[j / 2][(j & 1) * 2 + r] = pack_bf16(p[0], p[1]);
          }
        }
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
          if (!(live >> kk & 1u)) continue;
          pv_step<DHT>(o, pa[kk], vs, kk, lane);  // O += P.V
          mma_bf16(l, pa[kk], kOnes2, kOnes2);    // l += the rounded p's row sums
        }
      }
    }
    __syncthreads();  // this stage is consumed: t + 1 may refill it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = irow[r];
    if (i >= n) continue;  // (every row of an idle warp)
    const float lr = fmaxf(l[2 * r], 1e-30f);
    bf16* orow = out + (static_cast<long long>(b) * n + i) * d + h * dh;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int col = j * 8 + 2 * tq;
      if (col < dh)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(o[j][2 * r] / lr, o[j][2 * r + 1] / lr);
    }
  }
}

template <int DHT>
__host__ __device__ constexpr int mma_smem_bytes() {
  // q, the k/v ring, the key ids of each ring stage
  return (kMmaRows + 4 * kMmaTile) * mma_ld<DHT>() * 2 + 2 * kMmaTile * 4;
}

template <int DHT>
cudaError_t launch_mma(const void* qkv, const int* cid, const int* band,
                       void* out, long long sb, long long sn, int b, int n,
                       int pfx, int h, int dh, cudaStream_t stream) {
  constexpr int bytes = mma_smem_bytes<DHT>();
  const cudaError_t err = cudaFuncSetAttribute(
      banded_mma_kernel<DHT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kMmaRows - 1) / kMmaRows, h, b);
  banded_mma_kernel<DHT><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const bf16*>(qkv), cid, band, static_cast<bf16*>(out), sb,
      sn, n, pfx, h, dh);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* qkv, const int* cid, const int* band,
                         void* out, long long sb, long long sn, int b, int n,
                         int pfx, int h, int dh, cudaStream_t stream) {
  if (dh <= 16) return launch_mma<16>(qkv, cid, band, out, sb, sn, b, n, pfx, h, dh, stream);
  if (dh <= 32) return launch_mma<32>(qkv, cid, band, out, sb, sn, b, n, pfx, h, dh, stream);
  if (dh <= 64) return launch_mma<64>(qkv, cid, band, out, sb, sn, b, n, pfx, h, dh, stream);
  return launch_mma<128>(qkv, cid, band, out, sb, sn, b, n, pfx, h, dh, stream);
}

template <typename T>
void dispatch(const void* qkv, const int* cid, const int* band, void* out,
              long long sb, long long sn, int b, int n, int pfx, int h, int dh,
              cudaStream_t stream) {
  if (dh <= 16) {
    launch<T, 16>(qkv, cid, band, out, sb, sn, b, n, pfx, h, dh, stream);
  } else if (dh <= 32) {
    launch<T, 32>(qkv, cid, band, out, sb, sn, b, n, pfx, h, dh, stream);
  } else if (dh <= 64) {
    launch<T, 64>(qkv, cid, band, out, sb, sn, b, n, pfx, h, dh, stream);
  } else {
    launch<T, 128>(qkv, cid, band, out, sb, sn, b, n, pfx, h, dh, stream);
  }
}

}  // namespace
}  // namespace msvit

extern "C" {

// K10.  qkv: [B, pfx + N, 3*h*dh] of dtype (0 = float32 on the CUDA cores,
// 1 = bfloat16 on the tensor cores), image
// and row strides sb, sn in elements; cid: int32 [B, N] (values in
// [0, pfx / 2), ascending per image); band: int32 [B, 2, ceil(N / 64)] (the
// 64-key tiles kmin, kmax of each 64-row block); out: [B, N, h*dh]
// contiguous.  Returns cudaGetLastError() after the launch.
int msvit_banded_attention(const void* qkv, const void* cid, const void* band,
                           void* out, int dtype, int b, int n, int pfx, int h,
                           int dh, long long sb, long long sn, void* stream) {
  if (dh <= 0 || dh > 128 || dh % 8 != 0 || n <= 0 || b <= 0 || h <= 0 ||
      pfx < 2 || pfx % 2 != 0 || b > 65535 || h > 65535 || cid == nullptr ||
      band == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cid);
  const int* bd = static_cast<const int*>(band);
  if (dtype == 0) {
    msvit::dispatch<float>(qkv, c, bd, out, sb, sn, b, n, pfx, h, dh, s);
  } else if (dtype == 1) {
    return static_cast<int>(
        msvit::dispatch_mma(qkv, c, bd, out, sb, sn, b, n, pfx, h, dh, s));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
