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
// bf16 at head size 64 (banded_wgmma_kernel, below): K1's Hopper kernel
// (`attention_wgmma.cuh`) on the band, wgmma fed by TMA, warp-specialised and
// persistent; 4-D maps over the packed qkv's token rows and a second pair
// over its RX rows, items of 128 rows whose two 64-row blocks share one
// load of the union of their bands, each warpgroup multiplying only its
// own block's 64-key tiles, the key ids loaded one tile ahead straight
// into the accumulator's layout (its note below says how and why).  It skips
// whole 64-key tiles; the mma.sync kernel below skips 16-key blocks.  That
// kernel took 2.17-2.35 ms through the wrapper at one cluster
// ([8, 32+3136, 2304]) and 0.87-0.96 ms at 9 clusters, against SDPA's
// 1.07-1.13 ms over the equivalent mask (NVIDIA H100 80GB HBM3, 700 W).
//
// Other bf16 head sizes, on the tensor cores (banded_mma_kernel): K1's
// tiles (packed_attention.cu) on the band.  Warp-level mma.sync m16n8k16 (bf16
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
// ~87 KB of dynamic shared memory (cudaFuncSetAttribute).
//
// The route is the entry point's: bf16 at dh 64 takes the wgmma kernel,
// other bf16 head sizes the mma.sync kernel, f32 the CUDA cores; there is
// no fallback between them (a qkv TMA cannot map is refused).
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

#include "attention_wgmma.cuh"

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

// ------------------------------------------------- bf16 on wgmma (dh 64) --
//
// K1's pipeline and shaved softmax (`attention_wgmma.cuh`) on a walk of its
// own.  It is a sibling of attention_wgmma_kernel rather than one more
// instantiation of it because its walk and its mask touch every part of
// the dense kernel's item loop: the tiles an item loads come from a band
// table read on the card, each consumer warpgroup multiplies a sub-range
// of them and skips the rest, the last tiles come from two other maps, and
// the mask is a key range per row.  Folding that into the dense kernel
// would put a branch on the band into K1's, K4's, K5's and K7's inner
// loop.
//
// Operands.  q, k and v are K1's 4-D maps over the packed qkv
// [B, 2C + N, 3D] at element offsets 0, D and 2D, starting at the first
// token row (pfx = 2C): [B, H, N, 64] views, row pitch 3D*2 bytes, zero
// past N.  The RX keys and values are a second pair of maps over the
// prefix rows 1, 3, .., 2C - 1 (RX_c at row 2c + 1): [B, H, C, 64] views,
// row pitch 2 * 3D * 2 bytes, zero past C; each 64 clusters are one more
// key tile.  The q third is pre-scaled by the caller: x = s * log2e.
//
// The walk.  An item is 128 token rows of one (head, image), the two
// 64-row blocks qb0 = 2 qt and qb1 = 2 qt + 1 of the band table
// ([B, 2, ceil(N / 64)]: the first and last 64-key tile holding the keys
// of each block's clusters).  Ids ascend, so the two bands' union is the
// one range [kmin(qb0), kmax(qb1)]: the producer loads its tiles, then
// the RX tiles, through the ring.  Each consumer warpgroup multiplies only
// the tiles of its own block's band, then the RX tiles; a tile of the
// union outside its band it skips: it waits for the tile to land (so that
// its arrival counts toward the right phase) and arrives on the stage's
// empty barrier.  So it multiplies runs of consecutive tiles (its band,
// then the RX tiles; one run where its band ends the union), each in the
// dense kernel's pipeline and with every product waited for inside the
// run: no P.V is in flight across a skip (the producer may need the very
// stage it holds for the tile the skip waits on), and no accumulator is in
// flight across the branches between runs (ptxas would serialize every
// wgmma of the kernel).  A warpgroup whose 64 rows all lie past N
// multiplies nothing and skips every tile.  wgmma skips whole 64-key
// tiles where the mma.sync kernel skipped 16-key blocks: a tile at a
// cluster's edge is multiplied whole.
//
// The segment compare.  Ids ascend, so a row's cluster is one range of
// keys [kl, kh): each thread finds its two rows' ranges once an item by
// binary search in `cid` [B, N] int32 within its block's band (the four
// searches spread over the lanes of a quad).  A band tile inside both
// ranges of every thread of a warp takes K1's softmax with no compare;
// any other tile, and every RX tile (key c of the row's cluster where
// c == its id), two integer compares a score: p = 0 outside the range
// (also past N and past C).  A row past N has an empty range.  Loading
// the key ids into the accumulator's layout a tile ahead, as
// `attn_mask_tile` loads mask entries, and comparing each score's took
// 1.20-1.22 ms alone at one cluster ([8, 32+3136, 2304]) where K1 takes 0.67
// at the same 3136 keys (NVIDIA H100 80GB HBM3, 700 W).
//
// The softmax is K1's (kShaved): p = 2^clip(x, +-80 log2e), rounded to
// bf16 into P.V, l summed from the rounded p.  The output is
// o / max(l, 1e-30), written to out [B, N, D] at column h * 64; rows past
// N are never written.

struct BandedMaps {
  CUtensorMap q, k, v;  // the token rows: [B, H, N, 64] views
  CUtensorMap rk, rv;   // the RX rows: [B, H, C, 64] views
};

struct BandedArgs {
  const int* cid;   // [B, N], ascending per image
  const int* band;  // [B, 2, ceil(N / 64)]: kmin, kmax of each 64-row block
  bf16* out;        // [B, N, H * 64]
  int b, h, n, c;   // images, heads, token rows, clusters
};

// The first index in [lo, hi) of the ascending `ids` whose id is above
// `id` (RIGHT) or not below it (else); hi where there is none.
template <bool RIGHT>
__device__ __forceinline__ int search(const int* ids, int lo, int hi, int id) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int v = ids[mid];
    if (RIGHT ? v <= id : v < id)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// K1's shaved softmax (`shaved_tile`, kShaved) on one 64-key tile of K10,
// keys kv0.. : x = s * log2e (q is pre-scaled), p = 2^clip(x, +-80 log2e)
// rounded to bf16 in place of the scores, l summed from the rounded p.
// Unless FULL (every key of the tile in both rows' ranges), a key outside
// its row's range [kl[r], kh[r]) weighs 0, never e^-80.
template <bool FULL>
__device__ __forceinline__ void banded_tile(float (&sc)[32], int kv0, const int (&kl)[2],
                                            const int (&kh)[2], int tq, float (&l)[2]) {
  constexpr float kClip = 80.f * kLog2e;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float p[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = 4 * j + 2 * r + u;
        const int key = kv0 + j * 8 + 2 * tq + u;
        p[u] = hopper::ex2(fminf(fmaxf(sc[e] * kLog2e, -kClip), kClip));
        if (!FULL && (key < kl[r] || key >= kh[r])) p[u] = 0.f;  // another cluster
      }
      const uint32_t pr = pack_bf16(p[0], p[1]);  // lo: the lower key
      const float lo = __uint_as_float(pr << 16);
      const float hi = __uint_as_float(pr & 0xffff0000u);
      l[r] += lo + hi;  // the rounded p
      sc[4 * j + 2 * r] = lo;
      sc[4 * j + 2 * r + 1] = hi;
    }
  }
}

// A persistent block: one an SM, walking the items (head, 128 token rows,
// image) in the order of the head fastest, then the row tile, then the
// image, as attention_wgmma_kernel; bf16, head size 64.
__global__ void __launch_bounds__(hopper::kThreads, 1)
banded_wgmma_kernel(const __grid_constant__ BandedMaps maps, const BandedArgs a) {
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
  const int nqb = (a.n + 63) / 64;  // the band table's row blocks
  const int qtiles = (a.n + kAttnRows - 1) / kAttnRows;
  const int items = a.h * qtiles * a.b;
  const int rx_tiles = (a.c + 63) / 64;
  // the band table's entry e (0: kmin, 1: kmax) of row block qb of image b
  auto band_at = [&](int b, int e, int qb) {
    return a.band[(static_cast<long long>(b) * 2 + e) * nqb + qb];
  };

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

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == 2) {  // the producer: one thread issues every copy
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 256) {
      int g = 0;  // the block's tile count
      for (int w = blockIdx.x, i = 0; w < items; w += gridDim.x, ++i) {
        const int h = w % a.h;
        const int qt = (w / a.h) % qtiles;
        const int b = w / (a.h * qtiles);
        const int lo = band_at(b, 0, 2 * qt);
        const int nb = band_at(b, 1, min(2 * qt + 1, nqb - 1)) - lo + 1;
        if (i > 0) mbar_wait(qempty, (i - 1) & 1);  // the last item's S are issued
        mbar_expect_tx(qfull, 2 * kTileBytes);
        tma_load_4d(qs, &maps.q, qfull, 0, qt * kAttnRows, h, b);
        tma_load_4d(qs + 64 * 64, &maps.q, qfull, 0, qt * kAttnRows + 64, h, b);
        for (int t = 0; t < nb + rx_tiles; ++t, ++g) {
          const int s = g % kAttnStages;
          const bool rx = t >= nb;
          const int row = rx ? (t - nb) * 64 : (lo + t) * 64;
          mbar_wait(empty + s, ((g / kAttnStages) & 1) ^ 1);
          mbar_expect_tx(kfull + s, kTileBytes);
          tma_load_4d(ks + s * 64 * 64, rx ? &maps.rk : &maps.k, kfull + s, 0, row, h, b);
          mbar_expect_tx(vfull + s, kTileBytes);
          tma_load_4d(vs + s * 64 * 64, rx ? &maps.rv : &maps.v, vfull + s, 0, row, h, b);
        }
      }
    }
    return;
  }

  reg_alloc<kConsumerRegs>();
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x / 32) % 4;
  const int tq = lane % 4;
  const uint64_t dq = desc(qs + wg * 64 * 64);
  int g = 0;  // the block's tile count, as the producer's

  // a band entry broadcast from lane 0: provably uniform across the warp,
  // as the runs' bounds and branches around the products must be
  auto uniform_band = [&](int b, int e, int qb) {
    return __shfl_sync(0xffffffffu, band_at(b, e, qb), 0);
  };

  for (int w = blockIdx.x, item = 0; w < items; w += gridDim.x, ++item) {
    const int h = w % a.h;
    const int qt = (w / a.h) % qtiles;
    const int b = w / (a.h * qtiles);
    const int lo = uniform_band(b, 0, 2 * qt);
    const int nb = uniform_band(b, 1, min(2 * qt + 1, nqb - 1)) - lo + 1;
    const int tiles = nb + rx_tiles;
    // this warpgroup's row block, its band in the item's tiles
    // [own0, own0 + own)
    const int qb = 2 * qt + wg;
    const bool rows = qb < nqb;
    const int own0 = rows ? uniform_band(b, 0, qb) - lo : 0;
    const int own = rows ? uniform_band(b, 1, qb) - lo - own0 + 1 : 0;
    const int* cimg = a.cid + static_cast<long long>(b) * a.n;
    // this thread's two accumulator rows and their cluster ids (past N: -2,
    // which no RX key has)
    const int i_lo = qt * kAttnRows + wg * 64 + warp * 16 + lane / 4;
    const int irow[2] = {i_lo, i_lo + 8};
    int rid[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) rid[r] = irow[r] < a.n ? cimg[irow[r]] : -2;
    // each row's cluster as its range of keys [kl, kh) (ids ascend), found
    // within the block's band: lane tq of a quad searches bound tq & 1 of
    // row tq >> 1, and the quad shares the four.  A row past N has none
    int kl[2] = {0, 0}, kh[2] = {0, 0};
    if (rows) {
      const int band_lo = (lo + own0) * 64;
      const int band_hi = min((lo + own0 + own) * 64, a.n);
      const int r = tq >> 1;
      int bound = 0;
      if (irow[r] < a.n)
        bound = tq & 1 ? search<true>(cimg, irow[r] + 1, band_hi, rid[r])
                       : search<false>(cimg, band_lo, irow[r], rid[r]);
      const int quad = lane & ~3;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        kl[q] = __shfl_sync(0xffffffffu, bound, quad + 2 * q);
        kh[q] = __shfl_sync(0xffffffffu, bound, quad + 2 * q + 1);
      }
    }
    // on an RX tile key c is of row r's cluster where c == rid[r]
    const int rl[2] = {rid[0], rid[1]};
    const int rh[2] = {rid[0] + 1, rid[1] + 1};

    float o[32], sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      o[e] = 0.f;
      sc[e] = 0.f;
    }
    float l[2] = {0.f, 0.f};  // this lane's part of the row sums
    uint32_t pa[4][4];        // p of the previous tile: the A operand of 4 k-steps
    // the softmax of the item's tile t on its scores: a band tile inside
    // both rows' ranges of every thread of the warp takes no compare
    auto softmax = [&](int t) {
      if (t < nb) {
        const int kv0 = (lo + t) * 64;
        const bool full = kl[0] <= kv0 && kv0 + 64 <= kh[0] && kl[1] <= kv0 &&
                          kv0 + 64 <= kh[1];
        if (__all_sync(0xffffffffu, full))
          banded_tile<true>(sc, kv0, kl, kh, tq, l);
        else
          banded_tile<false>(sc, kv0, kl, kh, tq, l);
      } else {
        banded_tile<false>(sc, (t - nb) * 64, rl, rh, tq, l);
      }
    };
    // a tile of the item this warpgroup does not multiply: landed, then freed
    auto skip = [&](int t) {
      const int gt = g + t;
      mbar_wait(kfull + gt % kAttnStages, (gt / kAttnStages) & 1);
      if (lane == 0) mbar_arrive(empty + gt % kAttnStages);
    };
    // a run of n consecutive tiles from t0, in attention_wgmma_kernel's
    // pipeline: S of a tile beside P.V of the one before, every product
    // waited for inside the run (so that no accumulator is in flight across
    // the branches between runs); `last`: the item's last tile ends it, and
    // Q is freed once its S is done
    auto run = [&](int t0, int n, bool last) {
      int gt = g + t0;
      mbar_wait(kfull + gt % kAttnStages, (gt / kAttnStages) & 1);
      fence_acc(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(sc, dq + kstep_k(kk), desc(ks + gt % kAttnStages * 64 * 64) + kstep_k(kk),
                 kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      if (last && n == 1 && lane == 0) mbar_arrive(qempty);
      softmax(t0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(pa[kk], sc, kk);
      for (int i = 1; i < n; ++i) {
        gt = g + t0 + i;
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
        wgmma_wait<1>();  // S of this tile
        fence_acc(sc);
        if (last && i == n - 1 && lane == 0) mbar_arrive(qempty);
        softmax(t0 + i);
        wgmma_wait<0>();  // P.V of the tile before
        fence_acc(o);
        if (lane == 0) mbar_arrive(empty + sp);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc_to_a(pa[kk], sc, kk);
      }
      // P.V of the run's last tile, then its stage is free
      gt = g + t0 + n - 1;
      const int sl = gt % kAttnStages;
      mbar_wait(vfull + sl, (gt / kAttnStages) & 1);
      fence_acc(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_t(o, pa[kk], desc(vs + sl * 64 * 64) + kstep_mn(kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(o);
      if (lane == 0) mbar_arrive(empty + sl);
    };

    // its runs: its band, then the RX tiles (one run where its band ends the
    // union's); the tiles between them skipped.  Before a skip no P.V is in
    // flight: the producer may need the very stage it holds for the tile
    // the skip waits on
    const bool joined = own0 + own == nb;
    const int runs = rows ? (joined ? 1 : 2) : 0;
    int next = 0;  // the item's first tile neither multiplied nor skipped yet
    if (rows) mbar_wait(qfull, item & 1);
    for (int r = 0; r < runs; ++r) {
      const int t0 = r == 0 ? own0 : nb;
      const int n = r == 0 ? (joined ? own + rx_tiles : own) : rx_tiles;
      while (next < t0) skip(next++);
      run(t0, n, r == runs - 1);
      next = t0 + n;
    }
    while (next < tiles) skip(next++);  // (only where it has no rows)
    // a warpgroup without rows frees Q once the item's last tile has landed
    if (!rows && lane == 0) mbar_arrive(qempty);
    g += tiles;

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = fmaxf(row_sum<4>(l[r]), 1e-30f);
      const int i = irow[r];
      if (i >= a.n) continue;
      bf16* orow = a.out + (static_cast<long long>(b) * a.n + i) * (a.h * 64) + h * 64;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * tq) =
            pack_bf16(o[4 * j + 2 * r] / lr, o[4 * j + 2 * r + 1] / lr);
    }
  }
}

// One launch of banded_wgmma_kernel on `stream`: a persistent grid of
// min(items, SMs) blocks; returns cudaGetLastError() after it.
inline cudaError_t launch_banded_wgmma(const BandedMaps& maps, const BandedArgs& a,
                                       cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  cudaError_t err =
      hopper::allow_smem_once(banded_wgmma_kernel, attn_wgmma_smem_bytes(), done);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long items =
      static_cast<long long>(a.h) * ((a.n + kAttnRows - 1) / kAttnRows) * a.b;
  const int grid = static_cast<int>(items < sms ? items : sms);
  banded_wgmma_kernel<<<grid, hopper::kThreads, attn_wgmma_smem_bytes(), stream>>>(maps, a);
  return cudaGetLastError();
}

// The wgmma route (head size 64): q, k and v are the token rows' [B, H, N,
// 64] views of the packed qkv at element offsets 0, D and 2D from row pfx
// (image stride sb, head stride 64, row stride sn); the RX keys and values
// the [B, H, C, 64] views at D and 2D from prefix row 1, row stride 2 sn.
cudaError_t launch_wgmma(const void* qkv, const int* cid, const int* band, void* out,
                         long long sb, long long sn, int b, int n, int pfx, int h,
                         cudaStream_t stream) {
  const long long d = 64LL * h;
  const bf16* base = static_cast<const bf16*>(qkv);
  const bf16* tok = base + pfx * sn;
  const bf16* rx = base + sn;
  const int c = pfx / 2;
  BandedMaps maps;
  cudaError_t err = hopper::map_heads(&maps.q, tok, b, h, n, sb, 64, sn);
  if (err == cudaSuccess) err = hopper::map_heads(&maps.k, tok + d, b, h, n, sb, 64, sn);
  if (err == cudaSuccess) err = hopper::map_heads(&maps.v, tok + 2 * d, b, h, n, sb, 64, sn);
  if (err == cudaSuccess) err = hopper::map_heads(&maps.rk, rx + d, b, h, c, sb, 64, 2 * sn);
  if (err == cudaSuccess) err = hopper::map_heads(&maps.rv, rx + 2 * d, b, h, c, sb, 64, 2 * sn);
  if (err != cudaSuccess) return err;
  const BandedArgs a{cid, band, static_cast<bf16*>(out), b, h, n, c};
  return launch_banded_wgmma(maps, a, stream);
}

// bf16 on the tensor cores: wgmma at head size 64, else the mma.sync kernel
// of dh's bucket.
cudaError_t dispatch_mma(const void* qkv, const int* cid, const int* band,
                         void* out, long long sb, long long sn, int b, int n,
                         int pfx, int h, int dh, cudaStream_t stream) {
  if (dh == 64) return launch_wgmma(qkv, cid, band, out, sb, sn, b, n, pfx, h, stream);
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
// 1 = bfloat16 on the tensor cores: wgmma at dh 64, else mma.sync), image
// and row strides sn, sb in elements (the wgmma route maps them with TMA:
// base and both pitches on 16 bytes, or cudaErrorInvalidValue); cid: int32 [B, N] (values in
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
