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
// Per row: walk only the key tiles of the band, with an in-tile segment-id
// compare (a key of another cluster weighs nothing), then the one RX key.
// The softmax is the packed kernels' shaved one: p = exp(clip(s, -80, 80))
// with no row max and no rescale, so the band's contributions are a plain
// sum, and o = P.V / max(l, 1e-30).  Rounding in the TPU kernel's order:
// p is rounded to the compute dtype, and both l and P.V sum that rounded p
// (its pb . ones and pp . ones dots); `_token_rows_xla`, the JAX VJP's
// oracle, sums the unrounded p into l.  The plain version follows the TPU
// kernel.
//
// What bounds it on the card: the products of each token with the tokens of
// its own cluster, 4 * sum_c n_c^2 * dh FLOP per head (N^2 for one cluster,
// the layers before the first clustering event), against the qkv bytes
// (read once) and the output.  This first version runs them on the CUDA
// cores in f32 FMAs.  What the design does about it: the grid is (64-row
// block, head, image) with one thread per sorted query row holding q and
// its accumulator in registers; the block stages only its band's k/v tiles
// (coalesced 16-byte loads, read by all rows as broadcasts) and their
// cluster ids in shared memory; a row skips every key of another cluster
// before any product.  The TPU kernel's structure (dense score rows over
// 1024-key chunks with only the exp chain predicated, the head-pair lane
// blocks) does not carry over.

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

// K10.  qkv: [B, pfx + N, 3*h*dh] of dtype (0 = float32, 1 = bfloat16), image
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
    msvit::dispatch<__nv_bfloat16>(qkv, c, bd, out, sb, sn, b, n, pfx, h, dh, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
