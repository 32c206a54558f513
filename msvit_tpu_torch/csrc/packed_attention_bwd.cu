// Packed-layout self-attention, training backward (bf16 / f32).
//
// Replaces the TPU kernel `msvit_tpu/ops/packed_attention.py::
// _packed_backward` (body `_kernel_packed_bwd`).  Same contract: from the
// forward's residuals (qkv [B, N, 3D], mask, out [B, N, D], the per-head
// lse [B, H, N] f32) and the output cotangent g [B, N, D], it rebuilds the
// probabilities as exp(s - lse) and runs the five-product attention
// backward per head, writing dqkv packed [B, N, 3D]: dq at column h*dh, dk
// at D + h*dh, dv at 2D + h*dh.  The arithmetic mirrors the TPU kernel's:
// delta = sum(g*o) in f32; pb = exp(s - lse) rounded to the compute dtype;
// dv = pb^T g; dp = g v^T; ds = pb*(dp - delta) rounded to the compute
// dtype; dq = ds k * scale; dk = ds^T q * scale.  Masks as in the forward.
//
// The TPU kernel holds one image's [N, N] panels per program and loops over
// the heads in order.  Blocks on the card run in no order, so the work is
// split the flash way, into two kernels launched in turn on one stream:
//
// * dQ: a block per (64 query rows, head, image).  Each query row first
//   forms delta = sum(g*o) for itself and writes it to a small f32 scratch
//   [B, H, N]; then it walks the k/v tiles, recomputing s, pb, dp and ds,
//   and accumulates dq.
// * dK/dV: a block per (64 key rows, head, image).  Each key row walks the
//   query tiles of q and g (with their lse and delta), recomputing s, pb,
//   dp and ds, and accumulates dk and dv.  It reads the delta the dQ kernel
//   wrote, so it is launched after it.
//
// Every output element is written by exactly one thread: no atomics.
//
// What bounds it on the card: 2*5*N*N*dh FLOP per head (plus the
// recomputed q.k^T in the second kernel: 7 products in all) against a few
// N*dh elements: compute bound, here on the CUDA cores in f32 FMAs.  What
// the design does about it: k/v (dQ) and q/g (dK/dV) tiles are staged in
// shared memory with coalesced 16-byte loads and read as broadcasts; the
// [N, N] panels never exist.  Registers were the trouble: a dK/dV thread
// holding k, v, dk and dv at dh = 64 in f32 needs 256 of them.  Each row is
// therefore split over row_threads() neighbouring threads (1 at dh <= 32, 2
// at 64, 4 at 128), each holding a slice of at most 32 head elements, and
// the two dot products per (query, key) pair are summed across the slice
// threads with shuffles.  mma/wgmma come in a later change.

#include "common.cuh"

namespace msvit {
namespace {

template <typename T, int DHT>
__global__ void __launch_bounds__(kRows * row_threads<DHT>())
packed_bwd_dq_kernel(const T* __restrict__ qkv, const void* __restrict__ mask,
                     const T* __restrict__ out, const float* __restrict__ lse,
                     const T* __restrict__ g, float* __restrict__ delta,
                     T* __restrict__ dqkv, int n, int h_count, int dh,
                     int mask_kind, long long mask_sb, long long mask_sh,
                     float scale, float mask_value) {
  using RS = RowSlice<DHT>;
  constexpr int CH = RS::kCh;
  constexpr int KV = kv_rows<T, DHT>();
  __shared__ __align__(16) T ks[KV * DHT];
  __shared__ __align__(16) T vs[KV * DHT];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const RS rs(blockIdx.x * kRows);
  const int i = rs.row;
  const bool active = i < n;
  const int d = h_count * dh;
  const long long row = 3LL * d;
  const T* img = qkv + static_cast<long long>(b) * n * row;
  const long long tok = static_cast<long long>(b) * n + i;  // [B, N] index

  float q[CH], go[CH], dq[CH];
#pragma unroll
  for (int e = 0; e < CH; ++e) {
    q[e] = 0.f;
    go[e] = 0.f;
    dq[e] = 0.f;
  }
  float dl = 0.f;  // delta = sum(g * o), this thread's part
  if (active) {
    load_slice<T, CH>(img + i * row + h * dh, rs.e0, dh, q);
    load_slice<T, CH>(g + tok * d + h * dh, rs.e0, dh, go);
    float o[CH];
    load_slice<T, CH>(out + tok * d + h * dh, rs.e0, dh, o);
#pragma unroll
    for (int e = 0; e < CH; ++e)
      if (rs.e0 + e < dh) dl = fmaf(go[e], o[e], dl);
  }
  dl = row_sum<RS::kTpr>(dl);
  const long long li = (static_cast<long long>(b) * h_count + h) * n + i;
  const float lse_i = active ? lse[li] : 0.f;
  if (active && rs.e0 == 0) delta[li] = dl;

  const uint8_t* mb = static_cast<const uint8_t*>(mask);
  const float* mf = static_cast<const float*>(mask);
  const long long moff = b * mask_sb + h * mask_sh + static_cast<long long>(i) * n;
  const int width = dh * static_cast<int>(sizeof(T));
  const long long row_bytes = row * static_cast<long long>(sizeof(T));
  for (int kv0 = 0; kv0 < n; kv0 += KV) {
    __syncthreads();  // the previous tile is consumed
    stage_tile<uint4>(reinterpret_cast<char*>(ks),
                      reinterpret_cast<const char*>(img), row_bytes,
                      static_cast<long long>(d + h * dh) * sizeof(T), width,
                      kv0, KV, n);
    stage_tile<uint4>(reinterpret_cast<char*>(vs),
                      reinterpret_cast<const char*>(img), row_bytes,
                      static_cast<long long>(2 * d + h * dh) * sizeof(T),
                      width, kv0, KV, n);
    __syncthreads();
    const int cnt = min(KV, n - kv0);
    for (int j = 0; j < cnt; ++j) {
      // every lane takes part in the shuffles, active or not
      float s, dp;
      dot2<T, CH>(q, ks + j * dh, go, vs + j * dh, rs.e0, dh, s, dp);
      s = row_sum<RS::kTpr>(s);
      dp = row_sum<RS::kTpr>(dp);
      if (!active) continue;
      s = apply_mask(s * scale, mask_kind, mb, mf, moff + kv0 + j, mask_value);
      const float pb = round_to<T>(expf(s - lse_i));
      const float ds = round_to<T>(pb * (dp - dl));
      axpy<T, CH>(dq, ds, ks + j * dh, rs.e0, dh);
    }
  }
  if (active) store_slice<T, CH>(dqkv + tok * row + h * dh, rs.e0, dh, dq, scale);
}

template <typename T, int DHT>
__global__ void __launch_bounds__(kRows * row_threads<DHT>())
packed_bwd_dkv_kernel(const T* __restrict__ qkv, const void* __restrict__ mask,
                      const float* __restrict__ lse, const T* __restrict__ g,
                      const float* __restrict__ delta, T* __restrict__ dqkv,
                      int n, int h_count, int dh, int mask_kind,
                      long long mask_sb, long long mask_sh, float scale,
                      float mask_value) {
  using RS = RowSlice<DHT>;
  constexpr int CH = RS::kCh;
  constexpr int QT = kv_rows<T, DHT>();  // query rows per staged tile
  __shared__ __align__(16) T qs[QT * DHT];
  __shared__ __align__(16) T gs[QT * DHT];
  __shared__ float lses[QT];
  __shared__ float deltas[QT];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const RS rs(blockIdx.x * kRows);
  const int j = rs.row;  // this thread's key row
  const bool active = j < n;
  const int d = h_count * dh;
  const long long row = 3LL * d;
  const T* img = qkv + static_cast<long long>(b) * n * row;
  const T* gimg = g + static_cast<long long>(b) * n * d;
  const long long stat0 = (static_cast<long long>(b) * h_count + h) * n;

  float k[CH], v[CH], dk[CH], dv[CH];
#pragma unroll
  for (int e = 0; e < CH; ++e) {
    k[e] = 0.f;
    v[e] = 0.f;
    dk[e] = 0.f;
    dv[e] = 0.f;
  }
  if (active) {
    load_slice<T, CH>(img + j * row + d + h * dh, rs.e0, dh, k);
    load_slice<T, CH>(img + j * row + 2 * d + h * dh, rs.e0, dh, v);
  }
  const uint8_t* mb = static_cast<const uint8_t*>(mask);
  const float* mf = static_cast<const float*>(mask);
  const long long moff = b * mask_sb + h * mask_sh + j;  // column j
  const int width = dh * static_cast<int>(sizeof(T));
  for (int i0 = 0; i0 < n; i0 += QT) {
    __syncthreads();  // the previous tile is consumed
    stage_tile<uint4>(reinterpret_cast<char*>(qs),
                      reinterpret_cast<const char*>(img),
                      row * static_cast<long long>(sizeof(T)),
                      static_cast<long long>(h * dh) * sizeof(T), width, i0,
                      QT, n);
    stage_tile<uint4>(reinterpret_cast<char*>(gs),
                      reinterpret_cast<const char*>(gimg),
                      static_cast<long long>(d) * sizeof(T),
                      static_cast<long long>(h * dh) * sizeof(T), width, i0,
                      QT, n);
    for (int r = threadIdx.x; r < QT; r += blockDim.x) {
      const bool in = i0 + r < n;
      lses[r] = in ? lse[stat0 + i0 + r] : 0.f;
      deltas[r] = in ? delta[stat0 + i0 + r] : 0.f;
    }
    __syncthreads();
    const int cnt = min(QT, n - i0);
    for (int r = 0; r < cnt; ++r) {
      const T* qr = qs + r * dh;
      const T* gr = gs + r * dh;
      float s, dp;
      dot2<T, CH>(k, qr, v, gr, rs.e0, dh, s, dp);
      s = row_sum<RS::kTpr>(s);
      dp = row_sum<RS::kTpr>(dp);
      if (!active) continue;
      s = apply_mask(s * scale, mask_kind, mb, mf,
                     moff + static_cast<long long>(i0 + r) * n, mask_value);
      const float pb = round_to<T>(expf(s - lses[r]));
      axpy<T, CH>(dv, pb, gr, rs.e0, dh);
      const float ds = round_to<T>(pb * (dp - deltas[r]));
      axpy<T, CH>(dk, ds, qr, rs.e0, dh);
    }
  }
  if (!active) return;
  T* o = dqkv + (static_cast<long long>(b) * n + j) * row;
  store_slice<T, CH>(o + d + h * dh, rs.e0, dh, dk, scale);
  store_slice<T, CH>(o + 2 * d + h * dh, rs.e0, dh, dv, 1.f);
}

template <typename T, int DHT>
int launch(const void* qkv, const void* mask, const void* out,
           const void* lse, const void* g, void* delta, void* dqkv, int b,
           int n, int h, int dh, int mask_kind, long long sb, long long sh,
           float scale, float mask_value, cudaStream_t stream) {
  const dim3 grid((n + kRows - 1) / kRows, h, b);
  const int threads = kRows * row_threads<DHT>();
  packed_bwd_dq_kernel<T, DHT><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(qkv), mask, static_cast<const T*>(out),
      static_cast<const float*>(lse), static_cast<const T*>(g),
      static_cast<float*>(delta), static_cast<T*>(dqkv), n, h, dh, mask_kind,
      sb, sh, scale, mask_value);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_bwd_dkv_kernel<T, DHT><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(qkv), mask, static_cast<const float*>(lse),
      static_cast<const T*>(g), static_cast<const float*>(delta),
      static_cast<T*>(dqkv), n, h, dh, mask_kind, sb, sh, scale, mask_value);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* qkv, const void* mask, const void* out,
             const void* lse, const void* g, void* delta, void* dqkv, int b,
             int n, int h, int dh, int mask_kind, long long sb, long long sh,
             float scale, float mask_value, cudaStream_t stream) {
  if (dh <= 16)
    return launch<T, 16>(qkv, mask, out, lse, g, delta, dqkv, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  if (dh <= 32)
    return launch<T, 32>(qkv, mask, out, lse, g, delta, dqkv, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  if (dh <= 64)
    return launch<T, 64>(qkv, mask, out, lse, g, delta, dqkv, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
  return launch<T, 128>(qkv, mask, out, lse, g, delta, dqkv, b, n, h, dh, mask_kind, sb, sh, scale, mask_value, stream);
}

}  // namespace
}  // namespace msvit

extern "C" {

// qkv [B, N, 3D], out and g [B, N, D] in `dtype` (0 = float32,
// 1 = bfloat16); lse [B, H, N] f32 from the forward; delta [B, H, N] f32
// scratch (written by the dQ kernel, read by the dK/dV kernel); dqkv
// [B, N, 3D] in `dtype`, written.  Mask as msvit_packed_attention.
// Returns cudaGetLastError() after the launches.
int msvit_packed_attention_bwd(const void* qkv, const void* mask,
                               const void* out, const void* lse,
                               const void* g, void* delta, void* dqkv,
                               int dtype, int b, int n, int h, int dh,
                               int mask_kind, long long mask_sb,
                               long long mask_sh, float scale,
                               float mask_value, void* stream) {
  if (dh <= 0 || dh > 128 || dh % 8 != 0 || n <= 0 || b <= 0 || h <= 0 ||
      b > 65535 || h > 65535 || mask_kind < 0 || mask_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return msvit::dispatch<float>(qkv, mask, out, lse, g, delta, dqkv, b, n,
                                  h, dh, mask_kind, mask_sb, mask_sh, scale,
                                  mask_value, s);
  if (dtype == 1)
    return msvit::dispatch<__nv_bfloat16>(qkv, mask, out, lse, g, delta,
                                          dqkv, b, n, h, dh, mask_kind,
                                          mask_sb, mask_sh, scale,
                                          mask_value, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
