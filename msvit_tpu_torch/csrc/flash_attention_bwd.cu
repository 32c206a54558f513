// Flash-attention backward on [B, H, N, dh] operands (bf16 / f32): K6.
//
// Replaces the TPU kernel `msvit_tpu/ops/flash_attention.py::
// flash_attention_bwd`: its two pallas_calls, `_bwd_dq_kernel` and
// `_bwd_dkv_kernel`, over the shared tile math `_recompute_p_ds`.  It is
// the backward of the multistate trunk's fused attention (JAX's `_fused`
// custom VJP; here `FusedAttentionFunction`, whose forward is K5-lse).  From
// the forward's residuals -- q [B, H, Nq, dh], k, v [B, H, Nk, dh], out
// [B, H, Nq, dh], the compact lse [B, H, Nq] f32 -- and the cotangent g of
// out (cast to q's dtype by the wrapper, as the TPU function casts it), it
// writes dq, dk and dv.  The arithmetic is the TPU kernels':
//   s = q.k^T * scale in f32, the mask applied as in the forward (additive,
//   or where-valid with mask_value); p = exp(s - lse), kept in f32;
//   dp = g.v^T and delta = sum(g * o) in f32; ds = p * (dp - delta) in f32;
//   dv = p^T g with p rounded to the compute dtype; dk = ds^T q * scale and
//   dq = ds k * scale with ds rounded to the compute dtype.
// (K2, the packed backward, rounds p before it forms ds; K6 does not.)
//
// Operands are read through their (image, head, row) element strides with
// the last dim contiguous, so views of the QKV GEMM output and a strided
// cotangent need no copy; dq, dk and dv are written through strides too.
// Masks are bool (true = attend) or additive f32, [B|1, 1|H, Nq, Nk] with
// the last two dims contiguous.  Nq != Nk is allowed (cross-context K/V).
//
// Blocks run in no order, so the TPU grid's sequential kv (dQ) and q (dK/dV)
// axes become loops inside a block, and the work is two kernels launched in
// turn on one stream:
// * dQ: a block per (64 query rows, head, image).  Each row first forms
//   delta = sum(g * o) and writes it to an f32 scratch [B, H, Nq] -- once
//   per row, where the TPU kernels recompute it in every tile -- then walks
//   the k/v tiles, recomputing s, p, dp and ds, and accumulates dq.  Its
//   mask reads walk one query row.
// * dK/dV: a block per (64 key rows, head, image).  Each key row walks the
//   query tiles of q and g, staged in shared memory with their lse and
//   delta (the dQ kernel's), and accumulates dk and dv.  Neighbouring
//   threads hold neighbouring keys, so a query row's mask entries are read
//   coalesced.
// Every output element is written by exactly one thread: no atomics.
//
// What bounds it on the card: 5 products of 2*Nq*Nk*dh FLOP per head (the
// dK/dV kernel recomputes s and dp: 7 are done) against a few N*dh
// elements per operand and the mask's Nq*Nk entries.  At the multistate
// trunk, [8, 12, 816, 64] with an f32 mask, that is 41 GFLOP against
// 102 MB: compute bound.  This first version does the products as f32 FMAs
// on the CUDA cores (tensor cores are later work).  What the design does
// about it: k/v (dQ) and q/g (dK/dV) tiles are staged once per block with
// coalesced 16-byte loads and read by all rows as broadcasts; the [Nq, Nk]
// panels never leave registers; each row is split over row_threads()
// neighbouring threads (1 at dh <= 32, 2 at 64, 4 at 128) holding at most
// 32 head elements each, so the dK/dV kernel's k, v, dk and dv stay in
// registers, and the two dot products per (query, key) pair are summed
// across a row's threads with shuffles.

#include "common.cuh"

namespace msvit {
namespace {

// Element strides (image, head, row) of the eight [B, H, N, dh] operands.
struct Strides {
  long long q[3], k[3], v[3], o[3], g[3], dq[3], dk[3], dv[3];
};

__device__ __forceinline__ long long offset(const long long* s, int b, int h,
                                            int row) {
  return b * s[0] + h * s[1] + row * s[2];
}

template <typename T, int DHT>
__global__ void __launch_bounds__(kRows * row_threads<DHT>())
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ out,
                    const T* __restrict__ g, const float* __restrict__ lse,
                    const void* __restrict__ mask, float* __restrict__ delta,
                    T* __restrict__ dq, Strides st, int nq, int nk, int dh,
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
  const bool active = i < nq;

  float qr[CH], go[CH], acc[CH];
#pragma unroll
  for (int e = 0; e < CH; ++e) {
    qr[e] = 0.f;
    go[e] = 0.f;
    acc[e] = 0.f;
  }
  float dl = 0.f;  // delta = sum(g * o), this thread's part
  if (active) {
    load_slice<T, CH>(q + offset(st.q, b, h, i), rs.e0, dh, qr);
    load_slice<T, CH>(g + offset(st.g, b, h, i), rs.e0, dh, go);
    float o[CH];
    load_slice<T, CH>(out + offset(st.o, b, h, i), rs.e0, dh, o);
#pragma unroll
    for (int e = 0; e < CH; ++e)
      if (rs.e0 + e < dh) dl = fmaf(go[e], o[e], dl);
  }
  dl = row_sum<RS::kTpr>(dl);
  const long long li = (static_cast<long long>(b) * gridDim.y + h) * nq + i;
  const float lse_i = active ? lse[li] : 0.f;
  if (active && rs.e0 == 0) delta[li] = dl;

  const uint8_t* mb = static_cast<const uint8_t*>(mask);
  const float* mf = static_cast<const float*>(mask);
  const long long moff =
      b * mask_sb + h * mask_sh + static_cast<long long>(i) * nk;
  const char* kimg = reinterpret_cast<const char*>(k + b * st.k[0] + h * st.k[1]);
  const char* vimg = reinterpret_cast<const char*>(v + b * st.v[0] + h * st.v[1]);
  const int width = dh * static_cast<int>(sizeof(T));
  const long long krow = st.k[2] * static_cast<long long>(sizeof(T));
  const long long vrow = st.v[2] * static_cast<long long>(sizeof(T));
  for (int kv0 = 0; kv0 < nk; kv0 += KV) {
    __syncthreads();  // the previous tile is consumed
    stage_tile<uint4>(reinterpret_cast<char*>(ks), kimg, krow, 0, width, kv0,
                      KV, nk);
    stage_tile<uint4>(reinterpret_cast<char*>(vs), vimg, vrow, 0, width, kv0,
                      KV, nk);
    __syncthreads();
    const int cnt = min(KV, nk - kv0);
    for (int j = 0; j < cnt; ++j) {
      // every lane takes part in the shuffles, active or not
      float s, dp;
      dot2<T, CH>(qr, ks + j * dh, go, vs + j * dh, rs.e0, dh, s, dp);
      s = row_sum<RS::kTpr>(s);
      dp = row_sum<RS::kTpr>(dp);
      if (!active) continue;
      s = apply_mask(s * scale, mask_kind, mb, mf, moff + kv0 + j, mask_value);
      const float p = expf(s - lse_i);
      const float ds = round_to<T>(p * (dp - dl));
      axpy<T, CH>(acc, ds, ks + j * dh, rs.e0, dh);
    }
  }
  if (active)
    store_slice<T, CH>(dq + offset(st.dq, b, h, i), rs.e0, dh, acc, scale);
}

template <typename T, int DHT>
__global__ void __launch_bounds__(kRows * row_threads<DHT>())
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const void* __restrict__ mask,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Strides st, int nq, int nk, int dh,
                     int mask_kind, long long mask_sb, long long mask_sh,
                     float scale, float mask_value) {
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
  const bool active = j < nk;

  float kr[CH], vr[CH], dkr[CH], dvr[CH];
#pragma unroll
  for (int e = 0; e < CH; ++e) {
    kr[e] = 0.f;
    vr[e] = 0.f;
    dkr[e] = 0.f;
    dvr[e] = 0.f;
  }
  if (active) {
    load_slice<T, CH>(k + offset(st.k, b, h, j), rs.e0, dh, kr);
    load_slice<T, CH>(v + offset(st.v, b, h, j), rs.e0, dh, vr);
  }
  const uint8_t* mb = static_cast<const uint8_t*>(mask);
  const float* mf = static_cast<const float*>(mask);
  const long long moff = b * mask_sb + h * mask_sh + j;  // column j
  const char* qimg = reinterpret_cast<const char*>(q + b * st.q[0] + h * st.q[1]);
  const char* gimg = reinterpret_cast<const char*>(g + b * st.g[0] + h * st.g[1]);
  const int width = dh * static_cast<int>(sizeof(T));
  const long long qrow = st.q[2] * static_cast<long long>(sizeof(T));
  const long long grow = st.g[2] * static_cast<long long>(sizeof(T));
  const long long stat0 = (static_cast<long long>(b) * gridDim.y + h) * nq;
  for (int i0 = 0; i0 < nq; i0 += QT) {
    __syncthreads();  // the previous tile is consumed
    stage_tile<uint4>(reinterpret_cast<char*>(qs), qimg, qrow, 0, width, i0,
                      QT, nq);
    stage_tile<uint4>(reinterpret_cast<char*>(gs), gimg, grow, 0, width, i0,
                      QT, nq);
    for (int r = threadIdx.x; r < QT; r += blockDim.x) {
      const bool in = i0 + r < nq;
      lses[r] = in ? lse[stat0 + i0 + r] : 0.f;
      deltas[r] = in ? delta[stat0 + i0 + r] : 0.f;
    }
    __syncthreads();
    const int cnt = min(QT, nq - i0);
    for (int r = 0; r < cnt; ++r) {
      const T* qt = qs + r * dh;
      const T* gt = gs + r * dh;
      float s, dp;
      dot2<T, CH>(kr, qt, vr, gt, rs.e0, dh, s, dp);
      s = row_sum<RS::kTpr>(s);
      dp = row_sum<RS::kTpr>(dp);
      if (!active) continue;
      s = apply_mask(s * scale, mask_kind, mb, mf,
                     moff + static_cast<long long>(i0 + r) * nk, mask_value);
      const float p = expf(s - lses[r]);
      axpy<T, CH>(dvr, round_to<T>(p), gt, rs.e0, dh);
      const float ds = round_to<T>(p * (dp - deltas[r]));
      axpy<T, CH>(dkr, ds, qt, rs.e0, dh);
    }
  }
  if (!active) return;
  store_slice<T, CH>(dk + offset(st.dk, b, h, j), rs.e0, dh, dkr, scale);
  store_slice<T, CH>(dv + offset(st.dv, b, h, j), rs.e0, dh, dvr, 1.f);
}

struct Args {
  const void *q, *k, *v, *out, *g, *lse, *mask;
  void *delta, *dq, *dk, *dv;
  Strides st;
  int b, h, nq, nk, dh, mask_kind;
  long long mask_sb, mask_sh;
  float scale, mask_value;
};

template <typename T, int DHT>
int launch(const Args& a, cudaStream_t stream) {
  const int threads = kRows * row_threads<DHT>();
  const dim3 grid_q((a.nq + kRows - 1) / kRows, a.h, a.b);
  flash_bwd_dq_kernel<T, DHT><<<grid_q, threads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.out),
      static_cast<const T*>(a.g), static_cast<const float*>(a.lse), a.mask,
      static_cast<float*>(a.delta), static_cast<T*>(a.dq), a.st, a.nq, a.nk,
      a.dh, a.mask_kind, a.mask_sb, a.mask_sh, a.scale, a.mask_value);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_k((a.nk + kRows - 1) / kRows, a.h, a.b);
  flash_bwd_dkv_kernel<T, DHT><<<grid_k, threads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g),
      static_cast<const float*>(a.lse), a.mask,
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.st, a.nq, a.nk, a.dh, a.mask_kind, a.mask_sb,
      a.mask_sh, a.scale, a.mask_value);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, cudaStream_t stream) {
  if (a.dh <= 16) return launch<T, 16>(a, stream);
  if (a.dh <= 32) return launch<T, 32>(a, stream);
  if (a.dh <= 64) return launch<T, 64>(a, stream);
  return launch<T, 128>(a, stream);
}

}  // namespace
}  // namespace msvit

extern "C" {

// K6.  q, k, v, out, g in `dtype` (0 = float32, 1 = bfloat16), g already in
// q's dtype; lse [B, H, Nq] f32 from the forward (contiguous); delta
// [B, H, Nq] f32 scratch (written by the dQ kernel, read by the dK/dV
// kernel); dq [B, H, Nq, dh], dk and dv [B, H, Nk, dh] in `dtype`, written.
// strides: 24 element strides (host memory), (image, head, row) of q, k,
// v, out, g, dq, dk, dv in that order; every row's dh elements contiguous
// and 16-byte aligned.  mask_kind: 0 none, 1 bool (one byte per entry),
// 2 additive float32; mask_sb / mask_sh its image and head strides in
// elements (0 where broadcast), its last two dims contiguous [Nq, Nk].
// Returns cudaGetLastError() after the launches.
int msvit_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* out, const void* g,
                              const void* lse, const void* mask, void* delta,
                              void* dq, void* dk, void* dv, int dtype, int b,
                              int h, int nq, int nk, int dh,
                              const long long* strides, int mask_kind,
                              long long mask_sb, long long mask_sh,
                              float scale, float mask_value, void* stream) {
  if (dh <= 0 || dh > 128 || dh % 8 != 0 || nq <= 0 || nk <= 0 || b <= 0 ||
      h <= 0 || b > 65535 || h > 65535 || mask_kind < 0 || mask_kind > 2 ||
      strides == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  msvit::Args a{q, k, v, out, g, lse, mask, delta, dq, dk, dv, {},
                b, h, nq, nk, dh, mask_kind, mask_sb, mask_sh, scale,
                mask_value};
  long long* st[8] = {a.st.q, a.st.k, a.st.v, a.st.o,
                      a.st.g, a.st.dq, a.st.dk, a.st.dv};
  for (int t = 0; t < 8; ++t)
    for (int d = 0; d < 3; ++d) st[t][d] = strides[3 * t + d];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return msvit::dispatch<float>(a, s);
  if (dtype == 1) return msvit::dispatch<__nv_bfloat16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
