// flash_bwd_dq and flash_bwd_dkv: the flash attention backward for Hopper
// (sm_90a), as two kernels with no atomics.
//
// Replaces: apex_tpu/ops/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (both launched by _bwd_pallas). Given q (n, sq, d),
// k/v (n, sk, d), the output cotangent do (n, sq, d), the forward's
// per-row logsumexp lse (n, sq) (+inf on rows with no visible key) and
// delta = rowsum(do * out) (n, sq), both fp32, they recompute
//   p      = exp(scale * q k^T - lse), masked entries zeroed explicitly,
//   dp     = do v^T,
//   p_eff  = keep * p / (1 - rate),   dp_eff = keep * dp / (1 - rate),
//   ds     = p * (dp_eff - delta)     (the undropped p, as the reference),
// and produce dq = scale * ds k (flash_bwd_dq), dv = p_eff^T do and
// dk = scale * ds^T q (flash_bwd_dkv), in the inputs' dtype, bf16 or fp32,
// d in {64, 128}. The dropout keep mask is regenerated from the counter hash
// of common.cuh, the same bits as the forward's. Like the TPU kernels, ds is
// rounded to k's dtype before the dS K product, and p_eff to do's dtype and
// ds to q's dtype before the dkv products.
//
// What bounds them on the H100: at the training shape (n = 96, sq = sk =
// 1024, d = 64, causal, bf16) dq does 3 and dkv 4 products of the causal
// half, ~19 and ~26 GFLOP, whose floor on the tensor cores (~20 and ~26 us)
// is above the ~10-15 us of HBM traffic. This version runs its products on
// the fp32 pipes with one operand from shared memory per multiply-add, so
// shared-memory bandwidth bounds it, some two orders of magnitude above the
// floor.
//
// What the design does about it: the TPU kernels walk one sequential grid
// axis with an fp32 accumulator tile in VMEM scratch. Here a loop inside the
// block takes that axis, and the accumulators live in registers:
// - flash_bwd_dq: one block per (bh, 64-row q tile), 8 warps of 8
//   interleaved rows; the q and do tiles are staged once, each 32-key k/v
//   tile in turn (rows padded to d + 1 floats, so lane j's reads of key j
//   hit 32 distinct banks). For a row, lane j computes s and dp of key j;
//   then lanes own output dims and the tile's ds values are broadcast by
//   shuffle. The loop stops at the causal diagonal (offset sk - sq).
// - flash_bwd_dkv: one block per (bh, 64-key kv tile), 8 warps of 8
//   interleaved keys; k and v are staged once, each 32-row q/do tile in turn
//   with its lse and delta. For a key, lane i computes s and dp of row i,
//   then lanes own output dims of dk and dv. The loop starts at the first q
//   tile that can see the kv tile.
// dq and dkv stay two kernels, as on the TPU: the fused FlashAttention-2 form
// would add dq with atomics, in an order that changes from run to run. Each
// k/v byte is read once per q tile and each q/do byte once per kv tile.
// Tensor cores (mma.sync / wgmma) and TMA staging are left for a later,
// faster version.

#include "common.cuh"

namespace apex_port {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;   // rows a block owns: q rows (dq), keys (dkv)
constexpr int kTile = 32;   // rows of the streamed tile: one per lane
constexpr int kPerWarp = kRows / kWarps;

// fp32 shared memory of either kernel: the owned 64-row pair of tiles, the
// streamed 32-row pair (padded), and the streamed tile's lse and delta
template <int D>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (2 * kRows * D + 2 * kTile * (D + 1) + 2 * kTile);
}

// rows [r0, r0 + rows) of a (len, D) slice, widened to fp32 into a row
// stride `ld` (D or D + 1); rows at or past `len` are zero
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int r0, int rows, int len) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int c = i % D;
    dst[r * ld + c] =
        (r0 + r < len) ? to_float(src[static_cast<size_t>(r0 + r) * D + c])
                       : 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 16
  for (int c = 0; c < D; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int sq, int sk, int causal, float scale, Dropout dr) {
  constexpr int kDPL = D / 32;  // output dims per lane
  extern __shared__ float smem[];
  float* qs = smem;                      // kRows x D
  float* dos = qs + kRows * D;           // kRows x D
  float* ks = dos + kRows * D;           // kTile x (D + 1)
  float* vs = ks + kTile * (D + 1);      // kTile x (D + 1)

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int offset = sk - sq;  // causal: col <= row + offset is visible
  const size_t qbase = static_cast<size_t>(bh) * sq;
  const T* kb = k + static_cast<size_t>(bh) * sk * D;
  const T* vb = v + static_cast<size_t>(bh) * sk * D;
  const uint32_t bh_key = dropout_bh_key(dr, bh);

  stage<T, D>(qs, D, q + qbase * D, q0, kRows, sq);
  stage<T, D>(dos, D, dout + qbase * D, q0, kRows, sq);

  float row_lse[kPerWarp], row_delta[kPerWarp], acc[kPerWarp][kDPL];
#pragma unroll
  for (int rr = 0; rr < kPerWarp; ++rr) {
    const int row = q0 + rr * kWarps + warp;
    row_lse[rr] = row < sq ? lse[qbase + row] : CUDART_INF_F;
    row_delta[rr] = row < sq ? delta[qbase + row] : 0.f;
#pragma unroll
    for (int dd = 0; dd < kDPL; ++dd) acc[rr][dd] = 0.f;
  }

  // keys past kv_end are above the diagonal for every row of the tile
  int kv_end = sk;
  if (causal) kv_end = min(sk, q0 + kRows + offset);

  for (int j0 = 0; j0 < kv_end; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed; q and do are staged
    stage<T, D>(ks, D + 1, kb, j0, kTile, sk);
    stage<T, D>(vs, D + 1, vb, j0, kTile, sk);
    __syncthreads();
    const int col = j0 + lane;
    const float* kr = ks + lane * (D + 1);
    const float* vr = vs + lane * (D + 1);
#pragma unroll
    for (int rr = 0; rr < kPerWarp; ++rr) {
      const int r = rr * kWarps + warp;  // interleaved: balances causal work
      const int row = q0 + r;
      // both conditions are uniform across the warp
      if (row >= sq) continue;
      if (causal && j0 > row + offset) continue;
      const float s = dot<D>(qs + r * D, kr) * scale;
      float dp = dot<D>(dos + r * D, vr);
      const bool valid = col < sk && (!causal || col <= row + offset);
      // a fully masked row has lse = +inf: exp(s - inf) == 0, never NaN
      const float p = valid ? expf(s - row_lse[rr]) : 0.f;
      if (dr.on)
        dp = dropout_keep(bh_key, row, col, dr.thresh) ? dp * dr.inv_keep
                                                       : 0.f;
      const float ds = round_to<T>(p * (dp - row_delta[rr]));
      float t[kDPL];
#pragma unroll
      for (int dd = 0; dd < kDPL; ++dd) t[dd] = 0.f;
#pragma unroll 8
      for (int j = 0; j < kTile; ++j) {
        const float dsj = __shfl_sync(kFullMask, ds, j);
        const float* kj = ks + j * (D + 1) + lane;
#pragma unroll
        for (int dd = 0; dd < kDPL; ++dd)
          t[dd] = fmaf(dsj, kj[dd * 32], t[dd]);
      }
#pragma unroll
      for (int dd = 0; dd < kDPL; ++dd) acc[rr][dd] += t[dd] * scale;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kPerWarp; ++rr) {
    const int row = q0 + rr * kWarps + warp;
    if (row >= sq) continue;
    T* out = dq + (qbase + row) * D;
#pragma unroll
    for (int dd = 0; dd < kDPL; ++dd)
      store_as(out + lane + dd * 32, acc[rr][dd]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int sq, int sk, int causal,
                     float scale, Dropout dr) {
  constexpr int kDPL = D / 32;
  extern __shared__ float smem[];
  float* ks = smem;                      // kRows x D
  float* vs = ks + kRows * D;            // kRows x D
  float* qs = vs + kRows * D;            // kTile x (D + 1)
  float* dos = qs + kTile * (D + 1);     // kTile x (D + 1)
  float* lse_s = dos + kTile * (D + 1);  // kTile
  float* delta_s = lse_s + kTile;        // kTile

  const int bh = blockIdx.x;
  const int c0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int offset = sk - sq;
  const size_t qbase = static_cast<size_t>(bh) * sq;
  const size_t kbase = static_cast<size_t>(bh) * sk;
  const T* qb = q + qbase * D;
  const T* dob = dout + qbase * D;
  const uint32_t bh_key = dropout_bh_key(dr, bh);

  stage<T, D>(ks, D, k + kbase * D, c0, kRows, sk);
  stage<T, D>(vs, D, v + kbase * D, c0, kRows, sk);

  float dk_acc[kPerWarp][kDPL], dv_acc[kPerWarp][kDPL];
#pragma unroll
  for (int kk = 0; kk < kPerWarp; ++kk)
#pragma unroll
    for (int dd = 0; dd < kDPL; ++dd) dk_acc[kk][dd] = dv_acc[kk][dd] = 0.f;

  // rows before c0 - offset see none of this tile's keys
  int i_begin = 0;
  if (causal) i_begin = max(0, c0 - offset) / kTile * kTile;

  for (int i0 = i_begin; i0 < sq; i0 += kTile) {
    __syncthreads();  // the previous tile is consumed; k and v are staged
    stage<T, D>(qs, D + 1, qb, i0, kTile, sq);
    stage<T, D>(dos, D + 1, dob, i0, kTile, sq);
    if (threadIdx.x < kTile) {
      const int row = i0 + threadIdx.x;
      lse_s[threadIdx.x] = row < sq ? lse[qbase + row] : CUDART_INF_F;
      delta_s[threadIdx.x] = row < sq ? delta[qbase + row] : 0.f;
    }
    __syncthreads();
    const int row = i0 + lane;
    const float row_lse = lse_s[lane];
    const float row_delta = delta_s[lane];
    const float* qr = qs + lane * (D + 1);
    const float* dor = dos + lane * (D + 1);
#pragma unroll
    for (int kk = 0; kk < kPerWarp; ++kk) {
      const int c = kk * kWarps + warp;  // interleaved: balances causal work
      const int col = c0 + c;
      // both conditions are uniform across the warp
      if (col >= sk) continue;
      if (causal && col > i0 + kTile - 1 + offset) continue;
      const float s = dot<D>(qr, ks + c * D) * scale;
      float dp = dot<D>(dor, vs + c * D);
      const bool valid = row < sq && (!causal || col <= row + offset);
      const float p = valid ? expf(s - row_lse) : 0.f;
      float p_eff = p;
      if (dr.on) {
        const bool keep = dropout_keep(bh_key, row, col, dr.thresh);
        p_eff = keep ? p * dr.inv_keep : 0.f;
        dp = keep ? dp * dr.inv_keep : 0.f;
      }
      const float pr = round_to<T>(p_eff);
      const float ds = round_to<T>(p * (dp - row_delta));
      float tk[kDPL], tv[kDPL];
#pragma unroll
      for (int dd = 0; dd < kDPL; ++dd) tk[dd] = tv[dd] = 0.f;
#pragma unroll 8
      for (int i = 0; i < kTile; ++i) {
        const float pi = __shfl_sync(kFullMask, pr, i);
        const float dsi = __shfl_sync(kFullMask, ds, i);
        const float* qi = qs + i * (D + 1) + lane;
        const float* doi = dos + i * (D + 1) + lane;
#pragma unroll
        for (int dd = 0; dd < kDPL; ++dd) {
          tv[dd] = fmaf(pi, doi[dd * 32], tv[dd]);
          tk[dd] = fmaf(dsi, qi[dd * 32], tk[dd]);
        }
      }
#pragma unroll
      for (int dd = 0; dd < kDPL; ++dd) {
        dv_acc[kk][dd] += tv[dd];
        dk_acc[kk][dd] += tk[dd] * scale;
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < kPerWarp; ++kk) {
    const int col = c0 + kk * kWarps + warp;
    if (col >= sk) continue;
    T* dkr = dk + (kbase + col) * D;
    T* dvr = dv + (kbase + col) * D;
#pragma unroll
    for (int dd = 0; dd < kDPL; ++dd) {
      store_as(dkr + lane + dd * 32, dk_acc[kk][dd]);
      store_as(dvr + lane + dd * 32, dv_acc[kk][dd]);
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int n, sq, sk, causal;
  float scale;
  Dropout dr;
};

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n, (a.sq + kRows - 1) / kRows);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dq), a.sq, a.sk, a.causal, a.scale, a.dr);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n, (a.sk + kRows - 1) / kRows);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq, a.sk, a.causal,
      a.scale, a.dr);
  return cudaGetLastError();
}

template <bool kDq>
int dispatch(const BwdArgs& a, int d, int dtype, cudaStream_t st) {
  if (dtype == kFloat32 && d == 64)
    return kDq ? launch_dq<float, 64>(a, st) : launch_dkv<float, 64>(a, st);
  if (dtype == kFloat32 && d == 128)
    return kDq ? launch_dq<float, 128>(a, st) : launch_dkv<float, 128>(a, st);
  if (dtype == kBFloat16 && d == 64)
    return kDq ? launch_dq<__nv_bfloat16, 64>(a, st)
               : launch_dkv<__nv_bfloat16, 64>(a, st);
  if (dtype == kBFloat16 && d == 128)
    return kDq ? launch_dq<__nv_bfloat16, 128>(a, st)
               : launch_dkv<__nv_bfloat16, 128>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace apex_port

// C entry points, bound with ctypes. dtype: 0 fp32, 1 bf16 (q, k, v, do and
// the outputs share it; lse and delta are fp32). Dropout as in
// apex_flash_fwd. Each returns the cudaError_t of its launch (0 on success).
extern "C" int apex_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int n, int sq,
                                 int sk, int d, int dtype, int causal,
                                 float scale, int dropout, unsigned seed,
                                 int thresh, float inv_keep, void* stream) {
  using namespace apex_port;
  const BwdArgs a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, n, sq, sk,
                  causal, scale, Dropout{dropout, seed, thresh, inv_keep}};
  return dispatch<true>(a, d, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int apex_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int n,
                                  int sq, int sk, int d, int dtype, int causal,
                                  float scale, int dropout, unsigned seed,
                                  int thresh, float inv_keep, void* stream) {
  using namespace apex_port;
  const BwdArgs a{q, k, v, dout, lse, delta, nullptr, dk, dv, n, sq, sk,
                  causal, scale, Dropout{dropout, seed, thresh, inv_keep}};
  return dispatch<false>(a, d, dtype, static_cast<cudaStream_t>(stream));
}
