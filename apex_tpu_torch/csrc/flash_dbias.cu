// flash_dbias: the gradient of a learned additive score bias for Hopper
// (sm_90a), with no atomics.
//
// Replaces: apex_tpu/ops/flash_attention.py::_dbias_kernel (launched by
// _dbias_pallas). Given the inputs of flash_bwd_dq (q (n, sq, d), k/v (n, sk,
// d), do (n, sq, d) in bf16 or fp32, every d % 8 == 0 from 8 to 256 at its
// body width (flash_width.cuh); the forward's lse and delta = rowsum(do *
// out), (n, sq) fp32; the fp32 bias (bb, hb, sqb, sk) as
// common.cuh::ScoreBias; optional segment ids and dropout), it recomputes
//   p  = exp(scale * q k^T + bias - lse), masked entries zeroed,
//   dp = do v^T,  dp_eff = keep * dp / (1 - rate),
//   ds = p * (dp_eff - delta)              (fp32, the undropped p)
// and sums ds over the bias's broadcast dims into db (bb, hb, sqb, sk) fp32:
// the score cotangent, since the bias is added after the scale. Its memory
// is O(|bias|): the (n, sq, sk) score cotangent is never stored.
//
// The bias's kept slices are the kb = bb * hb (batch, head) pairs it holds;
// each sums the ds of R = n / kb batch-heads, slice g's r-th being
// bh = g * g_stride + r * r_stride (the reference's _dbias_pallas.bh_of).
//
// What bounds it on the H100: two recomputed products over the visible
// pairs, 4 d FLOP a pair (at the long-context path, 8 x 12 heads, sq = sk =
// 4096, d 64, causal, four packed documents a row: ~0.1 TFLOP against
// ~0.2 GB of inputs), so operations bound it, on the tensor cores ~0.1 ms.
// This version runs both products on the fp32 pipes out of shared memory,
// as flash_bwd_dq does, far above that floor.
//
// What the design does about it. The TPU kernel revisits each output tile
// on consecutive grid steps and accumulates in VMEM. Blocks here run in no
// order, so each block owns output tiles outright, loops over the R
// batch-heads (and the q tiles) that sum into them in a fixed order, keeps
// the sums in registers and writes each output once: a repeat is equal bit
// for bit. Two layouts, chosen by the bias's query dim:
// - sqb == sq (a relative-position table (1, h, sq, sk), a full bias):
//   dbias_rows_kernel, one block per (kept slice, 64-row q tile, 32-key
//   tile), 8 warps of 8 interleaved rows, lane j on key j; for each of the R
//   batch-heads it restages the q/do rows and the k/v tile, and each lane
//   adds its ds to a register per row.
// - sqb == 1 (an ALiBi row (1, h, 1, sk), a (b, 1, 1, sk) learned mask):
//   dbias_cols_kernel, one block per (kept slice, 64-key tile), 8 warps of 8
//   interleaved keys; for each batch-head it stages the k/v rows once and
//   walks every 32-row q/do tile (the loop of flash_bwd_dkv without its two
//   products), lane i on row i adding ds to a register per key; the warp
//   sums its lanes once at the end.
// Tiles the causal mask wholly hides are not computed, but their outputs are
// still written, as zeros. Rows and keys past sq and sk (ragged lengths) are
// masked in the kernel. Segment ids, dropout and the bias are read at the
// global (b, h, row, col) the forward read.
// This kernel is the route for tables with query rows and for fp32 inputs.
// A bias without query rows on bf16 inputs takes the fold instead:
// flash_bwd_dkv's tensor-core body (csrc/flash_bwd.cu, kDbias) already
// forms every visible ds, and writes each batch-head's sum over the rows
// per key into an (n, sk) fp32 partial; dbias_fold_sum_kernel below sums
// the R partials of each kept slice in the order r = 0..R-1 (no atomics: a
// repeat is equal bit for bit). A table's partials would hold R x |bias|
// floats (6.4 GB at the long-context shape), so tables stay here.

#include "common.cuh"
#include "flash_width.cuh"

namespace apex_port {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;   // rows a block owns: q rows (rows), keys (cols)
constexpr int kTile = 32;   // keys (rows) or q rows (cols) of a tile
constexpr int kPerWarp = kRows / kWarps;

// rows [r0, r0 + rows) of a (len, d) slice, widened to fp32 into W columns
// of row stride `ld` (W or W + 1); rows at or past `len` are zero, and so
// (kDyn, d a run-time width under W) are columns d..W-1
template <typename T, int W, bool kDyn>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int r0, int rows, int len, int d) {
  for (int i = threadIdx.x; i < rows * W; i += kThreads) {
    const int r = i / W;
    const int c = i % W;
    if constexpr (kDyn)
      dst[r * ld + c] =
          (r0 + r < len && c < d)
              ? to_float(src[static_cast<size_t>(r0 + r) * d + c])
              : 0.f;
    else
      dst[r * ld + c] =
          (r0 + r < len) ? to_float(src[static_cast<size_t>(r0 + r) * W + c])
                         : 0.f;
  }
}

template <int W>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 16
  for (int c = 0; c < W; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

struct DbiasArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  float* db;
  int sq, sk, d, causal;
  float scale;
  ScoreBias bias;
  Segments seg;
  Dropout dr;
  int reduced, g_stride, r_stride;
};

// ds of (row, col) of batch-head bh, from the score and dp dots, the row's
// lse and delta, and whether the score is visible
__device__ __forceinline__ float score_grad(Dropout dr, float s, float dp,
                                            float row_lse, float row_delta,
                                            bool valid, uint32_t bh_key,
                                            int row, int col) {
  // a fully masked row has lse = +inf: exp(s - inf) == 0, never NaN
  const float p = valid ? expf(s - row_lse) : 0.f;
  if (dr.on)
    dp = dropout_keep(bh_key, row, col, dr.thresh) ? dp * dr.inv_keep : 0.f;
  return p * (dp - row_delta);
}

// W the body width, d the head dim (W itself without kDyn)
template <typename T, int W, bool kDyn, bool kSeg>
__global__ void __launch_bounds__(kThreads)
dbias_rows_kernel(const DbiasArgs a) {
  const int d = kDyn ? a.d : W;
  extern __shared__ float smem[];
  float* qs = smem;                      // kRows x W
  float* dos = qs + kRows * W;           // kRows x W
  float* ks = dos + kRows * W;           // kTile x (W + 1)
  float* vs = ks + kTile * (W + 1);      // kTile x (W + 1)
  int* kid = reinterpret_cast<int*>(vs + kTile * (W + 1));  // kTile (kSeg)

  const int g = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int j0 = blockIdx.z * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sq = a.sq, sk = a.sk;
  const int offset = sk - sq;  // causal: col <= row + offset is visible
  const int col = j0 + lane;

  float acc[kPerWarp];
#pragma unroll
  for (int rr = 0; rr < kPerWarp; ++rr) acc[rr] = 0.f;

  // a tile wholly above the diagonal sums nothing: it is written as zeros
  const bool hidden = a.causal && j0 > q0 + kRows - 1 + offset;
  for (int r = 0; r < (hidden ? 0 : a.reduced); ++r) {
    const int bh = g * a.g_stride + r * a.r_stride;
    const size_t qbase = static_cast<size_t>(bh) * sq;
    const size_t kbase = static_cast<size_t>(bh) * sk;
    __syncthreads();  // the previous batch-head's tiles are consumed
    stage<T, W, kDyn>(qs, W, static_cast<const T*>(a.q) + qbase * d, q0,
                      kRows, sq, d);
    stage<T, W, kDyn>(dos, W, static_cast<const T*>(a.dout) + qbase * d, q0,
                      kRows, sq, d);
    stage<T, W, kDyn>(ks, W + 1, static_cast<const T*>(a.k) + kbase * d, j0,
                      kTile, sk, d);
    stage<T, W, kDyn>(vs, W + 1, static_cast<const T*>(a.v) + kbase * d, j0,
                      kTile, sk, d);
    if (kSeg && threadIdx.x < kTile) {
      const int c = j0 + threadIdx.x;
      kid[threadIdx.x] =
          c < sk ? seg_row(a.seg.kv, a.seg.heads, bh, sk)[c] : 0;
    }
    __syncthreads();
    const uint32_t bh_key = dropout_bh_key(a.dr, bh);
    const int* q_ids = kSeg ? seg_row(a.seg.q, a.seg.heads, bh, sq) : nullptr;
    const float* kr = ks + lane * (W + 1);
    const float* vr = vs + lane * (W + 1);
#pragma unroll
    for (int rr = 0; rr < kPerWarp; ++rr) {
      const int rloc = rr * kWarps + warp;  // interleaved: balances causal
      const int row = q0 + rloc;
      // both conditions are uniform across the warp
      if (row >= sq) continue;
      if (a.causal && j0 > row + offset) continue;
      float s = dot<W>(qs + rloc * W, kr) * a.scale;
      if (col < sk) s += bias_row(a.bias, bh, row)[col];
      const float dp = dot<W>(dos + rloc * W, vr);
      bool valid = col < sk && (!a.causal || col <= row + offset);
      if (kSeg) valid = valid && q_ids[row] == kid[lane];
      acc[rr] += score_grad(a.dr, s, dp, a.lse[qbase + row],
                            a.delta[qbase + row], valid, bh_key, row, col);
    }
  }

  if (col >= sk) return;
#pragma unroll
  for (int rr = 0; rr < kPerWarp; ++rr) {
    const int row = q0 + rr * kWarps + warp;
    if (row < sq)
      a.db[(static_cast<size_t>(g) * sq + row) * sk + col] = acc[rr];
  }
}

template <typename T, int W, bool kDyn, bool kSeg>
__global__ void __launch_bounds__(kThreads)
dbias_cols_kernel(const DbiasArgs a) {
  const int d = kDyn ? a.d : W;
  extern __shared__ float smem[];
  float* ks = smem;                      // kRows x W
  float* vs = ks + kRows * W;            // kRows x W
  float* qs = vs + kRows * W;            // kTile x (W + 1)
  float* dos = qs + kTile * (W + 1);     // kTile x (W + 1)
  float* lse_s = dos + kTile * (W + 1);  // kTile
  float* delta_s = lse_s + kTile;        // kTile
  int* qid_s = reinterpret_cast<int*>(delta_s + kTile);  // kTile (kSeg)

  const int g = blockIdx.x;
  const int c0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sq = a.sq, sk = a.sk;
  const int offset = sk - sq;

  float acc[kPerWarp];  // this lane's share of each owned key's sum
#pragma unroll
  for (int kk = 0; kk < kPerWarp; ++kk) acc[kk] = 0.f;

  // rows before c0 - offset see none of this tile's keys; if none is left,
  // the loops below run no step and the keys are written as zeros
  int i_begin = 0;
  if (a.causal) i_begin = max(0, c0 - offset) / kTile * kTile;

  for (int r = 0; r < a.reduced; ++r) {
    const int bh = g * a.g_stride + r * a.r_stride;
    const size_t qbase = static_cast<size_t>(bh) * sq;
    const size_t kbase = static_cast<size_t>(bh) * sk;
    const T* qb = static_cast<const T*>(a.q) + qbase * d;
    const T* dob = static_cast<const T*>(a.dout) + qbase * d;
    const int* q_ids = kSeg ? seg_row(a.seg.q, a.seg.heads, bh, sq) : nullptr;
    int kid[kPerWarp];  // the owned keys' ids in this batch (kSeg)
#pragma unroll
    for (int kk = 0; kk < kPerWarp; ++kk) {
      const int col = c0 + kk * kWarps + warp;
      if (kSeg) kid[kk] = col < sk ? seg_row(a.seg.kv, a.seg.heads, bh, sk)[col]
                                   : 0;
    }
    const uint32_t bh_key = dropout_bh_key(a.dr, bh);
    __syncthreads();  // the previous batch-head's tiles are consumed
    stage<T, W, kDyn>(ks, W, static_cast<const T*>(a.k) + kbase * d, c0,
                      kRows, sk, d);
    stage<T, W, kDyn>(vs, W, static_cast<const T*>(a.v) + kbase * d, c0,
                      kRows, sk, d);

    for (int i0 = i_begin; i0 < sq; i0 += kTile) {
      __syncthreads();  // the previous q tile is consumed; k, v are staged
      stage<T, W, kDyn>(qs, W + 1, qb, i0, kTile, sq, d);
      stage<T, W, kDyn>(dos, W + 1, dob, i0, kTile, sq, d);
      if (threadIdx.x < kTile) {
        const int row = i0 + threadIdx.x;
        lse_s[threadIdx.x] = row < sq ? a.lse[qbase + row] : CUDART_INF_F;
        delta_s[threadIdx.x] = row < sq ? a.delta[qbase + row] : 0.f;
        if (kSeg) qid_s[threadIdx.x] = row < sq ? q_ids[row] : 0;
      }
      __syncthreads();
      const int row = i0 + lane;
      const float* qr = qs + lane * (W + 1);
      const float* dor = dos + lane * (W + 1);
#pragma unroll
      for (int kk = 0; kk < kPerWarp; ++kk) {
        const int c = kk * kWarps + warp;  // interleaved: balances causal
        const int col = c0 + c;
        // both conditions are uniform across the warp
        if (col >= sk) continue;
        if (a.causal && col > i0 + kTile - 1 + offset) continue;
        float s = dot<W>(qr, ks + c * W) * a.scale;
        if (row < sq) s += bias_row(a.bias, bh, row)[col];
        const float dp = dot<W>(dor, vs + c * W);
        bool valid = row < sq && (!a.causal || col <= row + offset);
        if (kSeg) valid = valid && qid_s[lane] == kid[kk];
        acc[kk] += score_grad(a.dr, s, dp, lse_s[lane], delta_s[lane], valid,
                              bh_key, row, col);
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < kPerWarp; ++kk) {
    const int col = c0 + kk * kWarps + warp;
    const float sum = warp_sum(acc[kk]);  // every lane, in a fixed order
    if (col < sk && lane == 0)
      a.db[static_cast<size_t>(g) * sk + col] = sum;
  }
}

// The fold's second pass: db[g, key] = the sum over r = 0..R-1, in that
// order, of part[g * g_stride + r * r_stride, key], one thread a key. It
// reads the (n, sk) partials once (1.5 MB at the long-context shape)
constexpr int kSumThreads = 256;

__global__ void __launch_bounds__(kSumThreads)
dbias_fold_sum_kernel(const float* __restrict__ part, float* __restrict__ db,
                      int sk, int reduced, int g_stride, int r_stride) {
  const int g = blockIdx.y;
  const int key = blockIdx.x * kSumThreads + threadIdx.x;
  if (key >= sk) return;
  float sum = 0.f;
  for (int r = 0; r < reduced; ++r)
    sum += part[static_cast<size_t>(g * g_stride + r * r_stride) * sk + key];
  db[static_cast<size_t>(g) * sk + key] = sum;
}

template <typename T, int W, bool kDyn, bool kSeg>
cudaError_t launch(const DbiasArgs& a, int kept, int rows,
                   cudaStream_t stream) {
  if (rows) {
    const size_t smem = sizeof(float) * (2 * kRows * W + 2 * kTile * (W + 1))
                        + (kSeg ? sizeof(int) * kTile : 0);
    cudaError_t err = cudaFuncSetAttribute(
        dbias_rows_kernel<T, W, kDyn, kSeg>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(kept, (a.sq + kRows - 1) / kRows,
                    (a.sk + kTile - 1) / kTile);
    dbias_rows_kernel<T, W, kDyn, kSeg><<<grid, kThreads, smem, stream>>>(a);
  } else {
    const size_t smem =
        sizeof(float) * (2 * kRows * W + 2 * kTile * (W + 1) + 2 * kTile) +
        (kSeg ? sizeof(int) * kTile : 0);
    cudaError_t err = cudaFuncSetAttribute(
        dbias_cols_kernel<T, W, kDyn, kSeg>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(kept, (a.sk + kRows - 1) / kRows);
    dbias_cols_kernel<T, W, kDyn, kSeg><<<grid, kThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const DbiasArgs& a, int w, int kept, int rows,
                     cudaStream_t st) {
  return width::dispatch(a.d, w, [&](auto wc, auto dyn) {
    constexpr int W = decltype(wc)::value;
    constexpr bool kDyn = decltype(dyn)::value;
    return a.seg.q != nullptr ? launch<T, W, kDyn, true>(a, kept, rows, st)
                              : launch<T, W, kDyn, false>(a, kept, rows, st);
  });
}

}  // namespace
}  // namespace apex_port

// C entry point, bound with ctypes, one a group of widths
// (flash_width.cuh: apex_flash_dbias_p<group>); d is the head dim and w its
// body width. dtype: 0 fp32, 1 bf16 (q, k, v, do); lse,
// delta, the bias and db are fp32. The bias, the segment ids and dropout as
// in apex_flash_fwd. `kept` slices of db (bb * hb) each sum `reduced`
// batch-heads, the r-th of slice g being g * g_stride + r * r_stride; `rows`
// is 1 iff the bias has sq query rows (else 1 row). Returns the cudaError_t
// of the launch (0 on success).
extern "C" int APEX_FLASH_ENTRY(apex_flash_dbias)(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* db, int n, int sq, int sk,
    int d, int w, int dtype, int causal, float scale, const void* bias,
    int heads, int sb, int sh, int sr, const void* q_ids, const void* kv_ids,
    int seg_heads, int kept, int reduced, int g_stride, int r_stride,
    int rows, int dropout, unsigned seed, int thresh, float inv_keep,
    void* stream) {
  using namespace apex_port;
  if (kept <= 0 || reduced <= 0 || static_cast<long long>(kept) * reduced != n)
    return static_cast<int>(cudaErrorInvalidValue);
  const DbiasArgs a{q, k, v, dout, static_cast<const float*>(lse),
                    static_cast<const float*>(delta), static_cast<float*>(db),
                    sq, sk, d, causal, scale,
                    ScoreBias{static_cast<const float*>(bias), heads, sb, sh,
                              sr},
                    Segments{static_cast<const int*>(q_ids),
                             static_cast<const int*>(kv_ids), seg_heads},
                    Dropout{dropout, seed, thresh, inv_keep}, reduced,
                    g_stride, r_stride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_d<float>(a, w, kept, rows, st);
  if (dtype == kBFloat16) return launch_d<__nv_bfloat16>(a, w, kept, rows, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

#if APEX_FLASH_PART == 0
// The fold's second pass (dbias_fold_sum_kernel), in the first group's
// object alone (it takes no head dim): `part` (n, sk) fp32 from
// apex_flash_bwd_dkv's db_part, `db` (kept, sk) fp32, the split as in
// apex_flash_dbias. Returns the cudaError_t of the launch (0 on success).
extern "C" int apex_flash_dbias_fold_sum(const void* part, void* db, int kept,
                                         int reduced, int g_stride,
                                         int r_stride, int sk, void* stream) {
  using namespace apex_port;
  if (kept <= 0 || reduced <= 0 || sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((sk + kSumThreads - 1) / kSumThreads, kept);
  dbias_fold_sum_kernel<<<grid, kSumThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(db), sk, reduced,
      g_stride, r_stride);
  return static_cast<int>(cudaGetLastError());
}
#endif  // APEX_FLASH_PART == 0
