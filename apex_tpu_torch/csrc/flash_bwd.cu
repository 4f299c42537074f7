// flash_bwd_dq and flash_bwd_dkv: the flash attention backward for Hopper
// (sm_90a), as two kernels with no atomics.
//
// Replaces: apex_tpu/ops/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (both launched by _bwd_pallas). Given q (n, sq, d),
// k/v (n, sk, d), the output cotangent do (n, sq, d), the forward's
// per-row logsumexp lse (n, sq) (+inf on rows with no visible key) and
// delta = rowsum(do * out) (n, sq), both fp32, and the forward's optional
// fp32 score bias (common.cuh::ScoreBias) and segment ids
// (common.cuh::Segments), they recompute
//   p      = exp(scale * q k^T [+ bias] - lse), masked entries zeroed
//            (the causal mask, differing segment ids, ragged edges),
//   dp     = do v^T,
//   p_eff  = keep * p / (1 - rate),   dp_eff = keep * dp / (1 - rate),
//   ds     = p * (dp_eff - delta)     (the undropped p, as the reference),
// and produce dq = scale * ds k (flash_bwd_dq), dv = p_eff^T do and
// dk = scale * ds^T q (flash_bwd_dkv), in the inputs' dtype, bf16 or fp32,
// every d % 8 == 0 from 8 to 256, each run at a body width W whose columns
// past d the loads zero-fill and the stores skip (flash_width.cuh). The
// dropout keep mask is regenerated from the counter hash of common.cuh,
// the same bits as the forward's. Like the TPU kernels,
// ds is rounded to k's dtype before the dS K product, and p_eff to do's
// dtype and ds to q's dtype before the dkv products; dk's scale is applied
// after its fp32 sum, as the reference's.
//
// What bounds them on the H100: at the training shape (n = 96, sq = sk =
// 1024, d = 64, causal, bf16) dq does 3 and dkv 4 products of the causal
// half, ~19 and ~26 GFLOP, whose floor on the tensor cores (~20 and ~26 us)
// is above the ~10-15 us of HBM traffic.
//
// Two bodies each, chosen by the inputs' dtype (a route, not a fallback: a
// bf16 launch that fails raises): bf16 runs on the tensor cores, fp32 on
// the SIMT bodies below, whose exact fp32 products the fp32 checks' limits
// (and the long path's LONG_TOL_FP32) need.
//
// flash_bwd_dq, bf16: tensor cores (flash_bwd_dq_mma_kernel), in
// flash_attention's forward shape. One block of 4 warps per (batch-head,
// 64-row q tile), heaviest tile first, each warp owning 16 q rows. The q
// and do tiles are staged once (A operands through ldmatrix); the rows'
// lse and delta stay in registers, per row of the accumulator fragment;
// the 64-key K and V tiles, with (with ids) their key ids, stream through
// a 2-stage cp.async ring from key tile 0 to the causal diagonal (offset
// sk - sq). Per key tile: S = Q K^T and dP = dO V^T as m16n8k16 products
// (each 16-wide k chunk into a fresh accumulator); per accumulator element
// on its lane's (row, key), p = exp(scale s + bias - lse), the masks, the
// dropout hash and ds = p (dp_eff - delta); ds rounded to bf16 and packed
// from accumulator to A fragment; dQ += dS K with K as the B operand
// through ldmatrix.trans. The 16 x d fp32 dQ accumulator of a warp stays in
// registers for the whole loop, and the scale is applied after its sum. A
// (q tile, key tile) pair whose segment-id ranges are disjoint is never
// loaded. dS is rounded where the plain version rounds it: the flagged-score
// pass of rounding.cuh, fed the rows' q and do norms (from the staged tile)
// and each key tile's K and V norms (from its staged tile, between the
// ring's two barriers).
//
// flash_bwd_dkv, bf16: tensor cores (flash_bwd_dkv_mma_kernel). One block
// of 4 warps per (batch-head, 64-key tile), each warp owning 16 keys. K and
// V are staged once; the 64-row q and do tiles, with their lse, delta,
// row norms and (with ids) query ids, stream through a 2-stage cp.async
// ring, starting at the first q tile that can see the key tile. The work
// is transposed, as FlashAttention-2's dkv: S^T = K Q^T and dP^T = V dO^T
// are m16n8k16 products with K and V as the A operands, so P_eff^T and
// dS^T come out in accumulator fragments already laid out as the A
// operands of dV += P_eff^T dO and dK += dS^T Q (do and q as B operands
// through ldmatrix.trans); lse and delta are per column of the transposed
// tile. The dK and dV accumulators (16 keys x d fp32 a warp) stay in
// registers for the whole loop. Past width 80 a key group has two warps,
// each holding half of dK's and dV's columns; past width 64 each warp takes
// a q tile in 16-row quarters, so the transposed scores' registers fit
// beside the accumulators.
// A (q tile, key tile) pair whose segment-id ranges are disjoint
// (mma.cuh::tiles_meet) is never loaded: it would add exact zeros.
// P_eff and dS are rounded to bf16 where the plain version rounds them:
// the flagged-score pass of rounding.cuh (a few scores in a thousand take
// their sums again), fed the q and do row norms from the wrapper and the
// keys' K and V norms from the staged tiles.
// With a learned bias without query rows (bb, hb, 1, sk) on the bf16 path,
// the dkv body also takes the bias's gradient (kDbias, the fold of the
// reference's _dbias_kernel): the dS it forms for dK is that gradient's
// summand, so each thread adds the unrounded dS of its two keys as the
// flagged-score pass leaves them, the four lanes of a key combine at the
// end, and the key's sum over every row of the batch-head goes to an (n,
// sk) fp32 partial; csrc/flash_dbias.cu sums the partials of the
// batch-heads that share a bias slice in a fixed order. The standalone
// flash_dbias recomputed both products for that. Since the fp32 dS is the
// output here, the fold also takes again the dS of a score whose S scale +
// bias may round to another fp32 value than the plain version's (a large
// bias: rounding.cuh, bias_sum_uncertain), for its sum only: dK and dV are
// made of the same values as without the fold, and keep their bits.
//
// What holds both bf16 bodies above their floors: mma.sync (not wgmma);
// the softmax recompute, masks, dropout hash and rounding test of each
// score on the fp32 pipes; the re-taken sums; the causal diagonal's
// partial tiles. No atomics and a fixed loop order: a second launch gives
// the same bits.
//
// flash_bwd_dq and flash_bwd_dkv in fp32: the SIMT bodies, exact fp32
// products (what the fp32 checks' limits need), run on the fp32
// pipes with one operand from shared memory per multiply-add, so
// shared-memory bandwidth bounds them, some two orders of magnitude above
// the floor. The TPU kernels walk one sequential grid axis with an fp32
// accumulator tile in VMEM scratch. Here a loop inside the block takes
// that axis, and the accumulators live in registers:
// - flash_bwd_dq: one block per (bh, 64-row q tile), 8 warps of 8
//   interleaved rows; the q and do tiles are staged once, each 32-key k/v
//   tile in turn (rows padded to d + 1 floats, so lane j's reads of key j
//   hit 32 distinct banks). For a row, lane j computes s and dp of key j;
//   then lanes own output dims and the tile's ds values are broadcast by
//   shuffle. The loop stops at the causal diagonal (offset sk - sq).
// - flash_bwd_dkv (fp32): one block per (bh, 64-key kv tile), 8 warps of 8
//   interleaved keys; k and v are staged once, each 32-row q/do tile in
//   turn with its lse and delta. For a key, lane i computes s and dp of
//   row i, then lanes own output dims of dk and dv. The loop starts at the
//   first q tile that can see the kv tile.
// dq and dkv stay two kernels, as on the TPU: the fused FlashAttention-2 form
// would add dq with atomics, in an order that changes from run to run. Each
// k/v byte is read once per q tile and each q/do byte once per kv tile.
// The score bias is read where each score is formed, at the global
// (b, h, row, col) the forward read: lanes read consecutive keys of one row
// in dq, one key of consecutive rows in dkv (a single broadcast load when
// the bias is a (b, 1, 1, sk) padding mask, a row stride apart otherwise).
// Segment ids follow the same split: the streamed tile's ids go to shared
// memory beside it (key ids in dq, query ids in dkv) and the owned rows'
// or keys' ids stay in registers; without ids (kSeg false) nothing more is
// read or compared per score. The SIMT bodies skip no tile for its ids.

#include "common.cuh"
#include "flash_width.cuh"
#include "mma.cuh"
#include "rounding.cuh"

#include <type_traits>

namespace apex_port {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;   // rows a block owns: q rows (dq), keys (dkv)
constexpr int kTile = 32;   // rows of the streamed tile: one per lane
constexpr int kPerWarp = kRows / kWarps;

// fp32 shared memory of either kernel: the owned 64-row pair of tiles, the
// streamed 32-row pair (padded), and the streamed tile's lse and delta
// and, with segment ids, the streamed tile's ids; W the body width
template <int W, bool kSeg>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (2 * kRows * W + 2 * kTile * (W + 1) + 2 * kTile) +
         (kSeg ? sizeof(int) * kTile : 0);
}

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

// whether lane's output dim lane + 32 dd of the SIMT bodies lies in the
// first d (and so is read from the staged tiles and stored): every one at
// a fixed width, a multiple of 32
template <int W, bool kDyn>
__device__ __forceinline__ bool lane_dim(int lane, int dd, int d) {
  return !(kDyn || W % 32 != 0) || lane + dd * 32 < d;
}

template <typename T, int W, bool kDyn, bool kSeg>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int sq, int sk, int d, int causal, float scale,
                    ScoreBias bias, Segments seg, Dropout dr) {
  constexpr int kDPL = (W + 31) / 32;  // output dims per lane
  if constexpr (!kDyn) d = W;
  extern __shared__ float smem[];
  float* qs = smem;                      // kRows x W
  float* dos = qs + kRows * W;           // kRows x W
  float* ks = dos + kRows * W;           // kTile x (W + 1)
  float* vs = ks + kTile * (W + 1);      // kTile x (W + 1)
  // the (padded) lse and delta slots are unused here: ids follow them
  int* kid = reinterpret_cast<int*>(vs + kTile * (W + 1) + 2 * kTile);

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int offset = sk - sq;  // causal: col <= row + offset is visible
  const size_t qbase = static_cast<size_t>(bh) * sq;
  const T* kb = k + static_cast<size_t>(bh) * sk * d;
  const T* vb = v + static_cast<size_t>(bh) * sk * d;
  const uint32_t bh_key = dropout_bh_key(dr, bh);

  stage<T, W, kDyn>(qs, W, q + qbase * d, q0, kRows, sq, d);
  stage<T, W, kDyn>(dos, W, dout + qbase * d, q0, kRows, sq, d);

  float row_lse[kPerWarp], row_delta[kPerWarp], acc[kPerWarp][kDPL];
  int qid[kPerWarp];  // the rows' query ids (kSeg)
  const int* kv_ids = kSeg ? seg_row(seg.kv, seg.heads, bh, sk) : nullptr;
#pragma unroll
  for (int rr = 0; rr < kPerWarp; ++rr) {
    const int row = q0 + rr * kWarps + warp;
    if (kSeg) qid[rr] = row < sq ? seg_row(seg.q, seg.heads, bh, sq)[row]
                                 : 0;
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
    stage<T, W, kDyn>(ks, W + 1, kb, j0, kTile, sk, d);
    stage<T, W, kDyn>(vs, W + 1, vb, j0, kTile, sk, d);
    if (kSeg && threadIdx.x < kTile) {
      const int c = j0 + threadIdx.x;
      kid[threadIdx.x] = c < sk ? kv_ids[c] : 0;
    }
    __syncthreads();
    const int col = j0 + lane;
    const float* kr = ks + lane * (W + 1);
    const float* vr = vs + lane * (W + 1);
#pragma unroll
    for (int rr = 0; rr < kPerWarp; ++rr) {
      const int r = rr * kWarps + warp;  // interleaved: balances causal work
      const int row = q0 + r;
      // both conditions are uniform across the warp
      if (row >= sq) continue;
      if (causal && j0 > row + offset) continue;
      float s = dot<W>(qs + r * W, kr) * scale;
      // the same global (b, h, row, col) entry as the forward and dkv read
      if (bias.p != nullptr && col < sk) s += bias_row(bias, bh, row)[col];
      float dp = dot<W>(dos + r * W, vr);
      bool valid = col < sk && (!causal || col <= row + offset);
      if (kSeg) valid = valid && qid[rr] == kid[lane];
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
        const float* kj = ks + j * (W + 1) + lane;
#pragma unroll
        for (int dd = 0; dd < kDPL; ++dd)
          if (lane_dim<W, kDyn>(lane, dd, d))
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
    T* out = dq + (qbase + row) * d;
#pragma unroll
    for (int dd = 0; dd < kDPL; ++dd)
      if (lane_dim<W, kDyn>(lane, dd, d))
        store_as(out + lane + dd * 32, acc[rr][dd]);
  }
}

template <typename T, int W, bool kDyn, bool kSeg>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int sq, int sk, int d, int causal,
                     float scale, ScoreBias bias, Segments seg, Dropout dr) {
  constexpr int kDPL = (W + 31) / 32;
  if constexpr (!kDyn) d = W;
  extern __shared__ float smem[];
  float* ks = smem;                      // kRows x W
  float* vs = ks + kRows * W;            // kRows x W
  float* qs = vs + kRows * W;            // kTile x (W + 1)
  float* dos = qs + kTile * (W + 1);     // kTile x (W + 1)
  float* lse_s = dos + kTile * (W + 1);  // kTile
  float* delta_s = lse_s + kTile;        // kTile
  int* qid_s = reinterpret_cast<int*>(delta_s + kTile);  // kTile (kSeg)

  const int bh = blockIdx.x;
  const int c0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int offset = sk - sq;
  const size_t qbase = static_cast<size_t>(bh) * sq;
  const size_t kbase = static_cast<size_t>(bh) * sk;
  const T* qb = q + qbase * d;
  const T* dob = dout + qbase * d;
  const uint32_t bh_key = dropout_bh_key(dr, bh);

  stage<T, W, kDyn>(ks, W, k + kbase * d, c0, kRows, sk, d);
  stage<T, W, kDyn>(vs, W, v + kbase * d, c0, kRows, sk, d);

  float dk_acc[kPerWarp][kDPL], dv_acc[kPerWarp][kDPL];
  int kid[kPerWarp];  // the owned keys' ids (kSeg)
  const int* q_ids = kSeg ? seg_row(seg.q, seg.heads, bh, sq) : nullptr;
#pragma unroll
  for (int kk = 0; kk < kPerWarp; ++kk) {
    if (kSeg) {
      const int col = c0 + kk * kWarps + warp;
      kid[kk] = col < sk ? seg_row(seg.kv, seg.heads, bh, sk)[col] : 0;
    }
#pragma unroll
    for (int dd = 0; dd < kDPL; ++dd) dk_acc[kk][dd] = dv_acc[kk][dd] = 0.f;
  }

  // rows before c0 - offset see none of this tile's keys
  int i_begin = 0;
  if (causal) i_begin = max(0, c0 - offset) / kTile * kTile;

  for (int i0 = i_begin; i0 < sq; i0 += kTile) {
    __syncthreads();  // the previous tile is consumed; k and v are staged
    stage<T, W, kDyn>(qs, W + 1, qb, i0, kTile, sq, d);
    stage<T, W, kDyn>(dos, W + 1, dob, i0, kTile, sq, d);
    if (threadIdx.x < kTile) {
      const int row = i0 + threadIdx.x;
      lse_s[threadIdx.x] = row < sq ? lse[qbase + row] : CUDART_INF_F;
      delta_s[threadIdx.x] = row < sq ? delta[qbase + row] : 0.f;
      if (kSeg) qid_s[threadIdx.x] = row < sq ? q_ids[row] : 0;
    }
    __syncthreads();
    const int row = i0 + lane;
    const float row_lse = lse_s[lane];
    const float row_delta = delta_s[lane];
    const float* qr = qs + lane * (W + 1);
    const float* dor = dos + lane * (W + 1);
#pragma unroll
    for (int kk = 0; kk < kPerWarp; ++kk) {
      const int c = kk * kWarps + warp;  // interleaved: balances causal work
      const int col = c0 + c;
      // both conditions are uniform across the warp
      if (col >= sk) continue;
      if (causal && col > i0 + kTile - 1 + offset) continue;
      float s = dot<W>(qr, ks + c * W) * scale;
      if (bias.p != nullptr && row < sq) s += bias_row(bias, bh, row)[col];
      float dp = dot<W>(dor, vs + c * W);
      bool valid = row < sq && (!causal || col <= row + offset);
      if (kSeg) valid = valid && qid_s[lane] == kid[kk];
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
        const float* qi = qs + i * (W + 1) + lane;
        const float* doi = dos + i * (W + 1) + lane;
#pragma unroll
        for (int dd = 0; dd < kDPL; ++dd) {
          if (!lane_dim<W, kDyn>(lane, dd, d)) continue;
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
    T* dkr = dk + (kbase + col) * d;
    T* dvr = dv + (kbase + col) * d;
#pragma unroll
    for (int dd = 0; dd < kDPL; ++dd) {
      if (!lane_dim<W, kDyn>(lane, dd, d)) continue;
      store_as(dkr + lane + dd * 32, dk_acc[kk][dd]);
      store_as(dvr + lane + dd * 32, dv_acc[kk][dd]);
    }
  }
}

// ---------------------------------------------------------------------------
// flash_bwd_dkv's bf16 tensor-core body
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBN = 64;  // keys a block
constexpr int kBM = 64;  // q rows a streamed tile
static_assert(kBM == mma::kIdTile && kBN == mma::kIdTile,
              "the id ranges are per 64-position tile");

// Warps a block: four own 16 keys each, and past width 80 each key group
// has two warps, each holding half of dK's and dV's columns (two 16 x 128
// fp32 accumulators would not fit a warp's registers): both compute the
// group's transposed scores, each its half of the two products after them
// (at W 112 a half is 56 columns: two 8-wide n tiles at a time, then one).
// At width 80 one warp holds both 16 x 80 accumulators beside 16-row
// score tiles, and no score is computed twice (split, width 80 ran no
// faster than width 96)
template <int W>
__host__ __device__ constexpr int d_split() { return W > 80 ? 2 : 1; }

template <int W>
__host__ __device__ constexpr int dkv_threads() { return 128 * d_split<W>(); }

// K and V, two stages of the q and do tiles (padded rows), and two stages
// of the q tile's lse, delta, query ids and q and do row norms
template <int W>
constexpr size_t dkv_smem_bytes() {
  return sizeof(bf16) * (2 * kBN + 4 * kBM) * mma::ld<W>() +
         sizeof(float) * 2 * 5 * kBM;
}

// Exact rounding of P_eff and dS: csrc/rounding.cuh (kFixP and the
// flagged-score pass), shared with the dq body
using namespace rounding;

template <int W, bool kDyn, bool kSeg, bool kDbias>
__global__ void __launch_bounds__(dkv_threads<W>())
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ q_norm,
                         const float* __restrict__ do_norm,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int sq,
                         int sk, int d, int causal, float scale,
                         ScoreBias bias, Segments seg,
                         const int* __restrict__ q_rng,
                         const int* __restrict__ kv_rng, Dropout dr,
                         float* __restrict__ db_part) {
  constexpr int kThreads = dkv_threads<W>();
  constexpr int kLd = mma::ld<W>();
  constexpr int kKC = W / 16;  // k chunks of K Q^T and V dO^T
  constexpr int kDW = W / d_split<W>();  // dK and dV columns a warp holds
  constexpr int kDT = kDW / 8;  // their 8-wide n tiles
  // q rows a warp takes at once: past width 64 a quarter of the tile, so
  // the transposed scores' registers fit beside the accumulators; with the
  // fold at width 64 half of it, for the fold's registers (the same rows
  // go into dK and dV in the same order, so neither moves by a bit)
  constexpr int kRS = W > 64 ? 16 : (kDbias && W == 64 ? 32 : 64);
  if constexpr (!kDyn) d = W;
  constexpr int kRT = kRS / 8;  // 8-wide n tiles of the transposed scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // kBN x kLd
  bf16* vs = ks + kBN * kLd;                     // kBN x kLd
  bf16* qs = vs + kBN * kLd;                     // 2 stages of kBM x kLd
  bf16* dos = qs + 2 * kBM * kLd;                // 2 stages of kBM x kLd
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kBM * kLd);  // 2 x kBM
  float* delta_s = lse_s + 2 * kBM;                              // 2 x kBM
  int* qid_s = reinterpret_cast<int*>(delta_s + 2 * kBM);        // 2 x kBM
  float* qn_s = reinterpret_cast<float*>(qid_s + 2 * kBM);       // 2 x kBM
  float* dn_s = qn_s + 2 * kBM;                                  // 2 x kBM

  const int bh = blockIdx.x;
  const int kv_tile = blockIdx.y;  // the first key tiles see the most rows
  const int c0 = kv_tile * kBN;
  const int warp = threadIdx.x / 32 % 4;  // the warp's key group
  const int d0 = threadIdx.x / 128 * kDW;  // its first dK/dV column
  const int lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int w0 = c0 + warp * 16;  // the warp's first key
  const int keys[2] = {w0 + (lane >> 2), w0 + (lane >> 2) + 8};
  const int offset = sk - sq;
  const size_t qbase = static_cast<size_t>(bh) * sq;
  const size_t kbase = static_cast<size_t>(bh) * sk;
  const bf16* qb = q + qbase * d;
  const bf16* dob = dout + qbase * d;
  const uint32_t bh_key = dropout_bh_key(dr, bh);

  const int n_tiles = (sq + kBM - 1) / kBM;
  // rows before c0 - offset see none of this tile's keys
  const int first = causal ? max(0, c0 - offset) / kBM : 0;
  const int* qr = nullptr;
  const int* kr = nullptr;
  const int* q_ids = nullptr;
  if (kSeg) {
    const size_t b = bh / seg.heads;
    qr = q_rng + b * n_tiles * 2;
    kr = kv_rng + b * ((sk + kBN - 1) / kBN) * 2;
    q_ids = seg_row(seg.q, seg.heads, bh, sq);
  }
  // the first q tile at or after i whose ids can meet the key tile's
  auto next_tile = [&](int i) {
    if (kSeg)
      while (i < n_tiles && !mma::tiles_meet(qr, i, kr, kv_tile)) ++i;
    return i;
  };
  auto stage_q = [&](int i, int st) {
    mma::stage_tile<W, kThreads, kDyn>(qs + st * kBM * kLd, qb, i * kBM, sq,
                                       d);
    mma::stage_tile<W, kThreads, kDyn>(dos + st * kBM * kLd, dob, i * kBM,
                                       sq, d);
    if (threadIdx.x < kBM) {
      // rows past sq read as 0: the masks zero their scores
      const int row = i * kBM + threadIdx.x;
      const bool in = row < sq;
      const size_t g = qbase + (in ? row : 0);
      mma::cp_async_4(lse_s + st * kBM + threadIdx.x, lse + g, in);
      mma::cp_async_4(delta_s + st * kBM + threadIdx.x, delta + g, in);
      mma::cp_async_4(qn_s + st * kBM + threadIdx.x, q_norm + g, in);
      mma::cp_async_4(dn_s + st * kBM + threadIdx.x, do_norm + g, in);
      if (kSeg)
        mma::cp_async_4(qid_s + st * kBM + threadIdx.x,
                        q_ids + (in ? row : 0), in);
    }
  };

  mma::stage_tile<W, kThreads, kDyn>(ks, k + kbase * d, c0, sk, d);
  mma::stage_tile<W, kThreads, kDyn>(vs, v + kbase * d, c0, sk, d);
  mma::cp_async_commit();
  int i = next_tile(first);
  if (i < n_tiles) stage_q(i, 0);
  mma::cp_async_commit();

  int kid[2] = {0, 0};       // the keys' ids (kSeg)
  float kbias[2] = {0.f, 0.f};  // a bias without query rows, per key
  const float* bias0 = bias.p != nullptr ? bias_row(bias, bh, 0) : nullptr;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= sk) continue;
    if (kSeg) kid[r] = seg_row(seg.kv, seg.heads, bh, sk)[keys[r]];
    if (bias0 != nullptr && bias.sr == 0) kbias[r] = bias0[keys[r]];
  }
  // kDbias: what a flip of a score's S scale + bias moves p by, per unit p
  // (about an ulp of the key's bias: rounding.cuh, kFoldFlip)
  const float kulp[2] = {fp32_ulp(kbias[0]), fp32_ulp(kbias[1])};
  mma::cp_async_wait<1>();  // K and V
  __syncthreads();
  float kn[2], vn[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kl = warp * 16 + (lane >> 2) + 8 * r;
    // the bound on the S (times scale) and dP_eff sums' error, per unit
    // norm of the q or do row (kFixKappa)
    kn[r] = kFixKappa * scale * row_norm<W>(ks + kl * kLd);
    vn[r] = kFixKappa * (dr.on ? dr.inv_keep : 1.f) *
            row_norm<W>(vs + kl * kLd);
  }
  float dk_acc[kDT][4], dv_acc[kDT][4];
#pragma unroll
  for (int dn = 0; dn < kDT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dn][e] = dv_acc[dn][e] = 0.f;
  float db_acc[2] = {0.f, 0.f};  // kDbias: the lane's share of its keys' sums

  int st = 0;
  while (i < n_tiles) {
    const int in = next_tile(i + 1);
    if (in < n_tiles) stage_q(in, st ^ 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // K, V and q tile i
    __syncthreads();
    const int i0 = i * kBM;
    const bf16* qt = qs + st * kBM * kLd;
    const bf16* dot = dos + st * kBM * kLd;
    const float* ls = lse_s + st * kBM;
    const float* dl = delta_s + st * kBM;
    const int* qi = qid_s + st * kBM;
    const float* qn = qn_s + st * kBM;
    const float* dn = dn_s + st * kBM;
#pragma unroll
    for (int r0 = 0; r0 < kBM; r0 += kRS) {
      // uniform across the warp: keys past sk, or rows that see none of
      // the warp's keys
      const bool live =
          w0 < sk && !(causal && i0 + r0 + kRS - 1 + offset < w0);
      if (!live) continue;
      float s[kRT][4], dp[kRT][4];
#pragma unroll
      for (int nt = 0; nt < kRT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      // S^T = K Q^T and dP^T = V dO^T over this warp's 16 keys. Each
      // 16-wide k chunk goes into a fresh accumulator, added to the sum
      // with a rounded fp32 add: the tensor cores truncate a product's sum
      // into its accumulator, and across the chunks that bias moves p and
      // dp far enough from the plain version's fp32 sums to flip their
      // bf16 roundings (P_eff, dS) several times as often
#pragma unroll
      for (int kc = 0; kc < kKC; ++kc) {
        uint32_t ak[4], av[4];
        mma::ldmatrix_x4(ak, mma::frag_a_ptr<W>(ks, warp * 16, kc * 16,
                                                lane));
        mma::ldmatrix_x4(av, mma::frag_a_ptr<W>(vs, warp * 16, kc * 16,
                                                lane));
#pragma unroll
        for (int np = 0; np < kRT / 2; ++np) {
          uint32_t b[4];
          float c[4][4] = {};
          mma::ldmatrix_x4(b, mma::frag_bt_ptr<W>(qt, r0 + np * 16,
                                                  kc * 16, lane));
          mma::mma_16816(c[0], ak, b[0], b[1]);
          mma::mma_16816(c[1], ak, b[2], b[3]);
          mma::ldmatrix_x4(b, mma::frag_bt_ptr<W>(dot, r0 + np * 16,
                                                  kc * 16, lane));
          mma::mma_16816(c[2], av, b[0], b[1]);
          mma::mma_16816(c[3], av, b[2], b[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[2 * np][e] += c[0][e];
            s[2 * np + 1][e] += c[1][e];
            dp[2 * np][e] += c[2][e];
            dp[2 * np + 1][e] += c[3][e];
          }
        }
      }
      // masks are needed on the sq and sk edges, on the diagonal and with
      // ids
      const bool edge = i0 + r0 + kRS > sq || w0 + 16 > sk ||
                        (causal && w0 + 15 > i0 + r0 + offset) || kSeg;
      // element (nt, e): key keys[e / 2], q row i0 + r0 + 8 nt + 2 t + e % 2
      // bits of the elements whose S sum is taken again (fix), of those
      // whose dP sum is too (fix_dp), and (kDbias) of those whose dS the
      // fold takes again (fold)
      uint32_t fix = 0, fix_dp = 0, fold = 0;
#pragma unroll
      for (int nt = 0; nt < kRT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = keys[e >> 1];
          const int rl = r0 + nt * 8 + 2 * t + (e & 1);
          const int row = i0 + rl;
          bool valid = true;
          if (edge) {
            valid = row < sq && key < sk && (!causal || key <= row + offset);
            if (kSeg) valid = valid && kid[e >> 1] == qi[rl];
          }
          float p_eff = 0.f, ds = 0.f;
          if (valid) {
            const bool keep =
                !dr.on || dropout_keep(bh_key, row, key, dr.thresh);
            const float bv =
                bias0 == nullptr ? 0.f
                : bias.sr == 0   ? kbias[e >> 1]
                                 : bias0[static_cast<size_t>(row) * bias.sr +
                                         key];
            const Score sc = score_chain<false>(
                s[nt][e], dp[nt][e], scale, bias0 != nullptr, bv, ls[rl],
                dl[rl], dr, keep);
            p_eff = sc.p_eff;
            ds = sc.ds;
            if (sc.p > kFixP) {
              const float qk = qn[rl] * kn[e >> 1];
              const uint32_t bit = 1u << (nt * 4 + e);
              // dS uncertain: both sums; else P_eff uncertain: S alone (dS
              // then rounds to the plain version's bf16 value already)
              if (ds_uncertain(sc, qk, dn[rl] * vn[e >> 1])) fix_dp |= bit;
              if ((fix_dp & bit) || p_eff_uncertain(sc, qk)) fix |= bit;
              if constexpr (kDbias) {
                // the fold's fp32 dS: taken again where S scale + bias may
                // round off the plain version's (rounding.cuh, kFoldFlip)
                const float x1 = __fmul_rn(s[nt][e], scale);
                if (sc.p * kulp[e >> 1] >= kFoldFlip &&
                    bias_sum_uncertain(x1, bv,
                                       kFoldKappa / kFixKappa * qk +
                                           0.5f * kFixU * fabsf(x1)))
                  fold |= bit;
              }
            }
          }
          s[nt][e] = p_eff;
          dp[nt][e] = ds;
        }
      }
      // the rare scores near a bf16 rounding point: the sums and the chain
      // as the plain version takes them (see kFixP), one at a time; with
      // the fold, also the scores whose fp32 dS it takes again (fold), both
      // sums each, whose exact dS goes to the fold's sum alone: dK and dV
      // are made of the same values as without the fold
      fold &= ~fix_dp;
      for_each_bit(fix | fold, [&](int pos) {
        const int hi = pos >> 1 & 1;  // key g + 8
        const int key = hi ? keys[1] : keys[0];
        const int kl = warp * 16 + (lane >> 2) + 8 * hi;
        const int rl = r0 + (pos >> 2) * 8 + 2 * t + (pos & 1);
        const int row = i0 + rl;
        const bool keep =
            !dr.on || dropout_keep(bh_key, row, key, dr.thresh);
        const float bv =
            bias0 == nullptr ? 0.f
            : bias.sr == 0   ? (hi ? kbias[1] : kbias[0])
                             : bias0[static_cast<size_t>(row) * bias.sr +
                                     key];
        const bool with_dp = ((fix_dp | fold) >> pos) & 1u;
        const Score sc = score_chain<true>(
            fma_chain<W>(qt + rl * kLd, ks + kl * kLd),
            with_dp ? fma_chain<W>(dot + rl * kLd, vs + kl * kLd) : 0.f,
            scale, bias0 != nullptr, bv, ls[rl], dl[rl], dr, keep);
        if (!kDbias || ((fix >> pos) & 1u)) set_elem(s, pos, sc.p_eff);
        if ((fix_dp >> pos) & 1u) {
          set_elem(dp, pos, sc.ds);
        } else if (kDbias && ((fold >> pos) & 1u)) {
          // the fold's correction of the dS that dK is made of
          const float fix_ds = sc.ds - get_elem(dp, pos);
          if (hi)
            db_acc[1] += fix_ds;
          else
            db_acc[0] += fix_ds;
        }
      });
      if constexpr (kDbias) {
        // the bias's gradient: the unrounded dS of the lane's two keys, in
        // the order q tile, r0, then the fold's corrections in bit order
        // (above), then the dS in the order nt, e % 2 (masked scores hold
        // 0)
#pragma unroll
        for (int nt = 0; nt < kRT; ++nt) {
          db_acc[0] += dp[nt][0];
          db_acc[0] += dp[nt][1];
          db_acc[1] += dp[nt][2];
          db_acc[1] += dp[nt][3];
        }
      }
      // dV += P_eff^T dO and dK += dS^T Q: the fragments (rounded to
      // bf16) as A operands, do and q as B through ldmatrix.trans
#pragma unroll
      for (int kc = 0; kc < kRS / 16; ++kc) {
        uint32_t ap[4], as[4];
        mma::pack_a(ap, s[2 * kc], s[2 * kc + 1]);
        mma::pack_a(as, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
        for (int dn = 0; dn < kDW / 16; ++dn) {
          uint32_t b[4];
          mma::ldmatrix_x4_trans(b, mma::frag_a_ptr<W>(
                                        dot, r0 + kc * 16, d0 + dn * 16,
                                        lane));
          mma::mma_16816(dv_acc[2 * dn], ap, b[0], b[1]);
          mma::mma_16816(dv_acc[2 * dn + 1], ap, b[2], b[3]);
          mma::ldmatrix_x4_trans(b, mma::frag_a_ptr<W>(
                                        qt, r0 + kc * 16, d0 + dn * 16,
                                        lane));
          mma::mma_16816(dk_acc[2 * dn], as, b[0], b[1]);
          mma::mma_16816(dk_acc[2 * dn + 1], as, b[2], b[3]);
        }
        if constexpr (kDW % 16 != 0) {
          // the last 8-wide n tile of a half of 40 or 56 columns
          constexpr int dn = kDW / 16;
          uint32_t b[2];
          mma::ldmatrix_x2_trans(b, mma::frag_a_ptr<W>(
                                        dot, r0 + kc * 16, d0 + dn * 16,
                                        lane));
          mma::mma_16816(dv_acc[2 * dn], ap, b[0], b[1]);
          mma::ldmatrix_x2_trans(b, mma::frag_a_ptr<W>(
                                        qt, r0 + kc * 16, d0 + dn * 16,
                                        lane));
          mma::mma_16816(dk_acc[2 * dn], as, b[0], b[1]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before its refill
    i = in;
    st ^= 1;
  }
  mma::cp_async_wait<0>();

  if constexpr (kDbias) {
    // the four lanes of a key (t = 0..3) combine in a fixed order, and one
    // writes the key's partial; past width 80 both warps of a key group
    // hold the same sums, and the one with d0 == 0 writes. A key no q tile
    // reached writes 0
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = db_acc[r];
      sum += __shfl_xor_sync(kFullMask, sum, 1);
      sum += __shfl_xor_sync(kFullMask, sum, 2);
      if (t == 0 && d0 == 0 && keys[r] < sk) db_part[kbase + keys[r]] = sum;
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = keys[r];
    if (key >= sk) continue;
    bf16* dkr = dk + (kbase + key) * d + d0 + 2 * t;
    bf16* dvr = dv + (kbase + key) * d + d0 + 2 * t;
#pragma unroll
    for (int dn = 0; dn < kDT; ++dn) {
      if (kDyn && d0 + dn * 8 >= d) continue;  // the first d columns
      *reinterpret_cast<__nv_bfloat162*>(dkr + dn * 8) = __floats2bfloat162_rn(
          dk_acc[dn][2 * r] * scale, dk_acc[dn][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvr + dn * 8) = __floats2bfloat162_rn(
          dv_acc[dn][2 * r], dv_acc[dn][2 * r + 1]);
    }
  }
}

template <int W, bool kDyn, bool kSeg, bool kDbias>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* q_norm, const void* do_norm,
                       void* dk, void* dv, int n, int sq, int sk, int d,
                       int causal, float scale, ScoreBias bias, Segments seg,
                       const int* q_rng, const int* kv_rng, Dropout dr,
                       float* db_part, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<W>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_mma_kernel<W, kDyn, kSeg, kDbias>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n, (sk + kBN - 1) / kBN);
  constexpr int threads = dkv_threads<W>();
  flash_bwd_dkv_mma_kernel<W, kDyn, kSeg, kDbias>
      <<<grid, threads, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<const float*>(q_norm),
          static_cast<const float*>(do_norm), static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), sq, sk, d, causal, scale, bias, seg, q_rng,
          kv_rng, dr, db_part);
  return cudaGetLastError();
}

template <int W, bool kDyn, bool kSeg>
cudaError_t launch_dkv_fold(bool fold, const void* q, const void* k,
                            const void* v, const void* dout, const void* lse,
                            const void* delta, const void* q_norm,
                            const void* do_norm, void* dk, void* dv, int n,
                            int sq, int sk, int d, int causal, float scale,
                            ScoreBias bias, Segments seg, const int* q_rng,
                            const int* kv_rng, Dropout dr, float* db_part,
                            cudaStream_t stream) {
  return (fold ? launch_dkv<W, kDyn, kSeg, true>
               : launch_dkv<W, kDyn, kSeg, false>)(
      q, k, v, dout, lse, delta, q_norm, do_norm, dk, dv, n, sq, sk, d,
      causal, scale, bias, seg, q_rng, kv_rng, dr, db_part, stream);
}

// ---------------------------------------------------------------------------
// flash_bwd_dq's bf16 tensor-core body
// ---------------------------------------------------------------------------

constexpr int kDqThreads = 128;  // 4 warps of 16 q rows

// the q and do tiles, two stages of K and V (padded rows), and two stages
// of the key tile's ids and of its K and V row norms (fp32)
template <int W>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * (2 * kBM + 4 * kBN) * mma::ld<W>() +
         sizeof(float) * 2 * 3 * kBN;
}

template <int W, bool kDyn, bool kSeg>
__global__ void __launch_bounds__(kDqThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int sq, int sk, int d,
                        int causal, float scale, ScoreBias bias, Segments seg,
                        const int* __restrict__ q_rng,
                        const int* __restrict__ kv_rng, Dropout dr,
                        unsigned long long* __restrict__ retaken) {
  constexpr int kLd = mma::ld<W>();
  constexpr int kKC = W / 16;   // k chunks of Q K^T and dO V^T
  constexpr int kDT = W / 8;    // 8-wide n tiles of dQ
  // keys a warp scores at once: half a tile past width 32, so the
  // scores' registers leave room beside the dQ accumulator for three
  // blocks an SM at width 64 (chip_smoke.py prints ptxas's count)
  constexpr int kSub = W > 32 ? 32 : kBN;
  if constexpr (!kDyn) d = W;
  constexpr int kST = kSub / 8;  // 8-wide n tiles of S and dP
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kBM x kLd
  bf16* dos = qs + kBM * kLd;                    // kBM x kLd
  bf16* ks = dos + kBM * kLd;                    // 2 stages of kBN x kLd
  bf16* vs = ks + 2 * kBN * kLd;                 // 2 stages of kBN x kLd
  int* kid_s = reinterpret_cast<int*>(vs + 2 * kBN * kLd);  // 2 x kBN
  float* kn_s = reinterpret_cast<float*>(kid_s + 2 * kBN);  // 2 x kBN
  float* vn_s = kn_s + 2 * kBN;                              // 2 x kBN

  const int bh = blockIdx.x;
  const int q_tile = gridDim.y - 1 - blockIdx.y;  // heaviest first
  const int q0 = q_tile * kBM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int w0 = q0 + warp * 16;  // the warp's first row
  const int rows[2] = {w0 + (lane >> 2), w0 + (lane >> 2) + 8};
  const int offset = sk - sq;  // causal: col <= row + offset is visible
  const size_t qbase = static_cast<size_t>(bh) * sq;
  const bf16* kb = k + static_cast<size_t>(bh) * sk * d;
  const bf16* vb = v + static_cast<size_t>(bh) * sk * d;
  const uint32_t bh_key = dropout_bh_key(dr, bh);

  // keys past kv_end are above the diagonal for every row of the tile
  int kv_end = sk;
  if (causal) kv_end = min(sk, q0 + kBM + offset);
  const int n_tiles = kv_end > 0 ? (kv_end + kBN - 1) / kBN : 0;
  const int* qr = nullptr;
  const int* kr = nullptr;
  const int* kv_ids = nullptr;
  if (kSeg) {
    const size_t b = bh / seg.heads;
    qr = q_rng + b * ((sq + kBM - 1) / kBM) * 2;
    kr = kv_rng + b * ((sk + kBN - 1) / kBN) * 2;
    kv_ids = seg_row(seg.kv, seg.heads, bh, sk);
  }
  // the first key tile at or after j whose ids can meet the q tile's
  auto next_tile = [&](int j) {
    if (kSeg)
      while (j < n_tiles && !mma::tiles_meet(qr, q_tile, kr, j)) ++j;
    return j;
  };
  auto stage_kv = [&](int j, int st) {
    mma::stage_tile<W, kDqThreads, kDyn>(ks + st * kBN * kLd, kb, j * kBN,
                                         sk, d);
    mma::stage_tile<W, kDqThreads, kDyn>(vs + st * kBN * kLd, vb, j * kBN,
                                         sk, d);
    if (kSeg && threadIdx.x < kBN) {
      const int col = j * kBN + threadIdx.x;
      const bool in = col < sk;
      mma::cp_async_4(kid_s + st * kBN + threadIdx.x, kv_ids + (in ? col : 0),
                      in);
    }
  };
  // the bounds' per-key factors of a staged tile (rounding.cuh): thread i
  // takes key i % 64 of K (i < 64) or of V
  auto tile_norms = [&](int st) {
    const int key = threadIdx.x % kBN;
    if (threadIdx.x < kBN)
      kn_s[st * kBN + key] =
          kFixKappa * scale * row_norm<W>(ks + (st * kBN + key) * kLd);
    else
      vn_s[st * kBN + key] = kFixKappa * (dr.on ? dr.inv_keep : 1.f) *
                             row_norm<W>(vs + (st * kBN + key) * kLd);
  };

  mma::stage_tile<W, kDqThreads, kDyn>(qs, q + qbase * d, q0, sq, d);
  mma::stage_tile<W, kDqThreads, kDyn>(dos, dout + qbase * d, q0, sq, d);
  mma::cp_async_commit();
  int j = next_tile(0);
  if (j < n_tiles) stage_kv(j, 0);
  mma::cp_async_commit();

  // the rows' lse, delta, query ids and bias row (that of rows[1] is 8
  // rows on); rows past sq read lse +inf, so nothing of theirs is ever
  // nonzero, and their bias is never read
  float row_lse[2] = {CUDART_INF_F, CUDART_INF_F};
  float row_delta[2] = {0.f, 0.f};
  int qid[2] = {0, 0};
  const float* brow =
      bias.p != nullptr && rows[0] < sq ? bias_row(bias, bh, rows[0])
                                        : nullptr;
  const int brow_hi = 8 * bias.sr;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= sq) continue;
    row_lse[r] = lse[qbase + rows[r]];
    row_delta[r] = delta[qbase + rows[r]];
    if (kSeg) qid[r] = seg_row(seg.q, seg.heads, bh, sq)[rows[r]];
  }
  float acc[kDT][4];
#pragma unroll
  for (int dn = 0; dn < kDT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  mma::cp_async_wait<0>();  // q, do and the first key tile
  __syncthreads();
  float qn[2], don[2];  // the rows' q and do norms
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rl = warp * 16 + (lane >> 2) + 8 * r;
    qn[r] = row_norm<W>(qs + rl * kLd);
    don[r] = row_norm<W>(dos + rl * kLd);
  }
  if (j < n_tiles) tile_norms(0);

  int st = 0;
  while (j < n_tiles) {
    const int jn = next_tile(j + 1);
    // stage st ^ 1 was last read before the previous iteration's closing
    // barrier
    if (jn < n_tiles) stage_kv(jn, st ^ 1);
    mma::cp_async_commit();
    __syncthreads();  // tile j's norms are written
    const int j0 = j * kBN;
    // uniform across the warp: rows past sq, or every row above the tile
    const bool live = w0 < sq && !(causal && j0 > w0 + 15 + offset);
    if (live) {
      const bf16* kt = ks + st * kBN * kLd;
      const bf16* vt = vs + st * kBN * kLd;
      // the tile's keys in sub-tiles of kSub
#pragma unroll
      for (int k0 = 0; k0 < kBN; k0 += kSub) {
        const int* kid = kid_s + st * kBN + k0;
        const float* kn = kn_s + st * kBN + k0;
        const float* vn = vn_s + st * kBN + k0;
        const bf16* kst = kt + k0 * kLd;
        const bf16* vst = vt + k0 * kLd;
        const int c0 = j0 + k0;  // the sub-tile's first key
        // uniform across the warp: keys past sk, or above every row
        if (c0 >= sk || (causal && c0 > w0 + 15 + offset)) continue;
        // S = Q K^T and dP = dO V^T, each 16-wide k chunk into a fresh
        // accumulator added to the sum with a rounded fp32 add (the tensor
        // cores truncate a sum into its accumulator; chunk by chunk that
        // bias would pile up, and move dS further from the plain version's)
        float s[kST][4], dp[kST][4];
#pragma unroll
        for (int nt = 0; nt < kST; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
        for (int kc = 0; kc < kKC; ++kc) {
          uint32_t aq[4], ad[4];
          mma::ldmatrix_x4(aq, mma::frag_a_ptr<W>(qs, warp * 16, kc * 16,
                                                  lane));
          mma::ldmatrix_x4(ad, mma::frag_a_ptr<W>(dos, warp * 16, kc * 16,
                                                  lane));
#pragma unroll
          for (int np = 0; np < kST / 2; ++np) {
            uint32_t b[4];
            float c[2][4] = {};
            mma::ldmatrix_x4(b, mma::frag_bt_ptr<W>(kst, np * 16, kc * 16,
                                                    lane));
            mma::mma_16816(c[0], aq, b[0], b[1]);
            mma::mma_16816(c[1], aq, b[2], b[3]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[2 * np][e] += c[0][e];
              s[2 * np + 1][e] += c[1][e];
              c[0][e] = c[1][e] = 0.f;
            }
            mma::ldmatrix_x4(b, mma::frag_bt_ptr<W>(vst, np * 16, kc * 16,
                                                    lane));
            mma::mma_16816(c[0], ad, b[0], b[1]);
            mma::mma_16816(c[1], ad, b[2], b[3]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dp[2 * np][e] += c[0][e];
              dp[2 * np + 1][e] += c[1][e];
            }
          }
        }
        // masks are needed on the sq and sk edges, on the diagonal and with
        // ids
        const bool edge = w0 + 16 > sq || c0 + kSub > sk ||
                          (causal && c0 + kSub - 1 > w0 + offset) || kSeg;
        // element (nt, e): row rows[e / 2], key c0 + 8 nt + 2 t + e % 2;
        // the bits of the elements whose sums are taken again
        uint32_t fix = 0;
#pragma unroll
        for (int nt = 0; nt < kST; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const int row = rows[r];
            const int cl = nt * 8 + 2 * t + (e & 1);
            const int col = c0 + cl;
            bool valid = true;
            if (edge) {
              valid =
                  row < sq && col < sk && (!causal || col <= row + offset);
              if (kSeg) valid = valid && qid[r] == kid[cl];
            }
            float ds = 0.f;
            if (valid) {
              const bool keep =
                  !dr.on || dropout_keep(bh_key, row, col, dr.thresh);
              const Score sc = score_chain<false>(
                  s[nt][e], dp[nt][e], scale, brow != nullptr,
                  brow != nullptr ? brow[r * brow_hi + col] : 0.f,
                  row_lse[r], row_delta[r], dr, keep);
              ds = sc.ds;
              if (sc.p > kFixP &&
                  ds_uncertain(sc, qn[r] * kn[cl], don[r] * vn[cl]))
                fix |= 1u << (nt * 4 + e);
            }
            s[nt][e] = ds;
          }
        }
        // the rare scores near a bf16 rounding point: both sums and the
        // chain as the plain version takes them (rounding.cuh), one at a
        // time; the row's values by select, so no register array is
        // indexed at run time
        for_each_bit(fix, [&](int pos) {
          const bool hi = pos >> 1 & 1;  // row g + 8
          const int rl = warp * 16 + (lane >> 2) + (hi ? 8 : 0);
          const int cl = (pos >> 2) * 8 + 2 * t + (pos & 1);
          const int row = hi ? rows[1] : rows[0];
          const int col = c0 + cl;
          const bool keep =
              !dr.on || dropout_keep(bh_key, row, col, dr.thresh);
          const Score sc = score_chain<true>(
              fma_chain<W>(qs + rl * kLd, kst + cl * kLd),
              fma_chain<W>(dos + rl * kLd, vst + cl * kLd), scale,
              brow != nullptr,
              brow != nullptr ? brow[(hi ? brow_hi : 0) + col] : 0.f,
              hi ? row_lse[1] : row_lse[0], hi ? row_delta[1] : row_delta[0],
              dr, keep);
          set_elem(s, pos, sc.ds);
        });
        if (retaken != nullptr) {  // the diagnostic count (_kernels.py)
          const int n_fix = __reduce_add_sync(kFullMask, __popc(fix));
          if (lane == 0)
            atomicAdd(retaken, static_cast<unsigned long long>(n_fix));
        }
        // dQ += dS K: dS (rounded to bf16) as the A fragment, K as B
        // through ldmatrix.trans of its [key][d] tile
#pragma unroll
        for (int kc = 0; kc < kSub / 16; ++kc) {
          uint32_t a[4];
          mma::pack_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
          for (int dd = 0; dd < W / 16; ++dd) {
            uint32_t b[4];
            mma::ldmatrix_x4_trans(b, mma::frag_a_ptr<W>(kst, kc * 16,
                                                         dd * 16, lane));
            mma::mma_16816(acc[2 * dd], a, b[0], b[1]);
            mma::mma_16816(acc[2 * dd + 1], a, b[2], b[3]);
          }
        }
      }
    }
    mma::cp_async_wait<0>();  // tile jn
    __syncthreads();  // every warp is done with stage st; tile jn is in
    if (jn < n_tiles) tile_norms(st ^ 1);
    j = jn;
    st ^= 1;
  }

  // dq = scale * (dS K), the scale after the fp32 sum as the plain version
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rows[r];
    if (row >= sq) continue;
    bf16* out = dq + (qbase + row) * d + 2 * t;
#pragma unroll
    for (int dd = 0; dd < kDT; ++dd)
      if (!kDyn || dd * 8 < d)  // the first d columns
        *reinterpret_cast<__nv_bfloat162*>(out + dd * 8) =
            __floats2bfloat162_rn(acc[dd][2 * r] * scale,
                                  acc[dd][2 * r + 1] * scale);
  }
}

template <int W, bool kDyn, bool kSeg>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int n, int sq, int sk, int d, int causal,
                      float scale, ScoreBias bias, Segments seg,
                      const int* q_rng, const int* kv_rng, Dropout dr,
                      unsigned long long* retaken, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<W>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<W, kDyn, kSeg>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n, (sq + kBM - 1) / kBM);
  flash_bwd_dq_mma_kernel<W, kDyn, kSeg><<<grid, kDqThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), sq, sk, d, causal, scale, bias, seg, q_rng,
      kv_rng, dr, retaken);
  return cudaGetLastError();
}

}  // namespace tc

struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int n, sq, sk, d, causal;
  float scale;
  ScoreBias bias;
  Segments seg;
  Dropout dr;
  const int* q_rng;   // the ids' tile ranges (bf16 only)
  const int* kv_rng;
  const void* q_norm;  // q and do row norms, fp32 (n, sq) (bf16 dkv only)
  const void* do_norm;
  unsigned long long* retaken;  // bf16 dq: scores re-taken, or null
  float* db_part;  // bf16 dkv: the folded dbias's (n, sk) partials, or null
};

template <typename T, int W, bool kDyn, bool kSeg>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<W, kSeg>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, W, kDyn, kSeg>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n, (a.sq + kRows - 1) / kRows);
  flash_bwd_dq_kernel<T, W, kDyn, kSeg><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dq), a.sq, a.sk, a.d, a.causal, a.scale, a.bias,
      a.seg, a.dr);
  return cudaGetLastError();
}

template <typename T, int W, bool kDyn, bool kSeg>
cudaError_t launch_dkv(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<W, kSeg>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, W, kDyn, kSeg>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n, (a.sk + kRows - 1) / kRows);
  flash_bwd_dkv_kernel<T, W, kDyn, kSeg><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq, a.sk, a.d,
      a.causal, a.scale, a.bias, a.seg, a.dr);
  return cudaGetLastError();
}

// bf16 takes the tensor-core bodies, fp32 the SIMT bodies
template <bool kDq, typename T, int W, bool kDyn>
cudaError_t launch_kind(const BwdArgs& a, cudaStream_t st) {
  const bool seg = a.seg.q != nullptr;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (kDq && kBf16) {
    if (seg && (a.q_rng == nullptr || a.kv_rng == nullptr))
      return cudaErrorInvalidValue;
    return (seg ? tc::launch_dq<W, kDyn, true>
                : tc::launch_dq<W, kDyn, false>)(
        a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, a.n, a.sq, a.sk, a.d,
        a.causal, a.scale, a.bias, a.seg, a.q_rng, a.kv_rng, a.dr,
        a.retaken, st);
  } else if constexpr (kDq) {
    return seg ? launch_dq<T, W, kDyn, true>(a, st)
               : launch_dq<T, W, kDyn, false>(a, st);
  } else if constexpr (kBf16) {
    const bool fold = a.db_part != nullptr;
    // the fold takes a bias without query rows (row stride 0)
    if ((seg && (a.q_rng == nullptr || a.kv_rng == nullptr)) ||
        a.q_norm == nullptr || a.do_norm == nullptr ||
        (fold && (a.bias.p == nullptr || a.bias.sr != 0)))
      return cudaErrorInvalidValue;
    return (seg ? tc::launch_dkv_fold<W, kDyn, true>
                : tc::launch_dkv_fold<W, kDyn, false>)(
        fold, a.q, a.k, a.v, a.dout, a.lse, a.delta, a.q_norm, a.do_norm,
        a.dk, a.dv, a.n, a.sq, a.sk, a.d, a.causal, a.scale, a.bias, a.seg,
        a.q_rng, a.kv_rng, a.dr, a.db_part, st);
  } else {
    if (a.db_part != nullptr) return cudaErrorInvalidValue;  // bf16 only
    return seg ? launch_dkv<T, W, kDyn, true>(a, st)
               : launch_dkv<T, W, kDyn, false>(a, st);
  }
}

template <bool kDq, typename T>
cudaError_t launch_d(const BwdArgs& a, int w, cudaStream_t st) {
  return width::dispatch(a.d, w, [&](auto wc, auto dyn) {
    return launch_kind<kDq, T, decltype(wc)::value, decltype(dyn)::value>(
        a, st);
  });
}

template <bool kDq>
int dispatch(const BwdArgs& a, int w, int dtype, cudaStream_t st) {
  if (dtype == kFloat32) return launch_d<kDq, float>(a, w, st);
  if (dtype == kBFloat16) return launch_d<kDq, __nv_bfloat16>(a, w, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace apex_port

// C entry points, bound with ctypes, two a group of widths
// (flash_width.cuh: apex_flash_bwd_dq_p<group>, apex_flash_bwd_dkv_p<group>);
// d is the head dim and w its body width (_kernels.py::flash_width), which
// the group must hold. dtype: 0 fp32, 1 bf16 (q, k, v, do and
// the outputs share it; lse and delta are fp32; bf16 needs q, k, v and do
// 16-byte aligned, and bf16 dkv the fp32 (n, sq) row norms of q and do,
// `q_norm` and `do_norm`, null for fp32). The bias, the segment ids, their
// tile ranges (read by the bf16 bodies) and dropout as in apex_flash_fwd.
// dq's `retaken` is null, or a uint64 to which the bf16 body adds the
// scores its rounding pass took again (a diagnostic; dq is the same).
// dkv's `db_part` is null, or (bf16, with a bias of row stride 0) an (n, sk)
// fp32 tensor that takes each batch-head's sum of dS over the rows, per
// key: the folded dbias, before apex_flash_dbias_fold_sum. Each returns the
// cudaError_t of its launch (0 on success).
extern "C" int APEX_FLASH_ENTRY(apex_flash_bwd_dq)(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int n, int sq, int sk,
    int d, int w, int dtype, int causal, float scale, const void* bias,
    int heads, int sb, int sh, int sr, const void* q_ids, const void* kv_ids,
    int seg_heads, const void* q_rng, const void* kv_rng, int dropout,
    unsigned seed, int thresh, float inv_keep, void* retaken, void* stream) {
  using namespace apex_port;
  const BwdArgs a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, n, sq, sk,
                  d, causal, scale,
                  ScoreBias{static_cast<const float*>(bias), heads, sb, sh, sr},
                  Segments{static_cast<const int*>(q_ids),
                           static_cast<const int*>(kv_ids), seg_heads},
                  Dropout{dropout, seed, thresh, inv_keep},
                  static_cast<const int*>(q_rng),
                  static_cast<const int*>(kv_rng), nullptr, nullptr,
                  static_cast<unsigned long long*>(retaken), nullptr};
  return dispatch<true>(a, w, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int APEX_FLASH_ENTRY(apex_flash_bwd_dkv)(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int n, int sq,
    int sk, int d, int w, int dtype, int causal, float scale,
    const void* bias, int heads, int sb, int sh, int sr, const void* q_ids,
    const void* kv_ids, int seg_heads, const void* q_rng, const void* kv_rng,
    const void* q_norm, const void* do_norm, void* db_part, int dropout,
    unsigned seed, int thresh, float inv_keep, void* stream) {
  using namespace apex_port;
  const BwdArgs a{q, k, v, dout, lse, delta, nullptr, dk, dv, n, sq, sk,
                  d, causal, scale,
                  ScoreBias{static_cast<const float*>(bias), heads, sb, sh, sr},
                  Segments{static_cast<const int*>(q_ids),
                           static_cast<const int*>(kv_ids), seg_heads},
                  Dropout{dropout, seed, thresh, inv_keep},
                  static_cast<const int*>(q_rng),
                  static_cast<const int*>(kv_rng), q_norm, do_norm, nullptr,
                  static_cast<float*>(db_part)};
  return dispatch<false>(a, w, dtype, static_cast<cudaStream_t>(stream));
}
