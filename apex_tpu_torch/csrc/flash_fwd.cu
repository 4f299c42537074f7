// flash_fwd: blockwise online-softmax attention forward for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/flash_attention.py::_fwd_kernel (launched by
// _fwd_pallas). Computes O = softmax(scale * Q K^T [+ bias] [+ causal mask])
// V and the per-row logsumexp, +inf on rows with no visible key, over
// q (n, sq, d), k/v (n, sk, d) in bf16 or fp32, d in {32, 64, 128}, with an
// optional broadcast fp32 score bias (common.cuh::ScoreBias) added after
// the scale and before the masks, as the TPU kernel adds it, and optional
// packed-sequence segment ids (common.cuh::Segments) that mask a score
// whose query and key ids differ, as the causal mask masks it. A bias
// value is a finite score: only the masks make a row fully masked; with a
// (q_ids, kv_ids) pair, so does a query id that no key carries.
//
// What bounds it on the H100: at the serving prefill shape (n = 12 heads,
// sq = sk = 128, d = 64, causal) the function moves ~0.8 MB (q, k, v, o,
// lse) and needs ~25 MFLOP, so its floor is the ~0.24 us of HBM traffic;
// what actually bounds this version is latency and launch overhead, since
// one launch has only 24 blocks of work for 132 SMs.
//
// What the design does about it: the TPU kernel walks the kv blocks as a
// sequential grid axis with (m, l, acc) in VMEM scratch. Here a loop inside
// the block takes that axis: each block owns one (n, 64-row q tile), stages
// the q tile once and each 32-key k/v tile in shared memory (fp32, k rows
// padded to d + 1 floats so the per-lane score reads hit 32 distinct banks),
// and keeps the running (m, l, acc) of its rows in registers. Each warp owns
// 8 interleaved rows; for a row, lane j scores key j of the tile, the warp
// reduces max and sum with shuffles, and the P V product runs with lanes
// owning output dims and the probabilities broadcast by shuffle. Tiles
// wholly above the causal diagonal are skipped for the block and for each
// row (an exact no-op: they would leave (m, l, acc) unchanged), and each
// K/V byte is read from HBM once per q tile. Like the TPU kernel, the
// probabilities are rounded to the value dtype before the P V product and
// masked entries are zeroed explicitly. Dropout hashes the global (bh, row,
// col) of each score a lane owns, so the mask does not depend on the tiling.
// Segment ids: each streamed tile's key ids go to shared memory beside it,
// and a row's query id stays in a register; without ids (kSeg false) the
// kernel reads and compares nothing more per score. No tile is skipped for
// its ids yet (that is for a later version).
// Tensor cores (mma.sync / wgmma) and TMA staging are left for a later,
// faster version.

#include "common.cuh"

namespace apex_port {
namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 32;        // keys per k/v tile: one per lane
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kBQ / kWarps;

template <int D, bool kSeg>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (kBQ * D + kBK * (D + 1) + kBK * D) +
         (kSeg ? sizeof(int) * kBK : 0);
}

template <typename T, int D, bool kSeg>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int causal,
                 float scale, ScoreBias bias, Segments seg, Dropout dr) {
  constexpr int kDPL = D / 32;  // output dims per lane
  extern __shared__ float smem[];
  float* qs = smem;                     // kBQ x D
  float* ks = qs + kBQ * D;             // kBK x (D + 1)
  float* vs = ks + kBK * (D + 1);       // kBK x D
  int* kid = reinterpret_cast<int*>(vs + kBK * D);  // kBK key ids (kSeg)

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int offset = sk - sq;  // causal: col <= row + offset is visible
  const T* qb = q + static_cast<size_t>(bh) * sq * D;
  const T* kb = k + static_cast<size_t>(bh) * sk * D;
  const T* vb = v + static_cast<size_t>(bh) * sk * D;
  const uint32_t bh_key = dropout_bh_key(dr, bh);

  for (int i = tid; i < kBQ * D; i += kWarps * 32) {
    const int r = i / D;
    qs[i] = (q0 + r < sq) ? to_float(qb[static_cast<size_t>(q0) * D + i])
                          : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDPL];
  int qid[kRowsPerWarp];  // the rows' query ids (kSeg)
  const int* kv_ids = kSeg ? seg_row(seg.kv, seg.heads, bh, sk) : nullptr;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    if (kSeg) {
      const int row = q0 + rr * kWarps + warp;
      qid[rr] = row < sq ? seg_row(seg.q, seg.heads, bh, sq)[row] : 0;
    }
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDPL; ++dd) acc[rr][dd] = 0.f;
  }

  // keys past kv_end are above the diagonal for every row of the tile
  int kv_end = sk;
  if (causal) kv_end = min(sk, q0 + kBQ + offset);

  for (int j0 = 0; j0 < kv_end; j0 += kBK) {
    __syncthreads();  // the previous tile is consumed; the q tile is staged
    for (int i = tid; i < kBK * D; i += kWarps * 32) {
      const int r = i / D;
      const int c = i % D;
      const bool in = j0 + r < sk;
      const size_t g = static_cast<size_t>(j0 + r) * D + c;
      ks[r * (D + 1) + c] = in ? to_float(kb[g]) : 0.f;
      vs[r * D + c] = in ? to_float(vb[g]) : 0.f;
    }
    if (kSeg && tid < kBK) kid[tid] = j0 + tid < sk ? kv_ids[j0 + tid] : 0;
    __syncthreads();
    const int col = j0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = rr * kWarps + warp;  // interleaved: balances causal work
      const int row = q0 + r;
      // both conditions are uniform across the warp
      if (row >= sq) continue;
      if (causal && j0 > row + offset) continue;
      const float* qr = qs + r * D;
      const float* kr = ks + lane * (D + 1);
      float s = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) s = fmaf(qr[c], kr[c], s);
      s *= scale;
      if (bias.p != nullptr && col < sk) s += bias_row(bias, bh, row)[col];
      bool valid = col < sk && (!causal || col <= row + offset);
      if (kSeg) valid = valid && qid[rr] == kid[lane];
      s = valid ? s : kNegInf;
      const float m_new = fmaxf(m[rr], warp_max(s));
      // a row with no visible key so far has m_new == kNegInf and
      // exp(s - m_new) == 1 on masked entries: zero them explicitly
      const float p = valid ? expf(s - m_new) : 0.f;
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + warp_sum(p);
      m[rr] = m_new;
      float pd = p;
      if (dr.on)
        pd = dropout_keep(bh_key, row, col, dr.thresh) ? p * dr.inv_keep : 0.f;
      const float pr = round_to<T>(pd);
#pragma unroll
      for (int dd = 0; dd < kDPL; ++dd) acc[rr][dd] *= corr;
#pragma unroll 8
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(kFullMask, pr, j);
        const float* vr = vs + j * D + lane;
#pragma unroll
        for (int dd = 0; dd < kDPL; ++dd)
          acc[rr][dd] = fmaf(pj, vr[dd * 32], acc[rr][dd]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + rr * kWarps + warp;
    if (row >= sq) continue;
    const float safe_l = l[rr] == 0.f ? 1.f : l[rr];
    T* orow = o + (static_cast<size_t>(bh) * sq + row) * D;
#pragma unroll
    for (int dd = 0; dd < kDPL; ++dd)
      store_as(orow + lane + dd * 32, acc[rr][dd] / safe_l);
    if (lane == 0)
      lse[static_cast<size_t>(bh) * sq + row] =
          l[rr] == 0.f ? CUDART_INF_F : m[rr] + logf(safe_l);
  }
}

template <typename T, int D, bool kSeg>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int n, int sq, int sk, int causal, float scale,
                   ScoreBias bias, Segments seg, Dropout dr,
                   cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<D, kSeg>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, kSeg>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n, (sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, D, kSeg><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      sq, sk, causal, scale, bias, seg, dr);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_seg(const void* q, const void* k, const void* v, void* o,
                       void* lse, int n, int sq, int sk, int causal,
                       float scale, ScoreBias bias, Segments seg, Dropout dr,
                       cudaStream_t stream) {
  return seg.q != nullptr
             ? launch<T, D, true>(q, k, v, o, lse, n, sq, sk, causal, scale,
                                  bias, seg, dr, stream)
             : launch<T, D, false>(q, k, v, o, lse, n, sq, sk, causal, scale,
                                   bias, seg, dr, stream);
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v,
                     void* o, void* lse, int n, int sq, int sk, int causal,
                     float scale, ScoreBias bias, Segments seg, Dropout dr,
                     cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_seg<T, 32>(q, k, v, o, lse, n, sq, sk, causal, scale,
                               bias, seg, dr, stream);
    case 64:
      return launch_seg<T, 64>(q, k, v, o, lse, n, sq, sk, causal, scale,
                               bias, seg, dr, stream);
    case 128:
      return launch_seg<T, 128>(q, k, v, o, lse, n, sq, sk, causal, scale,
                                bias, seg, dr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace apex_port

// C entry point, bound with ctypes. dtype: 0 fp32, 1 bf16. `bias` is null
// or an fp32 bias read as common.cuh::ScoreBias with `heads` and the
// strides `sb`, `sh`, `sr`. `q_ids`/`kv_ids` are null or int32 segment ids
// (b, sq)/(b, sk) read as common.cuh::Segments with `seg_heads` heads per id
// row. Dropout is on iff `dropout`; then `seed`, `thresh` and `inv_keep`
// are as in common.cuh::Dropout. Returns the cudaError_t of the launch (0
// on success).
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int n, int sq, int sk,
                              int d, int dtype, int causal, float scale,
                              const void* bias, int heads, int sb, int sh,
                              int sr, const void* q_ids, const void* kv_ids,
                              int seg_heads, int dropout, unsigned seed,
                              int thresh, float inv_keep, void* stream) {
  using namespace apex_port;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ScoreBias bi{static_cast<const float*>(bias), heads, sb, sh, sr};
  const Segments sg{static_cast<const int*>(q_ids),
                    static_cast<const int*>(kv_ids), seg_heads};
  const Dropout dr{dropout, seed, thresh, inv_keep};
  if (dtype == kFloat32)
    return launch_d<float>(d, q, k, v, o, lse, n, sq, sk, causal, scale, bi,
                           sg, dr, st);
  if (dtype == kBFloat16)
    return launch_d<__nv_bfloat16>(d, q, k, v, o, lse, n, sq, sk, causal,
                                   scale, bi, sg, dr, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
