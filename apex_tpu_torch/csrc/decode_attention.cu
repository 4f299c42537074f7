// decode_attention: KV-cache attention for the serving decode step on
// Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/flash_attention.py::_decode_kernel (launched by
// _decode_pallas). For each slot-head n, q_len query rows attend the cached
// prefix [0, lengths[n]) of a dense (n, T, d) cache in bf16, fp32 or int8
// (int8 dequantized against per-(position, head) fp32 scales). Returns the
// output in q's dtype and the prefix logsumexp, -inf (with output 0) on an
// empty prefix, so the caller can merge the current token exactly.
//
// What bounds it on the H100: bytes. A decode step reads every live cache
// entry once and does ~2 flop per byte, far below the ~295 flop/byte at
// which the tensor cores would become the limit. At 8 slots x 12 heads x
// 1024 positions x d 64 in bf16 one layer's call must move 25.2 MB: 7.5 us
// at 3.35 TB/s.
//
// What the design does about it: the TPU kernel's grid and fetches are
// shaped by max_len (it skips only the math past the cursor). Here the loop
// bound is the cursor itself, so a slot at position t reads O(t) bytes and
// never touches the rest of its stripe. One block owns one slot-head (and up
// to 8 q rows; more rows take more blocks along grid.y). Its 8 warps split
// the positions in 32-position tiles; within a tile lane j owns position j,
// reads its key row with 16-byte vector loads and scores it against every q
// row held in shared memory, the warp keeps a partial online softmax
// (m, l, acc) per row, and the P V product reads value rows coalesced with
// lanes owning output dims. The 8 partials are merged in shared memory at
// the end. At 8 slots the grid has 96 blocks for 132 SMs (12 at one slot),
// under one wave: a split over positions across blocks is later work.

#include "common.cuh"

namespace apex_port {
namespace {

constexpr int kWarps = 8;
constexpr int kTile = 32;  // positions per warp step: one per lane

template <typename TQ, typename TKV, int D, int R>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              const int* __restrict__ lengths, TQ* __restrict__ o,
              float* __restrict__ lse, int q_len, int T, float scale) {
  constexpr int kDPL = D / 32;
  constexpr int kVec = Vec16<TKV>::N;
  __shared__ float qs[R * D];
  __shared__ float part_m[kWarps][R];
  __shared__ float part_l[kWarps][R];
  __shared__ float part_acc[kWarps][R][D];

  const int n = blockIdx.x;
  const int r0 = blockIdx.y * R;
  const int rows = min(R, q_len - r0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int len = max(0, min(lengths[n], T));
  const bool quantized = k_scale != nullptr;

  const TQ* qb = q + (static_cast<size_t>(n) * q_len + r0) * D;
  for (int i = tid; i < rows * D; i += kWarps * 32) qs[i] = to_float(qb[i]);
  __syncthreads();

  const TKV* kb = k + static_cast<size_t>(n) * T * D;
  const TKV* vb = v + static_cast<size_t>(n) * T * D;
  const float* ksb = quantized ? k_scale + static_cast<size_t>(n) * T : nullptr;
  const float* vsb = quantized ? v_scale + static_cast<size_t>(n) * T : nullptr;

  float m[R], l[R], acc[R][kDPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDPL; ++dd) acc[r][dd] = 0.f;
  }

  // only positions below the cursor are ever read
  for (int t0 = warp * kTile; t0 < len; t0 += kWarps * kTile) {
    const int pos = t0 + lane;
    const bool valid = pos < len;
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    if (valid) {
      const TKV* krow = kb + static_cast<size_t>(pos) * D;
#pragma unroll
      for (int c0 = 0; c0 < D; c0 += kVec) {
        float kv[kVec];
        Vec16<TKV>::load(krow + c0, kv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < rows) {
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              s[r] = fmaf(qs[r * D + c0 + e], kv[e], s[r]);
          }
        }
      }
      const float kscale = quantized ? ksb[pos] : 1.f;
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] *= kscale * scale;
    }
    float p[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= rows) continue;  // uniform across the block
      const float sr = valid ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sr));
      p[r] = valid ? expf(sr - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int dd = 0; dd < kDPL; ++dd) acc[r][dd] *= corr;
    }
    const int nv = min(kTile, len - t0);  // valid positions in this tile
    for (int j = 0; j < nv; ++j) {
      float pj[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        pj[r] = r < rows ? __shfl_sync(kFullMask, p[r], j) : 0.f;
      const TKV* vrow = vb + static_cast<size_t>(t0 + j) * D + lane;
      const float vscale = quantized ? vsb[t0 + j] : 1.f;
#pragma unroll
      for (int dd = 0; dd < kDPL; ++dd) {
        const float vv = to_float(vrow[dd * 32]) * vscale;
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][dd] = fmaf(pj[r], vv, acc[r][dd]);
      }
    }
  }

  // merge the warps' partial softmaxes
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= rows) continue;
    if (lane == 0) {
      part_m[warp][r] = m[r];
      part_l[warp][r] = l[r];
    }
#pragma unroll
    for (int dd = 0; dd < kDPL; ++dd)
      part_acc[warp][r][lane + dd * 32] = acc[r][dd];
  }
  __syncthreads();
  for (int i = tid; i < rows * D; i += kWarps * 32) {
    const int r = i / D;
    const int c = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, part_m[w][r]);
    float tot_l = 0.f, tot_acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = expf(part_m[w][r] - mx);
      tot_l = fmaf(part_l[w][r], a, tot_l);
      tot_acc = fmaf(part_acc[w][r][c], a, tot_acc);
    }
    const size_t row = static_cast<size_t>(n) * q_len + r0 + r;
    store_as(o + row * D + c, tot_l == 0.f ? 0.f : tot_acc / tot_l);
    if (c == 0)
      lse[row] = tot_l == 0.f ? -CUDART_INF_F : mx + logf(tot_l);
  }
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_scale, const void* v_scale,
                   const void* lengths, void* o, void* lse, int n, int q_len,
                   int T, float scale, cudaStream_t stream) {
  const TQ* qp = static_cast<const TQ*>(q);
  const TKV* kp = static_cast<const TKV*>(k);
  const TKV* vp = static_cast<const TKV*>(v);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* lp = static_cast<const int*>(lengths);
  TQ* op = static_cast<TQ*>(o);
  float* lsep = static_cast<float*>(lse);
  if (q_len == 1) {
    decode_kernel<TQ, TKV, D, 1><<<dim3(n, 1), kWarps * 32, 0, stream>>>(
        qp, kp, vp, ks, vs, lp, op, lsep, q_len, T, scale);
  } else {
    constexpr int R = 8;
    decode_kernel<TQ, TKV, D, R>
        <<<dim3(n, (q_len + R - 1) / R), kWarps * 32, 0, stream>>>(
            qp, kp, vp, ks, vs, lp, op, lsep, q_len, T, scale);
  }
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v,
                     const void* k_scale, const void* v_scale,
                     const void* lengths, void* o, void* lse, int n,
                     int q_len, int T, float scale, cudaStream_t stream) {
  if (d == 64)
    return launch<TQ, TKV, 64>(q, k, v, k_scale, v_scale, lengths, o, lse, n,
                               q_len, T, scale, stream);
  if (d == 128)
    return launch<TQ, TKV, 128>(q, k, v, k_scale, v_scale, lengths, o, lse,
                                n, q_len, T, scale, stream);
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t launch_kv(int kv_dtype, int d, const void* q, const void* k,
                      const void* v, const void* k_scale,
                      const void* v_scale, const void* lengths, void* o,
                      void* lse, int n, int q_len, int T, float scale,
                      cudaStream_t stream) {
  if (kv_dtype == kFloat32)
    return launch_d<TQ, float>(d, q, k, v, k_scale, v_scale, lengths, o, lse,
                               n, q_len, T, scale, stream);
  if (kv_dtype == kBFloat16)
    return launch_d<TQ, __nv_bfloat16>(d, q, k, v, k_scale, v_scale, lengths,
                                       o, lse, n, q_len, T, scale, stream);
  if (kv_dtype == kInt8 && k_scale != nullptr && v_scale != nullptr)
    return launch_d<TQ, int8_t>(d, q, k, v, k_scale, v_scale, lengths, o,
                                lse, n, q_len, T, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace apex_port

// C entry point, bound with ctypes. q_dtype: 0 fp32, 1 bf16; kv_dtype: 0
// fp32, 1 bf16, 2 int8 (then k_scale/v_scale are required, else null).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int apex_decode_attention(const void* q, const void* k,
                                     const void* v, const void* k_scale,
                                     const void* v_scale,
                                     const void* lengths, void* o, void* lse,
                                     int n, int q_len, int T, int d,
                                     int q_dtype, int kv_dtype, float scale,
                                     void* stream) {
  using namespace apex_port;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_dtype != kInt8) k_scale = v_scale = nullptr;
  if (q_dtype == kFloat32)
    return launch_kv<float>(kv_dtype, d, q, k, v, k_scale, v_scale, lengths,
                            o, lse, n, q_len, T, scale, st);
  if (q_dtype == kBFloat16)
    return launch_kv<__nv_bfloat16>(kv_dtype, d, q, k, v, k_scale, v_scale,
                                    lengths, o, lse, n, q_len, T, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
