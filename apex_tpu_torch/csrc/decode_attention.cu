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
// never touches the rest of its stripe. One block per slot-head would give
// 96 blocks for 132 SMs at 8 slots (12 at one slot): too few loads in
// flight to near the HBM rate. So each slot-head's live prefix is split
// over `splits` blocks (grid n x splits x row groups: one q row, or groups
// of 4; _kernels.decode_splits picks splits from n, T and q_len alone: a
// chunk of about 256 of the T positions, more blocks where the grid would
// not fill two waves of the SMs, never a chunk under 64). Block c takes
// positions [c ceil(len / splits), ...) of the live prefix, computed here
// from lengths[n]: the host never reads a cursor. Its 4 warps take tiles
// of the chunk in turn, and a cache row is split over D / 8 lanes (D / 4
// in fp32), each holding 8 of its elements (16 bytes; 8 of int8) and the
// same dims of the q rows in registers: at each of a tile's 4 steps the
// warp's lane groups take 32 / (D / 8) consecutive positions, so a lane
// issues the loads of its key and value slices for all 4 steps at once
// (one round trip to memory a tile, K and V together), the row's lanes
// sum their partial dot products with shuffles, and the online softmax
// (m, l) of each q row is kept per warp while each lane sums p v over its
// positions for its dims (the lane groups' sums are added once, at the
// end). The warps' partials merge in shared memory into the block's (m,
// l, acc), fp32, written to a scratch of n x splits x q_len x (d + 2)
// floats. The last block of a slot-head to arrive (an atomic counter per
// slot-head and row group, which that block resets to 0 for the next
// launch) merges the splits' partials in the fixed order c = 0 .. splits -
// 1 with the two-way logsumexp merge, and rounds the output to q's dtype
// once: one launch a call, and the same bits on every repeat whichever
// block arrives last. Chunks with no position give (m = -1e30, l = 0, acc
// = 0), which merge to nothing; a slot-head with none at all gives output
// 0 and lse -inf.

#include "common.cuh"

namespace apex_port {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSteps = 4;  // positions a lane takes in each warp tile

// One lane's slice of a cache row: N consecutive elements in one load (16
// bytes; 8 of int8), kept raw in registers until they are used
template <typename T>
struct Slice;
template <>
struct Slice<float> {
  using Raw = uint4;
  static constexpr int N = 4;
  __device__ __forceinline__ static float at(const Raw& w, int i) {
    const uint32_t x[4] = {w.x, w.y, w.z, w.w};
    return __uint_as_float(x[i]);
  }
};
template <>
struct Slice<__nv_bfloat16> {
  using Raw = uint4;
  static constexpr int N = 8;
  __device__ __forceinline__ static float at(const Raw& w, int i) {
    const uint32_t x[4] = {w.x, w.y, w.z, w.w};
    // the low half of a pair first, each widened by a 16-bit shift
    return __uint_as_float(i % 2 ? x[i / 2] & 0xffff0000u : x[i / 2] << 16);
  }
};
template <>
struct Slice<int8_t> {
  using Raw = uint2;
  static constexpr int N = 8;
  __device__ __forceinline__ static float at(const Raw& w, int i) {
    const uint32_t x = i < 4 ? w.x : w.y;
    return static_cast<float>(static_cast<int8_t>(x >> (8 * (i % 4))));
  }
};

template <typename TQ, typename TKV, int D, int R>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              const int* __restrict__ lengths, TQ* __restrict__ o,
              float* __restrict__ lse, float* __restrict__ part,
              unsigned* __restrict__ arrivals, int q_len, int T, int splits,
              float scale) {
  using S = Slice<TKV>;
  using Raw = typename S::Raw;
  constexpr int kN = S::N;                  // elements a lane's slice
  constexpr int kLPR = D / kN;              // lanes a cache row
  constexpr int kRPS = 32 / kLPR;           // rows a warp step
  constexpr int kTileP = kSteps * kRPS;     // positions a warp tile
  static_assert(kLPR <= 32 && 32 % kLPR == 0, "cache row split");
  __shared__ float part_m[kWarps][R];
  __shared__ float part_l[kWarps][R];
  __shared__ float part_acc[kWarps][R][D];
  __shared__ bool last;

  const int n = blockIdx.x;
  const int chunk_id = blockIdx.y;
  const int r0 = blockIdx.z * R;
  const int rows = min(R, q_len - r0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int grp = lane / kLPR;      // the lane's row of each step
  const int c0 = (lane % kLPR) * kN;  // its first dim
  const int len = max(0, min(lengths[n], T));
  const int chunk = (len + splits - 1) / splits;
  const int begin = min(len, chunk_id * chunk);
  const int end = min(len, begin + chunk);
  const bool quantized = k_scale != nullptr;

  const TKV* kb = k + static_cast<size_t>(n) * T * D + c0;
  const TKV* vb = v + static_cast<size_t>(n) * T * D + c0;
  const float* ksb = quantized ? k_scale + static_cast<size_t>(n) * T : nullptr;
  const float* vsb = quantized ? v_scale + static_cast<size_t>(n) * T : nullptr;

  // the lane's dims of each q row, and its running (m, l, acc) per row
  float qv[R][kN], m[R], l[R], acc[R][kN];
  const TQ* qb = q + (static_cast<size_t>(n) * q_len + r0) * D + c0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      qv[r][e] = r < rows ? to_float(qb[r * D + e]) : 0.f;
      acc[r][e] = 0.f;
    }
  }

  // only positions of this chunk, below the cursor, are ever read: step i
  // of a warp tile gives lane group grp the position t0 + i kRPS + grp
  for (int t0 = begin + warp * kTileP; t0 < end; t0 += kWarps * kTileP) {
    Raw kr[kSteps], vr[kSteps];
    float ksc[kSteps], vsc[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int pos = t0 + i * kRPS + grp;
      kr[i] = vr[i] = Raw{};
      ksc[i] = vsc[i] = 1.f;
      if (pos < end) {
        const size_t row = static_cast<size_t>(pos) * D;
        kr[i] = *reinterpret_cast<const Raw*>(kb + row);
        vr[i] = *reinterpret_cast<const Raw*>(vb + row);
        if (quantized) {
          ksc[i] = ksb[pos];
          vsc[i] = vsb[pos];
        }
      }
    }
    // scores: the lane's partial dot products, summed over the row's lanes
    float p[kSteps][R];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < kN; ++e) x = fmaf(qv[r][e], S::at(kr[i], e), x);
#pragma unroll
        for (int off = 1; off < kLPR; off <<= 1)
          x += __shfl_xor_sync(kFullMask, x, off);
        const bool in = t0 + i * kRPS + grp < end;
        p[i][r] = in ? x * ksc[i] * scale : kNegInf;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= rows) continue;  // uniform across the block
      float mt = kNegInf;
#pragma unroll
      for (int i = 0; i < kSteps; ++i) mt = fmaxf(mt, p[i][r]);
#pragma unroll
      for (int off = kLPR; off < 32; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(kFullMask, mt, off));
      const float m_new = fmaxf(m[r], mt);
      const float corr = expf(m[r] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int i = 0; i < kSteps; ++i) {
        const bool in = t0 + i * kRPS + grp < end;
        p[i][r] = in ? expf(p[i][r] - m_new) : 0.f;
        ls += p[i][r];
      }
#pragma unroll
      for (int off = kLPR; off < 32; off <<= 1)
        ls += __shfl_xor_sync(kFullMask, ls, off);
      l[r] = l[r] * corr + ls;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < kN; ++e) acc[r][e] *= corr;
    }
    // P V over the lane's positions and dims
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float x = S::at(vr[i], e) * vsc[i];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][e] = fmaf(p[i][r], x, acc[r][e]);
      }
    }
  }

  // the warp's value sums over its lanes of equal dims, then the warps'
  // partial softmaxes merged into the block's
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= rows) continue;
#pragma unroll
    for (int off = kLPR; off < 32; off <<= 1)
#pragma unroll
      for (int e = 0; e < kN; ++e)
        acc[r][e] += __shfl_xor_sync(kFullMask, acc[r][e], off);
    if (lane == 0) {
      part_m[warp][r] = m[r];
      part_l[warp][r] = l[r];
    }
    if (grp == 0) {
#pragma unroll
      for (int e = 0; e < kN; ++e) part_acc[warp][r][c0 + e] = acc[r][e];
    }
  }
  __syncthreads();
  constexpr int kPart = D + 2;  // a partial row: m, l, acc[D]
  for (int i = tid; i < rows * D; i += kThreads) {
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
    float* pr = part + ((static_cast<size_t>(n) * splits + chunk_id) * q_len +
                        r0 + r) * kPart;
    pr[2 + c] = tot_acc;
    if (c == 0) {
      pr[0] = mx;
      pr[1] = tot_l;
    }
  }

  // arrive; the last block of (n, row group) merges every chunk's partial
  __threadfence();
  __syncthreads();
  unsigned* count = arrivals + static_cast<size_t>(n) * gridDim.z + blockIdx.z;
  if (tid == 0)
    last = atomicAdd(count, 1u) == static_cast<unsigned>(splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int c = i % D;
    const float* p0 = part + (static_cast<size_t>(n) * splits * q_len + r0 +
                              r) * kPart;
    const size_t step = static_cast<size_t>(q_len) * kPart;  // next chunk
    float mx = kNegInf;
#pragma unroll 4
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, __ldcg(p0 + s * step));
    float tot_l = 0.f, tot_acc = 0.f;
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
      const float* ps = p0 + s * step;
      // an empty chunk: m = -1e30, l = 0, acc = 0 adds nothing
      const float a = expf(__ldcg(ps) - mx);
      tot_l = fmaf(__ldcg(ps + 1), a, tot_l);
      tot_acc = fmaf(__ldcg(ps + 2 + c), a, tot_acc);
    }
    const size_t row = static_cast<size_t>(n) * q_len + r0 + r;
    store_as(o + row * D + c, tot_l == 0.f ? 0.f : tot_acc / tot_l);
    if (c == 0)
      lse[row] = tot_l == 0.f ? -CUDART_INF_F : mx + logf(tot_l);
  }
  if (tid == 0) *count = 0u;  // every chunk has arrived: ready for the next
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_scale, const void* v_scale,
                   const void* lengths, void* o, void* lse, void* part,
                   void* arrivals, int n, int q_len, int T, int splits,
                   float scale, cudaStream_t stream) {
  const TQ* qp = static_cast<const TQ*>(q);
  const TKV* kp = static_cast<const TKV*>(k);
  const TKV* vp = static_cast<const TKV*>(v);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* lp = static_cast<const int*>(lengths);
  TQ* op = static_cast<TQ*>(o);
  float* lsep = static_cast<float*>(lse);
  float* pp = static_cast<float*>(part);
  unsigned* ap = static_cast<unsigned*>(arrivals);
  if (q_len == 1) {
    decode_kernel<TQ, TKV, D, 1><<<dim3(n, splits, 1), kThreads, 0, stream>>>(
        qp, kp, vp, ks, vs, lp, op, lsep, pp, ap, q_len, T, splits, scale);
  } else {
    constexpr int R = 4;
    decode_kernel<TQ, TKV, D, R>
        <<<dim3(n, splits, (q_len + R - 1) / R), kThreads, 0, stream>>>(
            qp, kp, vp, ks, vs, lp, op, lsep, pp, ap, q_len, T, splits,
            scale);
  }
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v,
                     const void* k_scale, const void* v_scale,
                     const void* lengths, void* o, void* lse, void* part,
                     void* arrivals, int n, int q_len, int T, int splits,
                     float scale, cudaStream_t stream) {
  if (d == 64)
    return launch<TQ, TKV, 64>(q, k, v, k_scale, v_scale, lengths, o, lse,
                               part, arrivals, n, q_len, T, splits, scale,
                               stream);
  if (d == 128)
    return launch<TQ, TKV, 128>(q, k, v, k_scale, v_scale, lengths, o, lse,
                                part, arrivals, n, q_len, T, splits, scale,
                                stream);
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t launch_kv(int kv_dtype, int d, const void* q, const void* k,
                      const void* v, const void* k_scale,
                      const void* v_scale, const void* lengths, void* o,
                      void* lse, void* part, void* arrivals, int n,
                      int q_len, int T, int splits, float scale,
                      cudaStream_t stream) {
  if (kv_dtype == kFloat32)
    return launch_d<TQ, float>(d, q, k, v, k_scale, v_scale, lengths, o, lse,
                               part, arrivals, n, q_len, T, splits, scale,
                               stream);
  if (kv_dtype == kBFloat16)
    return launch_d<TQ, __nv_bfloat16>(d, q, k, v, k_scale, v_scale, lengths,
                                       o, lse, part, arrivals, n, q_len, T,
                                       splits, scale, stream);
  if (kv_dtype == kInt8 && k_scale != nullptr && v_scale != nullptr)
    return launch_d<TQ, int8_t>(d, q, k, v, k_scale, v_scale, lengths, o,
                                lse, part, arrivals, n, q_len, T, splits,
                                scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace apex_port

// C entry point, bound with ctypes. q_dtype: 0 fp32, 1 bf16; kv_dtype: 0
// fp32, 1 bf16, 2 int8 (then k_scale/v_scale are required, else null).
// `splits` >= 1 blocks a slot-head; `part` is fp32 scratch of n x splits x
// q_len x (d + 2) floats, `arrivals` n x (row groups: 1 if q_len is 1, else
// ceil(q_len / 4)) uint32 counters,
// all 0 before the launch and left 0 after it. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int apex_decode_attention(const void* q, const void* k,
                                     const void* v, const void* k_scale,
                                     const void* v_scale,
                                     const void* lengths, void* o, void* lse,
                                     void* part, void* arrivals, int n,
                                     int q_len, int T, int d, int splits,
                                     int q_dtype, int kv_dtype, float scale,
                                     void* stream) {
  using namespace apex_port;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || part == nullptr || arrivals == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype != kInt8) k_scale = v_scale = nullptr;
  if (q_dtype == kFloat32)
    return launch_kv<float>(kv_dtype, d, q, k, v, k_scale, v_scale, lengths,
                            o, lse, part, arrivals, n, q_len, T, splits,
                            scale, st);
  if (q_dtype == kBFloat16)
    return launch_kv<__nv_bfloat16>(kv_dtype, d, q, k, v, k_scale, v_scale,
                                    lengths, o, lse, part, arrivals, n, q_len,
                                    T, splits, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
