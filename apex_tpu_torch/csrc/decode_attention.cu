// decode_attention: KV-cache attention for the serving decode step on
// Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/flash_attention.py::_decode_kernel (launched by
// _decode_pallas). For each slot-head n, q_len query rows attend the cached
// prefix [0, lengths[n]) of a dense (n, T, d) cache in bf16, fp32 or int8
// (int8 dequantized against per-(position, head) fp32 scales), d any
// multiple of 8 from 8 to 256. Returns the output in q's dtype and the
// prefix logsumexp, -inf (with output 0) on an empty prefix, so the caller
// can merge the current token exactly.
//
// What bounds it on the H100: bytes. At 8 slots x 12 heads x 1024 positions
// x d 64 in bf16 one layer's call must move 25.2 MB: 7.5 us at 3.35 TB/s.
//
// What the design does about it: the TPU kernel's grid and fetches are
// shaped by max_len (it skips only the math past the cursor). Here each
// slot-head's live prefix is split over several blocks that read only the
// positions below the cursor, and the last block to arrive merges their
// partials in a fixed order: decode.cuh's split body, which this kernel
// shares with paged_decode_attention.cu. A position pos of slot-head n is
// row pos of its (T, d) stripe of the cache (decode::DenseRows).

#include "decode.cuh"

namespace apex_port {
namespace {

template <typename TQ, typename TKV, bool kWide, int G, bool kFull, int R>
__global__ void __launch_bounds__(decode::kThreads)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              const int* __restrict__ lengths, TQ* __restrict__ o,
              float* __restrict__ lse, float* __restrict__ part,
              unsigned* __restrict__ arrivals, int q_len, int T, int d,
              int splits, float scale) {
  // the slot-head's stripe of the cache and its scales
  const size_t n = blockIdx.x;
  const bool quantized = k_scale != nullptr;
  const size_t stripe = n * T * d;
  decode::split_decode<TQ, TKV, kWide, G, kFull, R>(
      q, k + stripe, v + stripe, quantized ? k_scale + n * T : nullptr,
      quantized ? v_scale + n * T : nullptr, decode::DenseRows{},
      max(0, min(lengths[n], T)), o, lse, part, arrivals, q_len, d, splits,
      scale);
}

}  // namespace
}  // namespace apex_port

// C entry point, bound with ctypes. q (n, q_len, d), k/v (n, T, d), lengths
// (n,) int32, d a multiple of 8 in [8, 256]. q_dtype: 0 fp32, 1 bf16;
// kv_dtype: 0 fp32, 1 bf16, 2 int8 (then k_scale/v_scale (n, T) fp32 are
// required, else null). `splits` >= 1 blocks a slot-head; `part` is fp32
// scratch of n x splits x q_len x (d + 2) floats, `arrivals` n x (row
// groups: 1 if q_len is 1, else ceil(q_len / 4)) uint32 counters, all 0
// before the launch and left 0 after it. Returns the cudaError_t of the
// launch (0 on success).
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
  return static_cast<int>(decode::dispatch(
      q_dtype, kv_dtype, k_scale != nullptr && v_scale != nullptr, d, q_len,
      [&](auto tq, auto tkv, auto wide, auto g, auto full, auto r) {
        using TQ = typename decltype(tq)::type;
        using TKV = typename decltype(tkv)::type;
        constexpr int R = decltype(r)::value;
        decode_kernel<TQ, TKV, decltype(wide)::value, decltype(g)::value,
                      decltype(full)::value, R>
            <<<dim3(n, splits, (q_len + R - 1) / R), decode::kThreads, 0,
               st>>>(static_cast<const TQ*>(q), static_cast<const TKV*>(k),
                     static_cast<const TKV*>(v),
                     static_cast<const float*>(k_scale),
                     static_cast<const float*>(v_scale),
                     static_cast<const int*>(lengths), static_cast<TQ*>(o),
                     static_cast<float*>(lse), static_cast<float*>(part),
                     static_cast<unsigned*>(arrivals), q_len, T, d, splits,
                     scale);
        return cudaGetLastError();
      }));
}
