// paged_decode_attention: KV-cache attention over a global block pool for
// the paged serving decode step on Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/flash_attention.py::_paged_decode_kernel (launched
// by _paged_decode_pallas). For each slot s and head h, q_len query rows
// attend the slot's logical prefix [0, lengths[s]). Logical position t lies
// in pool block tables[s, t / bs] at offset t % bs of a (num_blocks, heads,
// bs, d) pool in bf16, fp32 or int8 (int8 dequantized against pooled
// per-(position, head) fp32 scales (num_blocks, heads, bs)), d any multiple
// of 8 from 8 to 256. Returns the output in q's dtype and the prefix
// logsumexp, -inf (with output 0) on an empty prefix, so the caller can
// merge the current token exactly.
//
// What bounds it on the H100: bytes, as for the dense decode kernel. A step
// reads every live pool row once and does ~2 flop per byte. At 8 slots x 12
// heads x 1024 positions (8 blocks of 128) x d 64 in bf16 one layer's call
// must move 25.2 MB of K and V: 7.5 us at 3.35 TB/s.
//
// What the design does about it: the TPU kernel aims each fetch of a
// sequential grid through a scalar-prefetched table and clamps the fetches
// past the cursor. Here each (slot, head)'s live prefix is split over
// several blocks, as the dense kernel's is, by decode.cuh's split body: the
// two kernels share the split, the lane layout and the fixed-order merge,
// and differ only in how a position becomes a row (decode::PagedRows). A
// lane resolves the rows of its tile's positions through the slot's table
// (the block by a multiply-high division, decode::FastDiv; within one pool
// block a head's rows are contiguous, so a step whose positions straddle a
// block boundary reads two runs of rows), then loads their keys and values
// at once. A chunk [begin, end) reads only the table entries [begin / bs,
// ceil(end / bs)): nothing past the cursor is read, neither a table entry
// nor a pool row. Any block size >= 1 works: the lookup is a division, not
// a tiling rule.

#include "decode.cuh"

namespace apex_port {
namespace {

template <typename TQ, typename TKV, bool kWide, int G, bool kFull, int R>
__global__ void __launch_bounds__(decode::kThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, TQ* __restrict__ o,
                    float* __restrict__ lse, float* __restrict__ part,
                    unsigned* __restrict__ arrivals, int heads, int q_len,
                    int bs, int n_table, decode::FastDiv div, int d,
                    int splits, float scale) {
  const int n = blockIdx.x;  // slot * heads + head
  const int slot = n / heads;
  const int head = n - slot * heads;
  // a cursor past the table's span reads no further than the span
  const int len = static_cast<int>(
      max(0LL, min(static_cast<long long>(lengths[slot]),
                   static_cast<long long>(n_table) * bs)));
  decode::split_decode<TQ, TKV, kWide, G, kFull, R>(
      q, k, v, k_scale, v_scale,
      decode::PagedRows{tables + static_cast<size_t>(slot) * n_table, heads,
                        head, bs, div},
      len, o, lse, part, arrivals, q_len, d, splits, scale);
}

}  // namespace
}  // namespace apex_port

// C entry point, bound with ctypes. q (n, q_len, d) with n = slots * heads;
// pools (num_blocks, heads, bs, d), d a multiple of 8 in [8, 256]; tables
// (slots, n_table) int32 with n_table * bs < 2^31; lengths (slots,) int32.
// q_dtype: 0 fp32, 1 bf16; kv_dtype: 0 fp32, 1 bf16, 2 int8 (then
// k_scale/v_scale (num_blocks, heads, bs) fp32 are required, else null).
// `splits`, `part` and `arrivals` as apex_decode_attention's; (div_magic,
// div_shift) divide by bs (decode::FastDiv). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int apex_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* tables, const void* lengths, void* o,
    void* lse, void* part, void* arrivals, int n, int heads, int q_len,
    int bs, int n_table, int d, int splits, unsigned div_magic,
    int div_shift, int q_dtype, int kv_dtype, float scale, void* stream) {
  using namespace apex_port;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || heads <= 0 || n % heads != 0 || q_len <= 0 || bs <= 0 ||
      n_table <= 0 || splits < 1 || part == nullptr || arrivals == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype != kInt8) k_scale = v_scale = nullptr;
  const decode::FastDiv div{div_magic, div_shift};
  return static_cast<int>(decode::dispatch(
      q_dtype, kv_dtype, k_scale != nullptr && v_scale != nullptr, d, q_len,
      [&](auto tq, auto tkv, auto wide, auto g, auto full, auto r) {
        using TQ = typename decltype(tq)::type;
        using TKV = typename decltype(tkv)::type;
        constexpr int R = decltype(r)::value;
        paged_decode_kernel<TQ, TKV, decltype(wide)::value,
                            decltype(g)::value, decltype(full)::value, R>
            <<<dim3(n, splits, (q_len + R - 1) / R), decode::kThreads, 0,
               st>>>(static_cast<const TQ*>(q), static_cast<const TKV*>(k),
                     static_cast<const TKV*>(v),
                     static_cast<const float*>(k_scale),
                     static_cast<const float*>(v_scale),
                     static_cast<const int*>(tables),
                     static_cast<const int*>(lengths), static_cast<TQ*>(o),
                     static_cast<float*>(lse), static_cast<float*>(part),
                     static_cast<unsigned*>(arrivals), heads, q_len, bs,
                     n_table, div, d, splits, scale);
        return cudaGetLastError();
      }));
}
