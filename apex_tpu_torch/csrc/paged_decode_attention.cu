// paged_decode_attention: KV-cache attention over a global block pool for
// the paged serving decode step on Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/flash_attention.py::_paged_decode_kernel (launched
// by _paged_decode_pallas). For each slot s and head h, q_len query rows
// attend the slot's logical prefix [0, lengths[s]). Logical position t lies
// in pool block tables[s, t / bs] at offset t % bs of a (num_blocks, heads,
// bs, d) pool in bf16, fp32 or int8 (int8 dequantized against pooled
// per-(position, head) fp32 scales (num_blocks, heads, bs)). Returns the
// output in q's dtype and the prefix logsumexp, -inf (with output 0) on an
// empty prefix, so the caller can merge the current token exactly.
//
// What bounds it on the H100: bytes, as for the dense decode kernel. A step
// reads every live pool row once and does ~2 flop per byte. At 8 slots x 12
// heads x 1024 positions (8 blocks of 128) x d 64 in bf16 one layer's call
// must move 25.2 MB of K and V: 7.5 us at 3.35 TB/s.
//
// What the design does about it: the TPU kernel aims each fetch of a
// sequential grid through a scalar-prefetched table and clamps the fetches
// past the cursor. Here one block owns one (slot, head) and reads only the
// table entries below ceil(len / bs), staged in shared memory kTable at a
// time; nothing past the cursor is read, neither a table entry nor a pool
// row. The rest is decode_attention.cu's tiling with a table lookup in
// place of a stride: 8 warps walk the positions in 32-position tiles, lane j
// resolves its own position's (block, offset) row and reads its key with
// 16-byte vector loads, each warp keeps an online softmax per q row, the
// P V product reads value rows coalesced with lanes owning output dims (in
// a tile that spans two blocks, each row index is shuffled from the lane
// that resolved it), and the 8 partials are merged in shared memory at the
// end. Any block size >= 1 works: the lookup is an integer division, not a
// tiling rule.

#include "common.cuh"

namespace apex_port {
namespace {

constexpr int kWarps = 8;
constexpr int kTile = 32;     // positions per warp step: one per lane
constexpr int kTable = 1024;  // table entries staged in shared memory at once

template <typename TQ, typename TKV, int D, int R>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, TQ* __restrict__ o,
                    float* __restrict__ lse, int heads, int q_len, int bs,
                    int n_table, float scale) {
  constexpr int kDPL = D / 32;
  constexpr int kVec = Vec16<TKV>::N;
  __shared__ float qs[R * D];
  __shared__ int tab[kTable];
  __shared__ float part_m[kWarps][R];
  __shared__ float part_l[kWarps][R];
  __shared__ float part_acc[kWarps][R][D];

  const int n = blockIdx.x;  // slot * heads + head
  const int slot = n / heads;
  const int head = n - slot * heads;
  const int r0 = blockIdx.y * R;
  const int rows = min(R, q_len - r0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // a cursor past the table's span reads no further than the span
  const int len = static_cast<int>(
      max(0LL, min(static_cast<long long>(lengths[slot]),
                   static_cast<long long>(n_table) * bs)));
  const int n_live = (len + bs - 1) / bs;  // table entries this slot reads
  const int* trow = tables + static_cast<size_t>(slot) * n_table;
  const bool quantized = k_scale != nullptr;

  const TQ* qb = q + (static_cast<size_t>(n) * q_len + r0) * D;
  for (int i = tid; i < rows * D; i += kWarps * 32) qs[i] = to_float(qb[i]);

  float m[R], l[R], acc[R][kDPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDPL; ++dd) acc[r][dd] = 0.f;
  }

  for (int c0 = 0; c0 < n_live; c0 += kTable) {
    const int nc = min(kTable, n_live - c0);
    __syncthreads();  // q is staged; the previous chunk's lookups are done
    for (int i = tid; i < nc; i += kWarps * 32) tab[i] = trow[c0 + i];
    __syncthreads();
    const int p_lo = c0 * bs;
    const int p_hi = min(len, (c0 + nc) * bs);
    for (int t0 = p_lo + warp * kTile; t0 < p_hi; t0 += kWarps * kTile) {
      const int pos = t0 + lane;
      const bool valid = pos < p_hi;
      // this lane's pool row: ((block * heads + head) * bs + offset)
      unsigned long long row = 0;
      if (valid) {
        const int j = pos / bs;
        row = (static_cast<unsigned long long>(tab[j - c0]) * heads + head) *
                  bs + (pos - j * bs);
      }
      float s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = 0.f;
      if (valid) {
        const TKV* krow = k + row * D;
#pragma unroll
        for (int c = 0; c < D; c += kVec) {
          float kv[kVec];
          Vec16<TKV>::load(krow + c, kv);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (r < rows) {
#pragma unroll
              for (int e = 0; e < kVec; ++e)
                s[r] = fmaf(qs[r * D + c + e], kv[e], s[r]);
            }
          }
        }
        const float kscale = quantized ? k_scale[row] : 1.f;
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
      const int nv = min(kTile, p_hi - t0);  // valid positions in this tile
      // acc += p_j v_j for the tile's position j, its value row at vrow
      auto accumulate = [&](int j, const TKV* vrow, float vscale) {
        float pj[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          pj[r] = r < rows ? __shfl_sync(kFullMask, p[r], j) : 0.f;
#pragma unroll
        for (int dd = 0; dd < kDPL; ++dd) {
          const float vv = to_float(vrow[dd * 32]) * vscale;
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][dd] = fmaf(pj[r], vv, acc[r][dd]);
        }
      };
      const unsigned long long row0 = __shfl_sync(kFullMask, row, 0);
      if (t0 / bs == (t0 + nv - 1) / bs) {
        // the tile lies in one block (every tile when bs is a multiple of
        // 32): its rows are consecutive, addressed as the dense kernel's
        const TKV* vb = v + row0 * D + lane;
        const float* vsb = quantized ? v_scale + row0 : nullptr;
        for (int j = 0; j < nv; ++j)
          accumulate(j, vb + j * D, quantized ? vsb[j] : 1.f);
      } else {
        for (int j = 0; j < nv; ++j) {
          const unsigned long long rj = __shfl_sync(kFullMask, row, j);
          accumulate(j, v + rj * D + lane, quantized ? v_scale[rj] : 1.f);
        }
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
    const size_t out_row = static_cast<size_t>(n) * q_len + r0 + r;
    store_as(o + out_row * D + c, tot_l == 0.f ? 0.f : tot_acc / tot_l);
    if (c == 0)
      lse[out_row] = tot_l == 0.f ? -CUDART_INF_F : mx + logf(tot_l);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* k_scale;
  const void* v_scale;
  const void* tables;
  const void* lengths;
  void* o;
  void* lse;
  int n, heads, q_len, bs, n_table;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D, int R>
void launch_rows(const Args& a) {
  paged_decode_kernel<TQ, TKV, D, R>
      <<<dim3(a.n, (a.q_len + R - 1) / R), kWarps * 32, 0, a.stream>>>(
          static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
          static_cast<const TKV*>(a.v), static_cast<const float*>(a.k_scale),
          static_cast<const float*>(a.v_scale),
          static_cast<const int*>(a.tables),
          static_cast<const int*>(a.lengths), static_cast<TQ*>(a.o),
          static_cast<float*>(a.lse), a.heads, a.q_len, a.bs, a.n_table,
          a.scale);
}

template <typename TQ, typename TKV>
cudaError_t launch(int d, const Args& a) {
  if (d != 64 && d != 128) return cudaErrorInvalidValue;
  // one q row: the decode step; more: up to 8 rows a block (verify rows)
  if (a.q_len == 1) {
    if (d == 64) launch_rows<TQ, TKV, 64, 1>(a);
    else launch_rows<TQ, TKV, 128, 1>(a);
  } else {
    if (d == 64) launch_rows<TQ, TKV, 64, 8>(a);
    else launch_rows<TQ, TKV, 128, 8>(a);
  }
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_kv(int kv_dtype, int d, const Args& a) {
  if (kv_dtype == kFloat32) return launch<TQ, float>(d, a);
  if (kv_dtype == kBFloat16) return launch<TQ, __nv_bfloat16>(d, a);
  if (kv_dtype == kInt8 && a.k_scale != nullptr && a.v_scale != nullptr)
    return launch<TQ, int8_t>(d, a);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace apex_port

// C entry point, bound with ctypes. q (n, q_len, d) with n = slots * heads;
// pools (num_blocks, heads, bs, d); tables (slots, n_table) int32; lengths
// (slots,) int32. q_dtype: 0 fp32, 1 bf16; kv_dtype: 0 fp32, 1 bf16, 2 int8
// (then k_scale/v_scale (num_blocks, heads, bs) fp32 are required, else
// null). Returns the cudaError_t of the launch (0 on success).
extern "C" int apex_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* tables, const void* lengths, void* o,
    void* lse, int n, int heads, int q_len, int bs, int n_table, int d,
    int q_dtype, int kv_dtype, float scale, void* stream) {
  using namespace apex_port;
  if (n <= 0 || heads <= 0 || n % heads != 0 || q_len <= 0 || bs <= 0 ||
      n_table <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype != kInt8) k_scale = v_scale = nullptr;
  const Args a{q, k, v, k_scale, v_scale, tables, lengths, o, lse, n, heads,
               q_len, bs, n_table, scale, static_cast<cudaStream_t>(stream)};
  if (q_dtype == kFloat32) return launch_kv<float>(kv_dtype, d, a);
  if (q_dtype == kBFloat16) return launch_kv<__nv_bfloat16>(kv_dtype, d, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
