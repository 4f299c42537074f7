// The split decode body shared by the port's two decode kernels on Hopper
// (sm_90a): decode_attention.cu (a dense (n, T, d) cache) and
// paged_decode_attention.cu (a (num_blocks, heads, bs, d) pool read through
// block tables). They differ only in how a position of a slot-head's prefix
// becomes a cache row: DenseRows (a stride) and PagedRows (a table lookup).
//
// What bounds both on the H100: bytes. A decode step reads every live cache
// row once and does ~2 flop per byte, far below the ~295 flop/byte at which
// the tensor cores would become the limit.
//
// The design: the loop bound is the cursor itself, so a slot at position t
// reads O(t) bytes. One block per slot-head would give 96 blocks for 132 SMs
// at 8 slots (12 at one slot): too few loads in flight to near the HBM rate.
// So each slot-head's live prefix is split over `splits` blocks (grid n x
// splits x row groups: one q row, or groups of kRows; the wrapper's
// _kernels.decode_splits picks splits from n, the positions T a slot-head
// can hold and q_len alone). Block c takes positions [c ceil(len / splits),
// ...) of the live prefix, len computed here from the cursor on the device:
// the host never reads a cursor. Its 4 warps take tiles of the chunk in
// turn. A cache row is split over G lanes, G the lanes the row needs rounded
// up to a power of two (1 to 32), each lane holding N of its elements and
// the same dims of the q rows in registers: N = 8 (16 bytes of bf16, 8 of
// int8), fp32 4 (16 bytes) up to d 128 and 8 (two 16-byte loads, kWide) past
// it. The head dim d is a run-time argument, any multiple of 8 from 8 to
// 256, so one template instance serves every d of a lane-group width that
// leaves lanes idle (lanes past d load nothing and add zeros to the dot
// product's shuffle sum); a d that fills its lanes (kFull: 64, 128, ...)
// takes an instance of its own with d a constant, so that a tile's steps
// address their rows at constant offsets. At each of a tile's kSteps steps
// the warp's lane groups take 32 / G consecutive positions: a lane resolves
// the rows of its steps first (the paged kernel's table reads), then sends out
// the loads of its key and value slices (and int8 scales) for every step at
// once (one round trip to memory a tile, K and V together), the row's lanes
// sum their partial dot products with shuffles, and the online softmax (m,
// l) of each q row is kept per warp while each lane sums p v over its
// positions for its dims (the lane groups' sums are added once, at the end).
// The warps' partials merge in shared memory into the block's (m, l, acc),
// fp32, written to a scratch of n x splits x q_len x (d + 2) floats. The
// last block of a slot-head and row group to arrive (an atomic counter,
// which that block resets to 0 for the next launch) merges the splits'
// partials in the fixed order c = 0 .. splits - 1 with the two-way logsumexp
// merge and rounds the output to q's dtype once: one launch a call, and the
// same bits on every repeat whichever block arrives last. Chunks with no
// position give (m = -1e30, l = 0, acc = 0), which merge to nothing; a
// slot-head with none at all gives output 0 and lse -inf.

#pragma once

#include <type_traits>

#include "common.cuh"

namespace apex_port {
namespace decode {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSteps = 4;   // positions a lane takes in each warp tile
constexpr int kRows = 4;    // q rows a block when q_len > 1
constexpr int kMaxD = 256;  // head dims taken: the multiples of 8 up to it

// One lane's slice of a cache row: N consecutive elements in one load (16
// bytes; 8 of int8; two 16-byte loads for kWide fp32), kept raw in
// registers until they are used
template <typename T, bool kWide = false>
struct Slice;
template <>
struct Slice<float, false> {
  using Raw = uint4;
  static constexpr int N = 4;
  __device__ __forceinline__ static float at(const Raw& w, int i) {
    const uint32_t x[4] = {w.x, w.y, w.z, w.w};
    return __uint_as_float(x[i]);
  }
};
template <>
struct Slice<float, true> {
  struct Raw {
    uint4 lo, hi;
  };
  static constexpr int N = 8;
  __device__ __forceinline__ static float at(const Raw& w, int i) {
    const uint4& h = i < 4 ? w.lo : w.hi;
    const uint32_t x[4] = {h.x, h.y, h.z, h.w};
    return __uint_as_float(x[i % 4]);
  }
};
template <>
struct Slice<__nv_bfloat16, false> {
  using Raw = uint4;
  static constexpr int N = 8;
  __device__ __forceinline__ static float at(const Raw& w, int i) {
    const uint32_t x[4] = {w.x, w.y, w.z, w.w};
    // the low half of a pair first, each widened by a 16-bit shift
    return __uint_as_float(i % 2 ? x[i / 2] & 0xffff0000u : x[i / 2] << 16);
  }
};
template <>
struct Slice<int8_t, false> {
  using Raw = uint2;
  static constexpr int N = 8;
  __device__ __forceinline__ static float at(const Raw& w, int i) {
    const uint32_t x = i < 4 ? w.x : w.y;
    return static_cast<float>(static_cast<int8_t>(x >> (8 * (i % 4))));
  }
};

// A dense cache, its pointers at slot-head n's (T, d) stripe: position pos
// is row pos
struct DenseRows {
  static constexpr bool kLookup = false;  // reads no memory
  __device__ __forceinline__ size_t operator()(int pos) const {
    return static_cast<size_t>(pos);
  }
};

// x / bs for 0 <= x < 2^31 by a multiply-high and a shift: magic =
// ceil(2^(31 + l) / bs) and shift = l - 1 with l = ceil(log2 bs), magic 0
// for bs = 1 (_kernels._fast_div computes them)
struct FastDiv {
  unsigned magic;
  int shift;
  __device__ __forceinline__ int operator()(int x) const {
    return magic ? static_cast<int>(
                       __umulhi(static_cast<unsigned>(x), magic) >> shift)
                 : x;
  }
};

// A pool: position pos of (slot, head) lies in pool block table[pos / bs]
// at offset pos % bs, row (block heads + head) bs + offset. Only the entries
// of positions below the cursor are ever read
struct PagedRows {
  static constexpr bool kLookup = true;  // reads the table
  const int* table;  // the slot's row of the block tables
  int heads, head, bs;
  FastDiv div;
  __device__ __forceinline__ size_t operator()(int pos) const {
    const int j = div(pos);
    return (static_cast<size_t>(__ldg(table + j)) * heads + head) * bs +
           (pos - j * bs);
  }
};

// Slot-head blockIdx.x's q rows [blockIdx.z R, ...) over positions [0,
// len), chunk blockIdx.y of `splits`; `row_of` maps a position to its
// cache row (of d elements; the int8 scales' index too). With kFull, d is
// G N whatever `d_arg` says
template <typename TQ, typename TKV, bool kWide, int G, bool kFull, int R,
          typename Rows>
__device__ __forceinline__ void split_decode(
    const TQ* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const Rows& row_of, int len,
    TQ* __restrict__ o, float* __restrict__ lse, float* __restrict__ part,
    unsigned* __restrict__ arrivals, int q_len, int d_arg, int splits,
    float scale) {
  using S = Slice<TKV, kWide>;
  using Raw = typename S::Raw;
  constexpr int kN = S::N;               // elements a lane's slice
  const int d = kFull ? G * kN : d_arg;  // the head dim
  constexpr int kRPS = 32 / G;           // rows a warp step
  constexpr int kTileP = kSteps * kRPS;  // positions a warp tile
  static_assert(G >= 1 && G <= 32 && 32 % G == 0, "cache row split");
  __shared__ float part_m[kWarps][R];
  __shared__ float part_l[kWarps][R];
  __shared__ float part_acc[kWarps][R][G * kN];
  __shared__ bool last;

  const int n = blockIdx.x;
  const int chunk_id = blockIdx.y;
  const int r0 = blockIdx.z * R;
  const int rows = min(R, q_len - r0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int grp = lane / G;           // the lane's row of each step
  const int c0 = (lane % G) * kN;     // its first dim
  const bool active = kFull || c0 < d;  // a lane past the row's end
  const int chunk = (len + splits - 1) / splits;
  const int begin = min(len, chunk_id * chunk);
  const int end = min(len, begin + chunk);
  const bool quantized = k_scale != nullptr;
  const TKV* kb = k + c0;
  const TKV* vb = v + c0;

  // the lane's dims of each q row, and its running (m, l, acc) per row
  float qv[R][kN], m[R], l[R], acc[R][kN];
  const TQ* qb = q + (static_cast<size_t>(n) * q_len + r0) * d + c0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      qv[r][e] = r < rows && active ? to_float(qb[r * d + e]) : 0.f;
      acc[r][e] = 0.f;
    }
  }

  // only positions of this chunk, below the cursor, are ever read: step i
  // of a warp tile gives lane group grp the position t0 + i kRPS + grp
  for (int t0 = begin + warp * kTileP; t0 < end; t0 += kWarps * kTileP) {
    // a table's rows for every step first, so its reads go out together
    size_t looked_up[kSteps];
    if constexpr (Rows::kLookup) {
#pragma unroll
      for (int i = 0; i < kSteps; ++i) {
        const int pos = t0 + i * kRPS + grp;
        looked_up[i] = pos < end ? row_of(pos) : 0;
      }
    }
    Raw kr[kSteps], vr[kSteps];
    float ksc[kSteps], vsc[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int pos = t0 + i * kRPS + grp;
      kr[i] = vr[i] = Raw{};
      ksc[i] = vsc[i] = 1.f;
      if (pos < end) {
        const size_t row = Rows::kLookup ? looked_up[i] : row_of(pos);
        if (active) {
          kr[i] = *reinterpret_cast<const Raw*>(kb + row * d);
          vr[i] = *reinterpret_cast<const Raw*>(vb + row * d);
        }
        if (quantized) {
          ksc[i] = k_scale[row];
          vsc[i] = v_scale[row];
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
        for (int off = 1; off < G; off <<= 1)
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
      for (int off = G; off < 32; off <<= 1)
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
      for (int off = G; off < 32; off <<= 1)
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
    for (int off = G; off < 32; off <<= 1)
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
  const int width = d + 2;  // a partial row: m, l, acc[d]
  for (int i = tid; i < rows * d; i += kThreads) {
    const int r = i / d;
    const int c = i % d;
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
                        r0 + r) * width;
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
  for (int i = tid; i < rows * d; i += kThreads) {
    const int r = i / d;
    const int c = i % d;
    const float* p0 = part + (static_cast<size_t>(n) * splits * q_len + r0 +
                              r) * width;
    const size_t step = static_cast<size_t>(q_len) * width;  // next chunk
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
    store_as(o + row * d + c, tot_l == 0.f ? 0.f : tot_acc / tot_l);
    if (c == 0)
      lse[row] = tot_l == 0.f ? -CUDART_INF_F : mx + logf(tot_l);
  }
  if (tid == 0) *count = 0u;  // every chunk has arrived: ready for the next
}

// ---------------------------------------------------------------------------
// Launch dispatch: f(Type<TQ>, Type<TKV>, Bool<kWide>, Int<G>, Bool<kFull>,
// Int<R>) for a launch's q and cache dtypes, head dim and q rows
// ---------------------------------------------------------------------------

template <typename T>
struct Type {
  using type = T;
};
template <int V>
using Int = std::integral_constant<int, V>;
template <bool V>
using Bool = std::integral_constant<bool, V>;

template <typename TQ, typename TKV, bool kWide, int G, bool kFull,
          typename F>
cudaError_t with_rows(int q_len, F& f) {
  if (q_len == 1)
    return f(Type<TQ>{}, Type<TKV>{}, Bool<kWide>{}, Int<G>{}, Bool<kFull>{},
             Int<1>{});
  return f(Type<TQ>{}, Type<TKV>{}, Bool<kWide>{}, Int<G>{}, Bool<kFull>{},
           Int<kRows>{});
}

// kFull: d fills the G lanes (a d of idle lanes exists only past G N = 16)
template <typename TQ, typename TKV, bool kWide, int G, typename F>
cudaError_t with_width(int d, int q_len, F& f) {
  constexpr int kWidth = G * Slice<TKV, kWide>::N;
  if constexpr (kWidth > 16) {
    if (d != kWidth) return with_rows<TQ, TKV, kWide, G, false>(q_len, f);
  }
  return with_rows<TQ, TKV, kWide, G, true>(q_len, f);
}

// G: the lanes a row of d elements needs, rounded up to a power of two
template <typename TQ, typename TKV, typename F>
cudaError_t with_lanes(int d, int q_len, F& f) {
  constexpr int kN = Slice<TKV>::N;
  const int lanes = (d + kN - 1) / kN;
  if constexpr (std::is_same<TKV, float>::value) {
    if (lanes > 32) return with_width<TQ, TKV, true, 32>(d, q_len, f);
  }
  if (lanes > 16) return with_width<TQ, TKV, false, 32>(d, q_len, f);
  if (lanes > 8) return with_width<TQ, TKV, false, 16>(d, q_len, f);
  if (lanes > 4) return with_width<TQ, TKV, false, 8>(d, q_len, f);
  if (lanes > 2) return with_width<TQ, TKV, false, 4>(d, q_len, f);
  if constexpr (kN == 8) {  // an fp32 row of d >= 8 takes 2 lanes or more
    if (lanes == 1) return with_width<TQ, TKV, false, 1>(d, q_len, f);
  }
  return with_width<TQ, TKV, false, 2>(d, q_len, f);
}

// q_dtype: fp32 or bf16; kv_dtype: fp32, bf16, or int8 when `scaled`
template <typename F>
cudaError_t dispatch(int q_dtype, int kv_dtype, bool scaled, int d,
                     int q_len, F&& f) {
  if (d < 8 || d > kMaxD || d % 8 != 0 || q_len < 1)
    return cudaErrorInvalidValue;
  auto by_kv = [&](auto tq) -> cudaError_t {
    using TQ = typename decltype(tq)::type;
    if (kv_dtype == kFloat32) return with_lanes<TQ, float>(d, q_len, f);
    if (kv_dtype == kBFloat16)
      return with_lanes<TQ, __nv_bfloat16>(d, q_len, f);
    if (kv_dtype == kInt8 && scaled)
      return with_lanes<TQ, int8_t>(d, q_len, f);
    return cudaErrorInvalidValue;
  };
  if (q_dtype == kFloat32) return by_kv(Type<float>{});
  if (q_dtype == kBFloat16) return by_kv(Type<__nv_bfloat16>{});
  return cudaErrorInvalidValue;
}

}  // namespace decode
}  // namespace apex_port
