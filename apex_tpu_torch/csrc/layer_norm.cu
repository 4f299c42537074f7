// layer_norm: LayerNorm / RMSNorm forward and backward for Hopper (sm_90a).
//
// Replaces: apex_tpu/normalization/_pallas.py::ln_fwd (body _fwd_body) and
// ::ln_bwd (body _bwd_body). For x (n, h) in fp32 or bf16, h a multiple of
// 8 up to 65536 (the reference's fast_layer_norm range), with an optional
// weight and bias (h,) in fp32 or bf16:
//   forward:  mean = sum(x) / h, then var = sum((x - mean)^2) / h (two
//             passes over the row, as _stats; RMSNorm: mean 0, var =
//             sum(x^2) / h), invvar = rsqrt(var + eps), out = (x - mean) *
//             invvar [* w] [+ b] in fp32, rounded once to x's or w's dtype;
//             mean and invvar (n, 1) in fp32;
//   backward: xhat = (x - mean) * invvar, dxhat = dy [* w],
//             dx = invvar * (dxhat - mean(dxhat) - xhat * mean(dxhat xhat))
//             (RMSNorm drops mean(dxhat)), in x's dtype; dgamma = sum over
//             rows of dy xhat and dbeta = sum of dy, in fp32.
//
// What bounds them on the H100: bytes. At the BERT/GPT shape (8192 x 768,
// bf16) the forward moves x in and out once (25.2 MB with the stats: 7.5 us
// at 3.35 TB/s) for ~10 flop per element; the backward reads dy and x and
// writes dx (37.8 MB, 11.3 us) plus the small dgamma/dbeta partials.
//
// What the design does about it: the TPU kernels take a block of rows into
// VMEM and carry dgamma/dbeta across the sequential grid in one resident
// block. Here, at h <= 4096 (forward) or 1024 (backward), one warp owns a
// row at a time and keeps it in registers: lane l holds the 16-byte vectors
// l, l + 32, ... (24 values a lane at h = 768), so each byte of x and dy is
// read from device memory once and every reduction is a warp shuffle. The
// backward's warps walk rows grid-stride; since a lane owns the same
// columns in every row, it accumulates its dgamma/dbeta partials in
// registers, the block's 8 warps add theirs into shared memory in a fixed
// order, and each block writes one fp32 partial row to a (ctas, h) scratch:
// the reference's two-stage scheme (layer_norm_cuda_kernel.cu:540-678). A
// second launch sums the partial rows per column, again in a fixed order,
// and writes them in the weight's dtype: no atomics, so the results repeat
// bit for bit. Above those widths one block of 256 threads owns a row and
// streams it from memory once per pass (two or three reads of x; the row
// no longer fits in registers), with the block's backward partial row kept
// in the scratch itself.
//
// The backward's row kernel is sized for occupancy: a memory-bound kernel
// needs rows in flight on every SM. A lane holds its columns of x and dy as
// loaded (bf16 stays packed, two values a register) and widens them at each
// use, the weight sits in shared memory (fp32, read by every warp), and the
// lane's values a row are instantiated for the widths taken (8, 16, 24 and
// 32: 24 at h = 768, so no vector is dead). That leaves 128 registers a
// thread at h = 768 bf16 (ptxas, no spill), two blocks of 8 warps an SM,
// where the first version's ~210 left one; where the next row's x and dy
// fit beside them (BwdPlan), they are loaded before the current row's two
// warp sums, so the sums' latency hides behind the loads. The grid is at
// most one wave of the blocks that fit at once (the occupancy query, in
// launch_bwd) and at most the wrapper's scratch of two partial rows an SM:
// 264 at 8192 x 768 on an H100, where the kernel took 0.0282 ms and the
// column sum 0.0021 (PERF.md).

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace apex_port {
namespace {

constexpr int kWarps = 8;                // rows in flight per block
constexpr int kThreads = kWarps * 32;
constexpr int kBlockThreads = 256;       // one block per row, wide rows
constexpr int kFwdWarpMaxH = 4096;       // widest rows a warp owns
constexpr int kBwdWarpMaxH = 1024;

// N consecutive elements of T at p, widened to fp32. The caller keeps p
// aligned to N * sizeof(T) bytes, a multiple of 8.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  static_assert(kBytes % 8 == 0, "vectors are whole 8-byte words");
  if constexpr (kBytes % 16 == 0) {
    uint4 raw[kBytes / 16];
#pragma unroll
    for (int j = 0; j < kBytes / 16; ++j)
      raw[j] = reinterpret_cast<const uint4*>(p)[j];
    const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
  } else {
    uint2 raw[kBytes / 8];
#pragma unroll
    for (int j = 0; j < kBytes / 8; ++j)
      raw[j] = reinterpret_cast<const uint2*>(p)[j];
    const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
  }
}

// N fp32 values rounded to T and stored at p (aligned as for load_vec)
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  static_assert(kBytes % 8 == 0, "vectors are whole 8-byte words");
  if constexpr (kBytes % 16 == 0) {
    uint4 raw[kBytes / 16];
    T* e = reinterpret_cast<T*>(raw);
#pragma unroll
    for (int i = 0; i < N; ++i) store_as(e + i, v[i]);
#pragma unroll
    for (int j = 0; j < kBytes / 16; ++j)
      reinterpret_cast<uint4*>(p)[j] = raw[j];
  } else {
    uint2 raw[kBytes / 8];
    T* e = reinterpret_cast<T*>(raw);
#pragma unroll
    for (int i = 0; i < N; ++i) store_as(e + i, v[i]);
#pragma unroll
    for (int j = 0; j < kBytes / 8; ++j)
      reinterpret_cast<uint2*>(p)[j] = raw[j];
  }
}

// kBytes bytes of a row held in registers as they were loaded, in 16-byte
// words (8-byte where a vector is 8 bytes), widened at each use
template <int kBytes>
struct Packed {
  static constexpr int kWord = kBytes % 16 == 0 ? 16 : 8;
  using Word = std::conditional_t<kWord == 16, uint4, uint2>;
  Word w[kBytes / kWord];
};

template <typename T, int N>
using PackedOf = Packed<N * static_cast<int>(sizeof(T))>;

template <typename T, int N>
__device__ __forceinline__ void load_packed(const T* p, PackedOf<T, N>& r) {
  using P = PackedOf<T, N>;
#pragma unroll
  for (int j = 0; j < N * static_cast<int>(sizeof(T)) / P::kWord; ++j)
    r.w[j] = reinterpret_cast<const typename P::Word*>(p)[j];
}

template <typename T, int N>
__device__ __forceinline__ void unpack(const PackedOf<T, N>& r, float* out) {
  const T* e = reinterpret_cast<const T*>(r.w);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
}

// the affine parameters of N columns at c: 1 and 0 where absent
template <typename W, int N>
__device__ __forceinline__ void load_affine(const W* w, const W* b, int c,
                                            float* wv, float* bv) {
  if (w) {
    load_vec<W, N>(w + c, wv);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) wv[i] = 1.f;
  }
  if (b) {
    load_vec<W, N>(b + c, bv);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) bv[i] = 0.f;
  }
}

// the sum of x over the block, the same value in every thread, in a fixed
// order; `red` holds one float per warp
__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  __syncthreads();  // a previous call's reads of red are done
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < static_cast<int>(blockDim.x) / 32; ++i) t += red[i];
  return t;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// one warp per row, the row in registers: kPer values a lane, h <= 32 kPer
template <typename T, typename W, typename O, int kPer>
__global__ void __launch_bounds__(kThreads)
ln_fwd_warp_kernel(const T* __restrict__ x, const W* __restrict__ w,
                   const W* __restrict__ b, O* __restrict__ out,
                   float* __restrict__ mean_out,
                   float* __restrict__ invvar_out, int n, int h, float eps,
                   int rms) {
  constexpr int kVec = 16 / sizeof(T);   // elements of one 16-byte load
  constexpr int kVecs = kPer / kVec;     // loads a lane
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n) return;                  // uniform across the warp
  const int nvec = h / kVec;
  const T* xr = x + static_cast<size_t>(row) * h;
  float v[kVecs][kVec];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int iv = lane + 32 * k;
    if (iv < nvec) {
      load_vec<T, kVec>(xr + iv * kVec, v[k]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[k][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) sum += v[k][i];
  }
  const float mu = rms ? 0.f : warp_sum(sum) / static_cast<float>(h);
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    if (lane + 32 * k >= nvec) continue;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float c = v[k][i] - mu;
      sq += c * c;
    }
  }
  const float inv = rsqrtf(warp_sum(sq) / static_cast<float>(h) + eps);
  O* orow = out + static_cast<size_t>(row) * h;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int iv = lane + 32 * k;
    if (iv >= nvec) continue;
    float wv[kVec], bv[kVec], o[kVec];
    load_affine<W, kVec>(w, b, iv * kVec, wv, bv);
#pragma unroll
    for (int i = 0; i < kVec; ++i) o[i] = (v[k][i] - mu) * inv * wv[i] + bv[i];
    store_vec<O, kVec>(orow + iv * kVec, o);
  }
  if (lane == 0) {
    mean_out[row] = mu;
    invvar_out[row] = inv;
  }
}

// one block per row for wide rows: three passes over x in memory
template <typename T, typename W, typename O>
__global__ void __launch_bounds__(kBlockThreads)
ln_fwd_block_kernel(const T* __restrict__ x, const W* __restrict__ w,
                    const W* __restrict__ b, O* __restrict__ out,
                    float* __restrict__ mean_out,
                    float* __restrict__ invvar_out, int n, int h, float eps,
                    int rms) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float red[kBlockThreads / 32];
  const int row = blockIdx.x;
  const int nvec = h / kVec;
  const T* xr = x + static_cast<size_t>(row) * h;
  float v[kVec];
  float mu = 0.f;
  if (!rms) {
    float sum = 0.f;
    for (int iv = threadIdx.x; iv < nvec; iv += kBlockThreads) {
      load_vec<T, kVec>(xr + iv * kVec, v);
#pragma unroll
      for (int i = 0; i < kVec; ++i) sum += v[i];
    }
    mu = block_sum(sum, red) / static_cast<float>(h);
  }
  float sq = 0.f;
  for (int iv = threadIdx.x; iv < nvec; iv += kBlockThreads) {
    load_vec<T, kVec>(xr + iv * kVec, v);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float c = v[i] - mu;
      sq += c * c;
    }
  }
  const float inv =
      rsqrtf(block_sum(sq, red) / static_cast<float>(h) + eps);
  O* orow = out + static_cast<size_t>(row) * h;
  for (int iv = threadIdx.x; iv < nvec; iv += kBlockThreads) {
    float wv[kVec], bv[kVec], o[kVec];
    load_vec<T, kVec>(xr + iv * kVec, v);
    load_affine<W, kVec>(w, b, iv * kVec, wv, bv);
#pragma unroll
    for (int i = 0; i < kVec; ++i) o[i] = (v[i] - mu) * inv * wv[i] + bv[i];
    store_vec<O, kVec>(orow + iv * kVec, o);
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mu;
    invvar_out[row] = inv;
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// The row kernel's register plan for kPer values a lane of x (T) and dy
// (D): a row's two packed arrays take kRowRegs registers and the lane's
// dgamma/dbeta partials 2 kPer. The next row is loaded early (kPrefetch)
// when both rows and the partials fit in 96 registers, and two blocks are
// asked of each SM (kMinBlocks, at most 128 registers a thread) when what
// is held does
template <typename T, typename D, int kPer>
struct BwdPlan {
  static constexpr int kRowRegs =
      kPer * static_cast<int>(sizeof(T) + sizeof(D)) / 4;
  static constexpr bool kPrefetch = 2 * kRowRegs + 2 * kPer <= 96;
  static constexpr int kMinBlocks =
      (kPrefetch ? 2 : 1) * kRowRegs + 2 * kPer <= 96 ? 2 : 1;
};

// one warp per row, grid-stride over rows; lane l owns the same columns in
// every row, so its dgamma/dbeta partials stay in registers. Each block
// writes its partial rows to part_g/part_b (ctas, h); either may be null.
template <typename T, typename D, typename W, int kPer>
__global__ void __launch_bounds__(kThreads, (BwdPlan<T, D, kPer>::kMinBlocks))
ln_bwd_warp_kernel(const D* __restrict__ dy, const T* __restrict__ x,
                   const float* __restrict__ mean,
                   const float* __restrict__ invvar,
                   const W* __restrict__ w, T* __restrict__ dx,
                   float* __restrict__ part_g, float* __restrict__ part_b,
                   int n, int h, int rms) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecs = kPer / kVec;
  constexpr bool kPrefetch = BwdPlan<T, D, kPer>::kPrefetch;
  extern __shared__ float sm[];  // the weight, then the 2 partial rows
  float* sw = sm;
  float* sg = sm + h;
  float* sb = sm + 2 * h;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int nvec = h / kVec;
  const float inv_h = 1.f / static_cast<float>(h);
  for (int i = threadIdx.x; i < h; i += kThreads) {
    sw[i] = w != nullptr ? to_float(w[i]) : 1.f;
    sg[i] = sb[i] = 0.f;
  }
  __syncthreads();

  float acc_g[kVecs][kVec], acc_b[kVecs][kVec];
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc_g[k][i] = acc_b[k][i] = 0.f;

  // a row's x and dy as loaded, and its statistics
  struct Row {
    PackedOf<T, kVec> x[kVecs];
    PackedOf<D, kVec> dy[kVecs];
    float mu, inv;
  };
  auto load_row = [&](int row, Row& r) {
    const size_t off = static_cast<size_t>(row) * h;
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int iv = lane + 32 * k;
      if (iv >= nvec) continue;
      load_packed<T, kVec>(x + off + iv * kVec, r.x[k]);
      load_packed<D, kVec>(dy + off + iv * kVec, r.dy[k]);
    }
    r.mu = rms ? 0.f : mean[row];
    r.inv = invvar[row];
  };

  const int stride = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + warp;
  Row cur, nxt;
  if (row < n) load_row(row, cur);
  for (; row < n; row += stride) {
    const int next = row + stride;
    // the next row's loads go out before this row's warp sums
    if (kPrefetch && next < n) load_row(next, nxt);
    const size_t off = static_cast<size_t>(row) * h;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int iv = lane + 32 * k;
      if (iv >= nvec) continue;
      float xv[kVec], dv[kVec];
      unpack<T, kVec>(cur.x[k], xv);
      unpack<D, kVec>(cur.dy[k], dv);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float xh = (xv[i] - cur.mu) * cur.inv;
        const float dxh = dv[i] * sw[iv * kVec + i];
        s1 += dxh;
        s2 += dxh * xh;
        acc_g[k][i] += dv[i] * xh;
        acc_b[k][i] += dv[i];
      }
    }
    const float m1 = rms ? 0.f : warp_sum(s1) * inv_h;
    const float m2 = warp_sum(s2) * inv_h;
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int iv = lane + 32 * k;
      if (iv >= nvec) continue;
      float xv[kVec], dv[kVec], g[kVec];
      unpack<T, kVec>(cur.x[k], xv);
      unpack<D, kVec>(cur.dy[k], dv);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float xh = (xv[i] - cur.mu) * cur.inv;
        const float dxh = dv[i] * sw[iv * kVec + i];
        g[i] = cur.inv * (dxh - m1 - xh * m2);
      }
      store_vec<T, kVec>(dx + off + iv * kVec, g);
    }
    if (next < n) {
      if (kPrefetch)
        cur = nxt;
      else
        load_row(next, cur);
    }
  }

  // the block's partial rows: the warps add theirs in order 0..7
  for (int turn = 0; turn < kWarps; ++turn) {
    __syncthreads();
    if (warp != turn) continue;
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int iv = lane + 32 * k;
      if (iv >= nvec) continue;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        sg[iv * kVec + i] += acc_g[k][i];
        sb[iv * kVec + i] += acc_b[k][i];
      }
    }
  }
  __syncthreads();
  const size_t prow = static_cast<size_t>(blockIdx.x) * h;
  for (int i = threadIdx.x; i < h; i += kThreads) {
    if (part_g) part_g[prow + i] = sg[i];
    if (part_b) part_b[prow + i] = sb[i];
  }
}

// one block per row for wide rows, grid-stride over rows; the block's
// partial rows live in part_g/part_b themselves (each element is read and
// written by one thread only). The caller launches at most n blocks, so
// every block owns at least one row and writes its whole partial rows.
template <typename T, typename D, typename W>
__global__ void __launch_bounds__(kBlockThreads)
ln_bwd_block_kernel(const D* __restrict__ dy, const T* __restrict__ x,
                    const float* __restrict__ mean,
                    const float* __restrict__ invvar,
                    const W* __restrict__ w, T* __restrict__ dx,
                    float* __restrict__ part_g, float* __restrict__ part_b,
                    int n, int h, int rms) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float red[kBlockThreads / 32];
  const int nvec = h / kVec;
  const float inv_h = 1.f / static_cast<float>(h);
  float* pg = part_g ? part_g + static_cast<size_t>(blockIdx.x) * h : nullptr;
  float* pb = part_b ? part_b + static_cast<size_t>(blockIdx.x) * h : nullptr;
  bool first = true;
  for (int row = blockIdx.x; row < n; row += gridDim.x) {
    const size_t off = static_cast<size_t>(row) * h;
    const float mu = rms ? 0.f : mean[row];
    const float inv = invvar[row];
    float s1 = 0.f, s2 = 0.f;
    for (int iv = threadIdx.x; iv < nvec; iv += kBlockThreads) {
      const int c = iv * kVec;
      float xv[kVec], dv[kVec], wv[kVec], unused[kVec];
      load_vec<T, kVec>(x + off + c, xv);
      load_vec<D, kVec>(dy + off + c, dv);
      load_affine<W, kVec>(w, nullptr, c, wv, unused);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float xh = (xv[i] - mu) * inv;
        const float dxh = dv[i] * wv[i];
        s1 += dxh;
        s2 += dxh * xh;
        if (pg) pg[c + i] = (first ? 0.f : pg[c + i]) + dv[i] * xh;
        if (pb) pb[c + i] = (first ? 0.f : pb[c + i]) + dv[i];
      }
    }
    const float m1 = rms ? 0.f : block_sum(s1, red) * inv_h;
    const float m2 = block_sum(s2, red) * inv_h;
    for (int iv = threadIdx.x; iv < nvec; iv += kBlockThreads) {
      const int c = iv * kVec;
      float xv[kVec], dv[kVec], wv[kVec], unused[kVec], g[kVec];
      load_vec<T, kVec>(x + off + c, xv);
      load_vec<D, kVec>(dy + off + c, dv);
      load_affine<W, kVec>(w, nullptr, c, wv, unused);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float xh = (xv[i] - mu) * inv;
        g[i] = inv * (dv[i] * wv[i] - m1 - xh * m2);
      }
      store_vec<T, kVec>(dx + off + c, g);
    }
    first = false;
  }
}

// stage two: out_g[c] = sum over the ctas partial rows of part_g[., c] (and
// the same for b, blockIdx.y == 1), rounded once to the weight's dtype W. A
// block owns 32 columns; its 32 row groups each sum every 32nd partial row
// (a handful of independent loads a thread), then one warp adds the 32
// group sums, all in a fixed order.
constexpr int kColGroups = 32;

template <typename W>
__global__ void __launch_bounds__(32 * kColGroups)
ln_colsum_kernel(const float* __restrict__ part_g,
                 const float* __restrict__ part_b, W* __restrict__ out_g,
                 W* __restrict__ out_b, int ctas, int h) {
  __shared__ float red[kColGroups][33];
  const float* part = blockIdx.y == 0 ? part_g : part_b;
  W* out = blockIdx.y == 0 ? out_g : out_b;
  if (part == nullptr) return;  // uniform across the block
  const int lane = threadIdx.x % 32;
  const int group = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < h) {
#pragma unroll 4
    for (int r = group; r < ctas; r += kColGroups)
      s += part[static_cast<size_t>(r) * h + col];
  }
  red[group][lane] = s;
  __syncthreads();
  if (group == 0 && col < h) {
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < kColGroups; ++g) t += red[g][lane];
    store_as(out + col, t);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct FwdArgs {
  const void *x, *w, *b;
  void *out, *mean, *invvar;
  int n, h;
  float eps;
  int rms;
};

template <typename T, typename W, typename O>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t st) {
  const T* x = static_cast<const T*>(a.x);
  const W* w = static_cast<const W*>(a.w);
  const W* b = static_cast<const W*>(a.b);
  O* out = static_cast<O*>(a.out);
  float* mean = static_cast<float*>(a.mean);
  float* invvar = static_cast<float*>(a.invvar);
  if (a.h <= kFwdWarpMaxH) {
    const dim3 grid((a.n + kWarps - 1) / kWarps);
    // values a lane holds, rounded up: a template of kPer covers rows of
    // up to 32 kPer values
    const int per = (a.h + 31) / 32;
    if (per <= 8)
      ln_fwd_warp_kernel<T, W, O, 8><<<grid, kThreads, 0, st>>>(
          x, w, b, out, mean, invvar, a.n, a.h, a.eps, a.rms);
    else if (per <= 32)
      ln_fwd_warp_kernel<T, W, O, 32><<<grid, kThreads, 0, st>>>(
          x, w, b, out, mean, invvar, a.n, a.h, a.eps, a.rms);
    else
      ln_fwd_warp_kernel<T, W, O, 128><<<grid, kThreads, 0, st>>>(
          x, w, b, out, mean, invvar, a.n, a.h, a.eps, a.rms);
  } else {
    ln_fwd_block_kernel<T, W, O><<<a.n, kBlockThreads, 0, st>>>(
        x, w, b, out, mean, invvar, a.n, a.h, a.eps, a.rms);
  }
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t fwd_by_out(const FwdArgs& a, int out_dtype, cudaStream_t st) {
  if (out_dtype == kFloat32) return launch_fwd<T, W, float>(a, st);
  if (out_dtype == kBFloat16) return launch_fwd<T, W, __nv_bfloat16>(a, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t fwd_by_w(const FwdArgs& a, int w_dtype, int out_dtype,
                     cudaStream_t st) {
  if (w_dtype == kFloat32) return fwd_by_out<T, float>(a, out_dtype, st);
  if (w_dtype == kBFloat16)
    return fwd_by_out<T, __nv_bfloat16>(a, out_dtype, st);
  return cudaErrorInvalidValue;
}

struct BwdArgs {
  const void *dy, *x, *mean, *invvar, *w;
  void *dx, *part_g, *part_b, *out_g, *out_b;
  int n, h, max_ctas, rms;
};

// the row kernel for width h: kPer, the values a lane holds, rounded up to
// the widths instantiated
template <typename T, typename D, typename W>
using BwdWarpFn = void (*)(const D*, const T*, const float*, const float*,
                           const W*, T*, float*, float*, int, int, int);

template <typename T, typename D, typename W>
BwdWarpFn<T, D, W> bwd_warp_kernel(int h) {
  const int per = (h + 31) / 32;
  if (per <= 8) return ln_bwd_warp_kernel<T, D, W, 8>;
  if (per <= 16) return ln_bwd_warp_kernel<T, D, W, 16>;
  if (per <= 24) return ln_bwd_warp_kernel<T, D, W, 24>;
  return ln_bwd_warp_kernel<T, D, W, 32>;
}

template <typename T, typename D, typename W>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t st) {
  const D* dy = static_cast<const D*>(a.dy);
  const T* x = static_cast<const T*>(a.x);
  const float* mean = static_cast<const float*>(a.mean);
  const float* invvar = static_cast<const float*>(a.invvar);
  const W* w = static_cast<const W*>(a.w);
  T* dx = static_cast<T*>(a.dx);
  float* pg = static_cast<float*>(a.part_g);
  float* pb = static_cast<float*>(a.part_b);
  // blocks: one for every kWarps rows (warp kernel) or every row (block
  // kernel), at most max_ctas, the partial rows the scratch holds; the row
  // kernel's also at most one wave of the blocks the SMs hold at once
  int ctas;
  if (a.h <= kBwdWarpMaxH) {
    const BwdWarpFn<T, D, W> kernel = bwd_warp_kernel<T, D, W>(a.h);
    const size_t smem = 3 * sizeof(float) * a.h;  // weight, 2 partial rows
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    ctas = std::min({(a.n + kWarps - 1) / kWarps, a.max_ctas, per_sm * sms});
    kernel<<<ctas, kThreads, smem, st>>>(dy, x, mean, invvar, w, dx, pg, pb,
                                         a.n, a.h, a.rms);
  } else {
    ctas = std::min(a.n, a.max_ctas);
    ln_bwd_block_kernel<T, D, W><<<ctas, kBlockThreads, 0, st>>>(
        dy, x, mean, invvar, w, dx, pg, pb, a.n, a.h, a.rms);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || (pg == nullptr && pb == nullptr)) return err;
  const dim3 grid((a.h + 31) / 32, 2);
  ln_colsum_kernel<W><<<grid, 32 * kColGroups, 0, st>>>(
      pg, pb, static_cast<W*>(a.out_g), static_cast<W*>(a.out_b), ctas, a.h);
  return cudaGetLastError();
}

template <typename T, typename D>
cudaError_t bwd_by_w(const BwdArgs& a, int w_dtype, cudaStream_t st) {
  if (w_dtype == kFloat32) return launch_bwd<T, D, float>(a, st);
  if (w_dtype == kBFloat16) return launch_bwd<T, D, __nv_bfloat16>(a, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t bwd_by_dy(const BwdArgs& a, int dy_dtype, int w_dtype,
                      cudaStream_t st) {
  if (dy_dtype == kFloat32) return bwd_by_w<T, float>(a, w_dtype, st);
  if (dy_dtype == kBFloat16)
    return bwd_by_w<T, __nv_bfloat16>(a, w_dtype, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace apex_port

// C entry points, bound with ctypes. dtypes: 0 fp32, 1 bf16; w and b share
// w_dtype (pass x's when there is no weight) and may be null; out_dtype is
// x's or w's. Each returns the cudaError_t of its launches (0 on success).
extern "C" int apex_ln_fwd(const void* x, const void* w, const void* b,
                           void* out, void* mean, void* invvar, int n, int h,
                           int x_dtype, int w_dtype, int out_dtype, float eps,
                           int rms, void* stream) {
  using namespace apex_port;
  const FwdArgs a{x, w, b, out, mean, invvar, n, h, eps, rms};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kFloat32) return fwd_by_w<float>(a, w_dtype, out_dtype, st);
  if (x_dtype == kBFloat16)
    return fwd_by_w<__nv_bfloat16>(a, w_dtype, out_dtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dx in x's dtype; part_g/part_b are (max_ctas, h) fp32 scratch, null
// when dgamma/dbeta are not wanted, and out_g/out_b their (h,) column sums
// in w's dtype. max_ctas >= 1 bounds the blocks launched: ceil(n / 8) at
// h <= 1024 and the blocks the SMs hold at once, n above; the column sum
// reads only the partial rows written.
extern "C" int apex_ln_bwd(const void* dy, const void* x, const void* mean,
                           const void* invvar, const void* w, void* dx,
                           void* part_g, void* part_b, void* out_g,
                           void* out_b, int n, int h, int max_ctas, int x_dtype,
                           int dy_dtype, int w_dtype, int rms, void* stream) {
  using namespace apex_port;
  const BwdArgs a{dy, x, mean, invvar, w, dx, part_g, part_b, out_g, out_b,
                  n, h, max_ctas, rms};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kFloat32) return bwd_by_dy<float>(a, dy_dtype, w_dtype, st);
  if (x_dtype == kBFloat16)
    return bwd_by_dy<__nv_bfloat16>(a, dy_dtype, w_dtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
