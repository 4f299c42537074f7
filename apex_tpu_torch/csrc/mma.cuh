// Tensor-core fragment helpers shared by the bf16 bodies of the flash
// kernels (sm_80+ instructions, built for sm_90a): the m16n8k16 bf16
// product with fp32 accumulation, ldmatrix loads of its operands from
// shared memory, cp.async staging with zero fill, a padded shared layout
// for (rows, D) bf16 tiles, and the packing of an accumulator fragment
// into the bf16 A fragment of the next product.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major), 4 registers of two bf16 each:
//     a[0] = (row g,     cols 2t, 2t+1)    a[1] = (row g + 8, cols 2t, 2t+1)
//     a[2] = (row g,     cols 2t+8, 2t+9)  a[3] = (row g + 8, cols 2t+8, 2t+9)
//   B (16 x 8, k x n), 2 registers:
//     b[0] = (k 2t, 2t+1; n g)             b[1] = (k 2t+8, 2t+9; n g)
//   C (16 x 8, fp32), 4 floats:
//     c[0], c[1] = (row g, cols 2t, 2t+1)  c[2], c[3] = (row g + 8, same)
// So every element index of a score tile is computed from the lane, never
// from a thread index.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace apex_port {
namespace mma {

// bf16 elements a shared tile row holds beyond its body width W: 16 bytes
// of pad, so the eight 16-byte row reads of one ldmatrix 8x8 matrix fall
// in eight distinct groups of four banks at every W the kernels take (a
// multiple of 16: row strides of 2 W + 16 bytes, 48 at W 16, 80, 144 and
// 272 at W 32, 64 and 128, 528 at W 256), and every row start stays
// 16-byte aligned for cp.async
constexpr int kPad = 8;

template <int W>
__host__ __device__ constexpr int ld() { return W + kPad; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// c += a b: one m16n8k16 product, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and lane l receives (row l / 4, cols 2 (l % 4), +1) of each matrix
// (with .trans: (rows 2 (l % 4), +1; col l / 4)).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Two 8x8 matrices transposed: lanes 0..7 give the row addresses of
// matrix 0, lanes 8..15 those of matrix 1 (the other lanes' are not read)
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t r[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// Row-major tile of row stride ld<D>(), [rows][D]. The address lane l
// gives to ldmatrix so that the four matrices are (rows r0..r0+7, cols
// c0..c0+7), (r0+8.., c0..), (r0.., c0+8..), (r0+8.., c0+8..):
//   non-trans: the A fragment of the 16 x 16 block at (r0, c0);
//   .trans:    B fragments of a [k][n] tile (k = rows, n = cols): r[0],
//              r[1] for n-tile c0..c0+7, r[2], r[3] for c0+8..c0+15.
template <int D>
__device__ __forceinline__ const __nv_bfloat16* frag_a_ptr(
    const __nv_bfloat16* tile, int r0, int c0, int lane) {
  return tile + (r0 + (lane & 15)) * ld<D>() + c0 + (lane >> 4) * 8;
}

// The address lane l gives to a non-trans ldmatrix for B fragments of an
// [n][k] tile (n = rows, k = cols, the "col" operand stored row by row):
// r[0], r[1] = b0, b1 of n-tile r0..r0+7 over k c0..c0+15; r[2], r[3] =
// those of n-tile r0+8..r0+15
template <int D>
__device__ __forceinline__ const __nv_bfloat16* frag_bt_ptr(
    const __nv_bfloat16* tile, int r0, int c0, int lane) {
  return tile + (r0 + (lane & 7) + ((lane >> 4) << 3)) * ld<D>() + c0 +
         ((lane >> 3) & 1) * 8;
}

// two fp32 values rounded to bf16 (round to nearest even, as
// __float2bfloat16 and torch's cast), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment over k = 16 kc .. 16 kc + 15 of a 16-row product whose
// k dim is the n dim of the accumulator tiles c[0 .. 2 kc + 1] (FA-2's
// order: n-tile 2 kc gives a[0], a[1], n-tile 2 kc + 1 gives a[2], a[3]),
// rounded to bf16
__device__ __forceinline__ void pack_a(uint32_t a[4], const float c0[4],
                                       const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// 16-byte global -> shared copy; with `full` false nothing is read and
// the 16 bytes are zero-filled (rows past the sequence)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(full ? 16 : 0));
}

// 4-byte copy, zero-filled without `full` (per-row fp32 and int32 values)
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows [r0, r0 + 64) of a (len, d) bf16 slice into a padded
// [64][ld<W>()] tile of body width W with cp.async, `kThreads` threads;
// rows at or past `len` are zero-filled (their source address is the
// slice's start). Without kDyn, d is W; with it, d is a run-time multiple
// of 8 below or at W (the slice's row stride), and columns d..W-1 are
// zero-filled by the copy's src-size operand, so the products over the
// body width add exact zeros
template <int W, int kThreads, bool kDyn = false>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int r0,
                                           int len, int d = W) {
  constexpr int kChunks = W / 8;  // 16-byte chunks a row
  constexpr int kTotal = 64 * kChunks;
  const int stride = kDyn ? d : W;
#pragma unroll
  for (int it = 0; it < (kTotal + kThreads - 1) / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    // widths whose chunks do not split evenly over the threads (80 and 112
    // over the dkv body's 256)
    if (kTotal % kThreads != 0 && i >= kTotal) break;
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool in = r0 + r < len && (!kDyn || c < d);
    const __nv_bfloat16* g =
        src + (in ? static_cast<size_t>(r0 + r) * stride + c : 0);
    cp_async_16(dst + r * ld<W>() + c, g, in);
  }
}

// ---------------------------------------------------------------------------
// Segment-id tile ranges: per batch row, the (min, max) id of each
// 64-position tile, int32 (b, ceil(len / 64), 2); a (q tile, key tile)
// pair whose ranges are disjoint holds no visible score, whatever the ids,
// and is skipped. Mirror of apex_tpu_torch/ops/flash_attention.py::
// _tiles_meet.
// ---------------------------------------------------------------------------

constexpr int kIdTile = 64;

__device__ __forceinline__ bool tiles_meet(const int* q_rng, int q_tile,
                                           const int* kv_rng, int kv_tile) {
  const int qlo = q_rng[2 * q_tile], qhi = q_rng[2 * q_tile + 1];
  const int klo = kv_rng[2 * kv_tile], khi = kv_rng[2 * kv_tile + 1];
  return khi >= qlo && klo <= qhi;
}

}  // namespace mma
}  // namespace apex_port
