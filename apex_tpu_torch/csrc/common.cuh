// Helpers shared by the port's attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace apex_port {

constexpr float kNegInf = -1e30f;  // the masking value of the reference
constexpr unsigned kFullMask = 0xffffffffu;

// dtype codes of the C entry points (mirrored in _kernels.py)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kInt8 = 2;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// x rounded to T and widened back: the reference's `.astype(dtype)` before
// a product
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// One 16-byte load of N = 16 / sizeof(T) consecutive elements, widened to
// fp32. The caller guarantees 16-byte alignment.
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
  __device__ __forceinline__ static void load(const T* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// Counter-hash attention dropout, bit for bit the reference's
// (apex_tpu/ops/flash_attention.py::_mix32, _keep_mask): a murmur3 finalizer
// over uint32, keyed on (seed, global batch-head, global row, global col),
// so every kernel regenerates the same mask whatever its tiling, and the
// backward needs no stored mask.
// ---------------------------------------------------------------------------

constexpr uint32_t kMix1 = 0x85EBCA6Bu;
constexpr uint32_t kMix2 = 0xC2B2AE35u;
constexpr uint32_t kGold = 0x9E3779B1u;

__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= kMix1;
  x ^= x >> 13;
  x *= kMix2;
  return x ^ (x >> 16);
}

// What a launch needs to regenerate the mask. `thresh` is
// int(rate * 2**24); an entry is kept iff its top-24-bit draw >= thresh, and
// kept probabilities are scaled by `inv_keep` = 1 / (1 - rate).
struct Dropout {
  int on;
  uint32_t seed;  // the int32 bit pattern of the reference's dropout_seed
  int thresh;
  float inv_keep;
};

// the per-(seed, batch-head) half of the hash, hoisted out of the tile loops
__device__ __forceinline__ uint32_t dropout_bh_key(const Dropout& dr,
                                                   uint32_t bh) {
  return mix32(dr.seed ^ mix32(bh));
}

__device__ __forceinline__ bool dropout_keep(uint32_t bh_key, uint32_t row,
                                             uint32_t col, int thresh) {
  const uint32_t x = mix32(mix32(bh_key ^ mix32(row * kGold + col)) + kGold);
  return static_cast<int>(x >> 8) >= thresh;
}

}  // namespace apex_port
