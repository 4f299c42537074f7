// Exact rounding of the backward's bf16 operands, shared by the tensor-core
// bodies of flash_bwd_dq (dS) and flash_bwd_dkv (P_eff and dS).
//
// The plain version's S = q k^T and dP = do v^T are cuBLAS fp32 sums, bit
// for bit a sequential fmaf chain over d from 0; the tensor cores' sums
// (each 16-wide k chunk into a fresh accumulator) differ from them by about
// 2^-23 |q| |k|. That moves a probability across a bf16 rounding point now
// and then, and one flipped P_eff or dS of a large probability moves a dK,
// dV or dQ element by up to 2^-7 p |do| (|q|, |k|), several times the
// checks' limit at the long-context shape. So a score whose p exceeds
// kFixP, and whose P_eff or dS lies closer to a bf16 rounding point than
// the sums' error bound (kFixKappa |q| |k|) carried through each fp32 step
// (kFixU of each step's value, and __expf's error) allows, has its sums
// taken again by that fmaf chain from the staged tiles, and its chain again
// with expf (the flagged-score pass, for_each_bit below). Flips of smaller
// probabilities move an element by under 2^-13 |do|.
#pragma once

#include "common.cuh"

#include <cuda_bf16.h>
#include <stdint.h>

namespace apex_port {
namespace rounding {

constexpr float kFixP = 1.f / 64.f;
constexpr float kFixKappa = 1.f / (1 << 20);
constexpr float kFixU = 1.f / (1 << 22);
// |x - lse| < 5.55 where p > kFixP, plus __expf's error (under 2^-20 of
// its value, kFixU of its argument's magnitude included), in units of
// kFixU
constexpr float kXPad = 5.55f + 4.f;

// a score's chain after its two sums, each fp32 op rounded on its own (no
// contraction into an fma) where the plain version rounds:
// p = exp(s * scale + bias - lse), p_eff = keep * p * inv_keep,
// ds = p * (keep * dp * inv_keep - delta); kExact takes expf, as the plain
// version, else __expf
struct Score {
  float p, p_eff, ds;
  float x_mag;  // |s * scale| + |s * scale + bias|
  float t_mag;  // |dp_eff| + |dp_eff - delta|
};

template <bool kExact>
__device__ __forceinline__ Score score_chain(float s, float dp, float scale,
                                             bool has_bias, float b,
                                             float lse, float delta,
                                             const Dropout& dr, bool keep) {
  Score r;
  const float x1 = __fmul_rn(s, scale);
  const float x2 = has_bias ? __fadd_rn(x1, b) : x1;
  // a fully masked row has lse = +inf: exp(s - inf) == 0
  const float x3 = __fsub_rn(x2, lse);
  r.p = kExact ? expf(x3) : __expf(x3);
  r.p_eff = r.p;
  float dpe = dp;
  if (dr.on) {
    r.p_eff = keep ? __fmul_rn(r.p, dr.inv_keep) : 0.f;
    dpe = keep ? __fmul_rn(dp, dr.inv_keep) : 0.f;
  }
  const float t = __fsub_rn(dpe, delta);
  r.ds = __fmul_rn(r.p, t);
  r.x_mag = fabsf(x1) + fabsf(x2);
  r.t_mag = fabsf(dpe) + fabsf(t);
  return r;
}

// whether y lies within r of the point halfway between its two nearest
// bf16 values, where round to nearest turns
__device__ __forceinline__ bool near_bf16_midpoint(float y, float r) {
  const float mid =
      __int_as_float((__float_as_int(y) & 0xffff0000) | 0x8000);
  return fabsf(y - mid) <= r;
}

// The flag tests of a score with p > kFixP. `qk` bounds the error of the
// tensor cores' S sum times scale (kFixKappa scale |q| |k|), `dv` that of
// dP_eff (kFixKappa inv_keep |do| |v|).
// whether its dS may round to another bf16 value than the plain version's
__device__ __forceinline__ bool ds_uncertain(const Score& sc, float qk,
                                             float dv) {
  const float dx = qk + kFixU * (sc.x_mag + kXPad);
  const float dt = dv + kFixU * sc.t_mag;
  return near_bf16_midpoint(sc.ds, fabsf(sc.ds) * (dx + kFixU) + sc.p * dt);
}

// whether its P_eff may
__device__ __forceinline__ bool p_eff_uncertain(const Score& sc, float qk) {
  const float dx = qk + kFixU * (sc.x_mag + kXPad);
  return near_bf16_midpoint(sc.p_eff, sc.p_eff * (dx + kFixU));
}

// The folded dbias (flash_bwd_dkv's kDbias body) sums each score's fp32 dS
// unrounded, so there a score's x2 = S scale + bias has to round where the
// plain version's does. Under a large bias it may not: an ALiBi row
// reaches ~2580, where an fp32 ulp is 2.4e-4, and the tensor cores' x1 =
// S scale, a little off the plain version's, can lie on the other side of
// one of x2's rounding points; p then moves by a relative 2.4e-4, and the
// long-context path's dbias by more than its limit (1.28 of it, on an
// H100, without this test). A score of p > kFixP where such a flip would
// move p by about kFoldFlip or more (p times an ulp of its key's bias,
// fp32_ulp) and may happen (bias_sum_uncertain, x1 taken to lie within
// kFoldKappa scale |q| |k| + 2^-23 |x1| of the plain version's: a few
// times the sums' typical error, not kFixKappa's bound) has its dS taken
// again for the fold. Neither window is a bound, and a score of p <= kFixP
// is never tested: the test sits in the bf16 tests' branch for p > kFixP
// (run on every score, it cost the fold twice as much at the same error).
// So what the flips it lets pass move is not bounded here; chip_smoke.py
// holds the fold under its limit at the long-context path's inputs, at
// three other seeds', under slopes 2 and 4 times steeper and with the
// slopes the path trained (PERF.md).
constexpr float kFoldFlip = 1.f / (1 << 18);
constexpr float kFoldKappa = 1.f / (1 << 21);

// an ulp of x, the spacing of the fp32 values at |x| (0 under 2^-103)
__device__ __forceinline__ float fp32_ulp(float x) {
  const int bits = __float_as_int(fabsf(x)) & 0x7f800000;
  return __int_as_float(max(bits - (23 << 23), 0));
}

// whether x1 + b, with x1 within dx of the plain version's, may round to
// another fp32 value than the plain version's
__device__ __forceinline__ bool bias_sum_uncertain(float x1, float b,
                                                   float dx) {
  const float x2 = __fadd_rn(x1, b);
  // the rounding error of x2, exactly (TwoSum)
  const float bt = __fsub_rn(x2, x1);
  const float err =
      __fadd_rn(__fsub_rn(x1, __fsub_rn(x2, bt)), __fsub_rn(b, bt));
  const float away = x2 < 0.f ? -err : err;  // toward larger |x2|
  // the rounding points of x2: half an ulp above |x2| and half an ulp
  // below it (a quarter at a power of two, whose lower neighbour is nearer)
  const float ulp = fp32_ulp(x2);
  const bool pow2 = (__float_as_int(x2) & 0x7fffff) == 0;
  const float below = pow2 ? 0.25f * ulp : 0.5f * ulp;
  return fminf(0.5f * ulp - away, below + away) <= dx;
}

// the plain version's sum of a (row, key) score: fmaf over d from 0, on
// two padded bf16 rows of shared tiles, 16 bytes of each at a time
template <int D>
__device__ __forceinline__ float fma_chain(const __nv_bfloat16* a,
                                           const __nv_bfloat16* b) {
  float acc = 0.f;
  for (int c = 0; c < D; c += 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(a + c);
    const uint4 y = *reinterpret_cast<const uint4*>(b + c);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
    const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 pair: the low half first, each widened by a 16-bit shift
      acc = fmaf(__uint_as_float(xs[i] << 16), __uint_as_float(ys[i] << 16),
                 acc);
      acc = fmaf(__uint_as_float(xs[i] & 0xffff0000u),
                 __uint_as_float(ys[i] & 0xffff0000u), acc);
    }
  }
  return acc;
}

// sqrt of the sum of squares of a padded bf16 row of a shared tile: a norm
// for the bounds above (its own rounding is far inside their margins)
template <int D>
__device__ __forceinline__ float row_norm(const __nv_bfloat16* a) {
  float acc = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; c += 2) {
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a + c));
    acc = fmaf(x.x, x.x, fmaf(x.y, x.y, acc));
  }
  return sqrtf(acc);
}

// The flagged-score pass: f(pos) for each set bit of `bits`, lowest first,
// one at a time. Bit nt * 4 + e names element e of 8-wide n-tile nt of a
// warp's m16n8 score fragments (the order the flag loops set them in).
template <class F>
__device__ __forceinline__ void for_each_bit(uint32_t bits, F&& f) {
  for (; bits != 0; bits &= bits - 1) f(__ffs(bits) - 1);
}

// frag[pos / 4][pos % 4], with every index static
template <int kNT>
__device__ __forceinline__ float get_elem(const float (&frag)[kNT][4],
                                          int pos) {
  float x = 0.f;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (pos == nt * 4 + e) x = frag[nt][e];
  return x;
}

// frag[pos / 4][pos % 4] = x with every index static, so the fragments
// stay in registers
template <int kNT>
__device__ __forceinline__ void set_elem(float (&frag)[kNT][4], int pos,
                                         float x) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (pos == nt * 4 + e) frag[nt][e] = x;
}

}  // namespace rounding
}  // namespace apex_port
