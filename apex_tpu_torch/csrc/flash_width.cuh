// The body widths of the flash kernels (flash_fwd.cu, flash_bwd.cu) and
// the dispatch of a launch to its width.
//
// A head dim d (a multiple of 8 from 8 to 256) runs at the body width W =
// d rounded up to a multiple of 16 (the k depth of an m16n8k16 product) at
// or below 128, and to a multiple of 32 above: _kernels.py::flash_width,
// which passes W to the entry points beside d. The loads zero-fill columns
// d..W-1 (the products over them add exact zeros) and the stores write the
// first d. W 32, 64 and 128 at d == W keep the code they had before the
// other widths (fixed_width: d is the template's W); every other (d, W)
// pair runs the body with d a run-time argument (kDyn).
//
// Each source is compiled once per group of widths, APEX_FLASH_PART
// (_kernels.py::_FLASH_PARTS, which this table must match), with its entry
// points named for the group (APEX_FLASH_ENTRY), so the groups' nvcc runs
// go side by side.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#ifndef APEX_FLASH_PART
#error "build each flash source with -DAPEX_FLASH_PART=<group of widths>"
#endif

#define APEX_FLASH_PASTE2(name, part) name##_p##part
#define APEX_FLASH_PASTE(name, part) APEX_FLASH_PASTE2(name, part)
#define APEX_FLASH_ENTRY(name) APEX_FLASH_PASTE(name, APEX_FLASH_PART)

namespace apex_port {
namespace width {

template <int... Ws>
struct List {};

// about equal compile times (a width's bodies take ~15 s plus ~0.17 s a
// column of W to compile, the fixed widths' as many again)
#if APEX_FLASH_PART == 0
using Part = List<16, 32, 48, 64>;
#elif APEX_FLASH_PART == 1
using Part = List<80, 96, 112, 160>;
#elif APEX_FLASH_PART == 2
using Part = List<128, 192>;
#elif APEX_FLASH_PART == 3
using Part = List<224, 256>;
#else
#error "APEX_FLASH_PART outside 0..3"
#endif

__host__ __device__ constexpr bool fixed_width(int W) {
  return W == 32 || W == 64 || W == 128;
}

__host__ __device__ constexpr bool valid(int d, int W) {
  return d % 8 == 0 && d >= 8 && d <= W &&
         (W <= 128 ? W % 16 == 0 && W - d < 16 : W % 32 == 0 && W - d < 32);
}

// f(std::integral_constant<int, W>, std::bool_constant<kDyn>) for this
// part's width W (kDyn unless d == W is a fixed width); an error for a
// (d, W) pair this part does not hold
template <class F>
cudaError_t dispatch(int, int, F&&, List<>) {
  return cudaErrorInvalidValue;
}

template <class F, int W, int... Rest>
cudaError_t dispatch(int d, int w, F&& f, List<W, Rest...>) {
  if (w != W) return dispatch(d, w, f, List<Rest...>{});
  if (!valid(d, W)) return cudaErrorInvalidValue;
  if constexpr (fixed_width(W)) {
    if (d == W)
      return f(std::integral_constant<int, W>{}, std::false_type{});
  }
  return f(std::integral_constant<int, W>{}, std::true_type{});
}

template <class F>
cudaError_t dispatch(int d, int w, F&& f) {
  return dispatch(d, w, f, Part{});
}

}  // namespace width
}  // namespace apex_port
