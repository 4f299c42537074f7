// Host-side buffer packing: the role of apex's apex_C extension
// (flatten and unflatten of many buffers into one contiguous one).
//
// The device-side flatten of the port is torch.cat over tensors on the
// card (FlatOptimizer); this library serves the host paths: packing many
// small numpy buffers into one contiguous staging buffer (checkpoint
// assembly, sampler batch packing) without a Python loop. Plain C ABI,
// loaded with ctypes: no pybind11 and no PyTorch headers, so g++ builds it
// in about a second.

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// Concatenate n buffers (srcs[i], nbytes[i]) into dst. Returns total bytes.
size_t apex_tpu_flatten(const void **srcs, const size_t *nbytes, size_t n,
                        unsigned char *dst) {
  size_t off = 0;
  for (size_t i = 0; i < n; ++i) {
    std::memcpy(dst + off, srcs[i], nbytes[i]);
    off += nbytes[i];
  }
  return off;
}

// Split src back into n buffers (dsts[i], nbytes[i]). Returns bytes read.
size_t apex_tpu_unflatten(const unsigned char *src, void **dsts,
                          const size_t *nbytes, size_t n) {
  size_t off = 0;
  for (size_t i = 0; i < n; ++i) {
    std::memcpy(dsts[i], src + off, nbytes[i]);
    off += nbytes[i];
  }
  return off;
}

// Gather rows: dst[i, :] = src[indices[i], :] for row_bytes-wide rows, the
// sampler's batch packing (one memcpy a sample).
void apex_tpu_gather_rows(const unsigned char *src, size_t row_bytes,
                          const int64_t *indices, size_t n,
                          unsigned char *dst) {
  for (size_t i = 0; i < n; ++i) {
    std::memcpy(dst + i * row_bytes,
                src + static_cast<size_t>(indices[i]) * row_bytes, row_bytes);
  }
}

}  // extern "C"
