// Shared by the pivoted-QR panel kernels (qrcp.cu, qrcp_c64.cu): the block
// shape and the warp-level sum and argmax reductions.

#pragma once

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace rc_qrcp {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

struct ArgMax {
  float v;
  int i;
};

// Larger value wins; equal values go to the lower index.
__device__ __forceinline__ ArgMax better(ArgMax a, ArgMax b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ ArgMax warp_argmax(ArgMax a) {
  for (int o = 16; o > 0; o >>= 1) {
    ArgMax b{__shfl_xor_sync(0xffffffffu, a.v, o),
             __shfl_xor_sync(0xffffffffu, a.i, o)};
    a = better(a, b);
  }
  return a;
}

}  // namespace rc_qrcp
