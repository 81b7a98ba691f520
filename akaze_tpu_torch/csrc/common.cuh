// Helpers shared by the kernels of akaze_tpu_torch (see _build.py).
#pragma once

#include <cuda_runtime.h>

// Reflect-101 index (i < 0 -> -i, i >= n -> 2n-2-i; one mirror), clamped
// into [0, n) so that reads past one mirror stay in bounds.  Callers only
// use such reads for outputs they discard.
__device__ __forceinline__ int mirror_index(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}
