// Launch helpers shared by the kernel sources (K1-K16).  Each source
// builds to its own object (one nvcc per source, run in parallel) and the
// objects link into one library with a plain C interface.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define K_THREADS 128

static inline int blocks_for(long long count, int threads) {
  return (int)((count + threads - 1) / threads);
}
