// Packed signed window digits, shared by the Ed25519 and BN256 kernels.
//
//   packed digits u8 [nw/2][n]: byte r of column i holds window 2r in its
//                low nibble and window 2r+1 in its high nibble, each as
//                digit + 7 (signed digits in [-7, 8]); window 0 is the most
//                significant (ops/msm_cuda.pack_digits).

#pragma once

#include <stddef.h>
#include <stdint.h>

#ifndef FE_FN
#if defined(__CUDACC__)
#define FE_FN __host__ __device__ __forceinline__
#else
#define FE_FN static inline
#endif
#endif

FE_FN int digit_at(const uint8_t *digits, int n, int w, int i) {
  uint8_t byte = digits[(size_t)(w >> 1) * n + i];
  int nib = (w & 1) ? (byte >> 4) : (byte & 15);
  return nib - 7;
}
