// Packed signed window digits, shared by the Ed25519 and BN256 kernels.
//
//   packed digits u8 [nw/2][n]: byte r of column i holds window 2r in its
//                low nibble and window 2r+1 in its high nibble, each as
//                digit + 7 (signed digits in [-7, 8]); window 0 is the most
//                significant (ops/msm_cuda.pack_digits).
//   fold digits  i8 [nd <= FOLD_DIGITS]: a fold challenge c's width-5
//                NAF, most significant first (ops/msm_cuda.fold_digits:
//                254 digits for Ed25519's l, 257 for the 256-bit BN
//                order), passed to K3, K7 and K12 by value (the constant
//                bank)

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

#define FOLD_DIGITS 257  // ops/msm_cuda.MAX_FOLD_DIGITS

struct FoldDigits {
  int8_t d[FOLD_DIGITS];
};

FE_FN int digit_at(const uint8_t *digits, int n, int w, int i) {
  uint8_t byte = digits[(size_t)(w >> 1) * n + i];
  int nib = (w & 1) ? (byte >> 4) : (byte & 15);
  return nib - 7;
}
