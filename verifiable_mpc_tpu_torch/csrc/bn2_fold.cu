// K12: BN256 twist (G2) generator fold, hand-written for Hopper (sm_90a).
//
// Replaces the BN2 instance of verifiable_mpc_tpu/ops/msm_pallas.py
// _make_fold_kernel (the pallas_call in _fold_pallas, registered for the
// twist by ops/bn2_pallas.register): g_l[i]^c * g_r[i] for one challenge
// c, then the normalized row.  As K7, one thread per generator: a 0..15
// table of g_l[i] (local memory, 3 KB a thread), Horner over c's unsigned
// windows, add g_r[i], one GF(p^2) inversion.  c's windows travel as a
// kernel argument (constant bank), as the TPU kernel read them from SMEM.
// A first launch turns the input rows of g_l and g_r into working rows
// (bn2_encode_kernel).  No protocol folds twist points today, so this
// kernel is held against its plain version and the C++ tier only.
//
// Bound: integer multiplies (the encoding of both inputs, 14 adds for the
// table, 4 doublings a window, an add per nonzero digit, the add of g_r
// and the normalization per generator).

#include "bn2_kernels.cuh"
#include "launch.cuh"

// n input rows -> working rows, one thread per row
__global__ void bn2_encode_kernel(const uint64_t *in, uint64_t *out,
                                  long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) bn2_encode_one(in + i * BN2_ROW, out + i * BN2_ROW);
}

struct Bn2Digits64 {
  uint8_t d[64];
};

__global__ void __launch_bounds__(K_THREADS, 1)
    bn2_fold_norm_kernel(const uint64_t *gl, const uint64_t *gr,
                         Bn2Digits64 c, int nw, uint64_t *out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bn2_fold_norm_one(gl + (size_t)i * BN2_ROW, gr + (size_t)i * BN2_ROW, c.d,
                    nw, out + (size_t)i * BN2_ROW);
}

// gl, gr, out [n][24] (input rows in, result rows out), work [2n][24]
// scratch for the working rows; cdig: nw (<= 64) unsigned digits, host
// memory
extern "C" int vmpc_cu_bn2_fold_norm(const uint64_t *gl, const uint64_t *gr,
                                     uint64_t *work, const uint8_t *cdig,
                                     int nw, uint64_t *out, int n,
                                     void *stream) {
  if (nw < 0 || nw > 64) return (int)cudaErrorInvalidValue;
  Bn2Digits64 c;
  for (int w = 0; w < 64; w++) c.d[w] = w < nw ? cdig[w] : 0;
  cudaStream_t s = (cudaStream_t)stream;
  uint64_t *wl = work, *wr = work + (size_t)n * BN2_ROW;
  bn2_encode_kernel<<<blocks_for(n, K_THREADS), K_THREADS, 0, s>>>(gl, wl, n);
  bn2_encode_kernel<<<blocks_for(n, K_THREADS), K_THREADS, 0, s>>>(gr, wr, n);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  bn2_fold_norm_kernel<<<blocks_for(n, K_THREADS), K_THREADS, 0, s>>>(
      wl, wr, c, nw, out, n);
  return (int)cudaGetLastError();
}
