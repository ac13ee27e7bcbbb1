// K4: Ed25519 fixed-base comb, hand-written for Hopper (sm_90a).
//
// Replaces verifiable_mpc_tpu/ops/msm_pallas.py _make_bexp_comb_kernel (the
// pallas_call in _bexp_comb_pallas) with its on-device normalize_pack:
// out_i = sum_w T[w][d_w(e_i)], one select and at most one mixed add per
// window, no doublings, then the canonical affine row.  The 9 * nw entry
// table (55 KB at nw = 64) comes affine from the host (msm_cuda.comb_table,
// built and normalized once per base), so every add is a mixed add whose
// D = 2 Z1 is an addition (7 products where the projective entry took 8),
// and the rows are read through L1/L2, every thread of a warp touching the
// same few rows.
//
// Normalization: each thread takes the exponents i = g, g + G, g + 2G, ...
// with G = min(n, one wave of msm_cuda.COMB_SM_THREADS (384) threads an
// SM: fewer than the registers allow, which ran faster on an H100), keeps
// their sums in their out rows, and normalizes the group with one
// inversion (Montgomery's trick, ed_normalize_group); an inversion an
// exponent was a third of the exponent's products.
//
// Bound: integer multiplies (a mixed add per nonzero window after the
// first, and the batch's normalization).

#include "ed25519_kernels.cuh"
#include "launch.cuh"

__global__ void comb_norm_kernel(const uint64_t *table, const uint8_t *digits,
                                 int n, int nw, int G, uint64_t *pre,
                                 uint64_t *out) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < G) comb_group(table, digits, n, nw, g, G, pre, out);
}

// the threads of K4 an SM holds at once (the wrapper runs G = min(n, that
// on every SM): one wave); a negative value is a CUDA error
extern "C" int vmpc_cu_comb_resident() {
  int blocks = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, comb_norm_kernel, K_THREADS, 0);
  return e != cudaSuccess ? -(int)e : blocks * K_THREADS;
}

// table [nw*9][12] affine rows, digits [nw/2][n], G threads (0 < G <= n),
// pre [n][4] scratch, out [n][16]
extern "C" int vmpc_cu_comb_norm(const uint64_t *table, const uint8_t *digits,
                                 int n, int nw, int G, uint64_t *pre,
                                 uint64_t *out, void *stream) {
  if (nw <= 0 || nw > 64 || G <= 0 || G > n)
    return (int)cudaErrorInvalidValue;
  comb_norm_kernel<<<blocks_for(G, K_THREADS), K_THREADS, 0,
                     (cudaStream_t)stream>>>(table, digits, n, nw, G, pre,
                                             out);
  return (int)cudaGetLastError();
}
