// K4: Ed25519 fixed-base comb, hand-written for Hopper (sm_90a).
//
// Replaces verifiable_mpc_tpu/ops/msm_pallas.py _make_bexp_comb_kernel (the
// pallas_call in _bexp_comb_pallas) with its on-device normalize_pack:
// out_i = sum_w T[w][d_w(e_i)], one select and one mixed add per window,
// no doublings, then the canonical affine row.  One thread per exponent;
// the 9 * nw entry table (74 KB at nw = 64) is read through L1/L2, every
// thread of a warp touching the same few rows.
//
// Bound: integer multiplies (8 per nonzero window plus ~268 for the
// normalization per exponent).

#include "ed25519_kernels.cuh"
#include "launch.cuh"

__global__ void comb_norm_kernel(const uint64_t *table, const uint8_t *digits,
                                 int n, int nw, uint64_t *out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  comb_norm_one(table, digits, n, nw, i, out + (size_t)i * 16);
}

// table [nw*9][16] pre rows, digits [nw/2][n], out [n][16]
extern "C" int vmpc_cu_comb_norm(const uint64_t *table, const uint8_t *digits,
                                 int n, int nw, uint64_t *out, void *stream) {
  comb_norm_kernel<<<blocks_for(n, K_THREADS), K_THREADS, 0,
                     (cudaStream_t)stream>>>(table, digits, n, nw, out);
  return (int)cudaGetLastError();
}
