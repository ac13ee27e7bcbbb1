// K8: BN256 G1 fixed-base comb, hand-written for Hopper (sm_90a).
//
// Replaces the BN instance of verifiable_mpc_tpu/ops/msm_pallas.py
// _make_bexp_comb_kernel (the pallas_call in _bexp_comb_pallas, with the
// group law of ops/bn_pallas.py), plus the normalization that the TPU left
// to the host: out_i = sum_w T[w][d_w(e_i)], one select and one add per
// window, no doublings, then the normalized row.  One thread per exponent;
// the 9 * nw entry table (55 KB at nw = 64) is read through L1/L2, every
// thread of a warp touching the same few rows.  A first launch turns the
// table's input rows into working rows (bn_encode_kernel); the table is a
// few hundred rows, so this costs microseconds.
//
// Bound: integer multiplies (12 Montgomery products per nonzero window
// plus the normalization per exponent).

#include "bn254_kernels.cuh"
#include "launch.cuh"

__global__ void bn_comb_norm_kernel(const uint64_t *table,
                                    const uint8_t *digits, int n, int nw,
                                    uint64_t *out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bn_comb_norm_one(table, digits, n, nw, i, out + (size_t)i * 12);
}

// table [nw*9][12] input rows, work [nw*9][12] scratch for the working
// rows, digits [nw/2][n], out [n][12]
extern "C" int vmpc_cu_bn_comb_norm(const uint64_t *table, uint64_t *work,
                                    const uint8_t *digits, int n, int nw,
                                    uint64_t *out, void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
  bn_encode_kernel<<<blocks_for(nw * 9, K_THREADS), K_THREADS, 0, s>>>(
      table, work, nw * 9);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  bn_comb_norm_kernel<<<blocks_for(n, K_THREADS), K_THREADS, 0, s>>>(
      work, digits, n, nw, out);
  return (int)cudaGetLastError();
}
