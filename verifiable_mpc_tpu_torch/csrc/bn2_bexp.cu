// K11: BN256 twist (G2) fixed-base batch exponentiation, hand-written for
// Hopper (sm_90a).
//
// Replaces the BN2 instance of verifiable_mpc_tpu/ops/msm_pallas.py
// _make_bexp_kernel (the pallas_call in _bexp_pallas, reached through
// _batch_exp_generic with the twist group law of ops/bn2_pallas.py), plus
// the normalization that the TPU left to the host: base^e_i for a shared
// base, by a signed-window Horner ladder over the exponent's windows (4
// doublings and one add of +-T[|d|] each), then the normalized row.  One
// thread per exponent.  The table T = 0..8 times the base is built on the
// host (as on the TPU) and uploaded as 9 input rows; a first launch turns
// them into working rows (bn2_encode_kernel), and every block copies the
// 1.7 KB table into shared memory, where a warp's threads read the entries
// their digits select.
//
// Bound: integer multiplies (4 doublings of 25 Montgomery products per
// window after the exponent's first nonzero one, an add of 42 per nonzero
// digit, and the batch's normalization).  Unlike the comb (K8), this
// ladder doubles: about 70 % of its products are doublings.

#include "bn2_kernels.cuh"
#include "launch.cuh"

__global__ void __launch_bounds__(K_THREADS, 1)
    bn2_bexp_kernel(const uint64_t *tbl, const uint8_t *digits, int n,
                    int nw, uint64_t *out) {
  __shared__ uint64_t sh[9 * BN2_ROW];
  for (int j = threadIdx.x; j < 9 * BN2_ROW; j += blockDim.x) sh[j] = tbl[j];
  __syncthreads();
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bn2_bexp_one(sh, digits, n, nw, i, out + (size_t)i * BN2_ROW);
}

// table [9][24] input rows (m * base for m = 0..8), work [9][24] scratch
// for their working rows, digits [nw/2][n], out [n][24]
extern "C" int vmpc_cu_bn2_bexp(const uint64_t *table, uint64_t *work,
                                const uint8_t *digits, int n, int nw,
                                uint64_t *out, void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
  bn2_encode_kernel<<<1, 32, 0, s>>>(table, work, 9);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  bn2_bexp_kernel<<<blocks_for(n, K_THREADS), K_THREADS, 0, s>>>(
      work, digits, n, nw, out);
  return (int)cudaGetLastError();
}
