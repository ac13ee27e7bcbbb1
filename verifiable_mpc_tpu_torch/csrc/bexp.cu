// K15: Ed25519 fixed-base batch exponentiation, hand-written for Hopper
// (sm_90a).
//
// Replaces the Ed25519 instance of verifiable_mpc_tpu/ops/msm_pallas.py
// _make_bexp_kernel (the pallas_call in _bexp_pallas, reached through
// msm_pallas.batch_exp and _batch_exp_generic), plus the normalization the
// TPU left to the host: base^e_i for a shared base by a signed-window
// Horner ladder (4 doublings and a mixed add of +-T[|d|] per window), then
// the canonical affine row.  One thread per exponent, as K11 on the twist.
// The table T = 0..8 times the base is built on the host (as on the TPU),
// in precomputed form; every block copies its 1,152 bytes into shared
// memory, where a warp's threads read the entries their digits select.
//
// Bound: integer multiplies (4 doublings per window after the exponent's
// first nonzero one, a mixed add per nonzero digit, and the batch's
// normalization).

#include "ed25519_kernels.cuh"
#include "launch.cuh"

__global__ void bexp_norm_kernel(const uint64_t *tbl, const uint8_t *digits,
                                 int n, int nw, uint64_t *out) {
  __shared__ uint64_t sh[9 * 16];
  for (int j = threadIdx.x; j < 9 * 16; j += blockDim.x) sh[j] = tbl[j];
  __syncthreads();
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bexp_norm_one(sh, digits, n, nw, i, out + (size_t)i * 16);
}

// table [9][16] precomputed-form rows (m * base for m = 0..8),
// digits [nw/2][n], out [n][16]
extern "C" int vmpc_cu_bexp_norm(const uint64_t *table, const uint8_t *digits,
                                 int n, int nw, uint64_t *out, void *stream) {
  bexp_norm_kernel<<<blocks_for(n, K_THREADS), K_THREADS, 0,
                     (cudaStream_t)stream>>>(table, digits, n, nw, out);
  return (int)cudaGetLastError();
}
