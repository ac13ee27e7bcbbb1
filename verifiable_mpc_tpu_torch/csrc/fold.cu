// K3: Ed25519 generator fold, hand-written for Hopper (sm_90a).
//
// Replaces verifiable_mpc_tpu/ops/msm_pallas.py _make_fold_kernel (the
// pallas_call in _fold_pallas) together with the engine's
// fold-then-normalize (ac20/pivot_tpu._fold_norm_call, plain jnp there):
// g_l[i]^c * g_r[i] for one challenge c, then the canonical affine row.
// One thread per generator: a 0..15 precomputed-form table of g_l[i] (in
// local memory), Horner over c's unsigned windows, add g_r[i], Fermat
// inversion.  c's windows travel as a kernel argument (constant bank), as
// the TPU kernel read them from SMEM.
//
// Bound: integer multiplies (about 2,400 field multiplies per generator,
// a third of them in the normalization).

#include "ed25519_kernels.cuh"
#include "launch.cuh"

struct Digits64 {
  uint8_t d[64];
};

__global__ void fold_norm_kernel(const uint64_t *gl, const uint64_t *gr,
                                 Digits64 c, int nw, uint64_t *out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fold_norm_one(gl + (size_t)i * 16, gr + (size_t)i * 16, c.d, nw,
                out + (size_t)i * 16);
}

// gl, gr, out [n][16]; cdig: nw (<= 64) unsigned digits, host memory
extern "C" int vmpc_cu_fold_norm(const uint64_t *gl, const uint64_t *gr,
                                 const uint8_t *cdig, int nw, uint64_t *out,
                                 int n, void *stream) {
  if (nw < 0 || nw > 64) return (int)cudaErrorInvalidValue;
  Digits64 c;
  for (int w = 0; w < 64; w++) c.d[w] = w < nw ? cdig[w] : 0;
  fold_norm_kernel<<<blocks_for(n, K_THREADS), K_THREADS, 0,
                     (cudaStream_t)stream>>>(gl, gr, c, nw, out, n);
  return (int)cudaGetLastError();
}
