// K3: Ed25519 generator fold, hand-written for Hopper (sm_90a).
//
// Replaces verifiable_mpc_tpu/ops/msm_pallas.py _make_fold_kernel (the
// pallas_call in _fold_pallas) together with the engine's
// fold-then-normalize (ac20/pivot_tpu._fold_norm_call, plain jnp there):
// g_l[i]^c * g_r[i] for one challenge c, then the canonical affine row.
// c's digits travel as a kernel argument (constant bank), as the TPU
// kernel read its windows from SMEM.
//
// Design (fold_group in ed25519_kernels.cuh): G threads, thread g folding
// the elements g, g + G, ... and normalizing them with one inversion
// (Montgomery's trick), so no element pays a Fermat chain of its own; G
// is one wave of msm_cuda.FOLD_SM_THREADS["fold"] threads an SM, fewer
// than the registers allow, which ran faster on the H100 (PERF.md).  c is
// a width-5 NAF (about 43 adds, where signed radix-16 takes about 60) over
// a 1 KB local table of g_l[i]'s odd multiples 1..15 (K1's table body),
// the sum starts at its first nonzero digit, and T is computed only in
// the doubling an add reads: about 2,250 field products an element, where
// unsigned radix-16 windows over a 0..15 table, 256 full doublings and an
// inversion an element took about 2,930.
//
// Bound: integer multiplies (the field products above).

#include "ed25519_kernels.cuh"
#include "launch.cuh"

__global__ void fold_norm_kernel(const uint64_t *gl, const uint64_t *gr,
                                 FoldDigits c, int nd, int n, int G,
                                 uint64_t *pre, uint64_t *out) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < G) fold_group(gl, gr, c.d, nd, n, g, G, pre, out);
}

// the threads of K3 an SM holds at once; a negative value is a CUDA error
extern "C" int vmpc_cu_fold_resident() {
  int blocks = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fold_norm_kernel, K_THREADS, 0);
  return e != cudaSuccess ? -(int)e : blocks * K_THREADS;
}

// gl, gr, out [n][16]; cdig: nd (<= FOLD_DIGITS) NAF digits, host
// memory; G threads (0 < G <= n); pre [n][4] scratch
extern "C" int vmpc_cu_fold_norm(const uint64_t *gl, const uint64_t *gr,
                                 const int8_t *cdig, int nd, int G,
                                 uint64_t *pre, uint64_t *out, int n,
                                 void *stream) {
  if (nd < 0 || nd > FOLD_DIGITS || G <= 0 || G > n)
    return (int)cudaErrorInvalidValue;
  FoldDigits c;
  for (int b = 0; b < FOLD_DIGITS; b++) c.d[b] = b < nd ? cdig[b] : 0;
  fold_norm_kernel<<<blocks_for(G, K_THREADS), K_THREADS, 0,
                     (cudaStream_t)stream>>>(gl, gr, c, nd, n, G, pre, out);
  return (int)cudaGetLastError();
}
