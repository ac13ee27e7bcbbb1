// K7: BN256 G1 generator fold, hand-written for Hopper (sm_90a).
//
// Replaces the BN instance of verifiable_mpc_tpu/ops/msm_pallas.py
// _make_fold_kernel (the pallas_call in _fold_pallas, registered for BN by
// ops/bn_pallas.register): g_l[i]^c * g_r[i] for one challenge c, then the
// normalized row.  c's digits travel as a kernel argument (constant bank),
// as the TPU kernel read its windows from SMEM.
//
// Design (bn_fold_group in bn254_kernels.cuh, K3's design over G1): G
// threads, thread g folding the elements g, g + G, ... and normalizing
// them with one inversion (Montgomery's trick), so no element pays a
// Fermat chain of its own; G is one wave of all the threads its registers
// allow an SM (msm_cuda.fold_threads: 256 at 179 registers, which ran
// faster than 384 or 512 by __launch_bounds__ on an H100; PERF.md).  Each
// thread encodes g_l[i] and g_r[i] from their input rows as it loads them
// (no encode launch, no scratch of working rows).  c is the width-5 NAF
// of c mod the BN order (about 43 adds) over a 768-byte local table of
// g_l[i]'s odd multiples 1..15 (one doubling and 7 adds), and the sum
// starts at its first nonzero digit: about 2,500 Montgomery products an
// element, where unsigned radix-16 windows over a 0..15 table (14 adds),
// 256 doublings from the identity and an inversion an element took about
// 3,200.
//
// Bound: integer multiplies (the field products above).

#include "bn254_kernels.cuh"
#include "launch.cuh"

__global__ void bn_fold_norm_kernel(const uint64_t *gl, const uint64_t *gr,
                                    FoldDigits c, int nd, int n, int G,
                                    uint64_t *pre, uint64_t *out) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < G) bn_fold_group(gl, gr, c.d, nd, n, g, G, pre, out);
}

// the threads of K7 an SM holds at once; a negative value is a CUDA error
extern "C" int vmpc_cu_bn_fold_resident() {
  int blocks = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, bn_fold_norm_kernel, K_THREADS, 0);
  return e != cudaSuccess ? -(int)e : blocks * K_THREADS;
}

// gl, gr [n][12] input rows, out [n][12] result rows; cdig: nd
// (<= FOLD_DIGITS) NAF digits, host memory; G threads (0 < G <= n);
// pre [n][4] scratch
extern "C" int vmpc_cu_bn_fold_norm(const uint64_t *gl, const uint64_t *gr,
                                    const int8_t *cdig, int nd, int G,
                                    uint64_t *pre, uint64_t *out, int n,
                                    void *stream) {
  if (nd < 0 || nd > FOLD_DIGITS || G <= 0 || G > n)
    return (int)cudaErrorInvalidValue;
  FoldDigits c;
  for (int b = 0; b < FOLD_DIGITS; b++) c.d[b] = b < nd ? cdig[b] : 0;
  bn_fold_norm_kernel<<<blocks_for(G, K_THREADS), K_THREADS, 0,
                        (cudaStream_t)stream>>>(gl, gr, c, nd, n, G, pre,
                                                out);
  return (int)cudaGetLastError();
}
