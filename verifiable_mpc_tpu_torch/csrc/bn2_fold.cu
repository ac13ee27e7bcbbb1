// K12: BN256 twist (G2) generator fold, hand-written for Hopper (sm_90a).
//
// Replaces the BN2 instance of verifiable_mpc_tpu/ops/msm_pallas.py
// _make_fold_kernel (the pallas_call in _fold_pallas, registered for the
// twist by ops/bn2_pallas.register): g_l[i]^c * g_r[i] for one challenge
// c, then the normalized row.  c's digits travel as a kernel argument
// (constant bank), as the TPU kernel read its windows from SMEM.  No
// protocol folds twist points today, so this kernel is held against its
// plain version and the C++ tier only.
//
// Design (bn2_fold_group in bn2_kernels.cuh, K7's over GF(p^2)): G
// threads, thread g folding the elements g, g + G, ... and normalizing
// them with one GF(p^2) inversion; G is one wave of the FOLD2_BLOCKS
// blocks an SM that __launch_bounds__ makes room for
// (msm_cuda.fold_threads).  Each thread encodes g_l[i] and g_r[i] as it
// loads them (no encode launch, no scratch of working rows).  c is the
// width-5 NAF of c mod the BN order over a 1.5 KB local table of g_l[i]'s
// odd multiples 1..15 (one doubling and 7 adds), the sum started at its
// first nonzero digit: about 8,400
// base-field products an element, where unsigned radix-16 windows over a
// 3 KB 0..15 table, 256 doublings from the identity and an inversion an
// element took about 9,900.  A point is 48 32-bit words: at two blocks an
// SM the kernel takes the 255-register cap with 1.1 KB of spill stores a
// thread; four blocks (512 threads an SM) cap it at 128 registers with
// 8.4 KB of spill stores, and ran 11 % faster on an H100 than three and
// about 15 % faster than two all the same; five, six and eight ran 19-30 %
// slower than three (chip_variants.py's k12_blocks*, PERF.md).
//
// Bound: integer multiplies (the base-field products above).

#define FOLD2_BLOCKS 4  // blocks of K_THREADS an SM

#include "bn2_kernels.cuh"
#include "launch.cuh"

__global__ void __launch_bounds__(K_THREADS, FOLD2_BLOCKS)
    bn2_fold_norm_kernel(const uint64_t *gl, const uint64_t *gr,
                         FoldDigits c, int nd, int n, int G, uint64_t *pre,
                         uint64_t *out) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < G) bn2_fold_group(gl, gr, c.d, nd, n, g, G, pre, out);
}

// the threads of K12 an SM holds at once; a negative value is a CUDA error
extern "C" int vmpc_cu_bn2_fold_resident() {
  int blocks = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, bn2_fold_norm_kernel, K_THREADS, 0);
  return e != cudaSuccess ? -(int)e : blocks * K_THREADS;
}

// gl, gr [n][24] input rows, out [n][24] result rows; cdig: nd
// (<= FOLD_DIGITS) NAF digits, host memory; G threads (0 < G <= n);
// pre [n][8] scratch
extern "C" int vmpc_cu_bn2_fold_norm(const uint64_t *gl, const uint64_t *gr,
                                     const int8_t *cdig, int nd, int G,
                                     uint64_t *pre, uint64_t *out, int n,
                                     void *stream) {
  if (nd < 0 || nd > FOLD_DIGITS || G <= 0 || G > n)
    return (int)cudaErrorInvalidValue;
  FoldDigits c;
  for (int b = 0; b < FOLD_DIGITS; b++) c.d[b] = b < nd ? cdig[b] : 0;
  bn2_fold_norm_kernel<<<blocks_for(G, K_THREADS), K_THREADS, 0,
                         (cudaStream_t)stream>>>(gl, gr, c, nd, n, G, pre,
                                                 out);
  return (int)cudaGetLastError();
}
