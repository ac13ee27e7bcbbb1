// K11: BN256 twist (G2) fixed-base batch exponentiation, hand-written for
// Hopper (sm_90a).
//
// Replaces the BN2 instance of verifiable_mpc_tpu/ops/msm_pallas.py
// _make_bexp_kernel (the pallas_call in _bexp_pallas, reached through
// _batch_exp_generic with the twist group law of ops/bn2_pallas.py), plus
// the normalization that the TPU left to the host: base^e_i for a shared
// base, normalized.  The TPU kernel runs a signed-window Horner ladder (4
// doublings and one add a window); the base is fixed, so this kernel is a
// comb instead, as K8 is on G1: out_i = sum_w +-T[w][|d_w(e_i)|], one
// table read and at most one add a window, and the ladder's doublings (70 %
// of its products) are gone.  The table (row w*9 + m = m * 16^(nw-1-w) *
// base, 576 rows at nw = 64) is built affine by the C++ tier
// (native.bn2_comb_table) and cached per base; a first launch turns its
// input rows into working rows (bn2_encode_affine_kernel), a warp's
// threads read the entries their digits select through L1/L2 (110.6 KB;
// a copy in shared memory measured no faster), and each add is a mixed
// add (39 Montgomery products, not 42).
//
// Normalization: each thread takes the exponents i = g, g + G, g + 2G, ...
// with G = min(n, the threads that fit on the card at once), keeps their
// sums in their out rows, and normalizes the group with one inversion
// (Montgomery's trick, bn2_normalize_group).  Every lane inverts its own
// group at the same time as the others, so no lane waits on another's
// serial inversion.
//
// Bound: integer multiplies (an add per nonzero window, the table's
// encoding, and the batch's normalization).

#include "bn2_kernels.cuh"
#include "launch.cuh"

// the table's input rows -> the working rows of their affine forms, one
// thread per row
__global__ void bn2_encode_affine_kernel(const uint64_t *in, uint64_t *out,
                                         int rows) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rows)
    bn2_encode_affine_one(in + (size_t)i * BN2_ROW, out + (size_t)i * BN2_ROW);
}

__global__ void __launch_bounds__(K_THREADS, 1)
    bn2_bexp_kernel(const uint64_t *tbl, const uint8_t *digits, int n,
                    int nw, int G, uint64_t *pre, uint64_t *out) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < G) bn2_bexp_group(tbl, digits, n, nw, g, G, pre, out);
}

// the threads of K11 an SM holds at once (the wrapper runs G = min(n, that
// on every SM): one wave); a negative value is a CUDA error
extern "C" int vmpc_cu_bn2_bexp_resident() {
  int blocks = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, bn2_bexp_kernel, K_THREADS, 0);
  return e != cudaSuccess ? -(int)e : blocks * K_THREADS;
}

// table [nw*9][24] input rows (row w*9 + m = m * 16^(nw-1-w) * base), work
// [nw*9][24] scratch for their working rows, digits [nw/2][n], G threads
// (0 < G <= n), pre [n][8] scratch, out [n][24]
extern "C" int vmpc_cu_bn2_bexp(const uint64_t *table, uint64_t *work,
                                const uint8_t *digits, int n, int nw, int G,
                                uint64_t *pre, uint64_t *out, void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
  bn2_encode_affine_kernel<<<blocks_for(nw * 9, K_THREADS), K_THREADS, 0,
                             s>>>(table, work, nw * 9);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  bn2_bexp_kernel<<<blocks_for(G, K_THREADS), K_THREADS, 0, s>>>(
      work, digits, n, nw, G, pre, out);
  return (int)cudaGetLastError();
}
