// K8: BN256 G1 fixed-base comb, hand-written for Hopper (sm_90a).
//
// Replaces the BN instance of verifiable_mpc_tpu/ops/msm_pallas.py
// _make_bexp_comb_kernel (the pallas_call in _bexp_comb_pallas, with the
// group law of ops/bn_pallas.py), plus the normalization that the TPU left
// to the host: out_i = sum_w T[w][d_w(e_i)], one select and at most one
// add per window, no doublings, then the normalized row.  The 9 * nw entry
// table (55 KB at nw = 64) is built affine by the C++ tier
// (native.bn_comb_table) and cached per base; a first launch turns its
// input rows into working rows (bn_encode_affine_kernel), every add is a
// mixed add (11 Montgomery products, not 12), and the rows are read
// through L1/L2, every thread of a warp touching the same few rows.
//
// Normalization: each thread takes the exponents i = g, g + G, g + 2G, ...
// with G = min(n, the threads that fit on the card at once), keeps their
// sums in their out rows, and normalizes the group with one inversion
// (Montgomery's trick, bn_normalize_group); every lane inverts its own
// group at the same time as the others.
//
// Bound: integer multiplies (an add per nonzero window after the first,
// the table's encoding, and the batch's normalization).

#include "bn254_kernels.cuh"
#include "launch.cuh"

// the table's input rows -> the working rows of their affine forms, one
// thread per row
__global__ void bn_encode_affine_kernel(const uint64_t *in, uint64_t *out,
                                        int rows) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rows)
    bn_encode_affine_one(in + (size_t)i * 12, out + (size_t)i * 12);
}

__global__ void bn_comb_norm_kernel(const uint64_t *table,
                                    const uint8_t *digits, int n, int nw,
                                    int G, uint64_t *pre, uint64_t *out) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < G) bn_comb_group(table, digits, n, nw, g, G, pre, out);
}

// the threads of K8 an SM holds at once (the wrapper runs G = min(n, that
// on every SM): one wave); a negative value is a CUDA error
extern "C" int vmpc_cu_bn_comb_resident() {
  int blocks = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, bn_comb_norm_kernel, K_THREADS, 0);
  return e != cudaSuccess ? -(int)e : blocks * K_THREADS;
}

// table [nw*9][12] input rows, work [nw*9][12] scratch for the working
// rows, digits [nw/2][n], G threads (0 < G <= n), pre [n][4] scratch,
// out [n][12]
extern "C" int vmpc_cu_bn_comb_norm(const uint64_t *table, uint64_t *work,
                                    const uint8_t *digits, int n, int nw,
                                    int G, uint64_t *pre, uint64_t *out,
                                    void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
  bn_encode_affine_kernel<<<blocks_for(nw * 9, K_THREADS), K_THREADS, 0,
                            s>>>(table, work, nw * 9);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  bn_comb_norm_kernel<<<blocks_for(G, K_THREADS), K_THREADS, 0, s>>>(
      work, digits, n, nw, G, pre, out);
  return (int)cudaGetLastError();
}
