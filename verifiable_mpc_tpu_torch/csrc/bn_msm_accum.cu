// K5: BN256 G1 MSM window accumulation, hand-written for Hopper (sm_90a).
//
// Replaces the BN instance of verifiable_mpc_tpu/ops/msm_pallas.py
// _make_chunk_kernel (the pallas_call in _chunk_pallas, with the group law
// of ops/bn_pallas.py): 4-bit signed-window accumulation into per-(window,
// lane) accumulators.  As K1: one thread owns one (batch, window, slice)
// accumulator and walks the slice's points; neighbouring threads take
// neighbouring points, so the row and digit loads coalesce.
//
// A first launch turns the input rows (jacobian, standard form, as
// native._bn_pts_to_u64 gives them) into working rows (projective,
// Montgomery form), once per point (bn_encode_kernel).
//
// Bound: integer multiplies (a complete add is 12 Montgomery products of
// 64 + 64 32x32->64 products and 8 low products each; times b3 = 9 is
// additions).  The function needs each point's encoding and 1..8
// multiples once, shared by its windows, and one add per nonzero digit
// (chip_smoke.py counts that).  This kernel builds
// the multiple |d| P of its point in every window (|d| - 1 adds per (point,
// window)), about 4 x that work; a table shared by the windows is left for
// later (PERF.md gives the distance from the bound).

#include "bn254_kernels.cuh"
#include "launch.cuh"

__global__ void bn_msm_accum_kernel(const uint64_t *pts,
                                    const uint8_t *digits, uint64_t *acc,
                                    int n, int nw, int S) {
  int b = blockIdx.y;
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nw * S) return;
  int w = t / S;
  int s = t - w * S;
  bn_msm_accum_one(pts + (size_t)b * n * 12,
                   digits + (size_t)b * (nw / 2) * n,
                   acc + ((size_t)(b * nw + w) * S + s) * 12, n, w, s, S);
}

// pts [B][n][12] input rows, work [B][n][12] scratch for the working
// rows, digits [B][nw/2][n], acc [B][nw][S][12]
extern "C" int vmpc_cu_bn_msm_accum(const uint64_t *pts, uint64_t *work,
                                    const uint8_t *digits, uint64_t *acc,
                                    int B, int n, int nw, int S,
                                    void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long rows = (long long)B * n;
  bn_encode_kernel<<<blocks_for(rows, K_THREADS), K_THREADS, 0, s>>>(
      pts, work, rows);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  dim3 grid(blocks_for((long long)nw * S, K_THREADS), B);
  bn_msm_accum_kernel<<<grid, K_THREADS, 0, s>>>(work, digits, acc, n, nw,
                                                 S);
  return (int)cudaGetLastError();
}
