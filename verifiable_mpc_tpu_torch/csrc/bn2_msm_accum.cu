// K9: BN256 twist (G2) MSM window accumulation, hand-written for Hopper
// (sm_90a).
//
// Replaces the BN2 instance of verifiable_mpc_tpu/ops/msm_pallas.py
// _make_chunk_kernel (the pallas_call in _chunk_pallas, with the twist
// group law of ops/bn2_pallas.py): 4-bit signed-window accumulation into
// per-(window, lane) accumulators.  As K5: one thread owns one (batch,
// window, slice) accumulator and walks the slice's points; neighbouring
// threads take neighbouring points.
//
// A first launch (bn2_table_kernel, one thread per point) turns each input
// row (jacobian, standard form, as native._bn2_pts_to_u64 gives it) into
// the working rows of the point's multiples 1..8 (192 bytes each, 1.5 KB a
// point in device memory): the table the TPU kernel built per tile, built
// once per point and shared by its windows.  The accumulation then reads
// +-|d| P per nonzero digit, so a thread holds only its accumulator and
// one point: a twist point is 48 words, and building |d| P in registers
// (as K5 does on G1) would hold three.
//
// Bound: integer multiplies (a complete twist add is 42 Montgomery
// products of 64 + 64 32x32->64 products and 8 low products each).  The
// function needs each point's encoding (14 products) and 7 adds for its
// table, and one add per nonzero digit (chip_smoke.py counts that); the
// kernel does that work and no more.

#include "bn2_kernels.cuh"
#include "launch.cuh"

__global__ void __launch_bounds__(K_THREADS, 1)
    bn2_table_kernel(const uint64_t *pts, uint64_t *tbl, long long rows) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rows) bn2_table_one(pts + i * BN2_ROW, tbl + i * 8 * BN2_ROW);
}

__global__ void __launch_bounds__(K_THREADS, 1)
    bn2_msm_accum_kernel(const uint64_t *tbl, const uint8_t *digits,
                         uint64_t *acc, int n, int nw, int S) {
  int b = blockIdx.y;
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nw * S) return;
  int w = t / S;
  int s = t - w * S;
  bn2_msm_accum_one(tbl + (size_t)b * n * 8 * BN2_ROW,
                    digits + (size_t)b * (nw / 2) * n,
                    acc + ((size_t)(b * nw + w) * S + s) * BN2_ROW, n, w, s,
                    S);
}

// pts [B][n][24] input rows, tbl [B][n][8][24] scratch for the multiples'
// working rows, digits [B][nw/2][n], acc [B][nw][S][24]
extern "C" int vmpc_cu_bn2_msm_accum(const uint64_t *pts, uint64_t *tbl,
                                     const uint8_t *digits, uint64_t *acc,
                                     int B, int n, int nw, int S,
                                     void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long rows = (long long)B * n;
  bn2_table_kernel<<<blocks_for(rows, K_THREADS), K_THREADS, 0, s>>>(
      pts, tbl, rows);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  dim3 grid(blocks_for((long long)nw * S, K_THREADS), B);
  bn2_msm_accum_kernel<<<grid, K_THREADS, 0, s>>>(tbl, digits, acc, n, nw,
                                                  S);
  return (int)cudaGetLastError();
}
