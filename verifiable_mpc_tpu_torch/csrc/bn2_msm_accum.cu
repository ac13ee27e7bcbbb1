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
// A first launch (bn2_table_kernel, one thread a point) turns each input
// row (jacobian, standard form, as native._bn2_pts_to_u64 gives it) into
// the point's multiples 1..8 (7 adds): the table the TPU kernel built per
// tile, built once per point and shared by its windows.  A second
// (bn2_table_norm_kernel, one wave of G threads) makes them affine (128
// bytes an entry, 1 KB a point, and a scratch of the same size in device
// memory): thread g normalizes the entries of the points g, g + G, ...
// with one GF(p^2) inversion (bn2_table_norm_group); one inversion a point
// (about 380 dependent products) would cost more than the mixed adds
// save, and the normalization in the first launch, beside the points'
// adds, spilled.  The accumulation then reads +-|d| P per nonzero digit
// and adds it with the mixed add (39 products where the complete add takes
// 42), holding a 48-word accumulator and a 32-word entry; it asks for 3
// blocks an SM (168 registers, with a spill), which ran faster than 2
// blocks at 255 registers on the H100.  In the Pinocchio prove the three
// launches ran faster than a projective table with complete adds at 3
// blocks an SM (PERF.md §6).
//
// Bound: integer multiplies (a mixed twist add is 39 Montgomery products
// of 64 + 64 32x32->64 products and 8 low products each).  The function
// needs each point's encoding (14 products), its multiples 2..8 (4
// doublings and 3 adds; the kernel does 7 adds), 8 entries' normalization
// (15 products each) and one GF(p^2) inversion for all of them (the
// kernel does one a thread), and one mixed add per nonzero digit whose
// entry is not the identity (chip_smoke.py counts that).

#include "bn2_kernels.cuh"
#include "launch.cuh"

__global__ void __launch_bounds__(K_THREADS)
    bn2_table_kernel(const uint64_t *pts, uint64_t *tbl, uint64_t *pre,
                     long long rows) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rows)
    bn2_table_one(pts + i * BN2_ROW, tbl + i * 8 * BN2_ENTRY,
                  pre + i * 8 * BN2_ENTRY);
}

__global__ void __launch_bounds__(K_THREADS)
    bn2_table_norm_kernel(uint64_t *tbl, uint64_t *pre, long long rows,
                          int G) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < G) bn2_table_norm_group(tbl, pre, rows, g, G);
}

__global__ void __launch_bounds__(K_THREADS, 3)
    bn2_msm_accum_kernel(const uint64_t *tbl, const uint8_t *digits,
                         uint64_t *acc, int n, int nw, int S) {
  int b = blockIdx.y;
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nw * S) return;
  int w = t / S;
  int s = t - w * S;
  bn2_msm_accum_one(tbl + (size_t)b * n * 8 * BN2_ENTRY,
                    digits + (size_t)b * (nw / 2) * n,
                    acc + ((size_t)(b * nw + w) * S + s) * BN2_ROW, n, w, s,
                    S);
}

// the threads of bn2_table_norm_kernel that one SM holds at once
extern "C" int vmpc_cu_bn2_table_resident() {
  int blocks = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, bn2_table_norm_kernel, K_THREADS, 0);
  return e != cudaSuccess ? -(int)e : blocks * K_THREADS;
}

// pts [B][n][24] input rows, tbl [B][n][8][16] scratch for the multiples'
// affine entries, pre [B][n][8][16] scratch of the first launches, G the
// normalization's threads (0 < G <= B n), digits [B][nw/2][n],
// acc [B][nw][S][24]
extern "C" int vmpc_cu_bn2_msm_accum(const uint64_t *pts, uint64_t *tbl,
                                     uint64_t *pre, const uint8_t *digits,
                                     uint64_t *acc, int B, int n, int nw,
                                     int S, int G, void *stream) {
  long long rows = (long long)B * n;
  if (B <= 0 || n <= 0 || S <= 0 || G <= 0 || G > rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  bn2_table_kernel<<<blocks_for(rows, K_THREADS), K_THREADS, 0, s>>>(
      pts, tbl, pre, rows);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  bn2_table_norm_kernel<<<blocks_for(G, K_THREADS), K_THREADS, 0, s>>>(
      tbl, pre, rows, G);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  dim3 grid(blocks_for((long long)nw * S, K_THREADS), B);
  bn2_msm_accum_kernel<<<grid, K_THREADS, 0, s>>>(tbl, digits, acc, n, nw,
                                                  S);
  return (int)cudaGetLastError();
}
