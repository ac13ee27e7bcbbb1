// K1: Ed25519 MSM window accumulation, hand-written for Hopper (sm_90a).
//
// Replaces verifiable_mpc_tpu/ops/msm_pallas.py _make_chunk_kernel (the
// pallas_call in _chunk_pallas): 4-bit signed-window accumulation into
// per-(window, lane) accumulators, where the TPU kernel builds each tile's
// 0..8 table of multiples in VMEM and selects from it per window.
//
// Two launches.  The first (msm_table_kernel, one thread per point) writes
// each point's multiples 1..8 in precomputed form to device memory
// (128 bytes each, 1 KB a point, [B][n][8][16]): the TPU kernel's table,
// built once per point and shared by its 64 windows.  The second
// (msm_accum_kernel) gives one thread each (batch, window, slice)
// accumulator, window-major (t = w S + s, the batch on blockIdx.y), so
// neighbouring threads read neighbouring points and their loads coalesce.
// For each of the slice's points it reads the one entry +-|d| P its digit
// selects and does one mixed add, so no work depends on |d| and the lanes
// of a warp stay together; a thread holds its accumulator and one entry.
// A zero digit adds the identity entry (the unified add is complete): the
// thread then needs 128 registers and four blocks fit an SM, 1-2 % faster
// on an H100 than skipping the digit at 136 registers (PERF.md).
//
// Bound: integer multiplies (a mixed add is 8 field multiplies of 64
// 32x32->64 products each; the table is 7 adds and 8 conversions a point),
// and in practice the field product's carries, which hold it to about half
// that rate (probe P2).  The table stream comes next: each (window, point)
// reads a 128-byte entry, about 2.1 GB a call at 2^18 points, which L2
// cannot hold.  On an H100 the kernel is bound by its products: an order
// that ran the 64 windows of a slice group on neighbouring blocks, to read
// the entries from L2, took as long as this one (PERF.md).

#include "ed25519_kernels.cuh"
#include "launch.cuh"

__global__ void __launch_bounds__(K_THREADS)
    msm_table_kernel(const uint64_t *pts, uint64_t *tbl, long long rows) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rows) msm_table_one(pts + i * 16, tbl + i * 8 * 16);
}

__global__ void __launch_bounds__(K_THREADS)
    msm_accum_kernel(const uint64_t *tbl, const uint8_t *digits,
                     uint64_t *acc, int n, int nw, int S) {
  int b = blockIdx.y;
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nw * S) return;
  int w = t / S;
  int s = t - w * S;
  msm_accum_one(tbl + (size_t)b * n * 8 * 16,
                digits + (size_t)b * (nw / 2) * n,
                acc + ((size_t)(b * nw + w) * S + s) * 16, n, w, s, S);
}

// pts [B][n][16], tbl [B][n][8][16] scratch for the multiples' rows,
// digits [B][nw/2][n], acc [B][nw][S][16]
extern "C" int vmpc_cu_msm_accum(const uint64_t *pts, uint64_t *tbl,
                                 const uint8_t *digits, uint64_t *acc, int B,
                                 int n, int nw, int S, void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  long long rows = (long long)B * n;
  if (rows) {
    msm_table_kernel<<<blocks_for(rows, K_THREADS), K_THREADS, 0, st>>>(
        pts, tbl, rows);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  dim3 grid(blocks_for((long long)nw * S, K_THREADS), B);
  msm_accum_kernel<<<grid, K_THREADS, 0, st>>>(tbl, digits, acc, n, nw, S);
  return (int)cudaGetLastError();
}
