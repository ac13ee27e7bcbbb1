// K5: BN256 G1 MSM window accumulation, hand-written for Hopper (sm_90a).
//
// Replaces the BN instance of verifiable_mpc_tpu/ops/msm_pallas.py
// _make_chunk_kernel (the pallas_call in _chunk_pallas, with the group law
// of ops/bn_pallas.py): 4-bit signed-window accumulation into per-(window,
// lane) accumulators, where the TPU kernel builds each tile's 0..8 table
// of multiples in VMEM and selects from it per window.
//
// Two launches, as K9 on the twist.  The first (bn_table_kernel, one
// thread per point) turns each input row (jacobian, standard form, as
// native._bn_pts_to_u64 gives it) into the working rows (projective,
// Montgomery form) of the point's multiples 1..8 (96 bytes each, 768 a
// point, [B][n][8][12]): the encoding and 7 complete adds, the TPU
// kernel's table built once per point and shared by its 64 windows.  The
// second (bn_msm_accum_kernel) gives one thread each (batch, window,
// slice) accumulator, window-major (t = w S + s, the batch on
// blockIdx.y), so neighbouring threads read neighbouring points.  For each
// of the slice's points it reads the one entry +-|d| P its digit selects
// and does one complete add, so no work depends on |d| and the lanes of a
// warp stay together; a thread holds its accumulator and one entry.  A
// zero digit is skipped, 2 % faster on an H100 than adding the identity
// (PERF.md).
//
// Bound: integer multiplies (a complete add is 12 Montgomery products of
// 64 + 64 32x32->64 products and 8 low products each; times b3 = 9 is
// additions), and in practice the field product's carries, which hold it
// to about half that rate (probe P2).  The table stream comes next: each
// (window, point) reads a 96-byte entry, about 0.8 GB a call at 2^17
// points.  On an H100 the kernel is bound by its products: an order that
// ran the 64 windows of a slice group on neighbouring blocks, to read the
// entries from L2, was 1-3 % slower than this one (PERF.md).

#include "bn254_kernels.cuh"
#include "launch.cuh"

__global__ void __launch_bounds__(K_THREADS)
    bn_table_kernel(const uint64_t *pts, uint64_t *tbl, long long rows) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rows) bn_table_one(pts + i * 12, tbl + i * 8 * 12);
}

__global__ void __launch_bounds__(K_THREADS)
    bn_msm_accum_kernel(const uint64_t *tbl, const uint8_t *digits,
                        uint64_t *acc, int n, int nw, int S) {
  int b = blockIdx.y;
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nw * S) return;
  int w = t / S;
  int s = t - w * S;
  bn_msm_accum_one(tbl + (size_t)b * n * 8 * 12,
                   digits + (size_t)b * (nw / 2) * n,
                   acc + ((size_t)(b * nw + w) * S + s) * 12, n, w, s, S);
}

// pts [B][n][12] input rows, tbl [B][n][8][12] scratch for the multiples'
// working rows, digits [B][nw/2][n], acc [B][nw][S][12]
extern "C" int vmpc_cu_bn_msm_accum(const uint64_t *pts, uint64_t *tbl,
                                    const uint8_t *digits, uint64_t *acc,
                                    int B, int n, int nw, int S,
                                    void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  long long rows = (long long)B * n;
  if (rows) {
    bn_table_kernel<<<blocks_for(rows, K_THREADS), K_THREADS, 0, st>>>(
        pts, tbl, rows);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  dim3 grid(blocks_for((long long)nw * S, K_THREADS), B);
  bn_msm_accum_kernel<<<grid, K_THREADS, 0, st>>>(tbl, digits, acc, n, nw,
                                                  S);
  return (int)cudaGetLastError();
}
