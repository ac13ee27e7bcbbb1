// K1: Ed25519 MSM window accumulation, hand-written for Hopper (sm_90a).
//
// Replaces verifiable_mpc_tpu/ops/msm_pallas.py _make_chunk_kernel (the
// pallas_call in _chunk_pallas): 4-bit signed-window accumulation into
// per-(window, lane) accumulators.  Here one thread owns one (batch,
// window, slice) accumulator and walks the slice's points; neighbouring
// threads take neighbouring points, so the row and digit loads coalesce.
//
// Bound: integer multiplies (a mixed add is 8 field multiplies of 64
// 32x32->64 products each).  The function needs each point's 0..8 table
// once, shared by its windows, and one mixed add per nonzero digit
// (chip_smoke.py counts that).  This kernel does several times more: the
// thread builds the multiples 1..|d| of its point for each window (the
// table entry its digit selects), so a point's table is rebuilt in every
// window, about |d| extra mixed adds per (point, window).  One table
// shared by the windows is the first optimisation left for later
// (PERF.md gives the distance from the bound).

#include "ed25519_kernels.cuh"
#include "launch.cuh"

__global__ void msm_accum_kernel(const uint64_t *pts, const uint8_t *digits,
                                 uint64_t *acc, int n, int nw, int S) {
  int b = blockIdx.y;
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nw * S) return;
  int w = t / S;
  int s = t - w * S;
  msm_accum_one(pts + (size_t)b * n * 16, digits + (size_t)b * (nw / 2) * n,
                acc + ((size_t)(b * nw + w) * S + s) * 16, n, w, s, S);
}

// pts [B][n][16], digits [B][nw/2][n], acc [B][nw][S][16]
extern "C" int vmpc_cu_msm_accum(const uint64_t *pts, const uint8_t *digits,
                                 uint64_t *acc, int B, int n, int nw, int S,
                                 void *stream) {
  dim3 grid(blocks_for((long long)nw * S, K_THREADS), B);
  msm_accum_kernel<<<grid, K_THREADS, 0, (cudaStream_t)stream>>>(
      pts, digits, acc, n, nw, S);
  return (int)cudaGetLastError();
}
