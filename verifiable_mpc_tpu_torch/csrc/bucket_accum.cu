// K13: Ed25519 bucket-method MSM accumulation, hand-written for Hopper
// (sm_90a).
//
// Replaces verifiable_mpc_tpu/ops/msm_bucket.py _make_accum_kernel (the
// pallas_call in _accum_pallas, fed by _gather_step_call): every (window,
// bucket) accumulator sums its column of gathered points, negating the
// entries of negative digits first.  The TPU walked a padded [nw, D,
// lanes] layout's depth serially over its grid.  Here the layout is
// compact (msm_bucket_cuda.compact_layout): one flat list of the nonzero
// digits' point indices, column by column, and the columns' offsets.  The
// columns are very uneven (a balanced scalar's top byte is 0..8, so at
// 2^18 points the top window's eight buckets hold about 29,000 entries
// each and the other windows' about 2,048), so the work is cut by entries,
// not by columns.  Three launches:
//
// * bucket_pre_kernel: the points' precomputed form (Y+X, Y-X, 2dT, 2Z)
//   once, so that every entry costs one 8-product mixed add;
// * bucket_accum_kernel: thread t sums the entries [t C, t C + C) (C the
//   wrapper's, msm_bucket_cuda.ACCUM_ENTRIES = 64), writing a column that lies
//   wholly inside it to its output row and a column that crosses one of
//   its ends to one of its two partial slots (ed25519_kernels.cuh:
//   bucket_accum_thread).  Every thread does the same number of adds
//   whatever the columns' depths;
// * bucket_combine_kernel, a warp per column: the identity for an empty
//   column, nothing for a column already written, else its partials summed
//   by the warp's lanes (a strided walk, then a tree in shared memory).
//   Its time is the latency of a few adds times the waves of columns: on
//   an H100 a warp a column (four a block) took 0.19-0.20 ms at 2^18 points
//   where a block of 128 threads a column took 0.28 ms (PERF.md).
//
// The longest chain of dependent adds is C mixed adds, then
// ceil(np / 32) + log2(min(np, 32)) complete adds for a column of np
// partials (about 15 + 5 for the top window's columns at 2^18, C = 64),
// where the padded design summed a column's segment partials on one
// thread (about 455 in a row).  The 2^18 points' precomputed rows (33.5 MB) stay in the
// 50 MB L2; within a column the entries are in index order, so
// neighbouring threads gather rows in the same order.
//
// Bound: integer multiplies (one mixed add per nonzero digit; chip_smoke.py
// counts that).

#include "ed25519_kernels.cuh"
#include "launch.cuh"

#define COMBINE_WARPS 4  // columns a block of the combination, a warp each

__global__ void bucket_pre_kernel(const uint64_t *pts, uint64_t *pre, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bucket_pre_one(pts + (size_t)i * 16, pre + (size_t)i * 16);
}

__global__ void __launch_bounds__(K_THREADS)
    bucket_accum_kernel(const uint64_t *pre, const int32_t *entries,
                        const int32_t *offsets, uint64_t *part, uint64_t *out,
                        int cols, int count, int chunk, int T) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  bucket_accum_thread(pre, entries, offsets, cols, count, chunk, t, part,
                      out);
}

__global__ void __launch_bounds__(COMBINE_WARPS * 32)
    bucket_combine_kernel(const uint64_t *part, const int32_t *offsets,
                          uint64_t *out, int cols, int chunk) {
  __shared__ uint64_t sh[COMBINE_WARPS][32][16];
  int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int c = blockIdx.x * COMBINE_WARPS + warp;
  if (c >= cols) return;
  uint64_t *dst = out + (size_t)c * 16;
  if (offsets[c] == offsets[c + 1]) {  // empty: the identity
    if (lane == 0) {
      ge_ext z;
      ge_identity(z);
      ge_store(dst, z);
    }
    return;
  }
  int np = bucket_partials(offsets, c, chunk);
  if (np == 0) return;  // written by the accumulation
  int m = np < 32 ? np : 32;
  if (lane < m)
    bucket_combine_lane(part, offsets, c, chunk, np, lane, m, sh[warp][lane]);
  __syncwarp();
  int p2 = 1;
  while (p2 < m) p2 <<= 1;
  for (int stride = p2 >> 1; stride > 0; stride >>= 1) {
    if (lane < stride && lane + stride < m)
      bucket_tree_step(sh[warp][0], lane, stride);
    __syncwarp();
  }
  if (lane < 16) dst[lane] = sh[warp][0][lane];
}

// pts [n][16] rows, pre [n][16] scratch, entries [count] and offsets
// [nw * lanes + 1] (the compact layout), part [ceil(count / chunk)][2][16]
// scratch, out [nw][lanes][16] bucket sums (extended rows, not
// normalized)
extern "C" int vmpc_cu_bucket_accum(const uint64_t *pts, uint64_t *pre,
                                    const int32_t *entries,
                                    const int32_t *offsets, uint64_t *part,
                                    uint64_t *out, int n, int nw, int lanes,
                                    int count, int chunk, void *stream) {
  if (n < 1 || nw < 1 || lanes < 1 || count < 0 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int cols = nw * lanes;
  bucket_pre_kernel<<<blocks_for(n, K_THREADS), K_THREADS, 0, st>>>(pts, pre,
                                                                   n);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  int T = (int)(((long long)count + chunk - 1) / chunk);
  if (T > 0) {
    bucket_accum_kernel<<<blocks_for(T, K_THREADS), K_THREADS, 0, st>>>(
        pre, entries, offsets, part, out, cols, count, chunk, T);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  bucket_combine_kernel<<<blocks_for(cols, COMBINE_WARPS), COMBINE_WARPS * 32,
                          0, st>>>(part, offsets, out, cols, chunk);
  return (int)cudaGetLastError();
}
