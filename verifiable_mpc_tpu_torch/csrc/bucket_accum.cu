// K13: Ed25519 bucket-method MSM accumulation, hand-written for Hopper
// (sm_90a).
//
// Replaces verifiable_mpc_tpu/ops/msm_bucket.py _make_accum_kernel (the
// pallas_call in _accum_pallas, fed by _gather_step_call): every (window,
// bucket) accumulator sums its column of gathered points, negating the
// entries of negative digits first.  The TPU walked the depth serially
// over its grid, XLA gathering each depth tile of points; here gathers are
// plain loads, and the 2^18-point array (32 MB of rows) stays in the 50 MB
// L2.  One thread per (window, bucket) would give only nw * 128 = 4096
// threads, about 31 per SM, so each column's depth is cut into segments of
// SEG rows: one thread per (window, bucket, segment) sums its segment, and
// a last launch adds each column's segment partials, skipping the empty
// ones.  The layout pads every column to the deepest (D rows), and the
// most significant window is far deeper than the others (a balanced
// scalar's top byte is 0..8, so its points fall in nine buckets): at 2^18
// points D is about 29,000 rows where the other windows need about 2,100,
// so most segment threads read padding only and leave.  Three launches in
// all: the points' precomputed form (Y+X, Y-X, 2dT, 2Z) once, so that every
// entry costs one 8-multiply mixed add; the segment sums; the column sums.
// Neighbouring threads take neighbouring buckets, so their perm and sgn
// loads coalesce; the point rows they gather are whole 128-byte lines.
//
// Bound: integer multiplies (one mixed add per nonzero digit,
// chip_smoke.py counts that; the padding of each column to the deepest is
// read but adds nothing).

#include "ed25519_kernels.cuh"
#include "launch.cuh"

__global__ void bucket_pre_kernel(const uint64_t *pts, uint64_t *pre, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bucket_pre_one(pts + (size_t)i * 16, pre + (size_t)i * 16);
}

__global__ void bucket_seg_kernel(const uint64_t *pre, const int32_t *perm,
                                  const int32_t *sgn, uint64_t *part,
                                  uint8_t *used, int nw, int D, int lanes,
                                  int seg, int nseg) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int cols = nw * lanes;
  if (t >= (long long)nseg * cols) return;
  int s = (int)(t / cols);
  int c = (int)(t - (long long)s * cols);
  int w = c / lanes;
  int b = c - w * lanes;
  int d0 = s * seg;
  int d1 = d0 + seg < D ? d0 + seg : D;
  used[t] = bucket_accum_one(pre, perm, sgn, D, lanes, w, b, d0, d1,
                             part + (size_t)t * 16) > 0;
}

__global__ void bucket_segsum_kernel(const uint64_t *part,
                                     const uint8_t *used, uint64_t *out,
                                     int nseg, int cols) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  bucket_segsum_one(part, used, nseg, cols, c, out + (size_t)c * 16);
}

// pts [n][16] rows, pre [n][16] scratch, perm and sgn [nw][D][lanes],
// part [nseg][nw][lanes][16] and used [nseg][nw][lanes] scratch (nseg =
// ceil(D / seg)), out [nw][lanes][16] bucket sums (extended rows, not
// normalized)
extern "C" int vmpc_cu_bucket_accum(const uint64_t *pts, uint64_t *pre,
                                    const int32_t *perm, const int32_t *sgn,
                                    uint64_t *part, uint8_t *used,
                                    uint64_t *out, int n, int nw, int D,
                                    int lanes, int seg, void *stream) {
  if (n < 1 || nw < 1 || D < 1 || lanes < 1 || seg < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int nseg = (D + seg - 1) / seg;
  int cols = nw * lanes;
  bucket_pre_kernel<<<blocks_for(n, K_THREADS), K_THREADS, 0, st>>>(pts, pre,
                                                                   n);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  bucket_seg_kernel<<<blocks_for((long long)nseg * cols, K_THREADS), K_THREADS,
                      0, st>>>(pre, perm, sgn, part, used, nw, D, lanes, seg,
                               nseg);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  bucket_segsum_kernel<<<blocks_for(cols, K_THREADS), K_THREADS, 0, st>>>(
      part, used, out, nseg, cols);
  return (int)cudaGetLastError();
}
