// K14: Ed25519 bucket-method MSM reduction, hand-written for Hopper
// (sm_90a).
//
// Replaces verifiable_mpc_tpu/ops/msm_bucket.py _make_reduce_kernel (the
// pallas_call in _reduce_pallas): per window, sum_b (b+1) B_b over its
// buckets, computed as sum_b suffix(B)_b, then the Horner ladder over the
// most-significant-first windows (8 doublings and one add each) and the
// normalized row.  The TPU ran the scan and a butterfly all-reduce across
// the 128 vector lanes; here one block per window holds its buckets in
// shared memory (two 16 KB buffers): a Hillis-Steele inclusive suffix scan
// (log2(lanes) rounds of one complete add a thread, ping-ponging between
// the buffers), then a tree sum over the lanes.  Blocks run in no order,
// so the Horner ladder is a second launch, one thread.
//
// Bound: integer multiplies.  The Horner thread is a serial chain of 8 *
// (nw - 1) doublings, nw adds and a Fermat inversion: its latency, not the
// card's throughput, sets the time, as in K2.

#include "ed25519_kernels.cuh"
#include "launch.cuh"

#define BUCKET_THREADS 128  // the most buckets a window holds

__global__ void bucket_window_kernel(const uint64_t *buckets, uint64_t *wsum,
                                     int lanes) {
  __shared__ uint64_t sh[2][BUCKET_THREADS * 16];
  int w = blockIdx.x;
  int b = threadIdx.x;
  const uint64_t *src = buckets + (size_t)w * lanes * 16;
  if (b < lanes)
    for (int j = 0; j < 16; j++) sh[0][b * 16 + j] = src[b * 16 + j];
  __syncthreads();
  int cur = 0;
  for (int shift = 1; shift < lanes; shift <<= 1) {
    if (b < lanes) bucket_scan_step(sh[cur], sh[cur ^ 1], lanes, b, shift);
    __syncthreads();
    cur ^= 1;
  }
  int p2 = 1;
  while (p2 < lanes) p2 <<= 1;
  for (int stride = p2 >> 1; stride > 0; stride >>= 1) {
    if (b < stride) bucket_tree_step(sh[cur], lanes, b, stride);
    __syncthreads();
  }
  if (b < 16) wsum[(size_t)w * 16 + b] = sh[cur][b];
}

__global__ void bucket_horner_kernel(const uint64_t *wsum, uint64_t *out,
                                     int nw) {
  if (threadIdx.x == 0) msm_horner_one(wsum, out, nw, 8);
}

// buckets [nw][lanes][16] (lanes <= 128) -> wsum [nw][16] scratch ->
// out [16] canonical row
extern "C" int vmpc_cu_bucket_reduce(const uint64_t *buckets, uint64_t *wsum,
                                     uint64_t *out, int nw, int lanes,
                                     void *stream) {
  if (nw < 1 || lanes < 1 || lanes > BUCKET_THREADS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  bucket_window_kernel<<<nw, BUCKET_THREADS, 0, st>>>(buckets, wsum, lanes);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  bucket_horner_kernel<<<1, 32, 0, st>>>(wsum, out, nw);
  return (int)cudaGetLastError();
}
