// K14: Ed25519 bucket-method MSM reduction, hand-written for Hopper
// (sm_90a).
//
// Replaces verifiable_mpc_tpu/ops/msm_bucket.py _make_reduce_kernel (the
// pallas_call in _reduce_pallas): per window, sum_b (b+1) B_b over its
// buckets, computed as sum_b suffix(B)_b, then the Horner ladder over the
// most-significant-first windows (8 doublings and one add each) and the
// normalized row.  The TPU ran the scan and a butterfly all-reduce across
// its 128 vector lanes.  Here, two launches:
//
// * bucket_window_kernel, a block per window: a lane group of BUCKET_LANES
//   lanes per bucket (ed_coop slots in dynamic shared memory, 416 bytes a
//   bucket), a Hillis-Steele inclusive suffix scan (log2(lanes) rounds),
//   then a tree sum over the buckets (log2(lanes) rounds); every add is
//   K2's two levels of four products spread over the group's lanes
//   (ed25519_kernels.cuh: bucket_scan_fetch, bucket_scan_add).  The scan
//   and the tree keep a log depth of 2 log2(lanes) adds; eight bit-plane
//   subset sums, the other log-depth form, would add their own Horner (7
//   doublings and 7 adds) to the chain;
// * bucket_tail_kernel, one block: K2's combination (coop.cuh:
//   tail_combine over the ed_coop steps) with 8-bit windows: a group of 4
//   lanes per window sum, REDUCE_GROUPS groups each run a Horner over a
//   run of windows, group 0 shifts, adds and normalizes by one inversion
//   (fe_inv_var).
//
// Bound: integer multiplies by the card's throughput, but the combination
// is one chain of 8 (nw - 1) doublings (248 at nw = 32), each two rounds
// of products, and the inversion: its latency sets the time, as in K2.
// The one-thread Horner it replaces ran the same doublings with their 8
// products in a row, 32 adds and a Fermat chain of 265 products.

#include "ed25519_kernels.cuh"
#include "launch.cuh"

#define BUCKET_LANES 4     // lanes per group operation
#define BUCKET_MAX 128     // the most buckets a window holds
#define REDUCE_WINDOWS 32  // the most windows (256 / 8)
#define REDUCE_GROUPS 8    // window groups of the combination

static_assert(32 % BUCKET_LANES == 0, "a lane group lies in one warp");
static_assert(REDUCE_GROUPS <= REDUCE_WINDOWS, "the groups fit the block");

__global__ void __launch_bounds__(BUCKET_MAX * BUCKET_LANES)
    bucket_window_kernel(const uint64_t *buckets, uint64_t *wsum, int lanes) {
  extern __shared__ uint64_t smem[];
  ed_coop *sh = (ed_coop *)smem;
  int b = threadIdx.x / BUCKET_LANES;
  CoopLanes ex = coop_lanes(BUCKET_LANES);
  bucket_load(ex, sh, buckets + (size_t)blockIdx.x * lanes * 16, b);
  __syncthreads();
  for (int shift = 1; shift < lanes; shift <<= 1) {
    bucket_scan_fetch(ex, sh, lanes, b, shift);
    __syncthreads();
    bucket_scan_add(ex, sh, lanes, b, shift);
    __syncthreads();
  }
  int p2 = 1;
  while (p2 < lanes) p2 <<= 1;
  for (int stride = p2 >> 1; stride > 0; stride >>= 1) {
    if (b < stride) {
      bucket_scan_fetch(ex, sh, lanes, b, stride);
      bucket_scan_add(ex, sh, lanes, b, stride);
    }
    __syncthreads();
  }
  if (b == 0)
    ex.run([&](int l) {
      coop_store_row(wsum + (size_t)blockIdx.x * 16, sh[0].v, l, ex.L);
    });
}

__global__ void __launch_bounds__(REDUCE_WINDOWS * BUCKET_LANES)
    bucket_tail_kernel(const uint64_t *wsum, uint64_t *out, int nw) {
  __shared__ ed_coop sh[REDUCE_WINDOWS];
  __shared__ fe ws[REDUCE_WINDOWS][4];
  tail_combine<BUCKET_LANES, BUCKET_LANES, REDUCE_GROUPS, 8>(sh, ws, wsum,
                                                             out, nw, 1);
}

// buckets [nw][lanes][16] (lanes <= 128, nw <= 32) -> wsum [nw][16]
// scratch -> out [16] canonical row
extern "C" int vmpc_cu_bucket_reduce(const uint64_t *buckets, uint64_t *wsum,
                                     uint64_t *out, int nw, int lanes,
                                     void *stream) {
  if (nw < 1 || nw > REDUCE_WINDOWS || lanes < 1 || lanes > BUCKET_MAX)
    return (int)cudaErrorInvalidValue;
  // on every call: the attribute holds for the current device only
  int smem = (int)(BUCKET_MAX * sizeof(ed_coop));
  int rc = (int)cudaFuncSetAttribute(
      bucket_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  bucket_window_kernel<<<nw, lanes * BUCKET_LANES,
                         lanes * sizeof(ed_coop), st>>>(buckets, wsum, lanes);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  bucket_tail_kernel<<<1, REDUCE_WINDOWS * BUCKET_LANES, 0, st>>>(wsum, out,
                                                                  nw);
  return (int)cudaGetLastError();
}
