// K6: BN256 G1 MSM tail, hand-written for Hopper (sm_90a).
//
// Replaces the BN instance of verifiable_mpc_tpu/ops/msm_pallas.py
// _make_tail_kernel (the pallas_call in _tail_pallas): the lane all-reduce
// of the window accumulators, then the Horner ladder over the windows (4
// doublings + 1 add each), then the normalization (on the TPU the BN
// result left projective and the host divided).  As K2, two launches:
// bn_msm_reduce_kernel sums a window's S slice accumulators in one block
// (a strided walk, then a shared-memory tree), bn_msm_horner_kernel runs
// the ladder and the normalization, one thread per batch.
//
// Bound: integer multiplies.  The Horner thread is a serial chain of ~320
// group operations plus a Fermat inversion: its latency, not the card's
// throughput, sets the time at these sizes.

#include "bn254_kernels.cuh"
#include "launch.cuh"

#define BN_REDUCE_THREADS 128

__global__ void bn_msm_reduce_kernel(const uint64_t *acc, uint64_t *wsum,
                                     int nw, int S) {
  __shared__ uint64_t sh[BN_REDUCE_THREADS][12];
  int w = blockIdx.x;
  int b = blockIdx.y;
  const uint64_t *base = acc + (size_t)(b * nw + w) * S * 12;
  g1p sum;
  g1_identity(sum);
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    g1p p, t;
    g1_load(p, base + (size_t)s * 12);
    g1_add(t, sum, p);
    sum = t;
  }
  g1_store(sh[threadIdx.x], sum);
  __syncthreads();
  for (int stride = blockDim.x / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      g1p p, q, t;
      g1_load(p, sh[threadIdx.x]);
      g1_load(q, sh[threadIdx.x + stride]);
      g1_add(t, p, q);
      g1_store(sh[threadIdx.x], t);
    }
    __syncthreads();
  }
  if (threadIdx.x < 12)
    wsum[(size_t)(b * nw + w) * 12 + threadIdx.x] = sh[0][threadIdx.x];
}

__global__ void bn_msm_horner_kernel(const uint64_t *wsum, uint64_t *out,
                                     int B, int nw) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  bn_msm_horner_one(wsum + (size_t)b * nw * 12, out + (size_t)b * 12, nw);
}

// acc [B][nw][S][12] -> wsum [B][nw][12] (scratch) -> out [B][12]
extern "C" int vmpc_cu_bn_msm_tail(const uint64_t *acc, uint64_t *wsum,
                                   uint64_t *out, int B, int nw, int S,
                                   void *stream) {
  dim3 grid(nw, B);
  bn_msm_reduce_kernel<<<grid, BN_REDUCE_THREADS, 0, (cudaStream_t)stream>>>(
      acc, wsum, nw, S);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  bn_msm_horner_kernel<<<blocks_for(B, 32), 32, 0, (cudaStream_t)stream>>>(
      wsum, out, B, nw);
  return (int)cudaGetLastError();
}
