// K10: BN256 twist (G2) MSM tail, hand-written for Hopper (sm_90a).
//
// Replaces the BN2 instance of verifiable_mpc_tpu/ops/msm_pallas.py
// _make_tail_kernel (the pallas_call in _tail_pallas): the lane all-reduce
// of the window accumulators, then the Horner ladder over the windows (4
// doublings + 1 add each), then the normalization (on the TPU the twist
// result left projective and the host divided).  As K6, two launches:
// bn2_msm_reduce_kernel sums a window's S slice accumulators in one block
// (a strided walk, then a shared-memory tree of 128 x 192 bytes),
// bn2_msm_horner_kernel runs the ladder and the normalization, one thread
// per batch.
//
// Bound: integer multiplies.  The Horner thread is a serial chain of ~320
// twist operations (about 9,000 Montgomery products) plus an inversion:
// its latency, not the card's throughput, sets the time.

#include "bn2_kernels.cuh"
#include "launch.cuh"

#define BN2_REDUCE_THREADS 128

__global__ void __launch_bounds__(BN2_REDUCE_THREADS, 1)
    bn2_msm_reduce_kernel(const uint64_t *acc, uint64_t *wsum, int nw,
                          int S) {
  __shared__ uint64_t sh[BN2_REDUCE_THREADS][BN2_ROW];
  int w = blockIdx.x;
  int b = blockIdx.y;
  const uint64_t *base = acc + (size_t)(b * nw + w) * S * BN2_ROW;
  g2p sum;
  g2_identity(sum);
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    g2p p;
    g2_load(p, base + (size_t)s * BN2_ROW);
    g2_add(sum, sum, p);
  }
  g2_store(sh[threadIdx.x], sum);
  __syncthreads();
  for (int stride = blockDim.x / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      g2p p, q;
      g2_load(p, sh[threadIdx.x]);
      g2_load(q, sh[threadIdx.x + stride]);
      g2_add(p, p, q);
      g2_store(sh[threadIdx.x], p);
    }
    __syncthreads();
  }
  if (threadIdx.x < BN2_ROW)
    wsum[(size_t)(b * nw + w) * BN2_ROW + threadIdx.x] = sh[0][threadIdx.x];
}

__global__ void __launch_bounds__(32, 1)
    bn2_msm_horner_kernel(const uint64_t *wsum, uint64_t *out, int B,
                          int nw) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  bn2_msm_horner_one(wsum + (size_t)b * nw * BN2_ROW,
                     out + (size_t)b * BN2_ROW, nw);
}

// acc [B][nw][S][24] -> wsum [B][nw][24] (scratch) -> out [B][24]
extern "C" int vmpc_cu_bn2_msm_tail(const uint64_t *acc, uint64_t *wsum,
                                    uint64_t *out, int B, int nw, int S,
                                    void *stream) {
  dim3 grid(nw, B);
  bn2_msm_reduce_kernel<<<grid, BN2_REDUCE_THREADS, 0,
                          (cudaStream_t)stream>>>(acc, wsum, nw, S);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  bn2_msm_horner_kernel<<<blocks_for(B, 32), 32, 0, (cudaStream_t)stream>>>(
      wsum, out, B, nw);
  return (int)cudaGetLastError();
}
