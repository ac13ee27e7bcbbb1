// K2: Ed25519 MSM tail, hand-written for Hopper (sm_90a).
//
// Replaces verifiable_mpc_tpu/ops/msm_pallas.py _make_tail_kernel (the
// pallas_call in _tail_pallas): the lane all-reduce of the window
// accumulators, then the Horner ladder over the windows (4 doublings + 1
// add each).  Blocks run in no order on Hopper, so the tail is two
// launches: msm_reduce_kernel sums a window's S slice accumulators in one
// block (a strided walk, then a shared-memory tree), and
// msm_horner_kernel runs the ladder and the normalization, one thread per
// batch.
//
// Bound: integer multiplies.  The Horner thread is a serial chain of ~320
// point operations plus a Fermat inversion: its latency, not the card's
// throughput, sets the time at these sizes.

#include "ed25519_kernels.cuh"
#include "launch.cuh"

#define REDUCE_THREADS 128

__global__ void msm_reduce_kernel(const uint64_t *acc, uint64_t *wsum, int nw,
                                  int S) {
  __shared__ uint64_t sh[REDUCE_THREADS][16];
  int w = blockIdx.x;
  int b = blockIdx.y;
  const uint64_t *base = acc + (size_t)(b * nw + w) * S * 16;
  ge_ext sum;
  ge_identity(sum);
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    ge_ext p, t;
    ge_load(p, base + (size_t)s * 16);
    ge_add(t, sum, p);
    sum = t;
  }
  ge_store(sh[threadIdx.x], sum);
  __syncthreads();
  for (int stride = blockDim.x / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      ge_ext p, q, t;
      ge_load(p, sh[threadIdx.x]);
      ge_load(q, sh[threadIdx.x + stride]);
      ge_add(t, p, q);
      ge_store(sh[threadIdx.x], t);
    }
    __syncthreads();
  }
  if (threadIdx.x < 16)
    wsum[(size_t)(b * nw + w) * 16 + threadIdx.x] = sh[0][threadIdx.x];
}

__global__ void msm_horner_kernel(const uint64_t *wsum, uint64_t *out, int B,
                                  int nw) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  msm_horner_one(wsum + (size_t)b * nw * 16, out + (size_t)b * 16, nw, 4);
}

// acc [B][nw][S][16] -> wsum [B][nw][16] (scratch) -> out [B][16]
extern "C" int vmpc_cu_msm_tail(const uint64_t *acc, uint64_t *wsum,
                                uint64_t *out, int B, int nw, int S,
                                void *stream) {
  dim3 grid(nw, B);
  msm_reduce_kernel<<<grid, REDUCE_THREADS, 0, (cudaStream_t)stream>>>(
      acc, wsum, nw, S);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  msm_horner_kernel<<<blocks_for(B, 32), 32, 0, (cudaStream_t)stream>>>(
      wsum, out, B, nw);
  return (int)cudaGetLastError();
}
