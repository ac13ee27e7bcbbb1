// P3 and P4, the probe kernels of probes/probe_carrychain.py, hand-written
// for Hopper (sm_90a).
//
// P3 replaces probe_carrychain.py:73 (the pallas_call of main.mk_chain):
// `iters` steps of a <- mul25519(a, b) over K independent chains a lane,
// K = 1 (chain) or 4 (ilp4, interleaved in one loop), eight 32-bit words a
// value, word-major [8][n] (K such arrays for a).  Each step of a chain
// waits for the one before, so one lane is bound by the product's latency;
// four chains give the scheduler independent work.  Bound: operations,
// 128 32-bit multiplies a product at the IMAD rate.
//
// P4 replaces probe_carrychain.py:89 (main.mk_raw): `steps` steps of
// x <- x * y + 1 on u32, one element per thread: the ceiling P3 is read
// against.  Bound: operations, one IMAD a step.

#include "launch.cuh"
#include "probe_ops.cuh"

#define PROBE_THREADS 256

template <int K>
__global__ void probe_chain_kernel(const uint32_t *a, const uint32_t *b,
                                   uint32_t *out, int n, int iters) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fe x[K], y;
#pragma unroll
  for (int c = 0; c < K; c++) fe_load_words(x[c], a + (size_t)c * 8 * n, n, i);
  fe_load_words(y, b, n, i);
  chain_steps<K>(x, y, iters);
#pragma unroll
  for (int c = 0; c < K; c++) fe_store_words(out + (size_t)c * 8 * n, x[c], n, i);
}

__global__ void probe_raw_kernel(const uint32_t *x, const uint32_t *y,
                                 uint32_t *out, int n, int steps) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = vpu_steps<VPU_U32_MUL>(x[i], y[i], steps);
}

// a, out: [chains][8][n] u32; b: [8][n]; chains 1 or 4
extern "C" int vmpc_cu_probe_chain(int chains, const uint32_t *a,
                                   const uint32_t *b, uint32_t *out, int n,
                                   int iters, void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int g = blocks_for(n, PROBE_THREADS);
  if (chains == 1)
    probe_chain_kernel<1><<<g, PROBE_THREADS, 0, s>>>(a, b, out, n, iters);
  else if (chains == 4)
    probe_chain_kernel<4><<<g, PROBE_THREADS, 0, s>>>(a, b, out, n, iters);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x, y, out: [n] u32
extern "C" int vmpc_cu_probe_raw(const uint32_t *x, const uint32_t *y,
                                 uint32_t *out, int n, int steps,
                                 void *stream) {
  probe_raw_kernel<<<blocks_for(n, PROBE_THREADS), PROBE_THREADS, 0,
                     (cudaStream_t)stream>>>(x, y, out, n, steps);
  return (int)cudaGetLastError();
}

// threads one SM holds at once (blocks of PROBE_THREADS): kernel 0 the
// chain, 1 ilp4, 2 raw; a negative value is a CUDA error
extern "C" int vmpc_cu_probe_carrychain_resident(int kernel) {
  int blocks = 0;
  cudaError_t e;
  switch (kernel) {
    case 0: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, probe_chain_kernel<1>, PROBE_THREADS, 0); break;
    case 1: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, probe_chain_kernel<4>, PROBE_THREADS, 0); break;
    case 2: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, probe_raw_kernel, PROBE_THREADS, 0); break;
    default: return -(int)cudaErrorInvalidValue;
  }
  return e != cudaSuccess ? -(int)e : blocks * PROBE_THREADS;
}
