// P1 and P2, the probe kernels of probes/probe_vpu.py, hand-written for
// Hopper (sm_90a).
//
// P1 replaces probe_vpu.py:38 (the pallas_call of main.mk): a loop of
// `iters` steps of one elementwise op x <- f(x, y), one lane per thread,
// the op a template parameter (probe_ops.cuh's VpuOp: u32_mul_split,
// u32_mul, u32_add, f32_fma).  Bound: operations, the 32-bit integer
// pipes' 64 lanes per SM per clock (IMAD, IADD3, LOP3) and the FP32
// pipes' 128 (FFMA); the probe measures exactly those rates.
//
// P2 replaces probe_vpu.py:94 (main.mk_field): `iters` dependent field
// products x <- x * y a lane, eight 32-bit words a value, word-major
// [8][n] in memory: fe25519.cuh's fe_mul (mul25519), a CIOS Montgomery
// product mod 2^255 - 19 with R = 2^256 (mont_mul), and fp254.cuh's BN256
// fp_mul.  Bound: operations, 128 32-bit multiplies a pseudo-Mersenne
// product and 264 a Montgomery one at the IMAD rate.  A lane's chain is
// serial; the card hides its latency only with enough lanes resident.

#include "launch.cuh"
#include "probe_ops.cuh"

#define PROBE_THREADS 256

template <int OP>
__global__ void probe_vpu_kernel(const typename VpuOp<OP>::T *x,
                                 const typename VpuOp<OP>::T *y,
                                 typename VpuOp<OP>::T *out, int n,
                                 int iters) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = vpu_steps<OP>(x[i], y[i], iters);
}

template <int OP>
__global__ void probe_field_kernel(const uint32_t *x, const uint32_t *y,
                                   uint32_t *out, int n, int iters,
                                   Mont25519 k) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fe a, b;
  fe_load_words(a, x, n, i);
  fe_load_words(b, y, n, i);
  field_steps<OP>(a, b, k, iters);
  fe_store_words(out, a, n, i);
}

template <int OP>
static void launch_vpu(const void *x, const void *y, void *out, int n,
                       int iters, cudaStream_t s) {
  typedef typename VpuOp<OP>::T T;
  probe_vpu_kernel<OP><<<blocks_for(n, PROBE_THREADS), PROBE_THREADS, 0, s>>>(
      (const T *)x, (const T *)y, (T *)out, n, iters);
}

template <int OP>
static void launch_field(const uint32_t *x, const uint32_t *y, uint32_t *out,
                         int n, int iters, cudaStream_t s) {
  probe_field_kernel<OP><<<blocks_for(n, PROBE_THREADS), PROBE_THREADS, 0,
                           s>>>(x, y, out, n, iters, mont25519_consts());
}

// x, y, out: [n] u32 (ops 0-2) or f32 (op 3)
extern "C" int vmpc_cu_probe_vpu(int op, const void *x, const void *y,
                                 void *out, int n, int iters, void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case VPU_U32_MUL_SPLIT: launch_vpu<VPU_U32_MUL_SPLIT>(x, y, out, n, iters, s); break;
    case VPU_U32_MUL: launch_vpu<VPU_U32_MUL>(x, y, out, n, iters, s); break;
    case VPU_U32_ADD: launch_vpu<VPU_U32_ADD>(x, y, out, n, iters, s); break;
    case VPU_F32_FMA: launch_vpu<VPU_F32_FMA>(x, y, out, n, iters, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x, y, out: word-major [8][n] u32
extern "C" int vmpc_cu_probe_field(int op, const uint32_t *x,
                                   const uint32_t *y, uint32_t *out, int n,
                                   int iters, void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case FIELD_MUL25519: launch_field<FIELD_MUL25519>(x, y, out, n, iters, s); break;
    case FIELD_MONT25519: launch_field<FIELD_MONT25519>(x, y, out, n, iters, s); break;
    case FIELD_FP254: launch_field<FIELD_FP254>(x, y, out, n, iters, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// threads one SM holds at once, in blocks of PROBE_THREADS (the registers
// ptxas gave the kernel decide it): kernel 0-3 the P1 ops, 4-6 the P2
// products; a negative value is a CUDA error
extern "C" int vmpc_cu_probe_vpu_resident(int kernel) {
  int blocks = 0;
  cudaError_t e;
  switch (kernel) {
    case 0: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, probe_vpu_kernel<0>, PROBE_THREADS, 0); break;
    case 1: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, probe_vpu_kernel<1>, PROBE_THREADS, 0); break;
    case 2: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, probe_vpu_kernel<2>, PROBE_THREADS, 0); break;
    case 3: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, probe_vpu_kernel<3>, PROBE_THREADS, 0); break;
    case 4: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, probe_field_kernel<0>, PROBE_THREADS, 0); break;
    case 5: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, probe_field_kernel<1>, PROBE_THREADS, 0); break;
    case 6: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, probe_field_kernel<2>, PROBE_THREADS, 0); break;
    default: return -(int)cudaErrorInvalidValue;
  }
  return e != cudaSuccess ? -(int)e : blocks * PROBE_THREADS;
}
