// K2: Ed25519 MSM tail, hand-written for Hopper (sm_90a).
//
// Replaces verifiable_mpc_tpu/ops/msm_pallas.py _make_tail_kernel (the
// pallas_call in _tail_pallas): the lane all-reduce of the window
// accumulators, then the Horner ladder over the windows (4 doublings + 1
// add each), then the normalization.  K6's design (bn_msm_tail.cu) over
// Ed25519, two launches:
//
// * msm_reduce_kernel: block (w * R + r, b) sums the r-th of R chunks of
//   window w's S slice accumulators (a strided walk, then a shared-memory
//   tree) into part [B][nw][R]; R is the wrapper's (msm_cuda.tail_split).
// * msm_combine_kernel, one block per batch: the groups of TAIL_LANES
//   lanes first sum each window's R partials (a group per window), then
//   TAIL_GROUPS groups of TAIL_CHAIN_LANES lanes run a Horner each over a
//   run of ceil(nw / P) windows, then group 0 shifts and adds the groups'
//   sums and normalizes (coop.cuh: tail_combine over
//   ed25519_kernels.cuh's ed_coop steps, the steps K6 and K10 run over
//   their curves).  A doubling and an add are each two levels of four
//   independent products, one round of the four lanes each; 64 groups of
//   416 bytes of slots and the window sums take 34,816 bytes of static
//   shared memory.  The last lane's inversion is the binary extended
//   Euclid algorithm (fe_inv_var), not a Fermat chain of 265 products.
//
// Bound: integer multiplies by the card's throughput, but the combination
// is one chain of dependent steps whatever the card's width: about 252
// doublings and 15 adds, each two rounds of products, then the inversion,
// where the one-thread Horner it replaces ran about 2,850 products in a
// row (256 doublings, 64 complete adds and a Fermat chain).

#include "ed25519_kernels.cuh"
#include "launch.cuh"

#define REDUCE_THREADS 128
#define TAIL_LANES 4        // lanes per group operation of the windows' sums
#define TAIL_CHAIN_LANES 4  // lanes per group operation of the Horners
#define TAIL_GROUPS 8       // window groups of the combination
#define TAIL_WINDOWS 64     // most windows of an MSM (one lane group each)

static_assert(32 % TAIL_LANES == 0 && 32 % TAIL_CHAIN_LANES == 0,
              "a lane group lies in one warp");
static_assert(TAIL_GROUPS * TAIL_CHAIN_LANES <= TAIL_WINDOWS * TAIL_LANES,
              "the window groups fit the block");

__global__ void __launch_bounds__(REDUCE_THREADS)
    msm_reduce_kernel(const uint64_t *acc, uint64_t *part, int nw, int S,
                      int R) {
  __shared__ uint64_t sh[REDUCE_THREADS][16];
  int w = blockIdx.x / R, r = blockIdx.x % R;
  int b = blockIdx.y;
  int chunk = (S + R - 1) / R;
  int s0 = r * chunk, s1 = s0 + chunk < S ? s0 + chunk : S;
  const uint64_t *base = acc + (size_t)(b * nw + w) * S * 16;
  ge_ext sum;
  ge_identity(sum);
  for (int s = s0 + threadIdx.x; s < s1; s += blockDim.x) {
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
    part[((size_t)(b * nw + w) * R + r) * 16 + threadIdx.x] =
        sh[0][threadIdx.x];
}

__global__ void __launch_bounds__(TAIL_WINDOWS * TAIL_LANES)
    msm_combine_kernel(const uint64_t *part, uint64_t *out, int nw, int R) {
  __shared__ ed_coop sh[TAIL_WINDOWS];
  __shared__ fe wsum[TAIL_WINDOWS][4];
  tail_combine<TAIL_LANES, TAIL_CHAIN_LANES, TAIL_GROUPS, 4>(sh, wsum, part,
                                                             out, nw, R);
}

// acc [B][nw][S][16] -> part [B][nw][R][16] (scratch) -> out [B][16]
extern "C" int vmpc_cu_msm_tail(const uint64_t *acc, uint64_t *part,
                                uint64_t *out, int B, int nw, int S, int R,
                                void *stream) {
  if (nw <= 0 || nw > TAIL_WINDOWS || R <= 0 || B <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(nw * R, B);
  msm_reduce_kernel<<<grid, REDUCE_THREADS, 0, s>>>(acc, part, nw, S, R);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  msm_combine_kernel<<<B, TAIL_WINDOWS * TAIL_LANES, 0, s>>>(part, out, nw,
                                                             R);
  return (int)cudaGetLastError();
}
