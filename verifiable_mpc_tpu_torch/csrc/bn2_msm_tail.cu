// K10: BN256 twist (G2) MSM tail, hand-written for Hopper (sm_90a).
//
// Replaces the BN2 instance of verifiable_mpc_tpu/ops/msm_pallas.py
// _make_tail_kernel (the pallas_call in _tail_pallas): the lane all-reduce
// of the window accumulators, then the Horner ladder over the windows (4
// doublings + 1 add each), then the normalization (on the TPU the twist
// result left projective and the host divided).  K6's design
// (bn_msm_tail.cu) over GF(p^2), two launches:
//
// * bn2_msm_reduce_kernel: block (w * R + r, b) sums the r-th of R chunks
//   of window w's S slice accumulators (a strided walk, then a
//   shared-memory tree) into part [B][nw][R]; R is the wrapper's
//   (msm_bn2_cuda.tail_split).
// * bn2_msm_combine_kernel, one block per batch: the groups of TAIL_LANES
//   lanes first sum each window's R partials (a group per window), then
//   TAIL_GROUPS groups of TAIL_CHAIN_LANES lanes run a Horner each over a
//   run of ceil(nw / P) windows, then group 0 shifts and adds the groups'
//   sums and normalizes (coop.cuh: tail_combine over bn2_kernels.cuh's
//   g2_coop steps, the steps K6 runs over G1).
//   Each group operation's three levels of independent base-field products
//   (an add's 18, 6 and 18, a doubling's 10, 3 and 12) run on the group's
//   lanes from slots in shared memory, a g2_coop of 1,600 bytes a group:
//   16 lanes take each level of a doubling in one round, where 8 take two
//   of its three levels in two.  64 groups and the window sums take 114,688
//   bytes, more than static shared memory allows, so the slots are dynamic
//   shared memory (the attribute set at every call).  A window per
//   group keeps the windows' sums in one round of R - 1 adds; fewer groups
//   would run them in turns.
//
// Bound: integer multiplies by the card's throughput, but the combination
// is one chain of dependent products whatever the card's width: about 252
// doublings, 15 adds and a Fermat inversion.  The window groups take the
// adds of 56 windows off it, and each group operation's products run on
// TAIL_CHAIN_LANES lanes at once (a doubling in 3 rounds of products),
// where the one-thread Horner it replaces ran 256 doublings and 64 adds of
// 25 and 42 products in a row.

#include "bn2_kernels.cuh"
#include "launch.cuh"

#define BN2_REDUCE_THREADS 128
#define TAIL_LANES 8     // lanes per group operation of the windows' sums
#define TAIL_CHAIN_LANES 16  // lanes per group operation of the Horners
#define TAIL_GROUPS 8    // window groups of the combination
#define TAIL_WINDOWS 64  // most windows of an MSM (one lane group each)
#define TAIL_SMEM (TAIL_WINDOWS * (sizeof(g2_coop) + 3 * sizeof(fp2)))

static_assert(32 % TAIL_LANES == 0 && 32 % TAIL_CHAIN_LANES == 0,
              "a lane group lies in one warp");
static_assert(TAIL_GROUPS * TAIL_CHAIN_LANES <= TAIL_WINDOWS * TAIL_LANES,
              "the window groups fit the block");

__global__ void __launch_bounds__(BN2_REDUCE_THREADS)
    bn2_msm_reduce_kernel(const uint64_t *acc, uint64_t *part, int nw, int S,
                          int R) {
  __shared__ uint64_t sh[BN2_REDUCE_THREADS][BN2_ROW];
  int w = blockIdx.x / R, r = blockIdx.x % R;
  int b = blockIdx.y;
  int chunk = (S + R - 1) / R;
  int s0 = r * chunk, s1 = s0 + chunk < S ? s0 + chunk : S;
  const uint64_t *base = acc + (size_t)(b * nw + w) * S * BN2_ROW;
  g2p sum;
  g2_identity(sum);
  for (int s = s0 + threadIdx.x; s < s1; s += blockDim.x) {
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
    part[((size_t)(b * nw + w) * R + r) * BN2_ROW + threadIdx.x] =
        sh[0][threadIdx.x];
}

__global__ void __launch_bounds__(TAIL_WINDOWS * TAIL_LANES)
    bn2_msm_combine_kernel(const uint64_t *part, uint64_t *out, int nw,
                           int R) {
  extern __shared__ uint64_t smem[];
  g2_coop *sh = (g2_coop *)smem;
  fp2(*wsum)[3] = (fp2(*)[3])(sh + TAIL_WINDOWS);
  tail_combine<TAIL_LANES, TAIL_CHAIN_LANES, TAIL_GROUPS, 4>(sh, wsum, part,
                                                             out, nw, R);
}

// acc [B][nw][S][24] -> part [B][nw][R][24] (scratch) -> out [B][24]
extern "C" int vmpc_cu_bn2_msm_tail(const uint64_t *acc, uint64_t *part,
                                    uint64_t *out, int B, int nw, int S,
                                    int R, void *stream) {
  if (nw <= 0 || nw > TAIL_WINDOWS || R <= 0 || B <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  // on every call: the attribute holds for the current device only
  int rc = (int)cudaFuncSetAttribute(
      bn2_msm_combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TAIL_SMEM);
  if (rc) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(nw * R, B);
  bn2_msm_reduce_kernel<<<grid, BN2_REDUCE_THREADS, 0, s>>>(acc, part, nw,
                                                            S, R);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  bn2_msm_combine_kernel<<<B, TAIL_WINDOWS * TAIL_LANES, TAIL_SMEM, s>>>(
      part, out, nw, R);
  return (int)cudaGetLastError();
}
