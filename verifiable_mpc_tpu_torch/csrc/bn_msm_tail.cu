// K6: BN256 G1 MSM tail, hand-written for Hopper (sm_90a).
//
// Replaces the BN instance of verifiable_mpc_tpu/ops/msm_pallas.py
// _make_tail_kernel (the pallas_call in _tail_pallas): the lane all-reduce
// of the window accumulators, then the Horner ladder over the windows (4
// doublings + 1 add each), then the normalization (on the TPU the BN
// result left projective and the host divided).  Two launches:
//
// * bn_msm_reduce_kernel: block (w * R + r, b) sums the r-th of R chunks of
//   window w's S slice accumulators (a strided walk, then a shared-memory
//   tree) into part [B][nw][R]; R is chosen so that about four adds a
//   thread remain and nw * R * B blocks fill the card at least twice.
// * bn_msm_combine_kernel, one block per batch: the groups of TAIL_LANES
//   lanes first sum each window's R partials (a group per window), then
//   TAIL_GROUPS groups run a Horner each over a run of ceil(nw / P)
//   windows, then group 0 shifts and adds the groups' sums and normalizes
//   (coop.cuh: tail_combine over bn254_kernels.cuh's g1_coop steps).
//
// Bound: integer multiplies by the card's throughput, but the combination
// is one chain of dependent products whatever the card's width: about 252
// doublings, 15 adds and a Fermat inversion.  A lone thread runs a
// dependent fp_mul in about a microsecond, so the design shortens the
// chain: the window groups take the adds of 56 windows off it, and each
// group operation runs its independent products on TAIL_LANES lanes at
// once (a doubling's 8 products in 2 rounds, an add's 12 in 4), where the
// one-thread Horner it replaces ran 256 doublings and 64 adds in a row.

#include "bn254_kernels.cuh"
#include "launch.cuh"

#define BN_REDUCE_THREADS 128
#define TAIL_LANES 4    // lanes per group operation
#define TAIL_GROUPS 8   // window groups of the combination
#define TAIL_WINDOWS 64  // most windows of an MSM (one lane group each)

static_assert(TAIL_GROUPS * TAIL_LANES <= 32 && 32 % TAIL_LANES == 0,
              "the window groups must share warp 0");

__global__ void bn_msm_reduce_kernel(const uint64_t *acc, uint64_t *part,
                                     int nw, int S, int R) {
  __shared__ uint64_t sh[BN_REDUCE_THREADS][12];
  int w = blockIdx.x / R, r = blockIdx.x % R;
  int b = blockIdx.y;
  int chunk = (S + R - 1) / R;
  int s0 = r * chunk, s1 = s0 + chunk < S ? s0 + chunk : S;
  const uint64_t *base = acc + (size_t)(b * nw + w) * S * 12;
  g1p sum;
  g1_identity(sum);
  for (int s = s0 + threadIdx.x; s < s1; s += blockDim.x) {
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
    part[((size_t)(b * nw + w) * R + r) * 12 + threadIdx.x] =
        sh[0][threadIdx.x];
}

__global__ void __launch_bounds__(TAIL_WINDOWS * TAIL_LANES)
    bn_msm_combine_kernel(const uint64_t *part, uint64_t *out, int nw,
                          int R) {
  __shared__ g1_coop sh[TAIL_WINDOWS];
  __shared__ fp wsum[TAIL_WINDOWS][3];
  tail_combine<TAIL_LANES, TAIL_LANES, TAIL_GROUPS, 4>(sh, wsum, part, out,
                                                       nw, R);
}

// acc [B][nw][S][12] -> part [B][nw][R][12] (scratch) -> out [B][12]
extern "C" int vmpc_cu_bn_msm_tail(const uint64_t *acc, uint64_t *part,
                                   uint64_t *out, int B, int nw, int S,
                                   int R, void *stream) {
  if (nw <= 0 || nw > TAIL_WINDOWS || R <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(nw * R, B);
  bn_msm_reduce_kernel<<<grid, BN_REDUCE_THREADS, 0, s>>>(acc, part, nw, S,
                                                          R);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  bn_msm_combine_kernel<<<B, TAIL_WINDOWS * TAIL_LANES, 0, s>>>(part, out,
                                                                nw, R);
  return (int)cudaGetLastError();
}
