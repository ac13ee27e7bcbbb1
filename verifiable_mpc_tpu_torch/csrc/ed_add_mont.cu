// K16: batched unified Ed25519 addition on Montgomery limbs, hand-written
// for Hopper (sm_90a).
//
// Replaces verifiable_mpc_tpu/ops/pallas_kernels.py _add_kernel (the
// pallas_call in _build_add, entry point pallas_add): p_i + q_i
// (add-2008-hwcd-3, complete) for point vectors held as four [n, 16]
// arrays of 16-bit limbs in u32 words, in the Montgomery domain of
// GF(2^255 - 19) (x * 2^256 mod p), as ops/curve_ed.encode_points leaves
// them.  One thread per element: it converts its eight input coordinates
// into fe25519.cuh's 8 x 32-bit form (times 38^-1, since 2^256 == 38 mod
// p), runs the unified add, and converts the four results back (times 38,
// canonical).  Each thread reads 64 contiguous bytes of every coordinate
// array, neighbouring threads the next 64.
//
// Bound: bytes (768 per element: eight 64-byte inputs, four outputs)
// against the add's 9 field multiplies.

#include "ed25519_kernels.cuh"
#include "launch.cuh"

__global__ void mont_add_kernel(MontCoords p, MontCoords q, MontCoordsOut o,
                                int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  mont_add_one(p, q, o, (size_t)i);
}

// p and q: x, y, z, t [n][16] u32 each; out x, y, z, t [n][16]
extern "C" int vmpc_cu_mont_add(const uint32_t *px, const uint32_t *py,
                                const uint32_t *pz, const uint32_t *pt,
                                const uint32_t *qx, const uint32_t *qy,
                                const uint32_t *qz, const uint32_t *qt,
                                uint32_t *ox, uint32_t *oy, uint32_t *oz,
                                uint32_t *ot, int n, void *stream) {
  MontCoords p = {px, py, pz, pt};
  MontCoords q = {qx, qy, qz, qt};
  MontCoordsOut o = {ox, oy, oz, ot};
  mont_add_kernel<<<blocks_for(n, K_THREADS), K_THREADS, 0,
                    (cudaStream_t)stream>>>(p, q, o, n);
  return (int)cudaGetLastError();
}
