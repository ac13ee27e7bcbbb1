// The lane groups of the MSM tails' combinations (K2 over Ed25519 in
// ed25519_kernels.cuh, K6 over BN256 G1 in bn254_kernels.cuh, K10 over the
// twist in bn2_kernels.cuh), and the combination's steps, which the three
// tails share.
//
// A group operation runs on a group of L lanes that share slots in shared
// memory: lane l computes the products k = l, l + L, ... of a level of
// independent products, writes them to the slots, and the group meets at a
// barrier.  Each step is a function of (slots, lane, L) that reads only
// what earlier steps wrote: the kernel runs a step in all lanes at once and
// then __syncwarp, the host harness (host_check.cc) runs the lanes one
// after another (CoopLanes::run).

#pragma once

#include "digits.cuh"

#if defined(__CUDACC__)
#define FE_MEMBER __host__ __device__ __forceinline__
#else
#define FE_MEMBER inline
#endif

// the lanes of one group: lane, L and the group's warp mask (device)
struct CoopLanes {
  int lane, L;
  unsigned mask;
  // step(l) for every lane l of the group, then the group's barrier
  template <class F>
  FE_MEMBER void run(F step) const {
#if defined(__CUDA_ARCH__)
    step(lane);
    __syncwarp(mask);
#else
    for (int l = 0; l < L; l++) step(l);
#endif
  }
};

// the nibble k of a table of small indices (of up to 8 or 16 entries)
FE_FN int nib(uint32_t table, int k) { return (table >> (4 * k)) & 15; }
FE_FN int nib64(uint64_t table, int k) { return (int)(table >> (4 * k)) & 15; }

// the windows [a, b) of group j of P (ceil(nw / P) windows each, the last
// groups shorter or empty)
FE_FN void tail_span(int j, int nw, int P, int &a, int &b) {
  int k = (nw + P - 1) / P;
  a = j * k < nw ? j * k : nw;
  b = a + k < nw ? a + k : nw;
}

#if defined(__CUDACC__)
// this thread's place in a lane group of L lanes (L divides 32)
__device__ __forceinline__ CoopLanes coop_lanes(int L) {
  CoopLanes ex;
  ex.lane = threadIdx.x % L;
  ex.L = L;
  ex.mask = (unsigned)((1ull << L) - 1) << (threadIdx.x % 32 / L * L);
  return ex;
}
#endif

// ---------------------------------------------------------------------------
// The combination of an MSM tail, over a curve's lane-group slots
// ---------------------------------------------------------------------------
//
// A curve's slots (ed_coop over fe, g1_coop over fp, g2_coop over fp2) hold
// a point of C = Slots::COORDS coordinates (4 for Ed25519's X, Y, Z, T; 3
// for the BN curves' X, Y, Z) in v[0..C), an add's other operand in
// v[C..2C) and 0 in v[2C].  Its header gives, for its slots and field
// elements, coop_load_row (C slots <- a working row), coop_copy (C slots <-
// C slots), coop_add (v[0..C) += v[C..2C)), coop_dbl (v[0..C) *= 2) and
// coop_store_normalized (the normalized result row of v[0..C), one lane);
// a curve whose add reads its operand in another form than the point's
// (Ed25519: 2d T in place of T) also gives coop_operand; the steps below
// find them where a kernel or the host harness instantiates them.  A
// working row is the C coordinates' words.

// v[k..k+C) <- the form in which coop_add reads its operand: nothing for a
// curve whose add reads the point as it is (G1, the twist)
template <class Lanes, class Slots>
FE_FN void coop_operand(const Lanes &, Slots &, int) {}

// window w's sum: its R partials part [R][row] (working rows), summed in
// order into v[0..C) and copied to wsum [C] in the operand's form (the
// window sums are the Horners' operands; as a Horner's start, its first
// step is a doubling or it is an operand of tail_shift)
template <class Lanes, class Slots, class E>
FE_FN void tail_window(const Lanes &ex, Slots &s, const uint64_t *part,
                       int R, E *wsum) {
  constexpr int C = Slots::COORDS;
  const size_t row = C * sizeof(E) / sizeof(uint64_t);
  ex.run([&](int l) {
    coop_load_row(s.v, part, l, ex.L);
    if (l == 0) s.v[2 * C] = {};
  });
  for (int r = 1; r < R; r++) {
    ex.run([&](int l) { coop_load_row(s.v + C, part + r * row, l, ex.L); });
    coop_operand(ex, s, C);
    coop_add(ex, s);
  }
  coop_operand(ex, s, 0);
  ex.run([&](int l) { coop_copy(wsum, s.v, l, ex.L); });
}

// group j's Horner over its windows (most significant first) of the
// window sums wsum [nw][C], windows of ``bits`` bits: v[0..C) =
// sum_{w in [a, b)} 2^(bits (b-1-w)) S_w, left in the operand's form (an
// empty group does nothing: tail_shift stops before it)
template <class Lanes, class Slots, class Sums>
FE_FN void tail_group(const Lanes &ex, Slots &s, Sums wsum, int j, int nw,
                      int P, int bits) {
  constexpr int C = Slots::COORDS;
  int a, b;
  tail_span(j, nw, P, a, b);
  if (a == b) return;
  ex.run([&](int l) {
    coop_copy(s.v, wsum[a], l, ex.L);
    if (l == 0) s.v[2 * C] = {};
  });
  for (int w = a + 1; w < b; w++) {
    for (int i = 0; i < bits; i++) coop_dbl(ex, s);
    ex.run([&](int l) { coop_copy(s.v + C, wsum[w], l, ex.L); });
    coop_add(ex, s);
  }
  if (b > a + 1) coop_operand(ex, s, 0);
}

// group 0 after every group's Horner: shift and add the groups' sums
// (sh[j].v[0..C) of group j), 2^(bits (nw - b_j)) H_j, into sh[0], then
// its normalized result row (lane 0)
template <class Lanes, class Slots>
FE_FN void tail_shift(const Lanes &ex, Slots *sh, int nw, int P, int bits,
                      uint64_t *out) {
  int a, b, prev;
  tail_span(0, nw, P, a, prev);
  for (int j = 1; j < P; j++) {
    tail_span(j, nw, P, a, b);
    if (a == b) break;
    for (int i = 0; i < bits * (b - prev); i++) coop_dbl(ex, sh[0]);
    ex.run([&](int l) {
      coop_copy(sh[0].v + Slots::COORDS, sh[j].v, l, ex.L);
    });
    coop_add(ex, sh[0]);
    prev = b;
  }
  ex.run([&](int l) {
    if (l == 0) coop_store_normalized(out, sh[0]);
  });
}

#if defined(__CUDACC__)
// the combination kernel's body, for batch blockIdx.x: part [B][nw][R][row]
// -> out [B][row] = sum_w 2^(BITS (nw-1-w)) (window w's sum).  The groups of
// L lanes sum each window's R partials (a group per window, sh[nw] and
// wsum[nw][C] in shared memory), then P groups of Lc lanes run a Horner
// each over a run of ceil(nw / P) windows, then group 0 shifts, adds and
// normalizes.  K2, K6 and K10 take 4-bit windows, K14 8-bit ones.
template <int L, int Lc, int P, int BITS, class Slots, class E, int C>
__device__ __forceinline__ void tail_combine(Slots *sh, E (*wsum)[C],
                                             const uint64_t *part,
                                             uint64_t *out, int nw, int R) {
  static_assert(C == Slots::COORDS, "a window sum is one point");
  const size_t row = C * sizeof(E) / sizeof(uint64_t);
  int grp = threadIdx.x / L;
  if (grp < nw)
    tail_window(coop_lanes(L), sh[grp],
                part + (size_t)(blockIdx.x * nw + grp) * R * row, R,
                wsum[grp]);
  __syncthreads();
  grp = threadIdx.x / Lc;
  CoopLanes ex = coop_lanes(Lc);
  if (grp < P) tail_group(ex, sh[grp], wsum, grp, nw, P, BITS);
  __syncthreads();
  if (grp == 0) tail_shift(ex, sh, nw, P, BITS, out + blockIdx.x * row);
}
#endif
