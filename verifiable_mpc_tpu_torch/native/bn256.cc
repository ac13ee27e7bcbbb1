// Native host tier: BN256 (and its sextic twist) group arithmetic.
//
// 4x64-bit Montgomery limbs over the BN base field p, jacobian coordinates
// (branchy complete handling is fine on the CPU), Fp2 = Fp[i]/(i^2+1) for
// the twist, and bucket-method MSM / fixed-base batch exponentiation for
// both groups — the hot loops of Pinocchio key generation and proving
// (reference pynocchio.py:101-200, :228-273).

#include <array>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <type_traits>
#include <vector>

typedef unsigned __int128 u128;
typedef uint64_t u64;

namespace bn {

static const u64 P[4] = {0x185cac6c5e089667ULL, 0xee5b88d120b5b59eULL,
                         0xaa6fecb86184dc21ULL, 0x8fb501e34aa387f9ULL};
static const u64 NPRIME = 0x2387f9007f17daa9ULL;
static const u64 R2[4] = {0x9c21c3ff7e444f56ULL, 0x409ed151b2efb0c2ULL,
                          0x0c6dc37b80fb1651ULL, 0x7c36e0e62c2380b7ULL};
static const u64 ONE_M[4] = {0xe7a35393a1f76999ULL, 0x11a4772edf4a4a61ULL,
                             0x559013479e7b23deULL, 0x704afe1cb55c7806ULL};

struct Fp {
  u64 v[4];
};

static inline bool fp_is_zero(const Fp &a) {
  return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

static inline bool fp_eq(const Fp &a, const Fp &b) {
  return memcmp(a.v, b.v, 32) == 0;
}

static inline void fp_add(Fp &o, const Fp &a, const Fp &b) {
  u128 c = 0;
  u64 t[4];
  for (int i = 0; i < 4; i++) {
    c += (u128)a.v[i] + b.v[i];
    t[i] = (u64)c;
    c >>= 64;
  }
  u128 borrow = 0;
  u64 s[4];
  for (int i = 0; i < 4; i++) {
    u128 d = (u128)t[i] - P[i] - borrow;
    s[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
  if (c || !borrow)
    memcpy(o.v, s, 32);
  else
    memcpy(o.v, t, 32);
}

static inline void fp_sub(Fp &o, const Fp &a, const Fp &b) {
  u128 borrow = 0;
  u64 t[4];
  for (int i = 0; i < 4; i++) {
    u128 d = (u128)a.v[i] - b.v[i] - borrow;
    t[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
  if (borrow) {
    u128 c = 0;
    for (int i = 0; i < 4; i++) {
      c += (u128)t[i] + P[i];
      t[i] = (u64)c;
      c >>= 64;
    }
  }
  memcpy(o.v, t, 32);
}

static inline void fp_mul(Fp &o, const Fp &a, const Fp &b) {
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; i++) {
    u128 c = 0;
    u64 ai = a.v[i];
    for (int j = 0; j < 4; j++) {
      c += (u128)t[j] + (u128)ai * b.v[j];
      t[j] = (u64)c;
      c >>= 64;
    }
    c += t[4];
    t[4] = (u64)c;
    t[5] = (u64)(c >> 64);

    u64 m = t[0] * NPRIME;
    c = (u128)t[0] + (u128)m * P[0];
    c >>= 64;
    for (int j = 1; j < 4; j++) {
      c += (u128)t[j] + (u128)m * P[j];
      t[j - 1] = (u64)c;
      c >>= 64;
    }
    c += t[4];
    t[3] = (u64)c;
    t[4] = t[5] + (u64)(c >> 64);
    t[5] = 0;
  }
  u128 borrow = 0;
  u64 s[4];
  for (int i = 0; i < 4; i++) {
    u128 d = (u128)t[i] - P[i] - borrow;
    s[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
  if (t[4] || !borrow)
    memcpy(o.v, s, 32);
  else
    memcpy(o.v, t, 32);
}

static inline void fp_to_mont(Fp &o, const Fp &a) {
  Fp r2;
  memcpy(r2.v, R2, 32);
  fp_mul(o, a, r2);
}

// Fermat inversion a^(p-2) inside the Montgomery domain: the ladder's
// invariant is result = x*R, so mont-muls keep it in-domain and the output
// is mont(a^-1).  ~380 field muls, used only via batch_inverse (one per
// normalization pass).
static inline void fp_inv(Fp &o, const Fp &a) {
  u64 e[4] = {P[0] - 2, P[1], P[2], P[3]};
  Fp result;
  memcpy(result.v, ONE_M, 32);
  for (int bit = 255; bit >= 0; bit--) {
    Fp t;
    fp_mul(t, result, result);
    result = t;
    if ((e[bit >> 6] >> (bit & 63)) & 1) {
      fp_mul(t, result, a);
      result = t;
    }
  }
  o = result;
}

static inline void fp_from_mont(Fp &o, const Fp &a) {
  Fp one;
  memset(one.v, 0, 32);
  one.v[0] = 1;
  fp_mul(o, a, one);
}

// ---- Fp2 = Fp[i] / (i^2 + 1) ---------------------------------------------

struct Fp2 {
  Fp c0, c1;
};

static inline bool fp2_is_zero(const Fp2 &a) {
  return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}

static inline bool fp2_eq(const Fp2 &a, const Fp2 &b) {
  return fp_eq(a.c0, b.c0) && fp_eq(a.c1, b.c1);
}

static inline void fp2_add(Fp2 &o, const Fp2 &a, const Fp2 &b) {
  fp_add(o.c0, a.c0, b.c0);
  fp_add(o.c1, a.c1, b.c1);
}

static inline void fp2_sub(Fp2 &o, const Fp2 &a, const Fp2 &b) {
  fp_sub(o.c0, a.c0, b.c0);
  fp_sub(o.c1, a.c1, b.c1);
}

static inline void fp2_mul(Fp2 &o, const Fp2 &a, const Fp2 &b) {
  Fp t0, t1, s0, s1, r0, r1;
  fp_mul(t0, a.c0, b.c0);
  fp_mul(t1, a.c1, b.c1);
  fp_add(s0, a.c0, a.c1);
  fp_add(s1, b.c0, b.c1);
  fp_mul(r1, s0, s1);
  fp_sub(r1, r1, t0);
  fp_sub(r1, r1, t1);
  fp_sub(r0, t0, t1);
  o.c0 = r0;
  o.c1 = r1;
}

static inline void fp2_inv(Fp2 &o, const Fp2 &a) {
  // (c0 + c1 i)^-1 = (c0 - c1 i) / (c0^2 + c1^2)  with i^2 = -1
  Fp t0, t1, norm, ninv, zero, neg;
  fp_mul(t0, a.c0, a.c0);
  fp_mul(t1, a.c1, a.c1);
  fp_add(norm, t0, t1);
  fp_inv(ninv, norm);
  fp_mul(o.c0, a.c0, ninv);
  memset(zero.v, 0, 32);
  fp_sub(neg, zero, a.c1);
  fp_mul(o.c1, neg, ninv);
}

static inline void fp2_to_mont(Fp2 &o, const Fp2 &a) {
  fp_to_mont(o.c0, a.c0);
  fp_to_mont(o.c1, a.c1);
}

static inline void fp2_from_mont(Fp2 &o, const Fp2 &a) {
  fp_from_mont(o.c0, a.c0);
  fp_from_mont(o.c1, a.c1);
}

// ---- generic jacobian point ops over a field F ----------------------------

template <typename F>
struct Ops;

template <>
struct Ops<Fp> {
  static void add(Fp &o, const Fp &a, const Fp &b) { fp_add(o, a, b); }
  static void sub(Fp &o, const Fp &a, const Fp &b) { fp_sub(o, a, b); }
  static void mul(Fp &o, const Fp &a, const Fp &b) { fp_mul(o, a, b); }
  static void inv(Fp &o, const Fp &a) { fp_inv(o, a); }
  static bool is_zero(const Fp &a) { return fp_is_zero(a); }
  static bool eq(const Fp &a, const Fp &b) { return fp_eq(a, b); }
  static void to_mont(Fp &o, const Fp &a) { fp_to_mont(o, a); }
  static void from_mont(Fp &o, const Fp &a) { fp_from_mont(o, a); }
  static Fp one() {
    Fp o;
    memcpy(o.v, ONE_M, 32);
    return o;
  }
  static constexpr int words = 4;
};

template <>
struct Ops<Fp2> {
  static void add(Fp2 &o, const Fp2 &a, const Fp2 &b) { fp2_add(o, a, b); }
  static void sub(Fp2 &o, const Fp2 &a, const Fp2 &b) { fp2_sub(o, a, b); }
  static void mul(Fp2 &o, const Fp2 &a, const Fp2 &b) { fp2_mul(o, a, b); }
  static void inv(Fp2 &o, const Fp2 &a) { fp2_inv(o, a); }
  static bool is_zero(const Fp2 &a) { return fp2_is_zero(a); }
  static bool eq(const Fp2 &a, const Fp2 &b) { return fp2_eq(a, b); }
  static void to_mont(Fp2 &o, const Fp2 &a) { fp2_to_mont(o, a); }
  static void from_mont(Fp2 &o, const Fp2 &a) { fp2_from_mont(o, a); }
  static Fp2 one() {
    Fp2 o;
    memcpy(o.c0.v, ONE_M, 32);
    memset(o.c1.v, 0, 32);
    return o;
  }
  static constexpr int words = 8;
};

template <typename F>
struct Pt {
  F x, y, z;
};

template <typename F>
static bool pt_is_identity(const Pt<F> &p) {
  return Ops<F>::is_zero(p.z);
}

template <typename F>
static void pt_identity(Pt<F> &o) {
  memset(&o, 0, sizeof(o));
}

template <typename F>
static void pt_double(Pt<F> &o, const Pt<F> &p) {
  typedef Ops<F> O;
  if (pt_is_identity(p)) {
    o = p;
    return;
  }
  F A, B, C, D, E, Fq, t, x3, y3, z3;
  O::mul(A, p.x, p.x);
  O::mul(B, p.y, p.y);
  O::mul(C, B, B);
  O::add(D, p.x, B);
  O::mul(D, D, D);
  O::sub(D, D, A);
  O::sub(D, D, C);
  O::add(D, D, D);
  O::add(E, A, A);
  O::add(E, E, A);
  O::mul(Fq, E, E);
  O::sub(x3, Fq, D);
  O::sub(x3, x3, D);
  F C8;
  O::add(C8, C, C);
  O::add(C8, C8, C8);
  O::add(C8, C8, C8);
  O::sub(t, D, x3);
  O::mul(y3, E, t);
  O::sub(y3, y3, C8);
  O::mul(z3, p.y, p.z);
  O::add(z3, z3, z3);
  o.x = x3;
  o.y = y3;
  o.z = z3;
}

template <typename F>
static void pt_add(Pt<F> &o, const Pt<F> &p1, const Pt<F> &p2) {
  typedef Ops<F> O;
  if (pt_is_identity(p1)) {
    o = p2;
    return;
  }
  if (pt_is_identity(p2)) {
    o = p1;
    return;
  }
  F z1z1, z2z2, u1, u2, s1, s2, t;
  O::mul(z1z1, p1.z, p1.z);
  O::mul(z2z2, p2.z, p2.z);
  O::mul(u1, p1.x, z2z2);
  O::mul(u2, p2.x, z1z1);
  O::mul(t, p1.y, p2.z);
  O::mul(s1, t, z2z2);
  O::mul(t, p2.y, p1.z);
  O::mul(s2, t, z1z1);
  if (O::eq(u1, u2)) {
    if (O::eq(s1, s2)) {
      pt_double(o, p1);
      return;
    }
    pt_identity(o);
    return;
  }
  F h, i, j, r, v, x3, y3, z3;
  O::sub(h, u2, u1);
  O::add(i, h, h);
  O::mul(i, i, i);
  O::mul(j, h, i);
  O::sub(r, s2, s1);
  O::add(r, r, r);
  O::mul(v, u1, i);
  O::mul(x3, r, r);
  O::sub(x3, x3, j);
  O::sub(x3, x3, v);
  O::sub(x3, x3, v);
  O::sub(t, v, x3);
  O::mul(y3, r, t);
  O::mul(t, s1, j);
  O::add(t, t, t);
  O::sub(y3, y3, t);
  O::add(z3, p1.z, p2.z);
  O::mul(z3, z3, z3);
  O::sub(z3, z3, z1z1);
  O::sub(z3, z3, z2z2);
  O::mul(z3, z3, h);
  o.x = x3;
  o.y = y3;
  o.z = z3;
}

// ---- affine tier: batch-normalized tables + mixed adds --------------------
//
// A jacobian+affine add (madd-2007-bl) costs ~11 field muls vs ~16 for the
// full jacobian add.  Tables (MSM input points, the fixed-base comb) are
// normalized ONCE with Montgomery's batch-inversion trick (one Fermat
// inversion total), and every accumulate thereafter is mixed.

template <typename F>
struct APt {
  F x, y;  // affine, never the identity (callers track identity flags)
};

template <typename F>
static void batch_inverse(F *xs, size_t n) {
  typedef Ops<F> O;
  std::vector<F> prefix(n);
  F run = O::one();
  for (size_t i = 0; i < n; i++) {
    prefix[i] = run;
    F t;
    O::mul(t, run, xs[i]);
    run = t;
  }
  F inv;
  O::inv(inv, run);
  for (size_t i = n; i-- > 0;) {
    F orig = xs[i];
    O::mul(xs[i], inv, prefix[i]);
    F t;
    O::mul(t, inv, orig);
    inv = t;
  }
}

/* Normalize jacobian points to affine; identity entries get inf[i]=1 and an
 * arbitrary (unused) affine slot. */
template <typename F>
static void pts_to_affine(const std::vector<Pt<F>> &pts,
                          std::vector<APt<F>> &out, std::vector<char> &inf) {
  typedef Ops<F> O;
  size_t n = pts.size();
  out.resize(n);
  inf.assign(n, 0);
  std::vector<F> zs(n);
  for (size_t i = 0; i < n; i++) {
    if (pt_is_identity(pts[i])) {
      inf[i] = 1;
      zs[i] = O::one();
    } else {
      zs[i] = pts[i].z;
    }
  }
  batch_inverse(zs.data(), n);
  for (size_t i = 0; i < n; i++) {
    F zi2, zi3;
    O::mul(zi2, zs[i], zs[i]);
    O::mul(zi3, zi2, zs[i]);
    O::mul(out[i].x, pts[i].x, zi2);
    O::mul(out[i].y, pts[i].y, zi3);
  }
}

template <typename F>
static void pt_from_affine(Pt<F> &o, const APt<F> &a) {
  o.x = a.x;
  o.y = a.y;
  o.z = Ops<F>::one();
}

template <typename F>
static void pt_add_mixed(Pt<F> &o, const Pt<F> &p1, const APt<F> &p2) {
  typedef Ops<F> O;
  if (pt_is_identity(p1)) {
    pt_from_affine(o, p2);
    return;
  }
  F z1z1, u2, s2, t;
  O::mul(z1z1, p1.z, p1.z);
  O::mul(u2, p2.x, z1z1);
  O::mul(t, p2.y, p1.z);
  O::mul(s2, t, z1z1);
  if (O::eq(p1.x, u2)) {
    if (O::eq(p1.y, s2)) {
      pt_double(o, p1);
      return;
    }
    pt_identity(o);
    return;
  }
  F h, hh, i, j, r, v, x3, y3, z3;
  O::sub(h, u2, p1.x);
  O::mul(hh, h, h);
  O::add(i, hh, hh);
  O::add(i, i, i);  // 4*hh
  O::mul(j, h, i);
  O::sub(r, s2, p1.y);
  O::add(r, r, r);
  O::mul(v, p1.x, i);
  O::mul(x3, r, r);
  O::sub(x3, x3, j);
  O::sub(x3, x3, v);
  O::sub(x3, x3, v);
  O::sub(t, v, x3);
  O::mul(y3, r, t);
  O::mul(t, p1.y, j);
  O::add(t, t, t);
  O::sub(y3, y3, t);
  O::add(z3, p1.z, h);
  O::mul(z3, z3, z3);
  O::sub(z3, z3, z1z1);
  O::sub(z3, z3, hh);
  o.x = x3;
  o.y = y3;
  o.z = z3;
}

static int scalar_bit(const u64 *s, int bit) {
  return (s[bit >> 6] >> (bit & 63)) & 1;
}

template <typename F>
static void pt_scalar_mul(Pt<F> &o, const Pt<F> &p, const u64 *s) {
  Pt<F> acc;
  pt_identity(acc);
  for (int bit = 255; bit >= 0; bit--) {
    Pt<F> tmp;
    pt_double(tmp, acc);
    acc = tmp;
    if (scalar_bit(s, bit)) {
      pt_add(tmp, acc, p);
      acc = tmp;
    }
  }
  o = acc;
}

template <typename F>
static void load_pt(Pt<F> &o, const u64 *src) {
  F tmp;
  memcpy(&tmp, src, sizeof(F));
  Ops<F>::to_mont(o.x, tmp);
  memcpy(&tmp, src + Ops<F>::words, sizeof(F));
  Ops<F>::to_mont(o.y, tmp);
  memcpy(&tmp, src + 2 * Ops<F>::words, sizeof(F));
  Ops<F>::to_mont(o.z, tmp);
}

template <typename F>
static void store_pt(u64 *dst, const Pt<F> &p) {
  F tmp;
  Ops<F>::from_mont(tmp, p.x);
  memcpy(dst, &tmp, sizeof(F));
  Ops<F>::from_mont(tmp, p.y);
  memcpy(dst + Ops<F>::words, &tmp, sizeof(F));
  Ops<F>::from_mont(tmp, p.z);
  memcpy(dst + 2 * Ops<F>::words, &tmp, sizeof(F));
}

template <typename F>
static void msm(const u64 *points, const u64 *scalars, u64 n, u64 *out) {
  // Capped at 11/12: larger windows push the per-thread bucket array out
  // of L2 and the accumulate phase goes memory-bound (measured on the Ed
  // path: w=11 1.6x faster than w=16 at n=2^18; same structure here).
  int w = 4;
  if (n >= 32) w = 8;
  if (n >= 4096) w = 11;
  if (n >= 1048576) w = 12;
  int nwin = (256 + w - 1) / w;
  size_t nbuckets = ((size_t)1 << w) - 1;

  std::vector<Pt<F>> pts(n);
#pragma omp parallel for schedule(static)
  for (long long i = 0; i < (long long)n; i++)
    load_pt(pts[i], points + i * 3 * Ops<F>::words);

  // normalize the inputs once (one batch inversion); every bucket
  // accumulate is then a mixed jacobian+affine add (~11 muls vs ~16)
  std::vector<APt<F>> apts;
  std::vector<char> inf;
  pts_to_affine(pts, apts, inf);

  // windows are independent: bucket-accumulate them in parallel
  std::vector<Pt<F>> window_sums(nwin);
#pragma omp parallel for schedule(dynamic, 1)
  for (int win = 0; win < nwin; win++) {
    std::vector<Pt<F>> buckets(nbuckets);
    std::vector<char> used(nbuckets, 0);
    int base = win * w;
    for (u64 i = 0; i < n; i++) {
      if (inf[i]) continue;
      u64 digit = 0;
      for (int k = w - 1; k >= 0; k--) {
        int bit = base + k;
        digit = (digit << 1) | (bit < 256 ? scalar_bit(scalars + i * 4, bit) : 0);
      }
      if (!digit) continue;
      size_t b = digit - 1;
      if (!used[b]) {
        pt_from_affine(buckets[b], apts[i]);
        used[b] = 1;
      } else {
        Pt<F> tmp;
        pt_add_mixed(tmp, buckets[b], apts[i]);
        buckets[b] = tmp;
      }
    }
    Pt<F> running, windowsum;
    pt_identity(running);
    pt_identity(windowsum);
    for (size_t b = nbuckets; b-- > 0;) {
      if (used[b]) {
        Pt<F> tmp;
        pt_add(tmp, running, buckets[b]);
        running = tmp;
      }
      Pt<F> tmp;
      pt_add(tmp, windowsum, running);
      windowsum = tmp;
    }
    window_sums[win] = windowsum;
  }

  // Horner combine across windows (sequential, nwin*w doublings)
  Pt<F> result;
  pt_identity(result);
  for (int win = nwin - 1; win >= 0; win--) {
    for (int k = 0; k < w; k++) {
      Pt<F> tmp;
      pt_double(tmp, result);
      result = tmp;
    }
    Pt<F> tmp;
    pt_add(tmp, result, window_sums[win]);
    result = tmp;
  }
  store_pt(out, result);
}

// 16-bit fixed-base comb for G1 with a per-base table cache.  The Pinocchio
// keygen issues EIGHT ~131k-exponent batches on the SAME generator
// (qap_fast.generate_keys_fast); a cached 16-window x 65535-entry affine
// table (67 MB) halves the per-exponent adds to <= 16 and amortizes its
// one-time build (1M adds, window-parallel) across every call on that base.
struct Comb16 {
  std::vector<APt<Fp>> table;  // [16][65535] affine multiples
};

static Comb16 *comb16_for(const Pt<Fp> &b) {
  static std::mutex mu;
  static std::map<std::array<u64, 12>, Comb16 *> cache;
  std::array<u64, 12> key;
  store_pt(key.data(), b);
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  Comb16 *c = new Comb16();
  // window start points 2^(16*win) * b by repeated doubling
  std::vector<Pt<Fp>> starts(16);
  starts[0] = b;
  for (int w = 1; w < 16; w++) {
    Pt<Fp> cur = starts[w - 1];
    for (int k = 0; k < 16; k++) {
      Pt<Fp> t;
      pt_double(t, cur);
      cur = t;
    }
    starts[w] = cur;
  }
  std::vector<Pt<Fp>> table(16ull * 65535);
#pragma omp parallel for schedule(dynamic, 1)
  for (int w = 0; w < 16; w++) {
    Pt<Fp> *t = &table[(u64)w * 65535];
    t[0] = starts[w];
    for (u64 v = 2; v <= 65535; v++) pt_add(t[v - 1], t[v - 2], starts[w]);
  }
  std::vector<char> inf;
  pts_to_affine(table, c->table, inf);
  cache[key] = c;
  return c;
}

static void batch_exp16_fp(const Pt<Fp> &b, const u64 *exps, u64 n,
                           u64 *out) {
  Comb16 *c = comb16_for(b);
  const APt<Fp> *table = c->table.data();
#pragma omp parallel for schedule(static)
  for (long long i = 0; i < (long long)n; i++) {
    Pt<Fp> acc;
    pt_identity(acc);
    const u64 *e = exps + i * 4;
    for (int win = 0; win < 16; win++) {
      unsigned d = (unsigned)((e[win / 4] >> (16 * (win % 4))) & 0xFFFF);
      if (d) {
        Pt<Fp> tmp;
        pt_add_mixed(tmp, acc, table[(u64)win * 65535 + d - 1]);
        acc = tmp;
      }
    }
    store_pt(out + i * 12, acc);
  }
}

template <typename F>
static void batch_exp(const u64 *base, const u64 *exps, u64 n, u64 *out) {
  Pt<F> b;
  load_pt(b, base);
  if (pt_is_identity(b)) {  // identity^e = identity for every e
    Pt<F> id;
    pt_identity(id);
    for (u64 i = 0; i < n; i++) store_pt(out + i * 3 * Ops<F>::words, id);
    return;
  }
  if constexpr (std::is_same_v<F, Fp>) {
    if (n >= 16384) {  // table build amortizes; small batches keep 8-bit
      batch_exp16_fp(b, exps, n, out);
      return;
    }
  }
  // 8-bit fixed-base comb: table[win][v-1] = v * 2^(8 win) * base.
  // 32*255 precomputed adds amortize over the batch; each exponentiation
  // is then <= 32 additions (one per nonzero byte) instead of ~128
  // (one per set bit).  The comb is batch-normalized to affine (one
  // inversion), so each of those additions is a mixed add.
  std::vector<Pt<F>> table(32 * 255);
  Pt<F> cur = b;
  for (int win = 0; win < 32; win++) {
    Pt<F> *t = &table[win * 255];
    t[0] = cur;
    for (int v = 2; v <= 255; v++) pt_add(t[v - 1], t[v - 2], cur);
    if (win < 31) {
      Pt<F> nxt;
      pt_add(nxt, t[254], cur);  // 256*cur = 255*cur + cur
      cur = nxt;
    }
  }
  std::vector<APt<F>> atable;
  std::vector<char> inf;  // all zero: prime-order base, multiples < order
  pts_to_affine(table, atable, inf);
#pragma omp parallel for schedule(static)
  for (long long i = 0; i < (long long)n; i++) {
    Pt<F> acc;
    pt_identity(acc);
    const u64 *e = exps + i * 4;
    for (int win = 0; win < 32; win++) {
      unsigned byte = (unsigned)((e[win / 8] >> (8 * (win % 8))) & 0xFF);
      if (byte) {
        Pt<F> tmp;
        pt_add_mixed(tmp, acc, atable[win * 255 + byte - 1]);
        acc = tmp;
      }
    }
    store_pt(out + i * 3 * Ops<F>::words, acc);
  }
}

// Fixed-base comb table, most significant window first: entry w*9 + m
// holds m * 16^(nw-1-w) * base (m = 0..8, entry m = 0 the identity), as
// affine rows (z = 1; the identity all zero).  4 (nw - 1) doublings, 7 nw
// adds and one batch inversion.
template <typename F>
static void comb_table(const u64 *base, int nw, u64 *out) {
  const int words = 3 * Ops<F>::words;
  std::vector<Pt<F>> pts((size_t)nw * 9);
  Pt<F> cur;
  load_pt(cur, base);
  for (int k = 0; k < nw; k++) {  // cur = 16^k base: window nw-1-k
    pts[(size_t)(nw - 1 - k) * 9 + 1] = cur;
    for (int d = 0; d < 4 && k + 1 < nw; d++) {
      Pt<F> t;
      pt_double(t, cur);
      cur = t;
    }
  }
#pragma omp parallel for schedule(static)
  for (int w = 0; w < nw; w++) {
    Pt<F> *row = &pts[(size_t)w * 9];
    pt_identity(row[0]);
    for (int j = 2; j <= 8; j++) pt_add(row[j], row[j - 1], row[1]);
  }
  std::vector<APt<F>> aff;
  std::vector<char> inf;
  pts_to_affine(pts, aff, inf);
  for (size_t i = 0; i < pts.size(); i++) {
    Pt<F> p;
    if (inf[i])
      pt_identity(p);
    else
      pt_from_affine(p, aff[i]);
    store_pt(out + i * words, p);
  }
}

}  // namespace bn

extern "C" {

// G1: points n*12 u64 (jacobian x,y,z plain domain), scalars n*4, out 12
void vmpc_bn_msm(const u64 *points, const u64 *scalars, u64 n, u64 *out) {
  bn::msm<bn::Fp>(points, scalars, n, out);
}

void vmpc_bn_batch_exp(const u64 *base, const u64 *exps, u64 n, u64 *out) {
  bn::batch_exp<bn::Fp>(base, exps, n, out);
}

void vmpc_bn_scalar_mul(const u64 *point, const u64 *s, u64 *out) {
  bn::Pt<bn::Fp> p, o;
  bn::load_pt(p, point);
  bn::pt_scalar_mul(o, p, s);
  bn::store_pt(out, o);
}

// twist: points n*24 u64 (x,y,z each as c0[4],c1[4]), scalars n*4, out 24
void vmpc_bn2_msm(const u64 *points, const u64 *scalars, u64 n, u64 *out) {
  bn::msm<bn::Fp2>(points, scalars, n, out);
}

void vmpc_bn2_batch_exp(const u64 *base, const u64 *exps, u64 n, u64 *out) {
  bn::batch_exp<bn::Fp2>(base, exps, n, out);
}

// comb tables: base 12 (G1) or 24 (twist) u64, out nw*9 affine rows of as
// many (the input rows of K8 and K11)
void vmpc_bn_comb_table(const u64 *base, int nw, u64 *out) {
  bn::comb_table<bn::Fp>(base, nw, out);
}

void vmpc_bn2_comb_table(const u64 *base, int nw, u64 *out) {
  bn::comb_table<bn::Fp2>(base, nw, out);
}

}  // extern "C"
