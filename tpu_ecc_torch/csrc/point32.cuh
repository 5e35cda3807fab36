// point32.cuh: projective points on the 32-bit field layer (fe32.cuh), the
// complete RCB 2015 formulas, and the per-lane bodies of the kernels that run
// on it (pdouble.cu, padd_chain.cu (also padd's), segscan.cu, ladder.cu,
// genmul.cu, bucket_reduce.cu, horner.cu, pow.cu, fixup.cu and
// ladder_probe.cu keep only the launch; pow's body is a field chain, on
// either of a curve's two fields).
//
// The formulas are RCB Algorithms 7, 8, 9 (a = 0, C::A0: the add, the mixed
// add, the doubling), 1, 2, 3 (generic a, C::AGEN: the Brainpool r1 curves,
// whose a is a full-width constant) and 4, 5, 6 (a = -3, the rest), chosen
// at compile time, each in the statement order of the Pallas bodies
// (tpu_ecc/ops/pallas_kernels.py: 56-311) and of ops/points.py's plain
// formulas. Every field operation is exact mod p, so each projective
// coordinate equals, mod p, the 13-bit kernels' and tpu_ecc's; the limbs
// differ, because every value here is canonical (fe32.cuh) and the rows are
// stored canonical.
//
// Everything is force-inlined: a point is 3N words (24 registers at N = 8,
// 51 at P-521's N = 17, where the kernels spill),
// and each formula with its temporaries lives in registers, with no call
// and no stack between the field operations.
#pragma once
#include "fe32.cuh"

namespace fe32 {

template <class C>
struct Pt {
  E<C> x, y, z;
};

template <class C>
FE32_FN Pt<C> identity() {  // (0 : 1 : 0)
  return Pt<C>{zero<C>(), one<C>(), zero<C>()};
}

// t * b3 (a = 0, generic a) or t * b (a = -3): a small multiply where the
// constant is small, else a full multiply by the constant in this layer's
// domain
template <class C>
FE32_FN E<C> mul_b(const E<C>& t) {
  if constexpr (C::BSMALL != 0u) {
    return mul_small<C>(t, C::BSMALL);
  } else {
    return mul<C>(bmul_const<C>(), t);
  }
}

// t * a (generic a): a full multiply by a in this layer's domain (C::amul;
// the Brainpool r1 curves' a is as wide as p)
template <class C>
FE32_FN E<C> mul_a(const E<C>& t) {
  E<C> a;
  FE32_UNROLL for (int i = 0; i < C::N; ++i) a.w[i] = C::amul(i);
  return mul<C>(a, t);
}

// RCB 2015 Algorithm 7 (a = 0)
template <class C>
FE32_FN Pt<C> padd_a0(const Pt<C>& p, const Pt<C>& q) {
  E<C> t0 = mul<C>(p.x, q.x);
  E<C> t1 = mul<C>(p.y, q.y);
  E<C> t2 = mul<C>(p.z, q.z);
  E<C> t3 = mul<C>(add<C>(p.x, p.y), add<C>(q.x, q.y));
  t3 = sub<C>(t3, add<C>(t0, t1));
  E<C> t4 = mul<C>(add<C>(p.y, p.z), add<C>(q.y, q.z));
  t4 = sub<C>(t4, add<C>(t1, t2));
  E<C> X3 = mul<C>(add<C>(p.x, p.z), add<C>(q.x, q.z));
  E<C> Y3 = sub<C>(X3, add<C>(t0, t2));
  t0 = add<C>(add<C>(t0, t0), t0);
  t2 = mul_b<C>(t2);
  E<C> Z3 = add<C>(t1, t2);
  t1 = sub<C>(t1, t2);
  Y3 = mul_b<C>(Y3);
  X3 = mul<C>(t4, Y3);
  t2 = mul<C>(t3, t1);
  X3 = sub<C>(t2, X3);
  Y3 = mul<C>(Y3, t0);
  t1 = mul<C>(t1, Z3);
  Y3 = add<C>(t1, Y3);
  t0 = mul<C>(t0, t3);
  Z3 = mul<C>(Z3, t4);
  Z3 = add<C>(Z3, t0);
  return Pt<C>{X3, Y3, Z3};
}

// RCB 2015 Algorithm 4 (a = -3)
template <class C>
FE32_FN Pt<C> padd_am3(const Pt<C>& p, const Pt<C>& q) {
  E<C> t0 = mul<C>(p.x, q.x);
  E<C> t1 = mul<C>(p.y, q.y);
  E<C> t2 = mul<C>(p.z, q.z);
  E<C> t3 = mul<C>(add<C>(p.x, p.y), add<C>(q.x, q.y));
  t3 = sub<C>(t3, add<C>(t0, t1));
  E<C> t4 = mul<C>(add<C>(p.y, p.z), add<C>(q.y, q.z));
  t4 = sub<C>(t4, add<C>(t1, t2));
  E<C> X3 = mul<C>(add<C>(p.x, p.z), add<C>(q.x, q.z));
  E<C> Y3 = sub<C>(X3, add<C>(t0, t2));
  E<C> Z3 = mul_b<C>(t2);
  X3 = sub<C>(Y3, Z3);
  Z3 = add<C>(X3, X3);
  X3 = add<C>(X3, Z3);
  Z3 = sub<C>(t1, X3);
  X3 = add<C>(t1, X3);
  Y3 = mul_b<C>(Y3);
  t1 = add<C>(add<C>(t2, t2), t2);
  Y3 = sub<C>(sub<C>(Y3, t1), t0);
  Y3 = add<C>(add<C>(Y3, Y3), Y3);
  t0 = add<C>(add<C>(t0, t0), t0);
  t0 = sub<C>(t0, t1);
  t1 = mul<C>(t4, Y3);
  t2 = mul<C>(t0, Y3);
  Y3 = add<C>(mul<C>(X3, Z3), t2);
  X3 = sub<C>(mul<C>(t3, X3), t1);
  Z3 = add<C>(mul<C>(t4, Z3), mul<C>(t3, t0));
  return Pt<C>{X3, Y3, Z3};
}

// RCB 2015 Algorithm 1 (generic a)
template <class C>
FE32_FN Pt<C> padd_gen(const Pt<C>& p, const Pt<C>& q) {
  E<C> t0 = mul<C>(p.x, q.x);
  E<C> t1 = mul<C>(p.y, q.y);
  E<C> t2 = mul<C>(p.z, q.z);
  E<C> t3 = mul<C>(add<C>(p.x, p.y), add<C>(q.x, q.y));
  t3 = sub<C>(t3, add<C>(t0, t1));
  E<C> t4 = mul<C>(add<C>(p.x, p.z), add<C>(q.x, q.z));
  t4 = sub<C>(t4, add<C>(t0, t2));
  E<C> t5 = mul<C>(add<C>(p.y, p.z), add<C>(q.y, q.z));
  t5 = sub<C>(t5, add<C>(t1, t2));
  E<C> Z3 = mul_a<C>(t4);
  E<C> X3 = mul_b<C>(t2);
  Z3 = add<C>(X3, Z3);
  X3 = sub<C>(t1, Z3);
  Z3 = add<C>(t1, Z3);
  E<C> Y3 = mul<C>(X3, Z3);
  t1 = add<C>(add<C>(t0, t0), t0);
  t2 = mul_a<C>(t2);
  t4 = mul_b<C>(t4);
  t1 = add<C>(t1, t2);
  t2 = mul_a<C>(sub<C>(t0, t2));
  t4 = add<C>(t4, t2);
  Y3 = add<C>(Y3, mul<C>(t1, t4));
  X3 = sub<C>(mul<C>(t3, X3), mul<C>(t5, t4));
  Z3 = add<C>(mul<C>(t5, Z3), mul<C>(t3, t1));
  return Pt<C>{X3, Y3, Z3};
}

template <class C>
FE32_FN Pt<C> padd(const Pt<C>& p, const Pt<C>& q) {
  if constexpr (C::A0) {
    return padd_a0<C>(p, q);
  } else if constexpr (C::AGEN) {
    return padd_gen<C>(p, q);
  } else {
    return padd_am3<C>(p, q);
  }
}

// RCB 2015 Algorithm 8 (a = 0): p + (x2 : y2 : 1); q must not be O
template <class C>
FE32_FN Pt<C> padd_mixed_a0(const Pt<C>& p, const E<C>& x2, const E<C>& y2) {
  E<C> t0 = mul<C>(p.x, x2);
  E<C> t1 = mul<C>(p.y, y2);
  E<C> t3 = mul<C>(add<C>(x2, y2), add<C>(p.x, p.y));
  t3 = sub<C>(t3, add<C>(t0, t1));
  E<C> t4 = add<C>(mul<C>(y2, p.z), p.y);
  E<C> Y3 = add<C>(mul<C>(x2, p.z), p.x);
  t0 = add<C>(add<C>(t0, t0), t0);
  E<C> t2 = mul_b<C>(p.z);
  E<C> Z3 = add<C>(t1, t2);
  t1 = sub<C>(t1, t2);
  Y3 = mul_b<C>(Y3);
  E<C> X3 = mul<C>(t4, Y3);
  t2 = mul<C>(t3, t1);
  X3 = sub<C>(t2, X3);
  Y3 = mul<C>(Y3, t0);
  t1 = mul<C>(t1, Z3);
  Y3 = add<C>(t1, Y3);
  t0 = mul<C>(t0, t3);
  Z3 = mul<C>(Z3, t4);
  Z3 = add<C>(Z3, t0);
  return Pt<C>{X3, Y3, Z3};
}

// RCB 2015 Algorithm 5 (a = -3): p + (x2 : y2 : 1); q must not be O
template <class C>
FE32_FN Pt<C> padd_mixed_am3(const Pt<C>& p, const E<C>& x2, const E<C>& y2) {
  E<C> t0 = mul<C>(p.x, x2);
  E<C> t1 = mul<C>(p.y, y2);
  E<C> t3 = mul<C>(add<C>(x2, y2), add<C>(p.x, p.y));
  t3 = sub<C>(t3, add<C>(t0, t1));
  E<C> t4 = add<C>(mul<C>(y2, p.z), p.y);
  E<C> Y3 = add<C>(mul<C>(x2, p.z), p.x);
  E<C> Z3 = mul_b<C>(p.z);
  E<C> X3 = sub<C>(Y3, Z3);
  Z3 = add<C>(X3, X3);
  X3 = add<C>(X3, Z3);
  Z3 = sub<C>(t1, X3);
  X3 = add<C>(t1, X3);
  Y3 = mul_b<C>(Y3);
  t1 = add<C>(add<C>(p.z, p.z), p.z);
  Y3 = sub<C>(sub<C>(Y3, t1), t0);
  Y3 = add<C>(add<C>(Y3, Y3), Y3);
  t0 = add<C>(add<C>(t0, t0), t0);
  t0 = sub<C>(t0, t1);
  t1 = mul<C>(t4, Y3);
  E<C> t2 = mul<C>(t0, Y3);
  Y3 = add<C>(mul<C>(X3, Z3), t2);
  X3 = sub<C>(mul<C>(t3, X3), t1);
  Z3 = add<C>(mul<C>(t4, Z3), mul<C>(t3, t0));
  return Pt<C>{X3, Y3, Z3};
}

// RCB 2015 Algorithm 2 (generic a): p + (x2 : y2 : 1); q must not be O
template <class C>
FE32_FN Pt<C> padd_mixed_gen(const Pt<C>& p, const E<C>& x2, const E<C>& y2) {
  E<C> t0 = mul<C>(p.x, x2);
  E<C> t1 = mul<C>(p.y, y2);
  E<C> t3 = mul<C>(add<C>(x2, y2), add<C>(p.x, p.y));
  t3 = sub<C>(t3, add<C>(t0, t1));
  E<C> t4 = add<C>(mul<C>(x2, p.z), p.x);
  E<C> t5 = add<C>(mul<C>(y2, p.z), p.y);
  E<C> Z3 = mul_a<C>(t4);
  E<C> X3 = mul_b<C>(p.z);
  Z3 = add<C>(X3, Z3);
  X3 = sub<C>(t1, Z3);
  Z3 = add<C>(t1, Z3);
  E<C> Y3 = mul<C>(X3, Z3);
  t1 = add<C>(add<C>(t0, t0), t0);
  E<C> t2 = mul_a<C>(p.z);
  t4 = mul_b<C>(t4);
  t1 = add<C>(t1, t2);
  t2 = mul_a<C>(sub<C>(t0, t2));
  t4 = add<C>(t4, t2);
  Y3 = add<C>(Y3, mul<C>(t1, t4));
  X3 = sub<C>(mul<C>(t3, X3), mul<C>(t5, t4));
  Z3 = add<C>(mul<C>(t5, Z3), mul<C>(t3, t1));
  return Pt<C>{X3, Y3, Z3};
}

template <class C>
FE32_FN Pt<C> padd_mixed(const Pt<C>& p, const E<C>& x2, const E<C>& y2) {
  if constexpr (C::A0) {
    return padd_mixed_a0<C>(p, x2, y2);
  } else if constexpr (C::AGEN) {
    return padd_mixed_gen<C>(p, x2, y2);
  } else {
    return padd_mixed_am3<C>(p, x2, y2);
  }
}

// RCB 2015 Algorithm 9 (a = 0)
template <class C>
FE32_FN Pt<C> pdouble_a0(const Pt<C>& p) {
  E<C> t0 = mul<C>(p.y, p.y);
  E<C> Z3 = add<C>(t0, t0);
  Z3 = add<C>(Z3, Z3);
  Z3 = add<C>(Z3, Z3);
  E<C> t1 = mul<C>(p.y, p.z);
  E<C> t2 = mul<C>(p.z, p.z);
  t2 = mul_b<C>(t2);
  E<C> X3 = mul<C>(t2, Z3);
  E<C> Y3 = add<C>(t0, t2);
  Z3 = mul<C>(t1, Z3);
  t1 = add<C>(t2, t2);
  t2 = add<C>(t1, t2);
  t0 = sub<C>(t0, t2);
  Y3 = mul<C>(t0, Y3);
  Y3 = add<C>(X3, Y3);
  t1 = mul<C>(p.x, p.y);
  X3 = mul<C>(t0, t1);
  X3 = add<C>(X3, X3);
  return Pt<C>{X3, Y3, Z3};
}

// RCB 2015 Algorithm 6 (a = -3)
template <class C>
FE32_FN Pt<C> pdouble_am3(const Pt<C>& p) {
  E<C> t0 = mul<C>(p.x, p.x);
  E<C> t1 = mul<C>(p.y, p.y);
  E<C> t2 = mul<C>(p.z, p.z);
  E<C> t3 = mul<C>(p.x, p.y);
  t3 = add<C>(t3, t3);
  E<C> Z3 = mul<C>(p.x, p.z);
  Z3 = add<C>(Z3, Z3);
  E<C> Y3 = mul_b<C>(t2);
  Y3 = sub<C>(Y3, Z3);
  E<C> X3 = add<C>(Y3, Y3);
  Y3 = add<C>(X3, Y3);
  X3 = sub<C>(t1, Y3);
  Y3 = add<C>(t1, Y3);
  Y3 = mul<C>(X3, Y3);
  X3 = mul<C>(X3, t3);
  t2 = add<C>(add<C>(t2, t2), t2);
  Z3 = mul_b<C>(Z3);
  Z3 = sub<C>(sub<C>(Z3, t2), t0);
  Z3 = add<C>(add<C>(Z3, Z3), Z3);
  t0 = add<C>(add<C>(t0, t0), t0);
  t0 = sub<C>(t0, t2);
  t0 = mul<C>(t0, Z3);
  Y3 = add<C>(Y3, t0);
  t0 = mul<C>(p.y, p.z);
  t0 = add<C>(t0, t0);
  Z3 = mul<C>(t0, Z3);
  X3 = sub<C>(X3, Z3);
  Z3 = mul<C>(t0, t1);
  Z3 = add<C>(Z3, Z3);
  Z3 = add<C>(Z3, Z3);
  return Pt<C>{X3, Y3, Z3};
}

// RCB 2015 Algorithm 3 (generic a)
template <class C>
FE32_FN Pt<C> pdouble_gen(const Pt<C>& p) {
  E<C> t0 = mul<C>(p.x, p.x);
  E<C> t1 = mul<C>(p.y, p.y);
  E<C> t2 = mul<C>(p.z, p.z);
  E<C> t3 = mul<C>(p.x, p.y);
  t3 = add<C>(t3, t3);
  E<C> Z3 = mul<C>(p.x, p.z);
  Z3 = add<C>(Z3, Z3);
  E<C> X3 = mul_a<C>(Z3);
  E<C> Y3 = mul_b<C>(t2);
  Y3 = add<C>(X3, Y3);
  X3 = sub<C>(t1, Y3);
  Y3 = add<C>(t1, Y3);
  Y3 = mul<C>(X3, Y3);
  X3 = mul<C>(t3, X3);
  Z3 = mul_b<C>(Z3);
  t2 = mul_a<C>(t2);
  t3 = mul_a<C>(sub<C>(t0, t2));
  t3 = add<C>(t3, Z3);
  t0 = add<C>(add<C>(add<C>(t0, t0), t0), t2);
  t0 = mul<C>(t0, t3);
  Y3 = add<C>(Y3, t0);
  t2 = mul<C>(p.y, p.z);
  t2 = add<C>(t2, t2);
  X3 = sub<C>(X3, mul<C>(t2, t3));
  Z3 = mul<C>(t2, t1);
  Z3 = add<C>(Z3, Z3);
  Z3 = add<C>(Z3, Z3);
  return Pt<C>{X3, Y3, Z3};
}

template <class C>
FE32_FN Pt<C> pdouble(const Pt<C>& p) {
  if constexpr (C::A0) {
    return pdouble_a0<C>(p);
  } else if constexpr (C::AGEN) {
    return pdouble_gen<C>(p);
  } else {
    return pdouble_am3<C>(p);
  }
}

// beta x, the x of the endomorphism psi(x, y) = (beta x, y) (C::HAS_BETA)
template <class C>
FE32_FN E<C> mul_beta(const E<C>& x) {
  E<C> b;
  FE32_UNROLL for (int i = 0; i < C::N; ++i) b.w[i] = C::beta(i);
  return mul<C>(b, x);
}

// y, or p - y where ng: a select, never a branch on ng
template <class C>
FE32_FN E<C> cneg(const E<C>& y, bool ng) {
  const E<C> yn = neg<C>(y);
  E<C> r;
  FE32_UNROLL for (int i = 0; i < C::N; ++i) r.w[i] = ng ? yn.w[i] : y.w[i];
  return r;
}

// one point of a limb-major row: coordinate c, limb k at src[(c NL + k) stride]
template <class C>
FE32_FN Pt<C> load_point(const uint32_t* __restrict__ src, uint32_t stride) {
  const uint32_t s = C::NL * stride;
  return Pt<C>{from_limbs<C>(src, stride), from_limbs<C>(src + s, stride),
               from_limbs<C>(src + 2 * s, stride)};
}

template <class C>
FE32_FN void store_point(const Pt<C>& p, uint32_t* __restrict__ dst, uint32_t stride) {
  const uint32_t s = C::NL * stride;
  to_limbs<C>(p.x, dst, stride);
  to_limbs<C>(p.y, dst + s, stride);
  to_limbs<C>(p.z, dst + 2 * s, stride);
}

// c ? a : b, word by word: a select, never a branch on c
template <class C>
FE32_FN Pt<C> pselect(bool c, const Pt<C>& a, const Pt<C>& b) {
  Pt<C> r;
  FE32_UNROLL for (int i = 0; i < C::N; ++i) {
    r.x.w[i] = c ? a.x.w[i] : b.x.w[i];
    r.y.w[i] = c ? a.y.w[i] : b.y.w[i];
    r.z.w[i] = c ? a.z.w[i] : b.z.w[i];
  }
  return r;
}

// ---------------------------------------------------------------------------
// the signed-digit tables: TBL = 9 entries [O, Q, .., 8Q] (the ladder's
// points) or 9 affine points d 16^j G (genmul's comb row j), in canonical
// words
// ---------------------------------------------------------------------------

constexpr int TBL = 9;

// word i of an element at dst[i * stride]
template <class C>
FE32_FN void put_elem(const E<C>& x, uint32_t* __restrict__ dst, uint32_t stride) {
  FE32_UNROLL for (int i = 0; i < C::N; ++i) dst[i * stride] = x.w[i];
}

// the element whose word i is at src[i * stride] (put_elem's layout)
template <class C>
FE32_FN E<C> get_elem(const uint32_t* __restrict__ src, uint32_t stride) {
  E<C> x;
  FE32_UNROLL for (int i = 0; i < C::N; ++i) x.w[i] = src[i * stride];
  return x;
}

// word j of a point (x, y, z: j = c N + i) at dst[j * stride]
template <class C>
FE32_FN void put_point(const Pt<C>& p, uint32_t* __restrict__ dst, uint32_t stride) {
  put_elem<C>(p.x, dst, stride);
  put_elem<C>(p.y, dst + C::N * stride, stride);
  put_elem<C>(p.z, dst + 2 * C::N * stride, stride);
}

// the point whose word j is at src[j * stride] (put_point's layout)
template <class C>
FE32_FN Pt<C> get_point(const uint32_t* __restrict__ src, uint32_t stride) {
  return Pt<C>{get_elem<C>(src, stride), get_elem<C>(src + C::N * stride, stride),
               get_elem<C>(src + 2 * C::N * stride, stride)};
}

// entry m in [0, 8] of the 9 points at tbl[(k 3N + j) * stride], as a
// masked select over every entry: which words load does not depend on m,
// so a secret digit shows in no address, branch or bank conflict
template <class C>
FE32_FN Pt<C> select_point(const uint32_t* __restrict__ tbl, uint32_t stride, uint32_t m) {
  constexpr int PN = 3 * C::N;
  uint32_t r[PN];
  FE32_UNROLL for (int j = 0; j < PN; ++j) r[j] = tbl[j * stride];
  FE32_UNROLL for (int k = 1; k < TBL; ++k) {
    const bool hit = m == (uint32_t)k;
    FE32_UNROLL for (int j = 0; j < PN; ++j) {
      const uint32_t v = tbl[(k * PN + j) * stride];
      r[j] = hit ? v : r[j];
    }
  }
  Pt<C> p;
  FE32_UNROLL for (int i = 0; i < C::N; ++i) {
    p.x.w[i] = r[i];
    p.y.w[i] = r[C::N + i];
    p.z.w[i] = r[2 * C::N + i];
  }
  return p;
}

// entry m in [0, 8] of the 9 affine points at row[k 2N + (0 | N) + i], a
// masked select over every entry as select_point
template <class C>
FE32_FN void select_affine(const uint32_t* __restrict__ row, uint32_t m, E<C>& x, E<C>& y) {
  FE32_UNROLL for (int i = 0; i < C::N; ++i) {
    x.w[i] = row[i];
    y.w[i] = row[C::N + i];
  }
  FE32_UNROLL for (int k = 1; k < TBL; ++k) {
    const bool hit = m == (uint32_t)k;
    FE32_UNROLL for (int i = 0; i < C::N; ++i) {
      const uint32_t vx = row[2 * k * C::N + i], vy = row[(2 * k + 1) * C::N + i];
      x.w[i] = hit ? vx : x.w[i];
      y.w[i] = hit ? vy : y.w[i];
    }
  }
}

// ---------------------------------------------------------------------------
// the kernels' per-lane bodies
// ---------------------------------------------------------------------------

// padd_chain: out = a + repeat * b for lane `lane` of [3, NL, B] rows
template <class C>
FE32_FN void padd_chain_lane(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                             uint32_t* __restrict__ out, int B, int lane, int repeat) {
  Pt<C> acc = load_point<C>(a + lane, (uint32_t)B);
  const Pt<C> q = load_point<C>(b + lane, (uint32_t)B);
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int r = 0; r < repeat; ++r) acc = padd<C>(acc, q);
  store_point<C>(acc, out + lane, (uint32_t)B);
}

// segscan: the segmented scan of lane `lane` over C_rows sorted rows. key2
// [C_rows, L]; val2 [C_rows, 3, NL, L]; neg2 [C_rows, L] or null (unsigned
// digits). Writes scanned[r] only where row r ends a run (key2[r + 1] !=
// key2[r], or the last row), lead at each run end whose key is the lane's
// first key, and tail and last_key after the last row; all canonical.
// Offsets are 32-bit: every array is below 2^32 words (the wrapper checks).
template <class C>
FE32_FN void segscan_lane(const uint32_t* __restrict__ key2, const uint32_t* __restrict__ val2,
                          const uint32_t* __restrict__ neg2, uint32_t* __restrict__ scanned,
                          uint32_t* __restrict__ last_key, uint32_t* __restrict__ tail,
                          uint32_t* __restrict__ lead, int C_rows, int L, uint32_t nbuck,
                          int lane) {
  constexpr uint32_t PN = 3 * C::NL;
  const uint32_t Lw = (uint32_t)L;
  Pt<C> acc = identity<C>();
  const uint32_t fk = key2[lane];
  uint32_t pk = nbuck;  // the sentinel: a zero digit's first row adds to O
  uint32_t k = fk;
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int r = 0; r < C_rows; ++r) {
    const bool last = r + 1 == C_rows;
    const uint32_t row = (uint32_t)r * Lw + lane;   // [r, lane] of a [C, L] array
    const uint32_t kn = last ? k : key2[row + Lw];
    Pt<C> v = load_point<C>(val2 + (row - lane) * PN + lane, Lw);
    if (neg2 != nullptr) v.y = cneg<C>(v.y, neg2[row] != 0u);  // a negative digit's point
    // keys are public: the add is skipped where the key changed
    if (k == pk) {
      acc = padd<C>(acc, v);
    } else {
      acc = v;
    }
    if (last || kn != k) {
      store_point<C>(acc, scanned + (row - lane) * PN + lane, Lw);
      if (k == fk) store_point<C>(acc, lead + lane, Lw);
    }
    pk = k;
    k = kn;
  }
  last_key[lane] = pk;
  store_point<C>(acc, tail + lane, Lw);
}

// ladder: sum_h d_h P_h for lane `lane` (the verify lincomb u1 G + u2 Q,
// scalar_mul, the Straus MSM). bases [T, 3, NL, B] 13-bit rows; mag, neg
// [nw, H, B], MSB window first; out [3, NL, B], canonical. H = T, or H = 2T
// with glv: term 2t takes base t, term 2t + 1 psi(base t) = (beta x, y),
// applied after the select (C::HAS_BETA; the launch refuses glv without
// it). With H == 1 the first window seeds the accumulator from its
// selected entry. tbl: this lane's T tables of 9 points, word j of entry k
// of base t at tbl[((t TBL + k) 3N + j) * stride] (the kernel's shared
// memory, the lane innermost).
template <class C>
FE32_FN void ladder_lane(const uint32_t* __restrict__ bases, const uint32_t* __restrict__ mag,
                         const uint32_t* __restrict__ neg, uint32_t* __restrict__ out,
                         uint32_t* __restrict__ tbl, uint32_t stride, int T, int H, int nw,
                         bool glv, int B, int lane) {
  constexpr uint32_t PN = 3 * C::N;
  const uint32_t Bw = (uint32_t)B, ts = TBL * PN * stride;   // one base's table
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int t = 0; t < T; ++t) {   // [O, Q, .., 8Q] with 7 adds
    uint32_t* tb = tbl + t * ts;
    const Pt<C> q = load_point<C>(bases + t * 3 * C::NL * Bw + lane, Bw);
    put_point<C>(identity<C>(), tb, stride);
    put_point<C>(q, tb + PN * stride, stride);
    Pt<C> cur = q;
#ifdef __CUDACC__
#pragma unroll 1
#endif
    for (int k = 2; k < TBL; ++k) {
      cur = padd<C>(cur, q);
      put_point<C>(cur, tb + k * PN * stride, stride);
    }
  }
  Pt<C> acc = identity<C>();
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int w = 0; w < nw; ++w) {
#ifdef __CUDACC__
#pragma unroll 1
#endif
    for (int d = 0; d < 4; ++d) acc = pdouble<C>(acc);
#ifdef __CUDACC__
#pragma unroll 1
#endif
    for (int h = 0; h < H; ++h) {
      const uint32_t t = glv ? h >> 1 : h;
      const uint32_t dg = ((uint32_t)w * H + h) * Bw + lane;
      Pt<C> s = select_point<C>(tbl + t * ts, stride, mag[dg]);
      if constexpr (C::HAS_BETA) {
        if (glv && (h & 1)) s.x = mul_beta<C>(s.x);
      }
      s.y = cneg<C>(s.y, neg[dg] != 0u);
      if (H == 1 && w == 0) {
        acc = s;
      } else {
        acc = padd<C>(acc, s);
      }
    }
  }
  store_point<C>(acc, out + lane, Bw);
}

// v, which the compiler may not take for the same value on two calls: a
// table read at an offset made from it stays inside its loop. Without it
// nvcc hoists the probe's table reads, whose address does not change
// between windows, out of the window loop, and the 216 words of select's
// 9 entries live in registers and spill (340-352 B).
FE32_FN uint32_t opaque(uint32_t v) {
#ifdef __CUDA_ARCH__
  asm volatile("" : "+r"(v));
#endif
  return v;
}

// ladder_probe's variants: the ladder body with its parts switched on one at
// a time (tools/profile_ladder.py)
enum ProbeVariant { PROBE_BARE, PROBE_UNROLL, PROBE_BUILD, PROBE_SELECT, PROBE_NEGATE,
                    PROBE_VARIANTS };

// ladder_probe: ladder_lane's body for one base (bases [3, NL, B] 13-bit rows;
// mag, neg [nw, 2, B]; out [3, NL, B], canonical), variant V. The lane puts
// O and Q into its table (word j of entry k at tbl[(k 3N + j) * stride], the
// kernel's shared memory), from PROBE_BUILD on also 2Q .. 8Q (7 adds); from
// O, per window 4 doublings (unrolled in PROBE_UNROLL), then for h = 0, 1 an
// add of entry 1 read from the table (PROBE_BARE .. PROBE_BUILD), of the
// masked select by mag[w, h] (PROBE_SELECT), with y negated where neg[w, h]
// (PROBE_NEGATE); the table is read on each term, as the ladder's.
template <class C, int V>
FE32_FN void ladder_probe_lane(const uint32_t* __restrict__ bases,
                               const uint32_t* __restrict__ mag,
                               const uint32_t* __restrict__ neg, uint32_t* __restrict__ out,
                               uint32_t* __restrict__ tbl, uint32_t stride, int nw, int B,
                               int lane) {
  constexpr uint32_t PN = 3 * C::N;
  const uint32_t Bw = (uint32_t)B;
  const Pt<C> q = load_point<C>(bases + lane, Bw);
  put_point<C>(identity<C>(), tbl, stride);
  put_point<C>(q, tbl + PN * stride, stride);
  if constexpr (V >= PROBE_BUILD) {
    Pt<C> cur = q;
#ifdef __CUDACC__
#pragma unroll 1
#endif
    for (int k = 2; k < TBL; ++k) {
      cur = padd<C>(cur, q);
      put_point<C>(cur, tbl + k * PN * stride, stride);
    }
  }
  Pt<C> acc = identity<C>();
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int w = 0; w < nw; ++w) {
    if constexpr (V == PROBE_UNROLL) {
      FE32_UNROLL for (int d = 0; d < 4; ++d) acc = pdouble<C>(acc);
    } else {
#ifdef __CUDACC__
#pragma unroll 1
#endif
      for (int d = 0; d < 4; ++d) acc = pdouble<C>(acc);
    }
#ifdef __CUDACC__
#pragma unroll 1
#endif
    for (int h = 0; h < 2; ++h) {
      const uint32_t dg = ((uint32_t)w * 2 + h) * Bw + lane;
      const uint32_t* tb = tbl + opaque(0u);   // the table, read on each term
      Pt<C> s;
      if constexpr (V >= PROBE_SELECT) {
        s = select_point<C>(tb, stride, mag[dg]);
      } else {
        s = get_point<C>(tb + PN * stride, stride);
      }
      if constexpr (V == PROBE_NEGATE) s.y = cneg<C>(s.y, neg[dg] != 0u);
      acc = padd<C>(acc, s);
    }
  }
  store_point<C>(acc, out + lane, Bw);
}

// genmul's prologue: the comb's `coords` 13-bit coordinates (rows [nw, 9,
// 2, NL], limbs contiguous) to canonical words in the layer's domain at
// ctab[i N + j], coordinates tid, tid + nthreads, .. by this thread
template <class C>
FE32_FN void genmul_table(const uint32_t* __restrict__ tbl, uint32_t* __restrict__ ctab,
                          int coords, int tid, int nthreads) {
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int i = tid; i < coords; i += nthreads) {
    const E<C> v = from_limbs<C>(tbl + (uint32_t)i * C::NL, 1u);
    FE32_UNROLL for (int j = 0; j < C::N; ++j) ctab[(uint32_t)i * C::N + j] = v.w[j];
  }
}

// genmul: the fixed-base comb sum_j d_j 16^j G for lane `lane`. ctab: the
// comb in words, [nw, 9, 2, N] (genmul_table; the same for every lane);
// mag, neg [nw, B], LSB window first; out [3, NL, B], canonical. Per
// window: a masked select of the affine entry, y or p - y by the sign, one
// mixed add, and the sum kept where the digit is 0 (entry 0 is a dummy).
template <class C>
FE32_FN void genmul_lane(const uint32_t* __restrict__ ctab, const uint32_t* __restrict__ mag,
                         const uint32_t* __restrict__ neg, uint32_t* __restrict__ out, int nw,
                         int B, int lane) {
  const uint32_t Bw = (uint32_t)B;
  Pt<C> acc = identity<C>();
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int w = 0; w < nw; ++w) {
    const uint32_t dg = (uint32_t)w * Bw + lane;
    const uint32_t m = mag[dg];
    E<C> x, y;
    select_affine<C>(ctab + (uint32_t)w * TBL * 2 * C::N, m, x, y);
    y = cneg<C>(y, neg[dg] != 0u);
    acc = pselect<C>(m == 0u, acc, padd_mixed<C>(acc, x, y));
  }
  store_point<C>(acc, out + lane, Bw);
}

// the scan steps of bucket_reduce and fixup read and write their points as
// words [3N, len] (put_point's layout, the bucket or lane innermost) between
// launches; the first step reads the 13-bit rows [3, NL, len] (ROWS), the
// last writes them.
template <class C, bool ROWS>
FE32_FN Pt<C> scan_point(const uint32_t* __restrict__ src, uint32_t len) {
  if constexpr (ROWS) {
    return load_point<C>(src, len);
  } else {
    return get_point<C>(src, len);
  }
}

// bucket_reduce's suffix step at shift s for bucket b of `total` (windows of
// nbuck buckets side by side, nbuck a power of two): dst[b] = src[b] +
// src[b + s] where b + s lies in b's window, else dst[b] = src[b]; src the
// 13-bit rows (ROWS: the first step) or the words of the step before, dst
// words. Bucket indices are public (Pippenger serves public sums): the
// guard is a branch.
template <class C, bool ROWS>
FE32_FN void bucket_suffix_lane(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                                uint32_t s, uint32_t nbuck, uint32_t total, uint32_t b) {
  Pt<C> v = scan_point<C, ROWS>(src + b, total);
  if ((b & (nbuck - 1)) + s < nbuck) v = padd<C>(v, scan_point<C, ROWS>(src + b + s, total));
  put_point<C>(v, dst + b, total);
}

// bucket_reduce's tree step over len = groups * width words' points:
// dst[t] = src[2t] + src[2t + 1]. zero0 (drop0, in the first step, width =
// nbuck): each window's bucket 0 reads as O. dst: words [3N, len / 2], or
// (ROWS: the last step) canonical 13-bit rows [3, NL, len / 2].
template <class C, bool ROWS>
FE32_FN void bucket_pair_lane(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                              uint32_t width, uint32_t len, bool zero0, uint32_t t) {
  const uint32_t l = 2 * t;
  const Pt<C> a = zero0 && (l & (width - 1)) == 0 ? identity<C>() : get_point<C>(src + l, len);
  const Pt<C> r = padd<C>(a, get_point<C>(src + l + 1, len));
  if constexpr (ROWS) {
    store_point<C>(r, dst + t, len / 2);
  } else {
    put_point<C>(r, dst + t, len / 2);
  }
}

// fixup's Hillis-Steele step at shift s for lane l of `lanes` (windows of L
// lanes side by side): dst[l] = src[l] + src[l - s] where l - s lies in l's
// window and last_key[l - s] == last_key[l], else dst[l] = src[l]; src the
// 13-bit rows (ROWS: the first step) or the words of the step before, dst
// words. The keys are public (Pippenger serves public sums): the guard is a
// branch, and a lane that does not add copies its words.
template <class C, bool ROWS>
FE32_FN void fixup_step_lane(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                             const uint32_t* __restrict__ last_key, uint32_t s, uint32_t L,
                             uint32_t lanes, uint32_t l) {
  Pt<C> v = scan_point<C, ROWS>(src + l, lanes);
  if (l % L >= s && last_key[l - s] == last_key[l])
    v = padd<C>(v, scan_point<C, ROWS>(src + l - s, lanes));
  put_point<C>(v, dst + l, lanes);
}

// fixup's last launch for lane l: out[l] = lead[l] + carry, carry = T[l - 1]
// (the words of the last step) where l - 1 lies in l's window and
// first_key[l] == last_key[l - 1], else O; lead and out 13-bit rows [3, NL,
// lanes], out canonical. Every lane adds, as the twin does (lead + O is lead
// projectively scaled, not lead's coordinates). With L = 1 no lane takes a
// carry, and T is never read.
template <class C>
FE32_FN void fixup_final_lane(const uint32_t* __restrict__ T, const uint32_t* __restrict__ last_key,
                              const uint32_t* __restrict__ first_key,
                              const uint32_t* __restrict__ lead, uint32_t* __restrict__ out,
                              uint32_t L, uint32_t lanes, uint32_t l) {
  const Pt<C> carry = l % L >= 1 && first_key[l] == last_key[l - 1]
                          ? get_point<C>(T + l - 1, lanes)
                          : identity<C>();
  store_point<C>(padd<C>(load_point<C>(lead + l, lanes), carry), out + l, lanes);
}

// pow: x^e for lane `lane` of x [NL, B] (13-bit rows of C's field, either
// of a curve's fields) -> out [NL, B], canonical 13-bit limbs. digits
// [ndig]: e's 4-bit windows, MSB first, public and the same for every lane.
// The lane's table x, x^2, .., x^15 (14 multiplies): word i of x^k at
// tbl[((k - 1) N + i) * stride] (the kernel's shared memory, the lane
// innermost). acc starts at one; per digit 4 squarings, then a multiply by
// x^d where d != 0 (a zero digit keeps acc: x^(16a) = (x^a)^16). The
// digit is the same in every thread, so the branch and the table's
// address are too.
template <class C>
FE32_FN void pow_lane(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                      uint32_t* __restrict__ tbl, uint32_t stride,
                      const uint32_t* __restrict__ digits, int ndig, int B, int lane) {
  const uint32_t Bw = (uint32_t)B;
  const E<C> xv = from_limbs<C>(x + lane, Bw);
  put_elem<C>(xv, tbl, stride);
  E<C> cur = xv;
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int k = 1; k < 15; ++k) {
    cur = mul<C>(cur, xv);
    put_elem<C>(cur, tbl + (uint32_t)k * C::N * stride, stride);
  }
  E<C> acc = one<C>();
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int d = 0; d < ndig; ++d) {
#ifdef __CUDACC__
#pragma unroll 1
#endif
    for (int s = 0; s < 4; ++s) acc = sqr<C>(acc);
    const uint32_t dig = digits[d];
    if (dig != 0u) acc = mul<C>(acc, get_elem<C>(tbl + (dig - 1u) * C::N * stride, stride));
  }
  to_limbs<C>(acc, out + lane, Bw);
}

// horner: acc = 2^w acc + S_win over the window sums s_all [nw, 3, NL]
// (13-bit rows, MSB window first) from acc = O, to out [3, NL], canonical.
template <class C>
FE32_FN void horner_lane(const uint32_t* __restrict__ s_all, uint32_t* __restrict__ out, int nw,
                         int w) {
  Pt<C> acc = identity<C>();
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int win = 0; win < nw; ++win) {
#ifdef __CUDACC__
#pragma unroll 1
#endif
    for (int d = 0; d < w; ++d) acc = pdouble<C>(acc);
    acc = padd<C>(acc, load_point<C>(s_all + (uint32_t)win * 3 * C::NL, 1u));
  }
  store_point<C>(acc, out, 1u);
}

}  // namespace fe32
