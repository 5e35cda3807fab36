// point32.cuh: projective points on the 32-bit field layer (fe32.cuh), the
// complete RCB 2015 add, and the per-lane bodies of the kernels that run on
// it (padd_chain.cu, segscan.cu keep only the launch).
//
// The add is RCB Algorithm 7 (a = 0, C::A0) or Algorithm 4 (a = -3), in
// the statement order of ops/kfe.py `_kadd_a0` and `_kadd_am3`, which is the
// Pallas bodies' own (tpu_ecc/ops/pallas_kernels.py:46-225). Every field
// operation is exact mod p, so each projective coordinate equals, mod p,
// the 13-bit kernels' and tpu_ecc's; the limbs differ, because every value
// here is canonical (fe32.cuh) and the rows are stored canonical.
//
// Everything is force-inlined: a point is 3N words (24 registers at N = 8),
// and the add with its temporaries lives in registers, with no call and no
// stack between the field operations.
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

// t * b3 (a = 0) or t * b (a = -3): a small multiply where the constant is
// small, else a full multiply by the constant in this layer's domain
template <class C>
FE32_FN E<C> mul_b(const E<C>& t) {
  if constexpr (C::BSMALL != 0u) {
    return mul_small<C>(t, C::BSMALL);
  } else {
    return mul<C>(bmul_const<C>(), t);
  }
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

template <class C>
FE32_FN Pt<C> padd(const Pt<C>& p, const Pt<C>& q) {
  if constexpr (C::A0) {
    return padd_a0<C>(p, q);
  } else {
    return padd_am3<C>(p, q);
  }
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
    if (neg2 != nullptr) {  // y of a negative digit's point: p - y, a select
      const bool ng = neg2[row] != 0u;
      const E<C> yn = neg<C>(v.y);
      FE32_UNROLL for (int i = 0; i < C::N; ++i) v.y.w[i] = ng ? yn.w[i] : v.y.w[i];
    }
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

}  // namespace fe32
