// fe32.cuh: a prime field in N words of 32 bits, held in registers, for the
// Hopper kernels that run on it (padd_chain, segscan; point32.cuh).
//
// Written by hand, portable C++17: every function is __host__ __device__
// and force-inlined, on uint32_t words with uint64_t products, which nvcc
// turns into IMAD.WIDE.U32 and carry chains and g++ builds for the CPU
// tests (tests/test_torch_fe32.py). No inline PTX.
//
// The field is a traits class C, emitted per curve into the generated
// header (ops/kfe.py `fe32_header`): the word count C::N, p, F = 2^(32N)
// mod p in C::FW words, the domain (C::MONT) and its constants, and the
// 13-bit limb plan of the rows the kernels read and write (C::NL limbs of
// C::LB bits). The code is generic in N; the builds are N = 8.
//
// Two reductions, one per domain of the 13-bit plan, so values keep their
// domain across the kernel boundary:
//   - solinas (C::MONT false: secp256k1, values not in Montgomery form):
//     2^(32N) = F mod p, so a product's high half folds in by F (secp256k1:
//     F = 2^32 + 977, two words);
//   - Montgomery (C::MONT true: P-256): CIOS with R32 = 2^(32N) and
//     C::N0 = -p^-1 mod 2^32 (1 for P-256). The 13-bit plan's R13 (2^273
//     for P-256) is mapped at the boundary: a row loads as mont(v, R32^2
//     R13^-1) = v R13^-1 R32 and stores as mont(x, R13) = x R32^-1 R13.
//
// Carry analysis (the emitter asserts each inequality for the curve it
// emits; requires 2^(32N-1) < p < 2^(32N), so 2^(32N) < 2p):
//   - every element is canonical, in [0, p), between operations;
//   - add: a + b < 2p, one conditional subtraction. sub: a - b, p added
//     back on a borrow. neg(a) = 0 - a, so neg(0) = 0;
//   - reduce_top(t, h): t + h 2^(32N) with h <= hmax. One fold by F leaves
//     a top word <= 1 if hmax F < 2^(32N); if it is 1, the low part is below
//     hmax F, so a second fold leaves the value below 2^(32N) if
//     (hmax + 1) F <= 2^(32N); then one conditional subtraction. It serves
//     mul_small (hmax = k - 1) and the load of a row (hmax = the 13-bit
//     rows' top word, below 2^(NL LB - 32N));
//   - solinas mul: T = a b < p^2. u = T_lo + T_hi F < 2^(32N) (1 + F) fits
//     N + FW words; v = u_lo + u_hi F < 2^(32N) + F^2 leaves a top word
//     <= 1 if F^2 < 2^(32N), and its fold leaves v below 2^(32N) if
//     F (F + 1) <= 2^(32N); one conditional subtraction;
//   - Montgomery mul: CIOS keeps t < 2p after every outer step for a, b <
//     p (t[N + 1] <= 1); one conditional subtraction at the end.
#pragma once
#include <stdint.h>

#ifndef __CUDACC__
#ifndef __host__
#define __host__
#endif
#ifndef __device__
#define __device__
#endif
#ifndef __forceinline__
#define __forceinline__ inline __attribute__((always_inline))
#endif
#endif

#define FE32_FN __host__ __device__ __forceinline__
#ifdef __CUDACC__
#define FE32_UNROLL _Pragma("unroll")
#else
#define FE32_UNROLL
#endif

namespace fe32 {

template <int N>
struct Fe {
  uint32_t w[N];
};

// a + b + c; c (any word) becomes the carry out (0, 1 or 2)
FE32_FN uint32_t addc(uint32_t a, uint32_t b, uint32_t& c) {
  const uint64_t t = (uint64_t)a + b + c;
  c = (uint32_t)(t >> 32);
  return (uint32_t)t;
}

// a - b - br; br (0 or 1) becomes the borrow out
FE32_FN uint32_t subb(uint32_t a, uint32_t b, uint32_t& br) {
  const uint64_t t = (uint64_t)a - b - br;
  br = (uint32_t)(t >> 63);
  return (uint32_t)t;
}

// a * b + r + c < 2^64; c (any word) becomes the high word
FE32_FN uint32_t mac(uint32_t a, uint32_t b, uint32_t r, uint32_t& c) {
  const uint64_t t = (uint64_t)a * b + r + c;
  c = (uint32_t)(t >> 32);
  return (uint32_t)t;
}

template <class C>
using E = Fe<C::N>;

template <class C>
FE32_FN E<C> zero() {
  E<C> r;
  FE32_UNROLL for (int i = 0; i < C::N; ++i) r.w[i] = 0u;
  return r;
}

// the constants of C (each a word function of the traits) as elements
template <class C>
FE32_FN E<C> one() {
  E<C> r;
  FE32_UNROLL for (int i = 0; i < C::N; ++i) r.w[i] = C::one(i);
  return r;
}

template <class C>
FE32_FN E<C> bmul_const() {
  E<C> r;
  FE32_UNROLL for (int i = 0; i < C::N; ++i) r.w[i] = C::bmul(i);
  return r;
}

// t + hi 2^(32N) below 2p (hi 0 or 1) -> canonical
template <class C>
FE32_FN E<C> reduce_once(const E<C>& t, uint32_t hi) {
  E<C> s, r;
  uint32_t br = 0;
  FE32_UNROLL for (int i = 0; i < C::N; ++i) s.w[i] = subb(t.w[i], C::p(i), br);
  const bool below = (hi == 0u) & (br != 0u);  // t + hi 2^(32N) < p
  FE32_UNROLL for (int i = 0; i < C::N; ++i) r.w[i] = below ? t.w[i] : s.w[i];
  return r;
}

template <class C>
FE32_FN E<C> add(const E<C>& a, const E<C>& b) {
  E<C> s;
  uint32_t c = 0;
  FE32_UNROLL for (int i = 0; i < C::N; ++i) s.w[i] = addc(a.w[i], b.w[i], c);
  return reduce_once<C>(s, c);
}

template <class C>
FE32_FN E<C> sub(const E<C>& a, const E<C>& b) {
  E<C> d, r;
  uint32_t br = 0, c = 0;
  FE32_UNROLL for (int i = 0; i < C::N; ++i) d.w[i] = subb(a.w[i], b.w[i], br);
  const uint32_t m = 0u - br;  // p added back where a < b
  FE32_UNROLL for (int i = 0; i < C::N; ++i) r.w[i] = addc(d.w[i], C::p(i) & m, c);
  return r;
}

template <class C>
FE32_FN E<C> neg(const E<C>& a) {
  return sub<C>(zero<C>(), a);
}

// t + h 2^(32N) = t + h F (mod p): the low N words; h becomes the new top word
template <class C>
FE32_FN E<C> fold(const E<C>& t, uint32_t& h) {
  E<C> r;
  uint32_t c = 0;
  FE32_UNROLL for (int i = 0; i < C::FW; ++i) r.w[i] = mac(h, C::f(i), t.w[i], c);
  FE32_UNROLL for (int i = C::FW; i < C::N; ++i) r.w[i] = addc(t.w[i], 0u, c);
  h = c;
  return r;
}

// t + h 2^(32N), h <= hmax (see the carry analysis) -> canonical
template <class C>
FE32_FN E<C> reduce_top(const E<C>& t, uint32_t h) {
  E<C> r = fold<C>(t, h);  // top word now 0 or 1
  r = fold<C>(r, h);       // now 0
  return reduce_once<C>(r, 0u);
}

// a k for a small constant k (k F <= 2^(32N))
template <class C>
FE32_FN E<C> mul_small(const E<C>& a, uint32_t k) {
  E<C> t;
  uint32_t c = 0;
  FE32_UNROLL for (int i = 0; i < C::N; ++i) t.w[i] = mac(a.w[i], k, 0u, c);
  return reduce_top<C>(t, c);
}

// the 2N-word product, operand scanning: one mac per word pair
template <int N>
FE32_FN void mul_wide(const Fe<N>& a, const Fe<N>& b, uint32_t (&t)[2 * N]) {
  FE32_UNROLL for (int i = 0; i < N; ++i) t[i] = 0u;
  FE32_UNROLL for (int i = 0; i < N; ++i) {
    uint32_t c = 0;
    FE32_UNROLL for (int j = 0; j < N; ++j) t[i + j] = mac(a.w[j], b.w[i], t[i + j], c);
    t[i + N] = c;
  }
}

template <class C>
FE32_FN E<C> reduce_solinas(const uint32_t (&t)[2 * C::N]) {
  constexpr int N = C::N, FW = C::FW;
  // u = T_lo + T_hi F in N + FW words
  uint32_t u[N + FW];
  FE32_UNROLL for (int i = 0; i < N; ++i) u[i] = t[i];
  FE32_UNROLL for (int i = 0; i < FW; ++i) u[N + i] = 0u;
  FE32_UNROLL for (int j = 0; j < FW; ++j) {
    uint32_t c = 0;
    FE32_UNROLL for (int i = 0; i < N; ++i) u[i + j] = mac(t[N + i], C::f(j), u[i + j], c);
    FE32_UNROLL for (int k = N + j; k < N + FW; ++k) u[k] = addc(u[k], 0u, c);
  }
  // v = u_lo + u_hi F: N words and a top word h <= 1
  E<C> v;
  FE32_UNROLL for (int i = 0; i < N; ++i) v.w[i] = u[i];
  uint32_t h = 0;
  FE32_UNROLL for (int j = 0; j < FW; ++j) {
    uint32_t c = 0;
    FE32_UNROLL for (int i = 0; i < FW; ++i) v.w[i + j] = mac(u[N + i], C::f(j), v.w[i + j], c);
    FE32_UNROLL for (int k = FW + j; k < N; ++k) v.w[k] = addc(v.w[k], 0u, c);
    h += c;
  }
  v = fold<C>(v, h);  // below 2^(32N): h is now 0
  return reduce_once<C>(v, 0u);
}

// CIOS Montgomery product a b R32^-1, a, b < p -> canonical
template <class C>
FE32_FN E<C> mul_mont(const E<C>& a, const E<C>& b) {
  constexpr int N = C::N;
  uint32_t t[N + 2];
  FE32_UNROLL for (int i = 0; i < N + 2; ++i) t[i] = 0u;
  FE32_UNROLL for (int i = 0; i < N; ++i) {
    uint32_t c = 0;
    FE32_UNROLL for (int j = 0; j < N; ++j) t[j] = mac(a.w[j], b.w[i], t[j], c);
    t[N] = addc(t[N], 0u, c);
    t[N + 1] = c;
    const uint32_t m = t[0] * C::N0;
    c = 0;
    (void)mac(m, C::p(0), t[0], c);  // the low word is 0 by the choice of m
    FE32_UNROLL for (int j = 1; j < N; ++j) t[j - 1] = mac(m, C::p(j), t[j], c);
    t[N - 1] = addc(t[N], 0u, c);
    t[N] = t[N + 1] + c;
  }
  E<C> r;
  FE32_UNROLL for (int i = 0; i < N; ++i) r.w[i] = t[i];
  return reduce_once<C>(r, t[N]);
}

template <class C>
FE32_FN E<C> mul(const E<C>& a, const E<C>& b) {
  if constexpr (C::MONT) {
    return mul_mont<C>(a, b);
  } else {
    uint32_t t[2 * C::N];
    mul_wide<C::N>(a, b, t);
    return reduce_solinas<C>(t);
  }
}

template <class C>
FE32_FN E<C> sqr(const E<C>& a) {
  return mul<C>(a, a);
}

// ---------------------------------------------------------------------------
// the boundary: rows of C::NL steady limbs of C::LB bits, limb k of one
// element at src[k * stride] (32-bit offsets: the wrappers keep every array
// below 2^32 words)
// ---------------------------------------------------------------------------

// a steady 13-bit element -> canonical, in this layer's domain
template <class C>
FE32_FN E<C> from_limbs(const uint32_t* __restrict__ src, uint32_t stride) {
  uint32_t w[C::N + 1];
  FE32_UNROLL for (int i = 0; i <= C::N; ++i) w[i] = 0u;
  FE32_UNROLL for (int i = 0; i < C::NL; ++i) {
    const uint32_t l = src[i * stride];
    const int bit = i * C::LB, k = bit / 32, off = bit % 32;
    w[k] |= l << off;
    if (off + C::LB > 32) w[k + 1] |= l >> (32 - off);
  }
  E<C> lo;
  FE32_UNROLL for (int i = 0; i < C::N; ++i) lo.w[i] = w[i];
  E<C> v = reduce_top<C>(lo, w[C::N]);
  if constexpr (C::MONT) {
    E<C> k;
    FE32_UNROLL for (int i = 0; i < C::N; ++i) k.w[i] = C::to32(i);
    v = mul_mont<C>(v, k);
  }
  return v;
}

// canonical, in this layer's domain -> canonical 13-bit limbs (a steady
// value of the 13-bit plan) at dst[k * stride]
template <class C>
FE32_FN void to_limbs(const E<C>& x, uint32_t* __restrict__ dst, uint32_t stride) {
  E<C> v = x;
  if constexpr (C::MONT) {
    E<C> k;
    FE32_UNROLL for (int i = 0; i < C::N; ++i) k.w[i] = C::to13(i);
    v = mul_mont<C>(x, k);
  }
  constexpr uint32_t mask = (1u << C::LB) - 1u;
  FE32_UNROLL for (int i = 0; i < C::NL; ++i) {
    const int bit = i * C::LB, k = bit / 32, off = bit % 32;
    uint32_t l = k < C::N ? v.w[k] >> off : 0u;
    if (off + C::LB > 32 && k + 1 < C::N) l |= v.w[k + 1] << (32 - off);
    dst[i * stride] = l & mask;
  }
}

}  // namespace fe32
