// fe32.cuh: a prime field in N words of 32 bits, held in registers, for the
// Hopper kernels that run on it (point32.cuh and the kernels built on it).
//
// Written by hand, portable C++17: every function is __host__ __device__
// and force-inlined, on uint32_t words with uint64_t products, which nvcc
// turns into IMAD.WIDE.U32 and carry chains and g++ builds for the CPU
// tests (tests/test_torch_fe32.py, tests/test_torch_fe32_wide.py). No
// inline PTX.
//
// The field is a traits class C, emitted per curve into the generated
// header (ops/kfe.py `fe32_header`): the word count C::N, p, F = 2^(32N)
// mod p in C::FW words, the domain (C::MONT) and its constants, the fold
// bit C::KB and the load form C::MLOAD, and the 13-bit limb plan of the
// rows the kernels read and write (C::NL limbs of C::LB bits). The code is
// generic in N, and N is the curve's own: ceil(bits(p) / 32) (6 for P-192,
// 7 for P-224, 8 for the 256-bit curves, 12 for P-384 and the 384-bit
// Brainpool curves, 17 for P-521; a curve's two fields have the same N).
//
// Two reductions, one per domain of the 13-bit plan, so values keep their
// domain across the kernel boundary:
//   - solinas (C::MONT false: secp256k1, bign256, P-192, P-521; values not
//     in Montgomery form): 2^(32N) = F mod p, so a product's high half
//     folds in by F (secp256k1: F = 2^32 + 977, two words). Where p lies
//     below 2^(32N-1) (P-521: p = 2^521 - 1 in 17 words), F is small
//     (2^23) but 2^(32N) is no longer below 2p, so the field also folds at
//     p's top bit C::KB: p = 2^KB - 1, so v = (v mod 2^KB) + (v >> KB)
//     mod p. Its multiply reduces the 2N-word product by that fold alone;
//   - Montgomery (C::MONT true: P-224, P-256, P-384, SM2, the Brainpool
//     curves, every scalar field): CIOS with R32 = 2^(32N) and C::N0 =
//     -p^-1 mod 2^32. The 13-bit plan's R13 (2^273 for P-256) is mapped at
//     the boundary: a row loads as mont(v, R32^2 R13^-1) = v R13^-1 R32 and
//     stores as mont(x, R13) = x R32^-1 R13.
//
// Carry analysis (the emitter, kfe.fe32_fits and kfe.fe32_field_constants,
// asserts each inequality for the field it emits; every field has p odd
// and 2^(32(N-1)) < p < 2^(32N)):
//   - every element is canonical, in [0, p), between operations;
//   - add: a + b < 2p < 2^(32N + 1), one conditional subtraction. sub:
//     a - b, p added back on a borrow. neg(a) = 0 - a, so neg(0) = 0;
//   - reduce_below(v), v < 2^(32N): where 2^(32N) < 2p (C::KB = 0), one
//     conditional subtraction; with C::KB, first the top fold: v mod 2^KB +
//     (v >> KB) < 2^KB + 2^(32N - KB) <= 2p if 2^(32N - KB) <= 2^KB - 2;
//   - reduce_top(t, h): t + h 2^(32N) with h <= hmax. One fold by F leaves
//     a top word <= 1 if hmax F < 2^(32N); if it is 1, the low part is below
//     hmax F, so a second fold leaves the value below 2^(32N) if
//     (hmax + 1) F <= 2^(32N); then reduce_below. It serves mul_small
//     (hmax = k - 1) and the load of a row (hmax = the 13-bit rows' top
//     word, below 2^(NL LB - 32N)) where C::MLOAD is false;
//   - solinas mul (C::KB = 0): T = a b < p^2. u = T_lo + T_hi F < 2^(32N)
//     (1 + F) fits N + FW words; v = u_lo + u_hi F < 2^(32N) + F^2 leaves a
//     top word <= 1 if F^2 < 2^(32N), and its fold leaves v below 2^(32N)
//     if F (F + 1) <= 2^(32N); one conditional subtraction;
//   - solinas mul with C::KB (p = 2^KB - 1): T < 2^(2 KB); T mod 2^KB +
//     (T >> KB) < 2^(KB + 1) <= 2^(32N), then reduce_below;
//   - Montgomery mul: CIOS gives (a b + M p) / R32 with M < R32, below
//     a b / R32 + p: for a < R32 and b < p, below 2p (t[N] <= 1), and every
//     partial sum fits N + 1 words and a carry. So any odd p < R32 works,
//     and one operand may be any N words; one conditional subtraction at
//     the end;
//   - the Montgomery load with C::MLOAD (where reduce_top cannot take the
//     row: the Brainpool fields, whose F is nearly p, so (h + 1) F >
//     2^(32N) for the rows' top word h of up to 17 or 19 bits; P-521's
//     scalar field, whose p is below 2^(32N-1)): the row is v = lo + h
//     2^(32N), lo < 2^(32N), h one word (NL LB <= 32 (N + 1)); it loads as
//     mont(lo, to32) + mont(to32h, h), to32h = F to32 mod p, each product
//     below 2p by the bound above (the second, one word by N, is CIOS's
//     first product row and its N reduction rows), then one add.
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

// v mod 2^KB + (v >> KB) for p = 2^KB - 1 (C::KB != 0; the same value mod p)
template <class C>
FE32_FN E<C> fold_top(const E<C>& v) {
  constexpr int KW = C::KB / 32, KS = C::KB % 32;
  static_assert(KS != 0, "the top fold needs a bit offset inside a word");
  E<C> lo, hi;
  FE32_UNROLL for (int i = 0; i < C::N; ++i) {
    lo.w[i] = i < KW ? v.w[i] : i == KW ? v.w[i] & ((1u << KS) - 1u) : 0u;
    const uint32_t h0 = KW + i < C::N ? v.w[KW + i] >> KS : 0u;
    const uint32_t h1 = KW + i + 1 < C::N ? v.w[KW + i + 1] << (32 - KS) : 0u;
    hi.w[i] = h0 | h1;
  }
  uint32_t c = 0;
  FE32_UNROLL for (int i = 0; i < C::N; ++i) lo.w[i] = addc(lo.w[i], hi.w[i], c);
  return lo;
}

// v < 2^(32N) -> canonical (see the carry analysis)
template <class C>
FE32_FN E<C> reduce_below(const E<C>& v) {
  if constexpr (C::KB != 0) {
    return reduce_once<C>(fold_top<C>(v), 0u);
  } else {
    return reduce_once<C>(v, 0u);
  }
}

// t + h 2^(32N), h <= hmax (see the carry analysis) -> canonical
template <class C>
FE32_FN E<C> reduce_top(const E<C>& t, uint32_t h) {
  E<C> r = fold<C>(t, h);  // top word now 0 or 1
  r = fold<C>(r, h);       // now 0
  return reduce_below<C>(r);
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

// the 2N-word product T < 2^(2 KB) mod p = 2^KB - 1 (C::KB != 0): T mod
// 2^KB + (T >> KB), then reduce_below
template <class C>
FE32_FN E<C> reduce_mersenne(const uint32_t (&t)[2 * C::N]) {
  constexpr int N = C::N, KW = C::KB / 32, KS = C::KB % 32;
  E<C> r;
  uint32_t c = 0;
  FE32_UNROLL for (int i = 0; i < N; ++i) {
    const uint32_t lo = i < KW ? t[i] : i == KW ? t[i] & ((1u << KS) - 1u) : 0u;
    const uint32_t h0 = t[KW + i] >> KS;
    const uint32_t h1 = KW + i + 1 < 2 * N ? t[KW + i + 1] << (32 - KS) : 0u;
    r.w[i] = addc(lo, h0 | h1, c);
  }
  return reduce_below<C>(r);
}

// CIOS Montgomery product a b R32^-1 (a < R32, b < p; see the carry
// analysis) -> canonical
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

// a h R32^-1 for a < p and one word h: CIOS's first product row, then its
// N reduction rows -> canonical
template <class C>
FE32_FN E<C> mont_word(const E<C>& a, uint32_t h) {
  constexpr int N = C::N;
  uint32_t t[N + 1];
  uint32_t c = 0;
  FE32_UNROLL for (int j = 0; j < N; ++j) t[j] = mac(a.w[j], h, 0u, c);
  t[N] = c;
  FE32_UNROLL for (int i = 0; i < N; ++i) {
    const uint32_t m = t[0] * C::N0;
    c = 0;
    (void)mac(m, C::p(0), t[0], c);  // the low word is 0 by the choice of m
    FE32_UNROLL for (int j = 1; j < N; ++j) t[j - 1] = mac(m, C::p(j), t[j], c);
    t[N - 1] = addc(t[N], 0u, c);
    t[N] = c;
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
    if constexpr (C::KB != 0) {
      return reduce_mersenne<C>(t);
    } else {
      return reduce_solinas<C>(t);
    }
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
  static_assert(C::MONT || !C::MLOAD, "the Montgomery load needs a Montgomery field");
  uint32_t w[C::N + 1];
  FE32_UNROLL for (int i = 0; i <= C::N; ++i) w[i] = 0u;
  FE32_UNROLL for (int i = 0; i < C::NL; ++i) {
    const uint32_t l = src[i * stride];
    const int bit = i * C::LB, k = bit / 32, off = bit % 32;
    w[k] |= l << off;
    if (off + C::LB > 32) w[k + 1] |= l >> (32 - off);
  }
  E<C> lo, k;
  FE32_UNROLL for (int i = 0; i < C::N; ++i) {
    lo.w[i] = w[i];
    k.w[i] = C::to32(i);
  }
  if constexpr (C::MLOAD) {  // mont(lo, to32) + mont(to32h, h): no fold through F
    E<C> v = mul_mont<C>(lo, k);
    if constexpr (C::NL * C::LB > 32 * C::N) {
      E<C> kh;
      FE32_UNROLL for (int i = 0; i < C::N; ++i) kh.w[i] = C::to32h(i);
      v = add<C>(v, mont_word<C>(kh, w[C::N]));
    }
    return v;
  } else {
    E<C> v = reduce_top<C>(lo, w[C::N]);
    if constexpr (C::MONT) v = mul_mont<C>(v, k);
    return v;
  }
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
