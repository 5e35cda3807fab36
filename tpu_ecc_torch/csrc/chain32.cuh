// chain32.cuh: the lane bodies of the probes' multiply chains on the 32-bit
// field layer (fmul_chain.cu, mxu_chain.cu), on a bare field C (the traits
// class Field32 of kfe.fe32_field_header). Host-compilable, as fe32.cuh:
// g++ builds it for the CPU tests (tests/test_torch_probes.py).
//
// fmul_chain_lane: a <- a * b, CHAIN times, by the layer's own `mul`.
//
// mxu_chain's step, x y R32^-1 with R32 = 2^(32N), splits the Montgomery
// multiply: T = x y (2N words) on the CUDA cores; then the two products by
// a constant, m = (T mod R32) N' mod R32 (N' = -p^-1 mod R32) and m p, as
// matrix products of byte digits on the tensor cores (mxu_chain.cu). A
// constant c of 4N bytes makes the banded Toeplitz matrix A[k, j] =
// c_(k-j) (0 <= k - j < 4N), rows k the output's byte columns; a lane's
// digits are the 4N bytes of its N words (little-endian). The product
// gives each lane its column sums s_k = sum_j A[k, j] d_j < 4N 255^2 <
// 2^22 (N <= 16). This header holds the step's parts on the CUDA cores:
// the digits' layout in shared memory, and the fold of the column sums
// into words with their carries:
//   - m keeps the low N words of sum_k s_k 2^(8k), k < 4N;
//   - u = T + m p: its low N words are 0 mod R32, so they carry 1 into the
//     high half exactly where T's low half is not 0 (then m p's low half
//     is R32 - T_lo); m p's high half comes from all 8N columns, whose low
//     4N carry into it. The high N words, u / R32 < (p^2 + R32 p) / R32 <
//     2p, take one conditional subtraction.
// A folded word is s_4w + s_(4w+1) 2^8 + s_(4w+2) 2^16 + s_(4w+3) 2^24 +
// carry (+ T's word) < 2^47, so every carry is below 2^15.
#pragma once
#include "fe32.cuh"

namespace fe32 {

constexpr int CHAIN = 16;  // multiplies a lane (kernels.CHAIN)

// a <- a * b, CHAIN times: a, b, out [NL, B] 13-bit rows, lane `lane`
template <class C>
FE32_FN void fmul_chain_lane(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                             uint32_t* __restrict__ out, int B, int lane) {
  const uint32_t Bw = (uint32_t)B;
  const E<C> y = from_limbs<C>(b + lane, Bw);
  E<C> x = from_limbs<C>(a + lane, Bw);
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int r = 0; r < CHAIN; ++r) x = mul<C>(x, y);
  to_limbs<C>(x, out + lane, Bw);
}

// The shapes of mxu_chain's two products at N words (kernels.mxu_shape):
// KB digit bytes a lane (the k axis, padded to the 32-byte k step), M1 and
// M2 rows of the N' and p matrices (4N and 8N, padded to 64-row tiles),
// SS words of column sums a lane in shared memory (at least 8N, 4 mod 16:
// the accumulators' stores and the lanes' 16-byte loads free of bank
// conflicts).
template <int N>
struct MxuShape {
  static constexpr int KB = 32 * ((4 * N + 31) / 32);
  static constexpr int M1 = 64 * ((4 * N + 63) / 64);
  static constexpr int M2 = 64 * ((8 * N + 63) / 64);
  static constexpr int SS = (8 * N + 11) / 16 * 16 + 4;
  static constexpr int CHUNKS = KB / 16;
};

// Byte offset of row r's 16-byte chunk c in a K-major operand of KB bytes
// a row without swizzle: core matrices of 8 rows x 16 bytes (128 B), the
// chunks of K 128 B apart (the descriptor's leading byte offset), each 8
// rows 8 KB bytes apart (its stride byte offset). The constant matrices
// (rows their output columns; kernels.mxu_tiles) and the lanes' digits
// (rows their lanes) both take this layout.
template <int N>
FE32_FN uint32_t mxu_offset(uint32_t r, uint32_t c) {
  return (r / 8u) * (8u * MxuShape<N>::KB) + c * 128u + (r % 8u) * 16u;
}

// the N words w as row l's KB digit bytes (zero above 4N)
template <int N>
FE32_FN void mxu_put(uint8_t* __restrict__ op, uint32_t l, const uint32_t* w) {
  FE32_UNROLL for (int c = 0; c < MxuShape<N>::CHUNKS; ++c) {
    uint32_t v[4];
    FE32_UNROLL for (int i = 0; i < 4; ++i) v[i] = 4 * c + i < N ? w[4 * c + i] : 0u;
    uint8_t* dst = op + mxu_offset<N>(l, (uint32_t)c);
#ifdef __CUDA_ARCH__
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
#else
    FE32_UNROLL for (int i = 0; i < 4; ++i) {
      FE32_UNROLL for (int k = 0; k < 4; ++k) dst[4 * i + k] = (uint8_t)(v[i] >> (8 * k));
    }
#endif
  }
}

// the word of the column sums s[0..3] (each < 2^22) plus carry; the carry
// becomes the bits above it
FE32_FN uint32_t mxu_word(const uint32_t* __restrict__ s, uint64_t& carry) {
#ifdef __CUDA_ARCH__
  const uint4 q = *reinterpret_cast<const uint4*>(s);  // 16-byte aligned: SS = 4 mod 16
  const uint32_t s0 = q.x, s1 = q.y, s2 = q.z, s3 = q.w;
#else
  const uint32_t s0 = s[0], s1 = s[1], s2 = s[2], s3 = s[3];
#endif
  const uint64_t v = (uint64_t)s0 + ((uint64_t)s1 << 8) + ((uint64_t)s2 << 16) +
                     ((uint64_t)s3 << 24) + carry;
  carry = v >> 32;
  return (uint32_t)v;
}

// m = sum_k s_k 2^(8k) mod R32 over the 4N sums of the N' product
template <int N>
FE32_FN void mxu_fold_m(const uint32_t* __restrict__ s, uint32_t (&m)[N]) {
  uint64_t carry = 0;
  FE32_UNROLL for (int w = 0; w < N; ++w) m[w] = mxu_word(s + 4 * w, carry);
}

// (T + m p) / R32, canonical, from the 8N sums of the m p product, T's
// high half th and nz = 1 where T's low half is not 0
template <class C>
FE32_FN E<C> mxu_fold_u(const uint32_t* __restrict__ s, const uint32_t (&th)[C::N], uint32_t nz) {
  constexpr int N = C::N;
  uint64_t carry = 0;
  FE32_UNROLL for (int w = 0; w < N; ++w) (void)mxu_word(s + 4 * w, carry);
  carry += nz;
  E<C> u;
  FE32_UNROLL for (int w = 0; w < N; ++w) {
    carry += th[w];
    u.w[w] = mxu_word(s + 4 * (N + w), carry);
  }
  return reduce_once<C>(u, (uint32_t)carry);
}

}  // namespace fe32
