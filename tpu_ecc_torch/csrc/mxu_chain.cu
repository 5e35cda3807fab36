// mxu_chain: a <- a * b * R^-1 sixteen times per lane, each Montgomery
// multiply separated into a data-by-data convolution on the CUDA cores and
// the reduction's two constant products on the int8 tensor cores — the probe
// of whether the tensor cores can take over the Montgomery reduction.
//
// Replaces tools/bench_mxu_mul.py bench_mxu_kernel_chain (:232-327), whose
// Pallas body (:285-299) kept the chain in VMEM and ran the two constant
// Toeplitz products on the TPU's matrix unit.
//
// Design: one warp per block, one thread per batch lane, the tool's order per
// step: the n x n limb convolution (columns < n * 2^26 < 2^31), a carry of 2n
// columns to the digits T, m = T[:n] * N' mod R (the product, then a carry of
// n), u = m * p + T, a carry of 2n, and the top n digits are the result
// (< 2p). The two constant products are banded Toeplitz matrices of 13-bit
// limbs times the lanes' digits, split into int8 planes (low 7 and high 6
// bits): four `mma.sync.m16n8k32` s8 * s8 + s32 tiles per row tile and group
// of 8 lanes — A the constant planes, their rows zero-padded to 16-row tiles
// and the limb axis to k = 32, held in shared memory; B eight lanes' digit
// planes, which each thread stages into shared memory as a row of 32 bytes
// and reads back in the fragment layout (k contiguous). The low-high and
// high-low products accumulate into one tile, and each column recombines as
// p00 + ((p01 + p10) << 7) + (p11 << 14) in unsigned 32 bits (every column
// < 2^31), written to shared memory, where its lane reads it back. A
// ragged warp runs the tensor-core steps on zero digits and stores nothing.
// `wgmma` would need 64-row tiles of one operand shared by the warp group;
// that is for a later change.
//
// Bound: operations on the CUDA cores — per step n^2 multiply-adds of the
// convolution and about 22 n adds, ANDs and shifts of the carries, the plane
// splits and the recombination — against 4 * 3 n^2 int8 multiply-adds per
// step on the tensor cores, which at the card's dense int8 rate take a small
// fraction of that.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_mxu_chain.cuh"

#define N KFE_FP_N
#define BITS KFE_FP_BITS
#define MASK ((1u << BITS) - 1u)
#define CHAIN 16
#define KD 32                     // the mma's depth: the limb axis, padded
#define MT ((N + 15) / 16)        // row tiles of the N' product (n rows)
#define PT ((2 * N + 15) / 16)    // row tiles of the p product (2n rows)
#define THREADS 32

static_assert(N <= KD, "one k step of the mma holds the limb axis");
static_assert(BITS <= 14, "both planes of a digit fit int8");

struct Smem {
  int8_t m_lo[MT * 16][KD], m_hi[MT * 16][KD];  // N' planes [n, n], padded
  int8_t p_lo[PT * 16][KD], p_hi[PT * 16][KD];  // p planes [2n, n], padded
  int8_t d_lo[THREADS][KD], d_hi[THREADS][KD];  // the lanes' digit planes
  uint32_t res[PT * 16][THREADS];               // recombined columns
};

__device__ static inline uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a * b on one m16n8k32 tile (int8 in, int32 accumulate)
__device__ static inline void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// out[k] = sum_i C[k, i] * d[i] for k < ROWS, C the constant planes lo/hi
// of TILES row tiles, d this lane's n digits; the warp runs it together.
template <int TILES, int ROWS>
__device__ static void const_conv(Smem& s, const int8_t (*c_lo)[KD],
                                  const int8_t (*c_hi)[KD], const uint32_t* d,
                                  uint32_t* out) {
  const int lane = threadIdx.x;
  for (int k = 0; k < N; ++k) {
    s.d_lo[lane][k] = (int8_t)(d[k] & 127u);
    s.d_hi[lane][k] = (int8_t)(d[k] >> 7);
  }
  __syncwarp();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int nt = 0; nt < THREADS / 8; ++nt) {
    const int col = 8 * nt + g;  // B's column: this group's lane
    const uint32_t b_lo[2] = {ld32(&s.d_lo[col][4 * t]),
                              ld32(&s.d_lo[col][16 + 4 * t])};
    const uint32_t b_hi[2] = {ld32(&s.d_hi[col][4 * t]),
                              ld32(&s.d_hi[col][16 + 4 * t])};
#pragma unroll
    for (int rt = 0; rt < TILES; ++rt) {
      const int r = 16 * rt + g;
      const uint32_t a_lo[4] = {ld32(&c_lo[r][4 * t]), ld32(&c_lo[r + 8][4 * t]),
                                ld32(&c_lo[r][16 + 4 * t]),
                                ld32(&c_lo[r + 8][16 + 4 * t])};
      const uint32_t a_hi[4] = {ld32(&c_hi[r][4 * t]), ld32(&c_hi[r + 8][4 * t]),
                                ld32(&c_hi[r][16 + 4 * t]),
                                ld32(&c_hi[r + 8][16 + 4 * t])};
      int p00[4] = {0, 0, 0, 0}, pmid[4] = {0, 0, 0, 0}, p11[4] = {0, 0, 0, 0};
      mma_s8(p00, a_lo, b_lo);
      mma_s8(pmid, a_lo, b_hi);
      mma_s8(pmid, a_hi, b_lo);
      mma_s8(p11, a_hi, b_hi);
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // D: row g (+8 for e >= 2), column 2t + e % 2
        s.res[r + (e >> 1) * 8][8 * nt + 2 * t + (e & 1)] =
            (uint32_t)p00[e] + ((uint32_t)pmid[e] << 7) +
            ((uint32_t)p11[e] << 14);
      }
    }
  }
  __syncwarp();
  for (int k = 0; k < ROWS; ++k) out[k] = s.res[k][lane];
  __syncwarp();  // the next call rewrites d_lo, d_hi and res
}

__device__ static inline void carry(uint32_t* v, int count) {
  uint32_t c = 0u;
  for (int k = 0; k < count; ++k) {
    const uint32_t t = v[k] + c;
    v[k] = t & MASK;
    c = t >> BITS;
  }
}

__device__ static void load_planes(int8_t (*dst)[KD], const int8_t* src,
                                   int rows, int tiles) {
  for (int e = threadIdx.x; e < tiles * 16 * KD; e += THREADS) {
    const int r = e / KD, k = e % KD;
    dst[r][k] = (r < rows && k < N) ? src[r * N + k] : (int8_t)0;
  }
}

__global__ void __launch_bounds__(THREADS)
    mxu_chain_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b,
                     const int8_t* __restrict__ m_lo,
                     const int8_t* __restrict__ m_hi,
                     const int8_t* __restrict__ p_lo,
                     const int8_t* __restrict__ p_hi,
                     uint32_t* __restrict__ out, int B) {
  __shared__ __align__(16) Smem s;
  load_planes(s.m_lo, m_lo, N, MT);
  load_planes(s.m_hi, m_hi, N, MT);
  load_planes(s.p_lo, p_lo, 2 * N, PT);
  load_planes(s.p_hi, p_hi, 2 * N, PT);
  for (int k = N; k < KD; ++k) s.d_lo[threadIdx.x][k] = s.d_hi[threadIdx.x][k] = 0;
  __syncwarp();

  const int lane = blockIdx.x * THREADS + threadIdx.x;
  const bool live = lane < B;  // a ragged warp still runs every mma
  uint32_t x[N], y[N], T[2 * N], u[2 * N];
  for (int i = 0; i < N; ++i) {
    x[i] = live ? a[(size_t)i * B + lane] : 0u;
    y[i] = live ? b[(size_t)i * B + lane] : 0u;
  }
#pragma unroll 1
  for (int step = 0; step < CHAIN; ++step) {
#pragma unroll
    for (int k = 0; k < 2 * N; ++k) T[k] = 0u;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) T[i + j] += x[i] * y[j];
    carry(T, 2 * N);                                   // T: digits of x * y
    const_conv<MT, N>(s, s.m_lo, s.m_hi, T, u);        // m = T * N'
    carry(u, N);                                       // mod R
    uint32_t m[N];
    for (int k = 0; k < N; ++k) m[k] = u[k];
    const_conv<PT, 2 * N>(s, s.p_lo, s.p_hi, m, u);    // m * p
    for (int k = 0; k < 2 * N; ++k) u[k] += T[k];
    carry(u, 2 * N);
    for (int i = 0; i < N; ++i) x[i] = u[N + i];       // (T + m p) / R
  }
  if (live)
    for (int i = 0; i < N; ++i) out[(size_t)i * B + lane] = x[i];
}

// a, b, out [n, B] digits; m_lo, m_hi [n, n] and p_lo, p_hi [2n, n] int8.
extern "C" int mxu_chain_launch(const void* a, const void* b, const void* m_lo,
                                const void* m_hi, const void* p_lo,
                                const void* p_hi, void* out, int B,
                                int* launched, void* stream) {
  *launched = 0;
  if (B == 0) return 0;
  mxu_chain_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                     (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (const int8_t*)m_lo,
      (const int8_t*)m_hi, (const int8_t*)p_lo, (const int8_t*)p_hi,
      (uint32_t*)out, B);
  *launched = 1;
  return (int)cudaGetLastError();
}
