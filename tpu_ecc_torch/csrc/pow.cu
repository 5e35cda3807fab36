// pow: x^e for a fixed public exponent e, 4-bit windows MSB first — the
// Fermat inversion s^-1 = s^(n-2) of ECDSA verify, on either field.
//
// Replaces tpu_ecc/ops/pallas_kernels.py pow_call (:1140-1236).
//
// Design: one thread per batch lane. The lane builds its table x^1..x^15
// with 14 multiplies into global scratch [15, n, B] (limb-major, so the
// table loads of a warp are coalesced), then walks the exponent digits:
// four squarings, then a multiply by the table entry of the digit. The
// accumulator starts at one and a zero digit keeps it, as the TPU kernel
// does (:1187-1205), so results are limb-equal with it. The digits are
// public, so the lane indexes the table by digit directly; every thread of
// the grid takes the same branch.
//
// Bound: operations (4 squarings + <= 1 multiply per digit, each a
// generated straight-line field op of ~1-2k 32-bit integer operations).
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_pow.cuh"

#define THREADS 32

struct FieldP {
  enum { N = KFE_FP_N };
  __device__ static void mul(const uint32_t* x, const uint32_t* y, uint32_t* o) {
    kfe_fp_mul(x, y, o);
  }
  __device__ static void sqr(const uint32_t* x, uint32_t* o) { kfe_fp_sqr(x, o); }
  __device__ static void one(uint32_t* o) { kfe_fp_one(o); }
};

struct FieldN {
  enum { N = KFE_FN_N };
  __device__ static void mul(const uint32_t* x, const uint32_t* y, uint32_t* o) {
    kfe_fn_mul(x, y, o);
  }
  __device__ static void sqr(const uint32_t* x, uint32_t* o) { kfe_fn_sqr(x, o); }
  __device__ static void one(uint32_t* o) { kfe_fn_one(o); }
};

template <class F>
__global__ void pow_kernel(const uint32_t* __restrict__ x,
                           uint32_t* __restrict__ out,
                           uint32_t* __restrict__ tbl,
                           const int32_t* __restrict__ digits, int ndig,
                           int B) {
  constexpr int N = F::N;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  uint32_t xv[N], cur[N], nxt[N], acc[N];
  for (int i = 0; i < N; ++i) {
    xv[i] = x[(size_t)i * B + lane];
    cur[i] = xv[i];
    tbl[(size_t)i * B + lane] = xv[i];
  }
#pragma unroll 1
  for (int k = 2; k < 16; ++k) {  // tbl[k - 1] = x^k
    F::mul(cur, xv, nxt);
    for (int i = 0; i < N; ++i) {
      cur[i] = nxt[i];
      tbl[((size_t)(k - 1) * N + i) * B + lane] = nxt[i];
    }
  }
  F::one(acc);
#pragma unroll 1
  for (int d = 0; d < ndig; ++d) {
#pragma unroll 1
    for (int s = 0; s < 4; ++s) {
      F::sqr(acc, nxt);
      for (int i = 0; i < N; ++i) acc[i] = nxt[i];
    }
    const int dig = digits[d];
    if (dig != 0) {  // x^(16a+0) = (x^a)^16: keep acc
      for (int i = 0; i < N; ++i)
        cur[i] = tbl[((size_t)(dig - 1) * N + i) * B + lane];
      F::mul(acc, cur, nxt);
      for (int i = 0; i < N; ++i) acc[i] = nxt[i];
    }
  }
  for (int i = 0; i < N; ++i) out[(size_t)i * B + lane] = acc[i];
}

// field: 0 = base field (KFE_FP_N limbs), 1 = scalar field (KFE_FN_N limbs).
// tbl: scratch of 15 * n * B words.
extern "C" int pow_launch(const void* x, void* out, void* tbl,
                          const void* digits, int ndig, int field, int B,
                          int* launched, void* stream) {
  const dim3 grid((B + THREADS - 1) / THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  if (field == 0)
    pow_kernel<FieldP><<<grid, THREADS, 0, st>>>(
        (const uint32_t*)x, (uint32_t*)out, (uint32_t*)tbl,
        (const int32_t*)digits, ndig, B);
  else
    pow_kernel<FieldN><<<grid, THREADS, 0, st>>>(
        (const uint32_t*)x, (uint32_t*)out, (uint32_t*)tbl,
        (const int32_t*)digits, ndig, B);
  *launched = 1;
  return (int)cudaGetLastError();
}
