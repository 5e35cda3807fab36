// genmul: the constant-time fixed-base comb k*G — the ECDSA sign nonce
// point and public-key derivation d*G (scalarmul.mul_by_generator).
//
// Replaces tpu_ecc/ops/pallas_kernels.py genmul_call (:1048-1136).
//
// Design: one thread per batch lane; the TPU's sequential window grid
// dimension, which carried the accumulator in VMEM scratch, becomes the
// window loop inside the thread, which keeps the accumulator for the whole
// loop and writes only the result. Windows run LSB first; table row j holds
// the affine points d * 16^j * G for d = 0..8 (entry 0 a dummy), identical
// for every lane (93.6 KB for secp256k1: 65 rows * 9 * 2 * 20 limbs). Per
// window:
//   1. a masked select over all 9 entries, comparing each with the digit:
//      never a load indexed by the digit and never a branch on it, since k
//      and d are secret. Every lane of a warp reads the same table words,
//      one broadcast load each through the read-only path;
//   2. y or its negation (ksteady(kneg(y))), selected by the sign mask;
//   3. one complete mixed add (RCB 2015 Algorithm 8), ksteady out;
//   4. acc = digit == 0 ? acc : new, a select (entry 0 is the dummy).
//
// Bound: operations — per window one mixed add (~10k 32-bit integer
// instructions, the generator's count) and the 9-entry select; the table
// and digits are a few hundred bytes per lane.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_genmul.cuh"

#define N KFE_FP_N
#define PN (3 * N)
#define TBL 9
#define THREADS 32

__global__ void genmul_kernel(const uint32_t* __restrict__ tbl,
                              const uint32_t* __restrict__ mag,
                              const uint32_t* __restrict__ neg,
                              uint32_t* __restrict__ out, int nw, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  uint32_t acc[PN], nxt[PN], x[N], y[N], yn[N];
  kfe_fp_one(yn);
  for (int i = 0; i < N; ++i) {  // the identity (0 : 1 : 0)
    acc[i] = 0u;
    acc[N + i] = yn[i];
    acc[2 * N + i] = 0u;
  }

#pragma unroll 1
  for (int w = 0; w < nw; ++w) {
    const size_t dg = (size_t)w * B + lane;
    const uint32_t m = mag[dg];
    const bool ng = neg[dg] != 0u;
    const uint32_t* row = tbl + (size_t)w * TBL * 2 * N;
    for (int i = 0; i < N; ++i) {
      x[i] = 0u;
      y[i] = 0u;
    }
#pragma unroll 1
    for (int k = 0; k < TBL; ++k) {
      const bool hit = (m == (uint32_t)k);
      const uint32_t* e = row + (size_t)k * 2 * N;
      for (int i = 0; i < N; ++i) {
        const uint32_t vx = __ldg(e + i);
        const uint32_t vy = __ldg(e + N + i);
        x[i] = hit ? vx : x[i];
        y[i] = hit ? vy : y[i];
      }
    }
    kfe_fp_neg(y, yn);
    for (int i = 0; i < N; ++i) y[i] = ng ? yn[i] : y[i];
    kfe_padd_mixed(acc, x, y, nxt);
    const bool keep = (m == 0u);
    for (int j = 0; j < PN; ++j) acc[j] = keep ? acc[j] : nxt[j];
  }
  for (int j = 0; j < PN; ++j) out[(size_t)j * B + lane] = acc[j];
}

// tbl [nw, 9, 2, n] affine table; mag, neg [nw, B] LSB window first;
// out [3, n, B].
extern "C" int genmul_launch(const void* tbl, const void* mag, const void* neg,
                             void* out, int nw, int B, int* launched,
                             void* stream) {
  genmul_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                  (cudaStream_t)stream>>>(
      (const uint32_t*)tbl, (const uint32_t*)mag, (const uint32_t*)neg,
      (uint32_t*)out, nw, B);
  *launched = 1;
  return (int)cudaGetLastError();
}
