// ladder: the signed-digit Straus ladder sum_h d_h * P_h — the verify
// lincomb u1*G + u2*Q (glv = 1: four 132-bit half-scalar terms on two shared
// tables) and scalar_mul's single-term ladder (glv = 0, H = 1).
//
// Replaces tpu_ecc/ops/pallas_kernels.py ladder_call (:887-1044).
//
// Design: one thread per batch lane; the TPU's sequential window grid
// dimension, which carried the accumulator in VMEM scratch, becomes the
// window loop inside the thread. Per base the lane builds the table
// [O, Q, .., 8Q] with 7 adds into global scratch [T * 9, 3, n, B]
// (2160 B per base per lane; 17.7 MB at T = 2, B = 4096, which L2 holds).
// Per window: 4 doublings, then per term a masked select over all 9 table
// entries (never an index by digit: scalar_mul serves secret scalars),
// beta * X for the odd GLV terms after the select (:991-992), a masked
// y-negation, and an add. With H == 1 the first window seeds the
// accumulator from the selected entry instead of adding it to O (:999-1007),
// for limb parity with the plain ladder. The GLV branch is compiled only
// where the generated header defines KFE_HAS_BETA (a curve with an
// endomorphism, such as secp256k1); elsewhere (P-256) a glv launch is
// refused before it starts.
//
// Bound: operations — per window 4 doublings (~11.2k 32-bit integer
// operations each) and H adds (~18.7k each), from the generator's counts.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_ladder.cuh"

#define N KFE_FP_N
#define PN (3 * N)
#define TBL 9
#define THREADS 32

__device__ static void identity(uint32_t* p) {
  uint32_t one[N];
  kfe_fp_one(one);
  for (int i = 0; i < N; ++i) {
    p[i] = 0u;
    p[N + i] = one[i];
    p[2 * N + i] = 0u;
  }
}

__global__ void ladder_kernel(const uint32_t* __restrict__ bases,
                              const uint32_t* __restrict__ mag,
                              const uint32_t* __restrict__ neg,
                              uint32_t* __restrict__ out,
                              uint32_t* __restrict__ tbl, int T, int H,
                              int nw, int glv, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  uint32_t acc[PN], cur[PN], nxt[PN], sel[PN], tmp[N];
  identity(sel);

#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    uint32_t* tb = tbl + (size_t)t * TBL * PN * B;
    for (int j = 0; j < PN; ++j) {
      acc[j] = bases[((size_t)t * PN + j) * B + lane];  // the base, steady
      cur[j] = acc[j];
      tb[(size_t)j * B + lane] = sel[j];                // entry 0: O
      tb[((size_t)PN + j) * B + lane] = acc[j];         // entry 1: Q
    }
#pragma unroll 1
    for (int k = 2; k < TBL; ++k) {
      kfe_padd(cur, acc, nxt);
      for (int j = 0; j < PN; ++j) {
        cur[j] = nxt[j];
        tb[((size_t)k * PN + j) * B + lane] = nxt[j];
      }
    }
  }

  identity(acc);
#pragma unroll 1
  for (int w = 0; w < nw; ++w) {
#pragma unroll 1
    for (int d = 0; d < 4; ++d) {
      kfe_pdouble(acc, nxt);
      for (int j = 0; j < PN; ++j) acc[j] = nxt[j];
    }
#pragma unroll 1
    for (int h = 0; h < H; ++h) {
      const int t = glv ? (h >> 1) : h;
      const size_t dg = ((size_t)w * H + h) * B + lane;
      const uint32_t m = mag[dg];
      const bool ng = neg[dg] != 0u;
      const uint32_t* tb = tbl + (size_t)t * TBL * PN * B;
      identity(sel);
#pragma unroll 1
      for (int k = 0; k < TBL; ++k) {
        const bool hit = (m == (uint32_t)k);
        for (int j = 0; j < PN; ++j) {
          const uint32_t v = tb[((size_t)k * PN + j) * B + lane];
          sel[j] = hit ? v : sel[j];
        }
      }
#ifdef KFE_HAS_BETA
      if (glv && (h & 1)) {  // psi(x, y) = (beta * x, y) after the select
        kfe_fp_mul_beta(sel, tmp);
        for (int i = 0; i < N; ++i) sel[i] = tmp[i];
      }
#endif
      kfe_fp_neg(sel + N, tmp);
      for (int i = 0; i < N; ++i) sel[N + i] = ng ? tmp[i] : sel[N + i];
      if (H == 1 && w == 0) {
        for (int j = 0; j < PN; ++j) acc[j] = sel[j];
      } else {
        kfe_padd(acc, sel, nxt);
        for (int j = 0; j < PN; ++j) acc[j] = nxt[j];
      }
    }
  }
  for (int j = 0; j < PN; ++j) out[(size_t)j * B + lane] = acc[j];
}

// bases [T, 3, n, B]; mag, neg [nw, H, B]; out [3, n, B];
// tbl: scratch of T * 9 * 3n * B words.
extern "C" int ladder_launch(const void* bases, const void* mag,
                             const void* neg, void* out, void* tbl, int T,
                             int H, int nw, int glv, int B, int* launched,
                             void* stream) {
#ifndef KFE_HAS_BETA
  if (glv) {  // the curve has no endomorphism: no psi to apply
    *launched = 0;
    return (int)cudaErrorInvalidValue;
  }
#endif
  ladder_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                  (cudaStream_t)stream>>>(
      (const uint32_t*)bases, (const uint32_t*)mag, (const uint32_t*)neg,
      (uint32_t*)out, (uint32_t*)tbl, T, H, nw, glv, B);
  *launched = 1;
  return (int)cudaGetLastError();
}
