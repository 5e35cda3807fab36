// ladder_probe: the signed-digit ladder's body with its parts switched on one
// at a time, so that the differences between the variants split the ladder's
// time among the formula floor, the table build, the select and the negation.
//
// Replaces tools/profile_ladder.py make(variant) (:72-175), the Pallas
// ladder body with the same switches (:75-151).
//
// Design: cut from csrc/ladder.cu (:44-115), the ladder this port runs: one
// thread per batch lane, the window loop inside the thread, the table
// [O, Q, .., 8Q] of the one base in global scratch [9, 3n, B], the masked
// select over all 9 entries and the masked y-negation. From O, per window:
// 4 doublings, then for h = 0, 1 an add of the selected entry. The variants
// (a template argument, instantiated five times in this one source and
// picked at launch, so that each is compiled as its own kernel):
//   0 bare    entry 1 (the base) only, the doublings in a `#pragma unroll 1`
//             loop;
//   1 unroll  as bare, the doubling loop `#pragma unroll` (4 call sites);
//   2 build   as bare, and entries 2-8 built with 7 adds first;
//   3 select  as build, the entry selected by mag[w, h];
//   4 negate  as select, y negated where neg[w, h] is set.
// Only select and negate read the digits.
//
// Bound: operations — per window 4 doublings and 2 adds of the generator's
// count (secp256k1: 6616 and 11204 32-bit integer instructions), 7 more adds
// from build on, and the select's compares and selects.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_ladder_probe.cuh"

#define N KFE_FP_N
#define PN (3 * N)
#define TBL 9
#define THREADS 32

enum { BARE, UNROLL, BUILD, SELECT, NEGATE, VARIANTS };

__device__ static void identity(uint32_t* p) {
  uint32_t one[N];
  kfe_fp_one(one);
  for (int i = 0; i < N; ++i) {
    p[i] = 0u;
    p[N + i] = one[i];
    p[2 * N + i] = 0u;
  }
}

template <int V>
__global__ void ladder_probe_kernel(const uint32_t* __restrict__ bases,
                                    const uint32_t* __restrict__ mag,
                                    const uint32_t* __restrict__ neg,
                                    uint32_t* __restrict__ out,
                                    uint32_t* __restrict__ tbl, int nw,
                                    int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  uint32_t acc[PN], cur[PN], nxt[PN], sel[PN], tmp[N];
  identity(sel);
  for (int j = 0; j < PN; ++j) {
    acc[j] = bases[(size_t)j * B + lane];  // the base, steady
    cur[j] = acc[j];
    tbl[(size_t)j * B + lane] = sel[j];            // entry 0: O
    tbl[((size_t)PN + j) * B + lane] = acc[j];     // entry 1: Q
  }
  if (V >= BUILD) {
#pragma unroll 1
    for (int k = 2; k < TBL; ++k) {
      kfe_padd(cur, acc, nxt);
      for (int j = 0; j < PN; ++j) {
        cur[j] = nxt[j];
        tbl[((size_t)k * PN + j) * B + lane] = nxt[j];
      }
    }
  }

  identity(acc);
#pragma unroll 1
  for (int w = 0; w < nw; ++w) {
    if (V == UNROLL) {
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        kfe_pdouble(acc, nxt);
        for (int j = 0; j < PN; ++j) acc[j] = nxt[j];
      }
    } else {
#pragma unroll 1
      for (int d = 0; d < 4; ++d) {
        kfe_pdouble(acc, nxt);
        for (int j = 0; j < PN; ++j) acc[j] = nxt[j];
      }
    }
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const size_t dg = ((size_t)w * 2 + h) * B + lane;
      if (V >= SELECT) {
        const uint32_t m = mag[dg];
        identity(sel);
#pragma unroll 1
        for (int k = 0; k < TBL; ++k) {
          const bool hit = (m == (uint32_t)k);
          for (int j = 0; j < PN; ++j) {
            const uint32_t v = tbl[((size_t)k * PN + j) * B + lane];
            sel[j] = hit ? v : sel[j];
          }
        }
      } else {
        for (int j = 0; j < PN; ++j) sel[j] = tbl[((size_t)PN + j) * B + lane];
      }
      if (V == NEGATE) {
        const bool ng = neg[dg] != 0u;
        kfe_fp_neg(sel + N, tmp);
        for (int i = 0; i < N; ++i) sel[N + i] = ng ? tmp[i] : sel[N + i];
      }
      kfe_padd(acc, sel, nxt);
      for (int j = 0; j < PN; ++j) acc[j] = nxt[j];
    }
  }
  for (int j = 0; j < PN; ++j) out[(size_t)j * B + lane] = acc[j];
}

// bases [3, n, B]; mag, neg [nw, 2, B]; out [3, n, B]; tbl: scratch of
// 9 * 3n * B words; variant: 0 bare, 1 unroll, 2 build, 3 select, 4 negate.
extern "C" int ladder_probe_launch(const void* bases, const void* mag,
                                   const void* neg, void* out, void* tbl,
                                   int nw, int variant, int B, int* launched,
                                   void* stream) {
  typedef void (*Kernel)(const uint32_t*, const uint32_t*, const uint32_t*,
                         uint32_t*, uint32_t*, int, int);
  static const Kernel kernels[VARIANTS] = {
      ladder_probe_kernel<BARE>, ladder_probe_kernel<UNROLL>,
      ladder_probe_kernel<BUILD>, ladder_probe_kernel<SELECT>,
      ladder_probe_kernel<NEGATE>};
  *launched = 0;
  if (variant < 0 || variant >= VARIANTS) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  kernels[variant]<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                     (cudaStream_t)stream>>>(
      (const uint32_t*)bases, (const uint32_t*)mag, (const uint32_t*)neg,
      (uint32_t*)out, (uint32_t*)tbl, nw, B);
  *launched = 1;
  return (int)cudaGetLastError();
}
