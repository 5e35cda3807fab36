// horner: the window combine of the bucketed Pippenger MSM,
// acc = 2^w * acc + S_j over the nw per-window sums, MSB window first
// (parallel/msm.py, step 9).
//
// Replaces tpu_ecc/ops/pallas_kernels.py horner_call (:814-883).
//
// Design: the combine is one dependent chain of nw * (w + 1) point
// operations on a single point. The TPU broadcast that point across an
// (8, 128) tile and ran one window per grid step; here one thread runs the
// whole chain, with the accumulator in the thread, and reads the window
// sums [nw, 3, n] as they are (no broadcast). acc starts at O; per window
// w doublings, each ksteady, and one ksteady add.
//
// Bound: the one thread's issue rate — about 2.0 million dependent 32-bit
// integer instructions at w = 14, nw = 19 (6616 per doubling, 11204 per
// add, the generator's counts), at most one per clock on one SM, so at
// least 1 ms; the card-wide operation bound (all SMs issuing) is three
// orders below that and does not bind.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_horner.cuh"

#define N KFE_FP_N
#define PN (3 * N)

__global__ void horner_kernel(const uint32_t* __restrict__ s_all,
                              uint32_t* __restrict__ out, int nw, int w) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  uint32_t acc[PN], s[PN], nxt[PN];
  kfe_fp_one(acc + N);  // the identity (0 : 1 : 0)
  for (int i = 0; i < N; ++i) {
    acc[i] = 0u;
    acc[2 * N + i] = 0u;
  }
#pragma unroll 1
  for (int win = 0; win < nw; ++win) {
#pragma unroll 1
    for (int d = 0; d < w; ++d) {
      kfe_pdouble(acc, nxt);
      for (int j = 0; j < PN; ++j) acc[j] = nxt[j];
    }
    for (int j = 0; j < PN; ++j) s[j] = s_all[(size_t)win * PN + j];
    kfe_padd(acc, s, nxt);
    for (int j = 0; j < PN; ++j) acc[j] = nxt[j];
  }
  for (int j = 0; j < PN; ++j) out[j] = acc[j];
}

// s_all [nw, 3, n], MSB window first; out [3, n].
extern "C" int horner_launch(const void* s_all, void* out, int nw, int w,
                             int* launched, void* stream) {
  horner_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)s_all, (uint32_t*)out, nw, w);
  *launched = 1;
  return (int)cudaGetLastError();
}
