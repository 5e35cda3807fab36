// horner: the window combine of the bucketed Pippenger MSM,
// acc = 2^w * acc + S_j over the nw per-window sums, MSB window first
// (parallel/msm.py, step 9).
//
// Replaces tpu_ecc/ops/pallas_kernels.py horner_call (:814-883).
//
// Design: the combine is one dependent chain of nw * (w + 1) point
// operations on a single point: 2^252 S_0 takes 252 doublings whatever the
// split. The TPU broadcast that point across an (8, 128) tile and ran one
// window per grid step; here one thread runs the whole chain on the 32-bit
// field layer (fe32.cuh, point32.cuh; the lane body is fe32::horner_lane):
// the accumulator stays in registers, each doubling and add is
// force-inlined, and the window sums [nw, 3, n] convert from their 13-bit
// rows as each is read. acc starts at O; per window w doublings and one
// add; the result stores once, canonical.
//
// Bound: the one thread's issue rate. At w = 14, nw = 19 the chain is
// 266 doublings and 19 adds, 266 * 1832 + 19 * 2887 = 542k instructions
// in the layer's count (kernels.work design "fe32"), about 0.27 ms at one
// instruction a clock at 1980 MHz; the card-wide operation bound (all SMs
// issuing) is three orders below that and does not bind. The thread has
// the SM to itself, so the kernel sets no __launch_bounds__ minimum.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8): 140 registers, 0 bytes of stack,
// spill stores and spill loads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_horner.cuh"
#include "point32.cuh"

__global__ void horner_kernel(const uint32_t* __restrict__ s_all, uint32_t* __restrict__ out,
                              int nw, int w) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  fe32::horner_lane<Curve32>(s_all, out, nw, w);
}

// s_all [nw, 3, n], MSB window first; out [3, n].
extern "C" int horner_launch(const void* s_all, void* out, int nw, int w, int* launched,
                             void* stream) {
  horner_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const uint32_t*)s_all, (uint32_t*)out, nw,
                                                   w);
  *launched = 1;
  return (int)cudaGetLastError();
}
