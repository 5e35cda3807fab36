// fixup: the lane fix-up of the bucketed Pippenger MSM — a segmented
// Hillis–Steele scan over the L lane tails of a window keyed on each lane's
// last key, then the carry from the lane before and the add into the
// leading run's value (parallel/msm.py, steps 4 and 5).
//
// Replaces tpu_ecc/ops/pallas_kernels.py fixup_call (:647-729).
//
// Design: the TPU ran the log2(L) steps as a sequential grid axis over one
// VMEM array, each step reading the whole array before writing it. Here the
// steps span all lanes, so each step is a launch of its own (the launch
// boundary is the grid-wide barrier) that reads one buffer and writes the
// other: lane l reads lane l - s while that lane is being written, so the
// steps ping-pong between two scratch buffers. Several windows go side by
// side, L lanes each, and a lane never reads across its window's start.
// One thread per lane, i = its index within the window:
//   step s = 1, 2, .., L/2: v'[l] = v[l] + v[l - s] where i >= s and
//     last_key[l - s] == last_key[l], else v'[l] = v[l] (the add is
//     skipped there: keys are public);
//   last: carry = T[l - 1] where i >= 1 and first_key[l] == last_key[l - 1],
//     else O; out[l] = lead[l] + carry, for every lane.
// log2(L) + 1 launches per call, whatever the number of windows (L = 1:
// the last launch alone). The twin's and the TPU kernel's order of adds,
// so each projective coordinate equals kernels.fixup_plain's mod p.
// Each launch is one lane body of the 32-bit field layer (fe32.cuh,
// point32.cuh: fe32::fixup_step_lane, fe32::fixup_final_lane), the add
// force-inlined in registers. Between steps the lanes stay canonical
// words, [3N][lanes] with the lane innermost (96 B a point against the
// 240 B of a 13-bit row): the two buffers of 8 windows of 8192 lanes are
// 12.6 MB, within the card's 50 MB L2. Only the first step converts from
// the 13-bit rows of t_l, and only the last launch reads lead's rows and
// stores 13-bit rows.
//
// Bound: operations — one add per lane whose partner is in its run, per
// step, and one per lane at the end; the bytes (a few point arrays of the
// lanes) are two orders smaller. At L = 8192 and 3 windows a step is 768
// warps, 1.5 a scheduler, so a launch takes about one add's latency.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_fixup.cuh"
#include "point32.cuh"

// Threads a block, which __launch_bounds__ follows; a build may set it.
// At 32, 64 and 128 ptxas gives the same registers (138-246 over the
// three instances; CUDA 12.8) and 0 bytes of stack and spill, and the
// times lie within 2% (8 windows 0.1677 / 0.1686 / 0.1693
// ms a call, 3 windows 0.0859 / 0.0850 / 0.0840 on an H100;
// tpu_ecc_torch/tools/bench_blocks.py, PERF.md): 128 stays.
#ifndef FIXUP_THREADS
#define FIXUP_THREADS 128
#endif
#define THREADS FIXUP_THREADS

// src: 13-bit rows [3, n, lanes] (ROWS) or words [3N, lanes]; dst words
template <bool ROWS>
__global__ void __launch_bounds__(THREADS)
    fixup_step_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                      const uint32_t* __restrict__ last_key, uint32_t s, uint32_t L,
                      uint32_t lanes) {
  const uint32_t l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  fe32::fixup_step_lane<Curve32, ROWS>(src, dst, last_key, s, L, lanes, l);
}

// T: the last step's words [3N, lanes]; lead, out [3, n, lanes]
__global__ void __launch_bounds__(THREADS)
    fixup_final_kernel(const uint32_t* __restrict__ T, const uint32_t* __restrict__ last_key,
                       const uint32_t* __restrict__ first_key,
                       const uint32_t* __restrict__ lead, uint32_t* __restrict__ out,
                       uint32_t L, uint32_t lanes) {
  const uint32_t l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  fe32::fixup_final_lane<Curve32>(T, last_key, first_key, lead, out, L, lanes, l);
}

// t_l, lead, out [3, n, lanes]; last_key, first_key [lanes]; lanes is a
// multiple of the window's L; buf: scratch of 2 * 3N * lanes words.
// Launches log2(L) steps and the final add, and counts them in *launched.
extern "C" int fixup_launch(const void* t_l, const void* last_key, const void* first_key,
                            const void* lead, void* out, void* buf, int L, int lanes,
                            int* launched, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const uint32_t Lw = (uint32_t)L, n = (uint32_t)lanes;
  const unsigned blocks = (n + THREADS - 1) / THREADS;
  const uint32_t* keys = (const uint32_t*)last_key;
  uint32_t* bufs[2] = {(uint32_t*)buf, (uint32_t*)buf + (size_t)3 * Curve32::N * n};
  const uint32_t* src = (const uint32_t*)t_l;   // with L = 1, never read
  int k = 0;
  for (uint32_t s = 1; s < Lw; s *= 2, ++k) {
    uint32_t* dst = bufs[k & 1];
    if (s == 1) {
      fixup_step_kernel<true><<<blocks, THREADS, 0, st>>>(src, dst, keys, s, Lw, n);
    } else {
      fixup_step_kernel<false><<<blocks, THREADS, 0, st>>>(src, dst, keys, s, Lw, n);
    }
    ++*launched;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  fixup_final_kernel<<<blocks, THREADS, 0, st>>>(src, keys, (const uint32_t*)first_key,
                                                 (const uint32_t*)lead, (uint32_t*)out, Lw, n);
  ++*launched;
  return (int)cudaGetLastError();
}
