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
//   step s = 1, 2, .., L/2: v'[l] = ksteady(padd(v[l], v[l - s])) where
//     i >= s and last_key[l - s] == last_key[l], else v'[l] = v[l] (the add
//     is skipped there: keys are public);
//   last: carry = T[l - 1] where i >= 1 and first_key[l] == last_key[l - 1],
//     else O; out[l] = ksteady(padd(lead[l], carry)), for every lane.
// log2(L) + 1 launches per call, whatever the number of windows.
//
// Bound: operations — one add per lane whose partner is in its run, per
// step, and one per lane at the end; the bytes (a few point arrays of the
// lanes) are two orders smaller. At L = 8192 and one window a step is about
// two warps per SM, so a launch takes about one add's latency; more windows
// side by side fill the card.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_fixup.cuh"

#define N KFE_FP_N
#define PN (3 * N)
#define THREADS 32

__global__ void fixup_step_kernel(const uint32_t* __restrict__ src,
                                  uint32_t* __restrict__ dst,
                                  const uint32_t* __restrict__ last_key,
                                  int s, int L, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  uint32_t a[PN], b[PN], nxt[PN];
  for (int j = 0; j < PN; ++j) a[j] = src[(size_t)j * lanes + lane];
  if (lane % L >= s && last_key[lane - s] == last_key[lane]) {
    for (int j = 0; j < PN; ++j) b[j] = src[(size_t)j * lanes + lane - s];
    kfe_padd(a, b, nxt);
    for (int j = 0; j < PN; ++j) a[j] = nxt[j];
  }
  for (int j = 0; j < PN; ++j) dst[(size_t)j * lanes + lane] = a[j];
}

__global__ void fixup_final_kernel(const uint32_t* __restrict__ T,
                                   const uint32_t* __restrict__ last_key,
                                   const uint32_t* __restrict__ first_key,
                                   const uint32_t* __restrict__ lead,
                                   uint32_t* __restrict__ out, int L,
                                   int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  uint32_t a[PN], carry[PN], nxt[PN];
  for (int j = 0; j < PN; ++j) a[j] = lead[(size_t)j * lanes + lane];
  if (lane % L >= 1 && first_key[lane] == last_key[lane - 1]) {
    for (int j = 0; j < PN; ++j) carry[j] = T[(size_t)j * lanes + lane - 1];
  } else {
    kfe_fp_one(carry + N);  // the identity (0 : 1 : 0)
    for (int i = 0; i < N; ++i) {
      carry[i] = 0u;
      carry[2 * N + i] = 0u;
    }
  }
  kfe_padd(a, carry, nxt);
  for (int j = 0; j < PN; ++j) out[(size_t)j * lanes + lane] = nxt[j];
}

// t_l, lead, out [3, n, lanes]; last_key, first_key [lanes]; lanes is a
// multiple of the window's L; buf: scratch of 2 * 3n * lanes words.
// Launches log2(L) steps and the final add, and counts them in *launched.
extern "C" int fixup_launch(const void* t_l, const void* last_key,
                            const void* first_key, const void* lead, void* out,
                            void* buf, int L, int lanes, int* launched,
                            void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (lanes + THREADS - 1) / THREADS;
  const uint32_t* src = (const uint32_t*)t_l;
  uint32_t* bufs[2] = {(uint32_t*)buf, (uint32_t*)buf + (size_t)PN * lanes};
  int i = 0;
  for (int s = 1; s < L; s *= 2, ++i) {
    uint32_t* dst = bufs[i & 1];
    fixup_step_kernel<<<blocks, THREADS, 0, st>>>(
        src, dst, (const uint32_t*)last_key, s, L, lanes);
    ++*launched;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  fixup_final_kernel<<<blocks, THREADS, 0, st>>>(
      src, (const uint32_t*)last_key, (const uint32_t*)first_key,
      (const uint32_t*)lead, (uint32_t*)out, L, lanes);
  ++*launched;
  return (int)cudaGetLastError();
}
