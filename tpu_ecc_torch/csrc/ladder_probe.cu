// ladder_probe: the signed-digit ladder's body with its parts switched on one
// at a time, so that the differences between the variants split the ladder's
// time among the formula floor, the table build, the select and the negation.
//
// Replaces tools/profile_ladder.py make(variant) (:72-175), the Pallas
// ladder body with the same switches (:75-151).
//
// Design: the body of csrc/ladder.cu, the ladder this port runs, on the same
// 32-bit field layer (fe32.cuh, point32.cuh; the lane body is
// fe32::ladder_probe_lane): one thread per batch lane, the window loop inside
// the thread, the base loaded once from its 13-bit rows, the point and every
// formula force-inlined in registers, and the table [O, Q, .., 8Q] in the
// block's shared memory, [entry][coordinate][word][PROBE_THREADS] with the
// lane innermost (864 B a lane), so that a warp's loads of one word fall on
// 32 banks, read on each term (fe32::opaque keeps the reads in the window
// loop: hoisted out of it, select's 9 entries spilled 352 B). From O, per
// window: 4 doublings, then for h = 0, 1 an add of the selected entry; the
// result stores once, canonical, in 13-bit limbs. The variants (a template argument, instantiated five times in this one source
// and picked at launch, so that each is compiled as its own kernel):
//   0 bare    entry 1 (the base) only, read from the table on each term,
//             the doublings in a `#pragma unroll 1` loop;
//   1 unroll  as bare, the 4 doublings unrolled;
//   2 build   as bare, and entries 2-8 built with 7 adds first;
//   3 select  as build, the entry selected by mag[w, h] (a masked select
//             over all 9 entries, as the ladder's);
//   4 negate  as select, y negated where neg[w, h] is set.
// Only select and negate read the digits.
//
// Bound: operations — per window 4 doublings and 2 adds (1832 and 2887
// instructions on secp256k1, kernels.work design "fe32"), 7 more adds from
// build on, and the select's compares and selects; the base, digits and
// result are a few hundred bytes a lane. B = 4096 lanes are 128 warps, 2 a
// block on 64 SMs, each waiting on its own dependent multiply-adds: latency,
// as the ladder's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_ladder_probe.cuh"
#include "point32.cuh"

// Threads a block, which __launch_bounds__ follows (at least one block an
// SM, as the ladder's solinas form) and the table's lane stride is (55 KB of
// shared memory a block at 64); a build may set it. At 32, 64 and 128 ptxas
// gives 0 bytes of spill (152-212 registers); 64 ran fastest on an H100 in
// all five variants, all within 3% (B = 4096, 34 windows, ms a call at 32 /
// 64 / 128: bare 1.6576 / 1.6417 / 1.6846, unroll 2.3428 / 2.3246 /
// 2.3476, build 1.7279 / 1.7146 / 1.7658, select 1.7803 / 1.7641 / 1.8062,
// negate 1.7748 / 1.7648 / 1.7985; tpu_ecc_torch/tools/bench_blocks.py,
// PERF.md).
#ifndef PROBE_THREADS
#define PROBE_THREADS 64
#endif

template <int V>
__global__ void __launch_bounds__(PROBE_THREADS, 1)
    ladder_probe_kernel(const uint32_t* __restrict__ bases, const uint32_t* __restrict__ mag,
                        const uint32_t* __restrict__ neg, uint32_t* __restrict__ out, int nw,
                        int B) {
  extern __shared__ uint32_t tbl[];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  fe32::ladder_probe_lane<Curve32, V>(bases, mag, neg, out, tbl + threadIdx.x, PROBE_THREADS,
                                      nw, B, lane);
}

// bases [3, n, B]; mag, neg [nw, 2, B]; out [3, n, B]; variant: 0 bare,
// 1 unroll, 2 build, 3 select, 4 negate.
extern "C" int ladder_probe_launch(const void* bases, const void* mag, const void* neg,
                                   void* out, int nw, int variant, int B, int* launched,
                                   void* stream) {
  typedef void (*Kernel)(const uint32_t*, const uint32_t*, const uint32_t*, uint32_t*, int,
                         int);
  static const Kernel kernels[fe32::PROBE_VARIANTS] = {
      ladder_probe_kernel<fe32::PROBE_BARE>, ladder_probe_kernel<fe32::PROBE_UNROLL>,
      ladder_probe_kernel<fe32::PROBE_BUILD>, ladder_probe_kernel<fe32::PROBE_SELECT>,
      ladder_probe_kernel<fe32::PROBE_NEGATE>};
  constexpr int smem = fe32::TBL * 3 * Curve32::N * PROBE_THREADS * (int)sizeof(uint32_t);
  *launched = 0;
  if (variant < 0 || variant >= fe32::PROBE_VARIANTS) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if constexpr (smem > 48 * 1024) {  // a build above 56 threads opts in
    const cudaError_t err = cudaFuncSetAttribute(
        kernels[variant], cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernels[variant]<<<(B + PROBE_THREADS - 1) / PROBE_THREADS, PROBE_THREADS, smem,
                     (cudaStream_t)stream>>>((const uint32_t*)bases, (const uint32_t*)mag,
                                             (const uint32_t*)neg, (uint32_t*)out, nw, B);
  *launched = 1;
  return (int)cudaGetLastError();
}
