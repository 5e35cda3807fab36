// bucket_reduce: the weighted bucket sum of the bucketed Pippenger MSM,
// sum_b b * S_b as a guarded suffix scan followed by the sum of all the
// suffixes (parallel/msm.py, step 8).
//
// Replaces tpu_ecc/ops/pallas_kernels.py bucket_reduce_call (:733-810).
//
// Design: the TPU's sequential grid of 2 * log2(nbuck) steps over one VMEM
// array becomes one launch per step (the launch boundary is the barrier
// across all buckets), ping-ponging between two scratch buffers (bucket b
// reads bucket b + s while that one is being written). Several windows go
// side by side, nbuck buckets each; no read crosses a window's end.
//   suffix phase, s = 1, 2, .., nbuck/2: v'[b] = v[b] + v[b + s] where
//     b + s is in b's window, else v'[b] = v[b]; one thread per bucket;
//   drop0 (unsigned digits, where bucket 0 holds digit 0): each window's
//     bucket 0 reads as O in the first step of the total phase, not in a
//     launch of its own;
//   total phase: the TPU ran a circular all-reduce, v'[b] = v[b] +
//     v[(b + s) mod nbuck] for every b, and read bucket 0. At shift s
//     bucket 0's result needs only the buckets that are multiples of 2s,
//     which read multiples of s and never wrap, so each step here keeps
//     just those: v'[t] = v[2t] + v[2t + 1] over a buffer that halves,
//     nbuck - 1 adds per window instead of nbuck * log2(nbuck).
// Each step is one lane body of the 32-bit field layer (fe32.cuh,
// point32.cuh: fe32::bucket_suffix_lane, fe32::bucket_pair_lane), the add
// force-inlined in registers. Between steps the buckets stay canonical
// words, [3N][groups * nbuck] with the bucket innermost (96 B a point
// against the 240 B of a 13-bit row): the two buffers of 8 windows are
// 2 * 8 * 8192 * 96 B = 12.6 MB, within the card's 50 MB L2. Only the
// first step converts from the 13-bit rows, and only the last stores them.
//
// Why the algorithm and its order of adds stay: the scan's depth, 2 *
// log2(nbuck) = 26 dependent adds at nbuck = 8192, sets its floor (an
// add's latency in one thread is about 10.8 us on an H100). A per-thread
// running sum with recursive chunk totals, or a Blelloch scan, does about
// 6x fewer adds but is no shallower (about 2c adds per level of chunk size
// c); and a different order of adds would give projective coordinates
// that no longer equal, mod p, the twin's and tpu_ecc's.
//
// Bound: operations — (nbuck - s) adds per window and suffix step and
// nbuck - 1 per window in the total phase; the bytes (the buckets in, one
// point per window out) are three orders smaller. A suffix step of 8
// windows at nbuck = 8192 is 2048 warps (3.9 a scheduler), of which an SM
// holds 12 at a time at these registers; the tree's narrow steps take
// about one add's latency each.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8): 139-167 registers over the four
// instances, 0 bytes of stack, spill stores and spill loads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_bucket_reduce.cuh"
#include "point32.cuh"

// Threads a block, which __launch_bounds__ follows; a build may set it.
// At 32, 64 and 128 ptxas gives the same 139-167 registers and 0 bytes of
// spill; 128 ran fastest on an H100 (8 windows: 0.525 ms a call against
// 0.554 and 0.578; 3 windows 0.326 against 0.332 and 0.335;
// tpu_ecc_torch/tools/bench_blocks.py, PERF.md)
#ifndef BUCKET_THREADS
#define BUCKET_THREADS 128
#endif
#define THREADS BUCKET_THREADS

// src: 13-bit rows [3, n, total] (ROWS) or words [3N, total]; dst words
template <bool ROWS>
__global__ void __launch_bounds__(THREADS)
    bucket_reduce_suffix_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                                uint32_t s, uint32_t nbuck, uint32_t total) {
  const uint32_t b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= total) return;
  fe32::bucket_suffix_lane<Curve32, ROWS>(src, dst, s, nbuck, total, b);
}

// src words [3N, len] -> dst words [3N, len / 2], or 13-bit rows (ROWS)
template <bool ROWS>
__global__ void __launch_bounds__(THREADS)
    bucket_reduce_pair_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                              uint32_t width, uint32_t len, int zero0) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= len / 2) return;
  fe32::bucket_pair_lane<Curve32, ROWS>(src, dst, width, len, zero0 != 0, t);
}

static unsigned blocks(uint32_t threads) { return (threads + THREADS - 1) / THREADS; }

// buckets [3, n, groups, nbuck]; out [3, n, groups]; buf: scratch of
// 2 * 3N * groups * nbuck words. Counts its launches in *launched.
extern "C" int bucket_reduce_launch(const void* buckets, void* out, void* buf, int nbuck,
                                    int groups, int drop0, int* launched, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const uint32_t nb = (uint32_t)nbuck, total = (uint32_t)groups * nb;
  uint32_t* bufs[2] = {(uint32_t*)buf, (uint32_t*)buf + (size_t)3 * Curve32::N * total};
  const uint32_t* src = (const uint32_t*)buckets;
  int k = 0;
  for (uint32_t s = 1; s < nb; s *= 2, ++k) {
    uint32_t* dst = bufs[k & 1];
    if (s == 1) {
      bucket_reduce_suffix_kernel<true><<<blocks(total), THREADS, 0, st>>>(src, dst, s, nb,
                                                                           total);
    } else {
      bucket_reduce_suffix_kernel<false><<<blocks(total), THREADS, 0, st>>>(src, dst, s, nb,
                                                                            total);
    }
    ++*launched;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  for (uint32_t width = nb; width > 1; width /= 2, ++k) {
    const uint32_t len = (uint32_t)groups * width;
    const int zero0 = drop0 && width == nb;
    uint32_t* dst = width == 2 ? (uint32_t*)out : bufs[k & 1];
    if (width == 2) {
      bucket_reduce_pair_kernel<true><<<blocks(len / 2), THREADS, 0, st>>>(src, dst, width,
                                                                          len, zero0);
    } else {
      bucket_reduce_pair_kernel<false><<<blocks(len / 2), THREADS, 0, st>>>(src, dst, width,
                                                                           len, zero0);
    }
    ++*launched;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  return 0;
}
