// bucket_reduce: the weighted bucket sum of the bucketed Pippenger MSM,
// sum_b b * S_b as a guarded suffix scan followed by the sum of all the
// suffixes (parallel/msm.py, step 8).
//
// Replaces tpu_ecc/ops/pallas_kernels.py bucket_reduce_call (:733-810).
//
// Design: the TPU's sequential grid of 2 * log2(nbuck) steps over one VMEM
// array becomes one launch per step, ping-ponging between two scratch
// buffers (bucket b reads bucket b + s while that one is being written).
// Several windows go side by side, nbuck buckets each; no read crosses a
// window's end.
//   suffix phase, s = 1, 2, .., nbuck/2: v'[b] = ksteady(padd(v[b],
//     v[b + s])) where b + s is in b's window, else v'[b] = v[b]; one thread
//     per bucket;
//   drop0 (unsigned digits, where bucket 0 holds digit 0): each window's
//     bucket 0 reads as O in the first step of the total phase, not in a
//     launch of its own;
//   total phase: the TPU ran a circular all-reduce, v'[b] = ksteady(padd(
//     v[b], v[(b + s) mod nbuck])) for every b, and read bucket 0. At shift
//     s bucket 0's result needs only the buckets that are multiples of 2s,
//     which read multiples of s and never wrap, so each step here keeps
//     just those: v'[t] = ksteady(padd(v[2t], v[2t + 1])) over a buffer
//     that halves, nbuck - 1 adds per window instead of nbuck * log2(nbuck),
//     with bucket 0's limbs unchanged.
// nbuck is a power of two. 2 * log2(nbuck) launches per call, whatever the
// number of windows.
//
// Bound: operations — (nbuck - s) adds per window and suffix step and
// nbuck - 1 per window in the total phase; the bytes (the buckets in, one
// point per window out) are three orders smaller. At nbuck = 8192 and one
// window a suffix step is about two warps per SM, so a launch takes about
// one add's latency; more windows side by side fill the card.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_bucket_reduce.cuh"

#define N KFE_FP_N
#define PN (3 * N)
#define THREADS 32

// p = src[.., b] of an array [3n, width], or O
__device__ static void load_point(const uint32_t* src, int b, int width,
                                  bool as_identity, uint32_t* p) {
  if (as_identity) {
    kfe_fp_one(p + N);  // the identity (0 : 1 : 0)
    for (int i = 0; i < N; ++i) {
      p[i] = 0u;
      p[2 * N + i] = 0u;
    }
  } else {
    for (int j = 0; j < PN; ++j) p[j] = src[(size_t)j * width + b];
  }
}

// src, dst [3n, groups * nbuck]
__global__ void bucket_reduce_suffix_kernel(const uint32_t* __restrict__ src,
                                            uint32_t* __restrict__ dst, int s,
                                            int nbuck, int total) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= total) return;
  uint32_t a[PN], c[PN], nxt[PN];
  load_point(src, b, total, false, a);
  if ((b & (nbuck - 1)) + s < nbuck) {
    load_point(src, b + s, total, false, c);
    kfe_padd(a, c, nxt);
    for (int j = 0; j < PN; ++j) a[j] = nxt[j];
  }
  for (int j = 0; j < PN; ++j) dst[(size_t)j * total + b] = a[j];
}

// src [3n, groups * width] -> dst [3n, groups * width / 2],
// dst[t] = src[2t] + src[2t + 1]; zero0: each window's first bucket reads
// as O.
__global__ void bucket_reduce_total_kernel(const uint32_t* __restrict__ src,
                                           uint32_t* __restrict__ dst, int width,
                                           int total, int zero0) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int half = total / 2;
  if (t >= half) return;
  uint32_t a[PN], c[PN], nxt[PN];
  load_point(src, 2 * t, total, zero0 && (2 * t) % width == 0, a);
  load_point(src, 2 * t + 1, total, false, c);
  kfe_padd(a, c, nxt);
  for (int j = 0; j < PN; ++j) dst[(size_t)j * half + t] = nxt[j];
}

// buckets [3, n, groups, nbuck]; out [3, n, groups]; buf: scratch of
// 2 * 3n * groups * nbuck words. Counts its launches in *launched.
extern "C" int bucket_reduce_launch(const void* buckets, void* out, void* buf,
                                    int nbuck, int groups, int drop0,
                                    int* launched, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int total = groups * nbuck;
  const uint32_t* src = (const uint32_t*)buckets;
  uint32_t* bufs[2] = {(uint32_t*)buf, (uint32_t*)buf + (size_t)PN * total};
  int k = 0;
  for (int s = 1; s < nbuck; s *= 2, ++k) {
    uint32_t* dst = bufs[k & 1];
    bucket_reduce_suffix_kernel<<<(total + THREADS - 1) / THREADS, THREADS, 0,
                                  st>>>(src, dst, s, nbuck, total);
    ++*launched;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  for (int width = nbuck; width > 1; width /= 2, ++k) {
    const int len = groups * width;
    uint32_t* dst = width == 2 ? (uint32_t*)out : bufs[k & 1];
    bucket_reduce_total_kernel<<<(len / 2 + THREADS - 1) / THREADS, THREADS, 0,
                                 st>>>(src, dst, width, len,
                                       drop0 && width == nbuck);
    ++*launched;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  return 0;
}
