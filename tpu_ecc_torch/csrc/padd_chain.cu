// padd_chain: out = a + repeat*b for a batch of points, a steady clamp after
// every add — the batched point-add workload.
//
// Replaces tpu_ecc/ops/pallas_kernels.py padd_chain_call (:426-459), which
// ran the chain on [S, 128] VMEM tiles per grid block.
//
// Design: one thread per batch lane. Both points load into registers once
// (limb-major [3, n, B] layout, so a warp's loads of one limb are
// coalesced), the repeat loop runs inside the thread, and only the result is
// written back. The add is the generated straight-line kfe_padd
// (ops/kfe.py), called from one site inside a `#pragma unroll 1` loop so it
// is compiled once.
//
// Bound: operations. A lane moves 3 * 3n words but runs `repeat` adds of
// ~18.7k 32-bit integer operations each (the generator's count), so the
// int32 issue rate, not memory, limits it. A k256 point is 60 words and the
// convolution has 39 columns; the point arrays passed to the out-of-line
// field functions live in local memory (a 3.6 KB stack frame per thread).
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_padd_chain.cuh"

#define PN (3 * KFE_FP_N)
#define THREADS 32

__global__ void padd_chain_kernel(const uint32_t* __restrict__ a,
                                  const uint32_t* __restrict__ b,
                                  uint32_t* __restrict__ out, int B,
                                  int repeat) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  uint32_t acc[PN], q[PN], nxt[PN];
  for (int k = 0; k < PN; ++k) {
    acc[k] = a[(size_t)k * B + lane];
    q[k] = b[(size_t)k * B + lane];
  }
#pragma unroll 1
  for (int r = 0; r < repeat; ++r) {
    kfe_padd(acc, q, nxt);
    for (int k = 0; k < PN; ++k) acc[k] = nxt[k];
  }
  for (int k = 0; k < PN; ++k) out[(size_t)k * B + lane] = acc[k];
}

extern "C" int padd_chain_launch(const void* a, const void* b, void* out,
                                 int B, int repeat, int* launched,
                                 void* stream) {
  padd_chain_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, B, repeat);
  *launched = 1;
  return (int)cudaGetLastError();
}
