// padd_chain: out = a + repeat*b for a batch of points — the batched
// point-add workload and the headline point-adds/s.
//
// Replaces tpu_ecc/ops/pallas_kernels.py padd_chain_call (:426-459), which
// ran the chain on [S, 128] VMEM tiles per grid block. At repeat = 1 it is
// also `padd` (kernels.padd launches this library and counts the launch as
// padd's), replacing _padd_call (:379-400), the single fused add behind
// padd_pallas (:1239): one build a curve serves both, and the add alone on
// the card is the chain's own.
//
// Design: one thread per batch lane on the 32-bit field layer (fe32.cuh,
// point32.cuh; the lane body is fe32::padd_chain_lane). The lane loads its
// two points once from the 13-bit rows (limb-major [3, n, B], so a warp's
// loads of one limb are coalesced) and converts them to 8 words a
// coordinate, runs the repeat loop on the force-inlined RCB add, and stores
// the result once, canonical, in 13-bit limbs. acc and q are 48 registers;
// no field operation is a call, so nvcc interleaves the independent
// products (X1X2, Y1Y2, Z1Z2, ...) and nothing goes through the stack.
//
// Bound: operations. A lane moves 9 * n words but runs `repeat` adds: 14
// field multiplies (2 of them by b or 3b) of 64 wide products each plus
// the reduction (secp256k1 folds by 2^32 + 977, P-256 runs CIOS), so the
// multiply pipe and the issue rate, not memory, limit it (kernels.work,
// design "fe32": 2.9k instructions an add on secp256k1, 4.3k on P-256;
// the SASS has about twice that, the carries through 64-bit C arithmetic).
// What is left between the time and the bound is latency: at B = 8192 the
// 256 warps are fewer than the card's 528 schedulers, and each waits on
// its own chain of dependent multiply-adds. The 13-bit design before it
// called each multiply out of line through local memory (3.6 KB of stack
// a thread) and ran 11.2k (secp256k1) or 12.6k (P-256) instructions an
// add.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8): 188 registers (secp256k1), 168
// (P-256), 0 bytes of stack, spill stores and spill loads; chip_smoke.py
// prints them at each build and fails on a spill at N = 8 words. On a curve
// whose base field rows load by two Montgomery products (the Brainpool
// fields: every word of p dense, N0 != 1) the build runs ptxas at -O1
// (kernels.DENSE_CHAIN_PTXAS): at -O3 bp256t1's add takes 255 registers
// and spills 28 B, at -O1 239 and none, as fast; the other curves build at
// -O3, where secp256k1's chain is 7.5% faster than at -O1
// (tools/bench_blocks.py padd_chain).
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_padd_chain.cuh"
#include "point32.cuh"

// 32 threads a block spread B = 8192 lanes over the most SMs; 64 and 128
// measured within 2.3% of it on an H100 (PERF.md)
#define THREADS 32

__global__ void __launch_bounds__(THREADS)
    padd_chain_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                      uint32_t* __restrict__ out, int B, int repeat) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  fe32::padd_chain_lane<Curve32>(a, b, out, B, lane, repeat);
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
