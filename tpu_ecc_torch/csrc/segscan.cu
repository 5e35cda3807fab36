// segscan: the per-lane segmented scan of the bucketed Pippenger MSM — each
// of L lanes accumulates its chunk of C digit-sorted points, restarting the
// sum wherever the bucket key changes (parallel/msm.py, step 3).
//
// Replaces tpu_ecc/ops/pallas_kernels.py segscan_call (:463-597).
//
// Design: one thread per lane on the 32-bit field layer (fe32.cuh,
// point32.cuh; the lane body is fe32::segscan_lane). The TPU's sequential
// row-chunk grid axis, which carried the running sum and the previous key
// in VMEM scratch, becomes the row loop inside the thread; the sum (24
// registers) stays in the thread for the whole chunk. Per row r:
//   1. the row's 60 words load coalesced (arrays [C, .., L], lane fastest)
//      and convert to 8 words a coordinate;
//   2. signed mode: y of a point whose digit was negative becomes p - y, a
//      select and never a branch on the sign;
//   3. key == previous key: acc = padd(acc, v) (force-inlined); else
//      acc = v. The previous key starts at the sentinel nbuck, which in
//      signed mode is also the key of a zero digit: such a lane's first row
//      computes padd(O, v), as the TPU kernel and the XLA scan do. The add
//      is skipped where the key changed: keys are public;
//   4. only where row r ends a run (key[r + 1] != key[r], or r = C - 1),
//      the one row bucket_lookup reads, acc is stored to scanned[r], and to
//      lead if the key is the lane's first. The other rows of scanned are
//      left unwritten.
// Stores are canonical 13-bit limbs; last_key, tail, lead as before.
//
// Bound: operations — one complete add per row whose key repeats (2.9k
// instructions in this design's count, 11.2k in the 13-bit one before it,
// which called every multiply out of line through local memory) against
// 240 B read per row; the bytes are about 70% as long at the card's rate.
// The stores fell from every row to the run ends: 1 row in 68 at 2^20
// points, 8192 buckets a window, 8192 lanes.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8): 254 registers, 0 bytes of stack,
// spill stores and spill loads; with 64-bit row offsets it spilled 72 B
// (the hoisted addresses of the tail stores), hence the 32-bit offsets.
// On the 8-word curves with a != 0 (the a = -3 and generic-a adds) -O3
// takes 255 registers and spills 16-64 B; those builds run ptxas at -O1
// (194-244 registers, no spill; kernels.DENSE_CHAIN_PTXAS).
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_segscan.cuh"
#include "point32.cuh"

// 128 threads a block. Launched at 32, 64 and 128 under
// __launch_bounds__(128), the times on an H100 stayed within 4% of one
// another; built under __launch_bounds__(64) (252 registers, not 254),
// the kernel ran 8% slower (PERF.md)
#define THREADS 128

__global__ void __launch_bounds__(THREADS)
    segscan_kernel(const uint32_t* __restrict__ key2, const uint32_t* __restrict__ val2,
                   const uint32_t* __restrict__ neg2, uint32_t* __restrict__ scanned,
                   uint32_t* __restrict__ last_key, uint32_t* __restrict__ tail,
                   uint32_t* __restrict__ lead, int C, int L, uint32_t nbuck) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  fe32::segscan_lane<Curve32>(key2, val2, neg2, scanned, last_key, tail, lead, C, L,
                              nbuck, lane);
}

// key2 [C, L]; val2 [C, 3, n, L]; neg2 [C, L] or null (unsigned digits);
// scanned [C, 3, n, L] (run-end rows written); last_key [L]; tail, lead
// [3, n, L].
extern "C" int segscan_launch(const void* key2, const void* val2,
                              const void* neg2, void* scanned, void* last_key,
                              void* tail, void* lead, int C, int L, int nbuck,
                              int* launched, void* stream) {
  segscan_kernel<<<(L + THREADS - 1) / THREADS, THREADS, 0,
                   (cudaStream_t)stream>>>(
      (const uint32_t*)key2, (const uint32_t*)val2, (const uint32_t*)neg2,
      (uint32_t*)scanned, (uint32_t*)last_key, (uint32_t*)tail,
      (uint32_t*)lead, C, L, (uint32_t)nbuck);
  *launched = 1;
  return (int)cudaGetLastError();
}
