// genmul: the constant-time fixed-base comb k*G — the ECDSA sign nonce
// point and public-key derivation d*G (scalarmul.mul_by_generator).
//
// Replaces tpu_ecc/ops/pallas_kernels.py genmul_call (:1048-1136).
//
// Design: one thread per batch lane on the 32-bit field layer (fe32.cuh,
// point32.cuh; the lane body is fe32::genmul_lane). The TPU's sequential
// window grid dimension, which carried the accumulator in VMEM scratch,
// becomes the window loop inside the thread, which keeps the accumulator
// in registers and writes only the result. Table row j holds the affine
// points d * 16^j * G for d = 0..8 (entry 0 a dummy), the same for every
// lane. In a prologue each block converts the 13-bit rows once into
// canonical words in its shared memory (fe32::genmul_table: 65 rows * 9 *
// 2 * 8 words = 37.4 KB, against 93.6 KB of 13-bit limbs for secp256k1),
// about 37 coordinates a thread, so the window loop reads no 13-bit row and
// maps no domain. Windows run LSB first; per window:
//   1. a masked select over all 9 entries, comparing each with the digit:
//      never a load indexed by the digit and never a branch on it, since k
//      and d are secret. Every lane of a warp reads the same words, one
//      shared-memory broadcast each;
//   2. y or its negation, selected by the sign mask;
//   3. one complete mixed add (RCB 2015 Algorithm 8 or 5), force-inlined;
//   4. acc = digit == 0 ? acc : new, a select (entry 0 is the dummy).
//
// Bound: operations — per window one mixed add (2553 instructions on
// secp256k1, 3880 on P-256, kernels.work design "fe32") and the 9-entry
// select; the digits and result are a few hundred bytes a lane. As for the
// ladder, the sign's B = 4096 lanes are 128 warps, one an SM: latency-bound.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_genmul.cuh"
#include "point32.cuh"

// 32 threads a block, at least 1 block an SM: ptxas then takes 198
// (secp256k1) and 225 (P-256) registers (chip_smoke.py prints them), 0
// bytes of stack and spill
#define THREADS 32

__global__ void __launch_bounds__(THREADS, 1)
    genmul_kernel(const uint32_t* __restrict__ tbl, const uint32_t* __restrict__ mag,
                  const uint32_t* __restrict__ neg, uint32_t* __restrict__ out, int nw,
                  int B) {
  extern __shared__ uint32_t comb[];
  fe32::genmul_table<Curve32>(tbl, comb, nw * fe32::TBL * 2, threadIdx.x, blockDim.x);
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  fe32::genmul_lane<Curve32>(comb, mag, neg, out, nw, B, lane);
}

// tbl [nw, 9, 2, n] affine table; mag, neg [nw, B] LSB window first;
// out [3, n, B].
extern "C" int genmul_launch(const void* tbl, const void* mag, const void* neg, void* out,
                             int nw, int B, int* launched, void* stream) {
  *launched = 0;
  const size_t smem = (size_t)nw * fe32::TBL * 2 * Curve32::N * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(genmul_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  genmul_kernel<<<(B + THREADS - 1) / THREADS, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)tbl, (const uint32_t*)mag, (const uint32_t*)neg, (uint32_t*)out, nw,
      B);
  *launched = 1;
  return (int)cudaGetLastError();
}
