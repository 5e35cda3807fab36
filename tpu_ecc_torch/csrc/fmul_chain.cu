// fmul_chain: a <- a * b sixteen times per lane on the CUDA cores, by the
// 32-bit layer's own `mul` — the multiply under every other kernel of the
// port, and the yardstick of the tensor-core chain (mxu_chain.cu).
//
// Replaces the KFE 16-mul chain in tools/bench_mxu_mul.py main (:118, its
// body :173-183), which ran A <- ksteady(kmul(A, B)) 16 times in one Pallas
// kernel on [S, 128] VMEM tiles.
//
// Design: one thread per batch lane on the 32-bit layer (fe32.cuh; the lane
// body is fe32::fmul_chain_lane, chain32.cuh), built per bare field (the
// traits class Field32 of kfe.fe32_field_header): P-256's, secp256k1's, and
// secp256k1's forced onto Montgomery. a and b load from their 13-bit rows
// once (limb-major [NL, B], so a warp's loads of one limb are coalesced),
// the force-inlined `mul` runs 16 times from one call site (`#pragma unroll
// 1`: the loop body is one multiply, solinas fold or CIOS), and the result
// stores once as canonical 13-bit limbs. On a Montgomery field each product
// carries R32^-1 where the 13-bit plan's carries R13^-1; the boundary maps
// R13 to R32 on load and back on store, so the value is the tool's mod p.
//
// Bound: operations — 16 multiplies of the layer's count each (kfe.
// fe32_counts: 75 IMAD.WIDE.U32 and 121 others on secp256k1's field, 64 and
// 194 on P-256's, 80 and 210 on the forced-Montgomery field), two loads and
// a store a lane, against 3 NL words of memory a lane.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_fmul_chain.cuh"
#include "chain32.cuh"

// Threads a block, which __launch_bounds__ follows; a build may set it.
// At B = 8192 on an H100 the three fields ran within 3% at 32, 64 and 128
// threads and 64 was fastest or tied on each; ptxas's default -O3 beat -O1
// by 24-33% (device ms a call at 32 / 64 / 128 threads, -O3: secp256k1.fp
// 0.0105 / 0.0102 / 0.0102, p256.fp 0.0114 / 0.0113 / 0.0114, k256mxu.fp
// 0.0140 / 0.0139 / 0.0139; -O1 0.0135-0.0183; 0 B of spill in every form;
// tpu_ecc_torch/tools/bench_blocks.py, PERF.md).
#ifndef FMUL_THREADS
#define FMUL_THREADS 64
#endif

__global__ void __launch_bounds__(FMUL_THREADS)
    fmul_chain_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                      uint32_t* __restrict__ out, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  fe32::fmul_chain_lane<Field32>(a, b, out, B, lane);
}

// a, b, out [NL, B] 13-bit rows.
extern "C" int fmul_chain_launch(const void* a, const void* b, void* out, int B,
                                 int* launched, void* stream) {
  *launched = 0;
  if (B == 0) return 0;
  fmul_chain_kernel<<<(B + FMUL_THREADS - 1) / FMUL_THREADS, FMUL_THREADS, 0,
                      (cudaStream_t)stream>>>((const uint32_t*)a, (const uint32_t*)b,
                                              (uint32_t*)out, B);
  *launched = 1;
  return (int)cudaGetLastError();
}
