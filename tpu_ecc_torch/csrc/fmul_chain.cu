// fmul_chain: a <- a * b sixteen times per lane on the CUDA cores — the
// field-multiply baseline that the int8 tensor-core chain (mxu_chain.cu) is
// measured against.
//
// Replaces the KFE 16-mul chain in tools/bench_mxu_mul.py main (:118, its
// body :173-183), which ran A <- ksteady(kmul(A, B)) 16 times in one Pallas
// kernel on [S, 128] VMEM tiles.
//
// Design: one thread per batch lane. a and b load into registers once
// (limb-major [n, B], so a warp's loads of one limb are coalesced), the
// generated straight-line kfe_fp_mul (ops/kfe.py: steady in, ksteady out,
// the field's own reduction — solinas fold or word-by-word Montgomery) runs
// 16 times from one call site, and only the result is written back. Built
// per field: P-256's, secp256k1's, and secp256k1's forced onto Montgomery.
//
// Bound: operations — 16 multiplies of the generator's count each (692
// 32-bit integer instructions on secp256k1's field, 776 on P-256's, 965 on
// the forced-Montgomery secp256k1 field, mostly multiply-adds), against
// 3 n words of memory per lane.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_fmul_chain.cuh"

#define N KFE_FP_N
#define CHAIN 16
#define THREADS 32

__global__ void fmul_chain_kernel(const uint32_t* __restrict__ a,
                                  const uint32_t* __restrict__ b,
                                  uint32_t* __restrict__ out, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  uint32_t acc[N], y[N], nxt[N];
  for (int i = 0; i < N; ++i) {
    acc[i] = a[(size_t)i * B + lane];
    y[i] = b[(size_t)i * B + lane];
  }
#pragma unroll 1
  for (int r = 0; r < CHAIN; ++r) {
    kfe_fp_mul(acc, y, nxt);
    for (int i = 0; i < N; ++i) acc[i] = nxt[i];
  }
  for (int i = 0; i < N; ++i) out[(size_t)i * B + lane] = acc[i];
}

// a, b, out [n, B] limbs.
extern "C" int fmul_chain_launch(const void* a, const void* b, void* out,
                                 int B, int* launched, void* stream) {
  *launched = 0;
  if (B == 0) return 0;
  fmul_chain_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, B);
  *launched = 1;
  return (int)cudaGetLastError();
}
