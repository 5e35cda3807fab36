// pdouble: out = 2a for a batch of points, one doubling per lane.
//
// Replaces tpu_ecc/ops/pallas_kernels.py _pdouble_call (:403-423), the
// single fused doubling behind pdouble_pallas (:1251).
//
// Design: one thread per batch lane; the point loads once (limb-major
// [3, n, B], coalesced per limb), one call of the generated straight-line
// kfe_pdouble (ops/kfe.py: Algorithm 9 for a = 0, Algorithm 6 for a = -3,
// ksteady out), one store; the ragged edge is masked. Like padd, it pins
// one formula alone on the card.
//
// Bound: operations — one doubling (6.6k 32-bit integer instructions for
// secp256k1, 11.3k for P-256, the generator's count) against 3n words in
// and 3n out.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_pdouble.cuh"

#define PN (3 * KFE_FP_N)
#define THREADS 32

__global__ void pdouble_kernel(const uint32_t* __restrict__ a,
                               uint32_t* __restrict__ out, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  uint32_t p[PN], r[PN];
  for (int k = 0; k < PN; ++k) p[k] = a[(size_t)k * B + lane];
  kfe_pdouble(p, r);
  for (int k = 0; k < PN; ++k) out[(size_t)k * B + lane] = r[k];
}

extern "C" int pdouble_launch(const void* a, void* out, int B, int* launched,
                              void* stream) {
  pdouble_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                   (cudaStream_t)stream>>>((const uint32_t*)a, (uint32_t*)out, B);
  *launched = 1;
  return (int)cudaGetLastError();
}
