// padd: out = a + b for a batch of points, one complete add per lane.
//
// Replaces tpu_ecc/ops/pallas_kernels.py _padd_call (:379-400), the single
// fused add behind padd_pallas (:1239), which ran the RCB formula on
// [S, 128] VMEM tiles per grid block.
//
// Design: one thread per batch lane; both points load once (limb-major
// [3, n, B], so a warp's loads of one limb are coalesced), one call of the
// generated straight-line kfe_padd (ops/kfe.py: Algorithm 7 for a = 0,
// Algorithm 4 for a = -3, ksteady out), one store. The ragged edge is
// masked. The kernel exists to pin each curve's add formula alone on the
// card: a limb mismatch in a ladder or a comb can be traced to it.
//
// Bound: operations — one add (11.2k 32-bit integer instructions for
// secp256k1, 12.6k for P-256, the generator's count) against 6n words in
// and 3n out.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_padd.cuh"

#define PN (3 * KFE_FP_N)
#define THREADS 32

__global__ void padd_kernel(const uint32_t* __restrict__ a,
                            const uint32_t* __restrict__ b,
                            uint32_t* __restrict__ out, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  uint32_t p[PN], q[PN], r[PN];
  for (int k = 0; k < PN; ++k) {
    p[k] = a[(size_t)k * B + lane];
    q[k] = b[(size_t)k * B + lane];
  }
  kfe_padd(p, q, r);
  for (int k = 0; k < PN; ++k) out[(size_t)k * B + lane] = r[k];
}

extern "C" int padd_launch(const void* a, const void* b, void* out, int B,
                           int* launched, void* stream) {
  padd_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                (cudaStream_t)stream>>>((const uint32_t*)a, (const uint32_t*)b,
                                        (uint32_t*)out, B);
  *launched = 1;
  return (int)cudaGetLastError();
}
