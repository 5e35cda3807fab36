// pdouble: out = 2a for a batch of points, one doubling per lane.
//
// Replaces tpu_ecc/ops/pallas_kernels.py _pdouble_call (:403-423), the
// single fused doubling behind pdouble_pallas (:1251).
//
// Design: one thread per batch lane on the 32-bit field layer (fe32.cuh,
// point32.cuh), at the curve's own word count. The lane loads its point
// once from the 13-bit rows (limb-major [3, n, B], coalesced per limb) into
// words in registers, runs one force-inlined RCB doubling (Algorithm 9 for
// a = 0, 6 for a = -3), and stores the result once, canonical, in 13-bit
// limbs: each coordinate equal mod p to the plain twin's. The ragged edge
// is masked. Like padd, it pins one formula alone on the card.
//
// Bound: operations (one doubling, kernels.work design "fe32": 1832
// instructions on secp256k1, 3837 on P-256, 8381 on P-384, 9238 on P-521,
// plus the three loads and three stores) against bytes (6 n int32 limbs a
// lane in and out). A single launch at B = 8192 is 256
// warps, under one a scheduler: its time is the launch and one doubling's
// latency.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_pdouble.cuh"
#include "point32.cuh"

#define THREADS 32

__global__ void __launch_bounds__(THREADS)
    pdouble_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const uint32_t Bw = (uint32_t)B;
  fe32::store_point<Curve32>(fe32::pdouble<Curve32>(fe32::load_point<Curve32>(a + lane, Bw)),
                             out + lane, Bw);
}

extern "C" int pdouble_launch(const void* a, void* out, int B, int* launched,
                              void* stream) {
  pdouble_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                   (cudaStream_t)stream>>>((const uint32_t*)a, (uint32_t*)out, B);
  *launched = 1;
  return (int)cudaGetLastError();
}
