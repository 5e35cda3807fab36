// pow: x^e for a fixed public exponent e, 4-bit windows MSB first — the
// Fermat inversion x^(p-2) (k^-1 in sign, s^-1 in verify, r^-1 in recover,
// z^-1 in to_affine) and the p = 3 (mod 4) square root x^((p+1)/4), on
// either field of the curve.
//
// Replaces tpu_ecc/ops/pallas_kernels.py pow_call (:1140-1236).
//
// Design: one thread per batch lane on the 32-bit field layer (fe32.cuh,
// point32.cuh; the lane body is fe32::pow_lane), templated on the field's
// traits: Curve32 for the base field (field 0), Scalar32 for the scalar
// field (field 1; every scalar field is Montgomery in the 13-bit plan, so
// its CIOS multiply runs with N0 != 1). The lane converts x from its
// 13-bit row once, builds its table x, x^2, .., x^15 with 14 multiplies
// into the block's shared memory, [15][N][POW_THREADS] words with the lane
// innermost (480 B a lane), and keeps x and the accumulator in registers,
// each multiply and squaring force-inlined. Per digit, MSB first: 4
// squarings, then a multiply by the table entry where the digit is not 0,
// as the TPU kernel does (:1187-1205) and kernels.fpow_plain; every step
// is exact mod p, so the result is the same element, stored once as
// canonical 13-bit limbs. The digits are public and the same for every
// lane, so the table's address and the branch are uniform over the grid:
// the shared-memory reads are free of bank conflicts and divergence.
//
// Bound: operations — per lane 14 + (nonzero digits) multiplies and 4 per
// digit squarings, about 330 multiplies at e = p - 2 (kernels.work design
// "fe32"); the bytes (x in, x^e out) are two orders smaller. B = 4096
// lanes are 128 warps, a quarter of a warp a scheduler, each waiting on
// its own dependent multiply-adds: latency, as the ladder's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_pow.cuh"
#include "point32.cuh"

// Threads a block, which __launch_bounds__ follows and the table's lane
// stride is (15 KB of shared memory a block at 32); a build may set it.
// At 32, 64 and 128 ptxas gives 0 bytes of spill (58-60 registers at 32,
// 40-48 at 64 and 128); 32 ran fastest on an H100 on three of the four
// fields, all within 2% (e = p - 2, B = 4096, ms a call at 32 / 64 / 128:
// secp256k1 fn 0.2508 / 0.2529 / 0.2551, fp 0.1858 / 0.1841 / 0.1864;
// P-256 fn 0.2246 / 0.2262 / 0.2264, fp 0.1738 / 0.1758 / 0.1753;
// tpu_ecc_torch/tools/bench_blocks.py, PERF.md).
#ifndef POW_THREADS
#define POW_THREADS 32
#endif

template <class C>
__global__ void __launch_bounds__(POW_THREADS)
    pow_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
               const uint32_t* __restrict__ digits, int ndig, int B) {
  extern __shared__ uint32_t tbl[];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  fe32::pow_lane<C>(x, out, tbl + threadIdx.x, POW_THREADS, digits, ndig, B, lane);
}

template <class C>
static int pow_run(const void* x, void* out, const void* digits, int ndig, int B,
                   cudaStream_t st) {
  constexpr int smem = 15 * C::N * POW_THREADS * (int)sizeof(uint32_t);
  void (*kernel)(const uint32_t*, uint32_t*, const uint32_t*, int, int) = pow_kernel<C>;
  if constexpr (smem > 48 * 1024) {  // a build above 96 threads opts in; 32 needs no call
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(B + POW_THREADS - 1) / POW_THREADS, POW_THREADS, smem, st>>>(
      (const uint32_t*)x, (uint32_t*)out, (const uint32_t*)digits, ndig, B);
  return 0;
}

// x, out [n, B] (13-bit rows of the field: 0 the base field, 1 the scalar
// field); digits [ndig] int32, MSB first.
extern "C" int pow_launch(const void* x, void* out, const void* digits, int ndig, int field,
                          int B, int* launched, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int err = field == 0 ? pow_run<Curve32>(x, out, digits, ndig, B, st)
                             : pow_run<Scalar32>(x, out, digits, ndig, B, st);
  if (err != 0) return err;
  *launched = 1;
  return (int)cudaGetLastError();
}
