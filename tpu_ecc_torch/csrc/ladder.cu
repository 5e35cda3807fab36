// ladder: the signed-digit Straus ladder sum_h d_h * P_h — the verify
// lincomb u1*G + u2*Q (glv = 1: four 132-bit half-scalar terms on two shared
// tables), scalar_mul's single-term ladder (glv = 0, H = 1) and the Straus
// MSM (T = 8 with GLV).
//
// Replaces tpu_ecc/ops/pallas_kernels.py ladder_call (:887-1044).
//
// Design: one thread per batch lane on the 32-bit field layer (fe32.cuh,
// point32.cuh; the lane body is fe32::ladder_lane). The TPU's sequential
// window grid dimension, which carried the accumulator in VMEM scratch,
// becomes the window loop inside the thread. The lane loads its T bases
// once from the 13-bit rows, builds per base the table [O, Q, .., 8Q] with
// 7 adds into the block's shared memory, [base][entry][coordinate][word]
// [lane] with the lane innermost, so that a warp's loads of one word fall
// on 32 banks (864 B a base and lane in words; 55.3 KB at T = 2 and 32
// lanes, 221 KB at T = 8). A block takes at most 32 lanes, fewer where T
// tables of 32 lanes would not fit the 227 KB a block may opt into; the
// wrapper refuses a T whose one-lane tables do not fit. Per window: 4
// doublings, then per term a masked select over all 9 entries (every
// entry's words load whatever the digit: scalar_mul serves secret
// scalars, and a load indexed by the digit would show it in the banks'
// timing), beta * X for the odd GLV terms after the select (:991-992), a
// masked y-negation and a complete add, all force-inlined in registers.
// With H == 1 the first window seeds the accumulator from the selected
// entry instead of adding it to O (:999-1007). The result stores once,
// canonical, in 13-bit limbs. A glv launch on a curve without an
// endomorphism (P-256) is refused before it starts.
//
// Bound: operations — per window 4 doublings (1832 instructions each on
// secp256k1, 3837 on P-256, kernels.work design "fe32") and H adds (2887,
// 4274); the bases, digits and result are a few hundred bytes a lane. What
// is left between the time and the bound is latency: the verify's B = 4096
// lanes are 128 warps, one on each of 128 SMs, each waiting on its own
// dependent multiply-adds.
//
// ptxas (-Xptxas -v, sm_90a): secp256k1 255 and 228 registers (the
// instances S = 0 and 32), P-256 254, 0 bytes of stack and spill;
// chip_smoke.py prints them at each build and fails on a spill at N = 8
// words. On a curve with the generic a (the Brainpool r1 curves: 17
// multiplies an add, 16 a doubling) the build runs ptxas at -O1
// (kernels.DENSE_CHAIN_PTXAS): at -O3 bp256r1's holds 168 registers and
// spills 32 B, at -O1 148 and none (tools/bench_blocks.py ladder).
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_ladder.cuh"
#include "point32.cuh"

#define MAX_LANES 32

// One lane's work: its column of the block's tables, at lane stride S (a
// compile-time constant) or, with S = 0, blockDim.x.
template <int S>
__device__ __forceinline__ void ladder_block(const uint32_t* __restrict__ bases,
                                             const uint32_t* __restrict__ mag,
                                             const uint32_t* __restrict__ neg,
                                             uint32_t* __restrict__ out, int T, int H, int nw,
                                             int glv, int B) {
  extern __shared__ uint32_t tables[];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  fe32::ladder_lane<Curve32>(bases, mag, neg, out, tables + threadIdx.x,
                             S > 0 ? (uint32_t)S : blockDim.x, T, H, nw, glv != 0, B, lane);
}

// Each field's build takes the form that ran fastest on an H100, both with
// 0 bytes of spill (tools/bench_ladder_forms.py times all four; PERF.md):
//   - solinas (secp256k1): at least 1 block an SM, and for full blocks (T
//     <= 8) the lane stride MAX_LANES as a constant, so that each table word
//     loads at an immediate offset: 2.42 ms against 2.65 with the stride in
//     a register. Without the minimum, ptxas held the build to 168
//     registers and spilled 16-24 B;
//   - Montgomery (P-256): no minimum, the stride in a register (254
//     registers): 5.89 ms against 7.59 in the solinas form, whose
//     constant-stride instance ptxas held to 203 registers.
template <int S>
__global__ void __launch_bounds__(MAX_LANES, 1)
    ladder_kernel(const uint32_t* __restrict__ bases, const uint32_t* __restrict__ mag,
                  const uint32_t* __restrict__ neg, uint32_t* __restrict__ out, int T,
                  int H, int nw, int glv, int B) {
  ladder_block<S>(bases, mag, neg, out, T, H, nw, glv, B);
}

template <int S>
__global__ void __launch_bounds__(MAX_LANES)
    ladder_mont_kernel(const uint32_t* __restrict__ bases, const uint32_t* __restrict__ mag,
                       const uint32_t* __restrict__ neg, uint32_t* __restrict__ out, int T,
                       int H, int nw, int glv, int B) {
  ladder_block<S>(bases, mag, neg, out, T, H, nw, glv, B);
}

typedef void (*ladder_fn)(const uint32_t*, const uint32_t*, const uint32_t*, uint32_t*, int,
                          int, int, int, int);

template <class C>
static ladder_fn ladder_form(int lanes) {
  if constexpr (C::MONT) {
    return ladder_mont_kernel<0>;
  } else {
    return lanes == MAX_LANES ? ladder_kernel<MAX_LANES> : ladder_kernel<0>;
  }
}

// bases [T, 3, n, B]; mag, neg [nw, H, B]; out [3, n, B]; `lanes` a block
// (kernels.ladder_lanes: at most 32, with T * 9 * 3N words * lanes of
// shared memory: 864 B a base and lane at N = 8, 3672 B at P-521's 17).
extern "C" int ladder_launch(const void* bases, const void* mag, const void* neg, void* out,
                             int T, int H, int nw, int glv, int B, int lanes, int* launched,
                             void* stream) {
  *launched = 0;
  if ((glv && !Curve32::HAS_BETA) || lanes < 1 || lanes > MAX_LANES)
    return (int)cudaErrorInvalidValue;  // glv: the curve has no endomorphism
  const size_t smem = (size_t)T * fe32::TBL * 3 * Curve32::N * sizeof(uint32_t) * lanes;
  const ladder_fn kernel = ladder_form<Curve32>(lanes);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(B + lanes - 1) / lanes, lanes, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)bases, (const uint32_t*)mag, (const uint32_t*)neg, (uint32_t*)out, T,
      H, nw, glv, B);
  *launched = 1;
  return (int)cudaGetLastError();
}
