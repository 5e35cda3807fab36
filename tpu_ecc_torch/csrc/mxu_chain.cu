// mxu_chain: a <- a * b * R^-1 sixteen times per lane, each Montgomery
// multiply split into a data-by-data product on the CUDA cores and the
// reduction's two constant products on Hopper's warpgroup tensor-core
// product (`wgmma`, u8 x u8 -> s32) — the probe of whether the tensor cores
// can take over the Montgomery reduction of the 32-bit layer's multiply.
//
// Replaces tools/bench_mxu_mul.py bench_mxu_kernel_chain (:232-327), whose
// Pallas body (:285-299) kept the chain in VMEM and ran the two constant
// Toeplitz products on the TPU's matrix unit in 7 + 6-bit planes of 13-bit
// limbs.
//
// Design: on the 32-bit layer (fe32.cuh; the step's word-and-carry code is
// chain32.cuh), built per Montgomery field of N <= 12 words (the traits
// class Field32 of kfe.fe32_field_header). A block is one warpgroup of 128
// threads and takes MXU_LANES = 64 lanes: thread t < 64 owns lane t and
// keeps it in fe32 words in registers, loads it from its 13-bit rows once
// (R13 -> R32) and stores canonical 13-bit limbs once; threads 64-127 own
// no lane and take part in the products and the accumulators' stores
// alone. One step, x y R32^-1 with R32 = 2^(32N):
//   1. T = x y in 2N words (fe32::mul_wide): it has no shared operand, so
//      it stays on the CUDA cores. T's low half goes to shared memory as
//      the lane's 4N digit bytes: a word array is already its bytes, so no
//      split is needed.
//   2. The column sums of N' x (T mod R32): one m64n64k32 `wgmma` per k
//      step of 32 bytes; A the constant's Toeplitz matrix (rows the
//      output's byte columns, padded to 64; loaded into shared memory once
//      a block), B the lanes' digits; both K-major without swizzle, the one
//      layout 8-bit `wgmma` takes. The accumulators (s32, each sum below
//      2^22) go to shared memory, [lane][column], and each thread reads its
//      lane's back: m = the low N words of their fold.
//   3. m's bytes go back as B; the m p product (8N rows, one or two 64-row
//      tiles) the same way; the thread folds its 8N sums into u = T + m p,
//      whose high N words (below 2p) take one conditional subtraction.
// Each `wgmma` reads shared memory written by threads, so every write is
// followed by `fence.proxy.async` and a barrier of the block before the
// product; every product is waited for before its operands are rewritten.
// A lane past B runs every product on zero digits and stores nothing.
//
// Bound (kernels.mxu_step_counts): on the CUDA cores, per step and lane,
// N^2 wide products, the carries of 3N words folded from the column sums
// and one conditional subtraction; on the tensor cores the two products'
// nonzero bands, 4N (4N + 1) / 2 + 16 N^2 byte multiply-adds a lane and
// step (1552 at N = 8; the padded tiles run 4096), which at the card's
// dense int8 rate take a few hundredths of the CUDA cores' time. The round
// trips through shared memory are this kernel's cost, not the function's,
// and the row's bound is also held to the layer's own multiply on the same
// chain (kernels.designs: "cios").
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_mxu_chain.cuh"
#include "chain32.cuh"

// Lanes a block. A sweep over 64, 128 and 256 lanes a warpgroup and one or
// two warpgroups a block found 64 x 1 fastest at B = 8192 on an H100
// (device ms a call on p256.fp 0.0256 against 0.0274 at 128 lanes and
// 0.0467 at 256, two warpgroups a block 0.0340-0.0709; k256mxu.fp the
// same within 2%; PERF.md §6): 128 blocks cover 128 of the 132 SMs, and a
// thread's one lane keeps its registers at 90.
#define MXU_LANES 64

using C = Field32;
using Shape = fe32::MxuShape<C::N>;
constexpr int N = C::N;
constexpr int A1_BYTES = Shape::M1 * Shape::KB, A2_BYTES = Shape::M2 * Shape::KB;
constexpr int B_BYTES = MXU_LANES * Shape::KB;
constexpr int SMEM = A1_BYTES + A2_BYTES + B_BYTES + MXU_LANES * Shape::SS * 4;

static_assert(C::MONT, "mxu_chain runs on a Montgomery field");
static_assert(N <= 12, "mxu_chain takes fields of at most 12 words");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The matrix descriptor of a K-major operand at p without swizzle (the
// layout of fe32::mxu_offset): start address, leading byte offset 128 (the
// next 16 bytes of K), stride byte offset 8 KB (the next 8 rows), each in
// 16-byte units; base offset 0, layout type 0.
__device__ __forceinline__ uint64_t desc(const uint8_t* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4) | ((uint64_t)(128u >> 4) << 16) |
         ((uint64_t)((8u * Shape::KB) >> 4) << 32);
}

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the accumulators pinned in place around the asynchronous product
__device__ __forceinline__ void hold(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A B for one 64 x 64 tile, k = 32 bytes (scale_d 0: d = A B)
__device__ __forceinline__ void mma_u8(int (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The column sums of the constant matrix A (TILES tiles of 64 rows) times
// the lanes' digits op, rows below ROWS, to sums[lane * SS + row]. A
// thread's accumulator d[4j + e] of a 64 x 64 tile holds row 16 warp +
// lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2.
template <int TILES, int ROWS>
__device__ __forceinline__ void product(const uint8_t* A, const uint8_t* op,
                                        uint32_t* __restrict__ sums, int t) {
  const int warp = t / 32, ln = t % 32;
#pragma unroll
  for (int mt = 0; mt < TILES; ++mt) {
    int d[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0;
    hold(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < Shape::KB / 32; ++ks)
      mma_u8(d, desc(A + mt * 64 * Shape::KB + ks * 256), desc(op + ks * 256), ks);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    hold(d);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 64 * mt + 16 * warp + ln / 4 + 8 * (e >> 1);
        const int col = 8 * j + 2 * (ln % 4) + (e & 1);
        if (row < ROWS) sums[col * Shape::SS + row] = (uint32_t)d[4 * j + e];
      }
    }
  }
}

__global__ void __launch_bounds__(128)
    mxu_chain_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                     const uint4* __restrict__ tiles, uint32_t* __restrict__ out, int B) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint8_t* A1 = smem;
  const uint8_t* A2 = smem + A1_BYTES;
  uint8_t* op = smem + A1_BYTES + A2_BYTES;
  uint32_t* sums = reinterpret_cast<uint32_t*>(op + B_BYTES);
  const int t = threadIdx.x;
  for (int i = t; i < (A1_BYTES + A2_BYTES) / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] = tiles[i];
  fence_async();
  __syncthreads();

  const uint32_t Bw = (uint32_t)B;
  const int lane = blockIdx.x * MXU_LANES + t;
  const bool owner = t < MXU_LANES, live = owner && lane < B;
  fe32::E<C> x = live ? fe32::from_limbs<C>(a + lane, Bw) : fe32::zero<C>();
  const fe32::E<C> y = live ? fe32::from_limbs<C>(b + lane, Bw) : fe32::zero<C>();
  uint32_t th[N], nz = 0u;
#pragma unroll 1
  for (int step = 0; step < fe32::CHAIN; ++step) {
    if (owner) {
      uint32_t T[2 * N];
      fe32::mul_wide<N>(x, y, T);
      uint32_t any = 0u;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        any |= T[i];
        th[i] = T[N + i];
      }
      nz = any != 0u;
      fe32::mxu_put<N>(op, (uint32_t)t, T);
    }
    fence_async();
    __syncthreads();
    product<Shape::M1 / 64, 4 * N>(A1, op, sums, t);
    __syncthreads();
    if (owner) {
      uint32_t m[N];
      fe32::mxu_fold_m<N>(sums + t * Shape::SS, m);
      fe32::mxu_put<N>(op, (uint32_t)t, m);
    }
    fence_async();
    __syncthreads();
    product<Shape::M2 / 64, 8 * N>(A2, op, sums, t);
    __syncthreads();
    if (owner) x = fe32::mxu_fold_u<C>(sums + t * Shape::SS, th, nz);
  }
  if (live) fe32::to_limbs<C>(x, out + lane, Bw);
}

// a, b, out [NL, B] 13-bit rows; tiles: the N' and p matrices' bytes in the
// operand layout (kernels.mxu_tiles), M1 + M2 rows of KB bytes.
extern "C" int mxu_chain_launch(const void* a, const void* b, const void* tiles, void* out,
                                int B, int* launched, void* stream) {
  *launched = 0;
  if (B == 0) return 0;
  if (SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mxu_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  mxu_chain_kernel<<<(B + MXU_LANES - 1) / MXU_LANES, 128, SMEM, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (const uint4*)tiles, (uint32_t*)out, B);
  *launched = 1;
  return (int)cudaGetLastError();
}
