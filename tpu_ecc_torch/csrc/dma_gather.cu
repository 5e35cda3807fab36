// dma_gather: the XOR of M payload rows chosen by idx, each row fetched by an
// asynchronous bulk copy of its own — a probe of the per-row copy issue
// rate, the ceiling of a gather fused into segscan.
//
// Replaces tools/bench_gather_probe.py dma_gather_call (:82-145), which
// issued one TPU DMA descriptor per row, `depth` deep, over a sequential
// grid of M / Cb chunks with the indices in scalar prefetch.
//
// Design: one block per chunk of Cb indices; the blocks run in parallel in
// any order. The block first loads its own Cb indices into shared memory
// (scalar prefetch has no counterpart on the card). It keeps a ring of
// `depth` row slots in shared memory, each with its own mbarrier. Thread 0
// issues one `cp.async.bulk` global -> shared copy of W * 4 bytes per row
// (the Hopper counterpart of one DMA descriptor), announced to the slot's
// mbarrier with expect_tx; every thread waits on the slot's phase, XORs its
// word of the row into a register, and after a block barrier (the slot is
// free again) thread 0 issues the row `depth` places further on into it.
// At the end one atomicXor per word folds the block into the zeroed [1, W]
// output: XOR is order-free, so the result is exact in any block order.
//
// Bound: bytes — M * W * 4 bytes of rows and 4 M of indices; the XORs are
// one integer operation per word. What the probe measures is how far the
// copy issue rate of `depth` copies in flight per block falls short of it.
#include <cuda_runtime.h>
#include <stdint.h>

__device__ static inline uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ static inline void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ static inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ static inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        "  .reg .pred p;\n"
        "  mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "  selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// one row, global -> shared, completing on `bar` (bytes: a multiple of 16)
__device__ static inline void bulk_copy(void* dst, const void* src,
                                        uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__global__ void dma_gather_kernel(const uint32_t* __restrict__ payload,
                                  const int32_t* __restrict__ idx,
                                  uint32_t* __restrict__ out, int N, int W,
                                  int Cb, int depth) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* rows = (uint32_t*)smem;                          // [depth, W]
  int32_t* ids = (int32_t*)(rows + (size_t)depth * W);       // [Cb]
  uint64_t* bars = (uint64_t*)(ids + Cb + (Cb & 1));         // [depth]
  const int tid = threadIdx.x;
  const int32_t* chunk = idx + (size_t)blockIdx.x * Cb;
  for (int r = tid; r < Cb; r += blockDim.x) {
    const int32_t i = chunk[r];
    if (i < 0 || i >= N) __trap();  // outside the payload: fault, as index_select
    ids[r] = i;
  }
  if (tid == 0) {
    for (int j = 0; j < depth; ++j) mbar_init(&bars[j], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const uint32_t bytes = (uint32_t)W * 4u;
  if (tid == 0) {
    for (int j = 0; j < depth; ++j) {
      mbar_expect_tx(&bars[j], bytes);
      bulk_copy(rows + (size_t)j * W, payload + (size_t)ids[j] * W, bytes,
                &bars[j]);
    }
  }
  uint32_t acc = 0u;
#pragma unroll 1
  for (int r = 0; r < Cb; ++r) {
    const int slot = r % depth;
    mbar_wait(&bars[slot], (uint32_t)((r / depth) & 1));
    acc ^= rows[(size_t)slot * W + tid];
    __syncthreads();  // every thread has read the slot: it may be refilled
    const int next = r + depth;
    if (tid == 0 && next < Cb) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_expect_tx(&bars[slot], bytes);
      bulk_copy(rows + (size_t)slot * W, payload + (size_t)ids[next] * W,
                bytes, &bars[slot]);
    }
  }
  atomicXor(&out[tid], acc);
}

// payload [N, W] (uint32 words, W * 4 a multiple of 16), idx [M] with M a
// multiple of Cb and Cb of depth, out [1, W] zeroed. One block of W threads
// per chunk of Cb indices.
extern "C" int dma_gather_launch(const void* payload, const void* idx,
                                 void* out, int N, int W, int M, int Cb,
                                 int depth, int* launched, void* stream) {
  *launched = 0;
  if (M == 0) return 0;  // nothing to gather: out stays zero
  if (W <= 0 || W > 1024 || (W * 4) % 16 || Cb <= 0 || depth <= 0 ||
      M % Cb || Cb % depth)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)depth * W * 4 + (size_t)(Cb + (Cb & 1)) * 4 +
                      (size_t)depth * 8;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dma_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dma_gather_kernel<<<M / Cb, W, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)payload, (const int32_t*)idx, (uint32_t*)out, N, W, Cb,
      depth);
  *launched = 1;
  return (int)cudaGetLastError();
}
