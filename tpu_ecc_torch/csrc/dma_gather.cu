// dma_gather: the XOR of M payload rows chosen by idx, each row fetched by an
// asynchronous bulk copy of its own — a probe of the per-row copy issue
// rate, the ceiling of a gather fused into segscan.
//
// Replaces tools/bench_gather_probe.py dma_gather_call (:82-145), which
// issued one TPU DMA descriptor per row, `depth` deep, over a sequential
// grid of M / Cb chunks with the indices in scalar prefetch.
//
// Design: a ring for each warp. The M indices are M / Cb chunks of Cb, as
// on the TPU; each chunk is split into ceil(Cb / GATHER_ROWS) runs of at
// most GATHER_ROWS rows, one run a warp, so that the card holds the same
// number of warps, and of copies in flight, whatever Cb is (Cb only bounds
// a run: no warp gathers across chunks). A block is GATHER_WARPS warps; the
// warps run in parallel in any order. A warp loads its run's indices into
// shared memory (scalar prefetch has no counterpart on the card), checking
// each, and keeps a ring of `depth` row slots in shared memory, each with
// its own mbarrier. One lane issues one `cp.async.bulk` global -> shared
// copy of W * 4 bytes per row (the Hopper counterpart of one DMA
// descriptor), announced to the slot's mbarrier with expect_tx. Every lane
// waits on the slot's phase (row r of the run completes phase r / depth of
// slot r % depth, so a run of any length keeps the parity right) and XORs
// its 16-byte words of the row into registers; after a __syncwarp (the slot
// is free again) the issuing lane fences the generic reads against the
// async proxy and issues the row `depth` places further on into it. No
// barrier spans more than the warp until the end, where each warp XORs its
// words into the block's shared fold and the block makes one atomicXor per
// word into the zeroed [1, W] output: XOR is order-free, so the result is
// exact in any order of warps and blocks.
//
// Bound: bytes — M * W * 4 bytes of rows and 4 M of indices; the XORs are
// one integer operation per word. To run at the HBM's rate the card needs
// its bandwidth times its latency in flight, some 2-3 MB: at M = 2^18 the
// runs of 32 rows are 8192 warps, up to depth rows of 512 B in flight each.
#include <cuda_runtime.h>
#include <stdint.h>

// Warps a block and the most rows a warp gathers; a build may set them.
// tools/bench_blocks.py sweeps 4, 8 and 16 warps by 32, 64 and 128 rows at
// the tool's four shapes (PERF.md): all within 0.0634-0.0847 ms on an H100,
// 64 registers and 0 bytes of spill; 4 x 32 was the fastest over the four
// (mean 0.0682 ms; 0.0664 at Cb = 4096, depth 8, against the best 0.0657 of
// 16 x 64, which fell to 0.0794 at depth 16, two waves of blocks), and 128
// rows the slowest at every width.
#ifndef GATHER_WARPS
#define GATHER_WARPS 4
#endif
#ifndef GATHER_ROWS
#define GATHER_ROWS 32
#endif

#define SMEM_MAX 232448   // shared memory a block may opt into (227 KB)
#define VMAX 8            // 16-byte words a lane holds of a row (W <= 1024)

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

// shared memory of a block of `warps` warps: [warps][depth] row slots of W
// words, [warps][depth] mbarriers, [warps][run] indices, the fold [W]
__host__ __device__ static inline size_t gather_smem(int warps, int W, int depth, int run) {
  return (size_t)warps * ((size_t)depth * W * 4 + (size_t)depth * 8 + (size_t)run * 4) +
         (size_t)W * 4;
}

__global__ void __launch_bounds__(GATHER_WARPS * 32)
    dma_gather_kernel(const uint32_t* __restrict__ payload, const int32_t* __restrict__ idx,
                      uint32_t* __restrict__ out, int N, int W, int Cb, int depth, int parts,
                      int run, int total) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x / 32, wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint32_t* slots = (uint32_t*)smem + (size_t)wid * depth * W;             // [depth, W]
  uint64_t* bars = (uint64_t*)(smem + (size_t)warps * depth * W * 4) + (size_t)wid * depth;
  int32_t* ids = (int32_t*)(smem + (size_t)warps * depth * (W * 4 + 8)) + (size_t)wid * run;
  uint32_t* fold = (uint32_t*)(smem + gather_smem(warps, W, depth, run) - (size_t)W * 4);
  for (int i = threadIdx.x; i < W; i += blockDim.x) fold[i] = 0u;

  // this warp's run: rows [lo, lo + n) of chunk g / parts
  const int g = blockIdx.x * warps + wid;
  int n = 0;
  size_t lo = 0;
  if (g < total) {
    const int part = g % parts, start = part * run;
    lo = (size_t)(g / parts) * Cb + start;
    n = min(run, Cb - start);
  }
  for (int r = lane; r < n; r += 32) {
    const int32_t i = idx[lo + r];
    if (i < 0 || i >= N) __trap();  // outside the payload: fault, as index_select
    ids[r] = i;
  }
  if (lane == 0) {
    for (int j = 0; j < depth; ++j) mbar_init(&bars[j], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the fold is zeroed; the warp's barriers and indices are set
  const uint32_t bytes = (uint32_t)W * 4u;
  if (lane == 0) {
    for (int j = 0; j < depth && j < n; ++j) {
      mbar_expect_tx(&bars[j], bytes);
      bulk_copy(slots + (size_t)j * W, payload + (size_t)ids[j] * W, bytes, &bars[j]);
    }
  }
  const int words = W / 4;  // 16-byte words a row
  uint4 acc[VMAX];
#pragma unroll
  for (int k = 0; k < VMAX; ++k) acc[k] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 1
  for (int r = 0; r < n; ++r) {
    const int slot = r % depth;
    mbar_wait(&bars[slot], (uint32_t)((r / depth) & 1));
    const uint4* row = (const uint4*)(slots + (size_t)slot * W);
#pragma unroll
    for (int k = 0; k < VMAX; ++k) {
      const int v = lane + 32 * k;
      if (v < words) {
        const uint4 x = row[v];
        acc[k].x ^= x.x, acc[k].y ^= x.y, acc[k].z ^= x.z, acc[k].w ^= x.w;
      }
    }
    __syncwarp();  // every lane has read the slot: it may be refilled
    const int next = r + depth;
    if (lane == 0 && next < n) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_expect_tx(&bars[slot], bytes);
      bulk_copy(slots + (size_t)slot * W, payload + (size_t)ids[next] * W, bytes,
                &bars[slot]);
    }
  }
#pragma unroll
  for (int k = 0; k < VMAX; ++k) {
    const int v = lane + 32 * k;
    if (v < words && n > 0) {
      atomicXor(&fold[4 * v], acc[k].x), atomicXor(&fold[4 * v + 1], acc[k].y);
      atomicXor(&fold[4 * v + 2], acc[k].z), atomicXor(&fold[4 * v + 3], acc[k].w);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < W; i += blockDim.x) atomicXor(&out[i], fold[i]);
}

// payload [N, W] (uint32 words, W * 4 a multiple of 16, W <= 1024), idx [M]
// with M a multiple of Cb and Cb of depth, out [1, W] zeroed. A block takes
// GATHER_WARPS warps, fewer where their rings would not fit its shared
// memory.
extern "C" int dma_gather_launch(const void* payload, const void* idx,
                                 void* out, int N, int W, int M, int Cb,
                                 int depth, int* launched, void* stream) {
  *launched = 0;
  if (M == 0) return 0;  // nothing to gather: out stays zero
  if (W <= 0 || W > 4 * 32 * VMAX || (W * 4) % 16 || Cb <= 0 || depth <= 0 || M % Cb ||
      Cb % depth)
    return (int)cudaErrorInvalidValue;
  const int parts = (Cb + GATHER_ROWS - 1) / GATHER_ROWS;
  const int run = (Cb + parts - 1) / parts;
  const int total = M / Cb * parts;  // warps with a run
  int warps = GATHER_WARPS;
  while (warps > 1 && gather_smem(warps, W, depth, run) > SMEM_MAX) --warps;
  const size_t smem = gather_smem(warps, W, depth, run);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dma_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dma_gather_kernel<<<(total + warps - 1) / warps, warps * 32, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)payload, (const int32_t*)idx, (uint32_t*)out, N, W, Cb, depth, parts,
      run, total);
  *launched = 1;
  return (int)cudaGetLastError();
}
