// segscan: the per-lane segmented scan of the bucketed Pippenger MSM — each
// of L lanes accumulates its chunk of C digit-sorted points, restarting the
// sum wherever the bucket key changes (parallel/msm.py, step 3).
//
// Replaces tpu_ecc/ops/pallas_kernels.py segscan_call (:463-597).
//
// Design: one thread per lane. The TPU's sequential row-chunk grid axis,
// which carried the running sum and the previous key in VMEM scratch,
// becomes the row loop inside the thread; the sum stays in the thread for
// the whole chunk. Per row r:
//   1. signed mode: y of a point whose digit was negative is replaced by
//      ksteady(kneg(y)), a select and never a branch on the sign;
//   2. key == previous key: acc = ksteady(padd(acc, v)); else acc = v. The
//      previous key starts at the sentinel nbuck, which in signed mode is
//      also the key of a zero digit: such a lane's first row computes
//      padd(O, v), as the TPU kernel and the XLA scan do (the same point,
//      other limbs). The add is skipped where the key changed: keys are
//      public, and the skipped add is one whose result the TPU discarded;
//   3. scanned[r] = acc, and lead = acc while the key equals the lane's
//      first key (monotone keys: the last such row ends the leading run).
//      lead lives in its output buffer, written under that condition, not
//      in a fourth register array.
// Arrays are [C, .., L] with the lane fastest, so a warp's loads and stores
// of one word are coalesced.
//
// Bound: operations — one complete add (11204 32-bit integer instructions,
// the generator's count) per row whose key repeats; the bytes (the C rows in
// and out, 2 * 240 B per point) are about half as long at the card's rate.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kfe_segscan.cuh"

#define N KFE_FP_N
#define PN (3 * N)
#define THREADS 32

__global__ void segscan_kernel(const uint32_t* __restrict__ key2,
                               const uint32_t* __restrict__ val2,
                               const uint32_t* __restrict__ neg2,
                               uint32_t* __restrict__ scanned,
                               uint32_t* __restrict__ last_key,
                               uint32_t* __restrict__ tail,
                               uint32_t* __restrict__ lead, int C, int L,
                               uint32_t nbuck) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  uint32_t acc[PN], v[PN], nxt[PN], yn[N];
  kfe_fp_one(yn);
  for (int i = 0; i < N; ++i) {  // the identity (0 : 1 : 0)
    acc[i] = 0u;
    acc[N + i] = yn[i];
    acc[2 * N + i] = 0u;
  }
  const uint32_t fk = key2[lane];
  uint32_t pk = nbuck;

#pragma unroll 1
  for (int r = 0; r < C; ++r) {
    const size_t kr = (size_t)r * L + lane;
    const uint32_t k = key2[kr];
    const uint32_t* row = val2 + (size_t)r * PN * L + lane;
    for (int j = 0; j < PN; ++j) v[j] = row[(size_t)j * L];
    if (neg2 != nullptr) {
      const bool ng = neg2[kr] != 0u;
      kfe_fp_neg(v + N, yn);
      for (int i = 0; i < N; ++i) v[N + i] = ng ? yn[i] : v[N + i];
    }
    if (k == pk) {
      kfe_padd(acc, v, nxt);
      for (int j = 0; j < PN; ++j) acc[j] = nxt[j];
    } else {
      for (int j = 0; j < PN; ++j) acc[j] = v[j];
    }
    uint32_t* out = scanned + (size_t)r * PN * L + lane;
    for (int j = 0; j < PN; ++j) out[(size_t)j * L] = acc[j];
    if (k == fk) {
      for (int j = 0; j < PN; ++j) lead[(size_t)j * L + lane] = acc[j];
    }
    pk = k;
  }
  last_key[lane] = pk;
  for (int j = 0; j < PN; ++j) tail[(size_t)j * L + lane] = acc[j];
}

// key2 [C, L]; val2 [C, 3, n, L]; neg2 [C, L] or null (unsigned digits);
// scanned [C, 3, n, L]; last_key [L]; tail, lead [3, n, L].
extern "C" int segscan_launch(const void* key2, const void* val2,
                              const void* neg2, void* scanned, void* last_key,
                              void* tail, void* lead, int C, int L, int nbuck,
                              int* launched, void* stream) {
  segscan_kernel<<<(L + THREADS - 1) / THREADS, THREADS, 0,
                   (cudaStream_t)stream>>>(
      (const uint32_t*)key2, (const uint32_t*)val2, (const uint32_t*)neg2,
      (uint32_t*)scanned, (uint32_t*)last_key, (uint32_t*)tail,
      (uint32_t*)lead, C, L, (uint32_t)nbuck);
  *launched = 1;
  return (int)cudaGetLastError();
}
