// OR-Set fold kernels for Hopper (sm_90a): the scatter phase and the
// normalize tail of crdt_enc_tpu_torch.ops.orset.orset_fold.
//
// Replaces, in crdt_enc_tpu/ops/pallas_fold.py:
//   * orset_scatter_pallas (pallas_call at :628, kernel
//     _fold_tile_kernel_ablk, prologue _ablk_prologue) -> scatter_kernel;
//   * the normalize tail that orset_fold_pallas runs after it in XLA
//     (_normalize_tail), which orset_fold_pallas_fused (:830, kernel
//     _fold_tile_kernel_ablk_fused) and orset_retire fuse on the TPU
//     -> tail_kernel.
//
// The TPU kernels sort the rows and recast scatter-max as one-hot bf16
// limb matmuls because the TPU has no fast scatter; that is why they
// bound counters below 2^14 and pad to (8, 128) tiles.  Hopper has a fast
// int32 atomicMax in L2, so the scatter is one thread per row and one
// atomic per row, with no sort, no counter bound and no padding.  Only
// the output must match, bit for bit.
//
// What bounds it on this card: bytes.  The scatter moves 13 bytes per
// row plus the two zeroed (E, R) planes; the tail reads four (E, R)
// planes and writes two.  Both are elementwise or one-atomic-per-row, so
// there is no arithmetic to speak of.  At config 3 (E = 4096,
// R = 10,000, N = 1M) the row atomics touch ~1M distinct cells spread
// over 328 MB, with little contention; the clock updates land ~90 rows
// on each of 10k addresses in random order.  Measured on the H100 at
// config 3, the clock atomics cost ~0.04 ms of the scatter's ~0.24 ms,
// and zero-filling the two planes ~0.12 ms (PERF.md).  Rows of one warp
// rarely share an actor, so a warp-level pre-reduction buys nothing; a
// read-before-atomic filter on the clock measured no gain either.
//
// Why the clock is final when the scatter ends:
//   max(clock0[r], colmax(where(add_new > clock0, add_new, 0))[r])
//     == max(clock0[r], max add counter of actor r)
// because the cell-level gate only zeroes cells <= clock0[r].  So the
// scatter raises a clock seeded with clock0 by atomicMax, and the tail
// needs no cross-block column reduction.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(); the Python wrapper raises when that is nonzero.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kKindAdd = 0;
constexpr int kKindRm = 1;
constexpr int kThreads = 256;

// One thread per row (grid-stride).  Rows with an actor outside [0, R)
// (the actor >= R padding sentinel included), a member outside [0, E) or
// a kind other than ADD/RM drop out.  Both planes arrive zeroed, so
// untouched cells read 0 and counters <= 0 change nothing.
__global__ void scatter_kernel(const int8_t* __restrict__ kind,
                               const int32_t* __restrict__ member,
                               const int32_t* __restrict__ actor,
                               const int32_t* __restrict__ counter,
                               int64_t n, int32_t E, int32_t R,
                               int32_t* __restrict__ add_new,
                               int32_t* __restrict__ rm_new,
                               int32_t* __restrict__ clock) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t a = actor[i];
    const int32_t m = member[i];
    if (a < 0 || a >= R || m < 0 || m >= E) continue;
    const int k = kind[i];
    const int32_t c = counter[i];
    const int64_t cell = (int64_t)m * R + a;
    if (k == kKindAdd) {
      atomicMax(add_new + cell, c);
      if (clock != nullptr) atomicMax(clock + a, c);
    } else if (k == kKindRm) {
      atomicMax(rm_new + cell, c);
    }
  }
}

// Elementwise over (E, R): blockIdx.x/threadIdx.x walk R (coalesced),
// blockIdx.y walks the members.  add/rm may not alias the inputs.
__global__ void tail_kernel(const int32_t* __restrict__ clock0,
                            const int32_t* __restrict__ clock,
                            const int32_t* __restrict__ add0,
                            const int32_t* __restrict__ rm0,
                            const int32_t* __restrict__ add_new,
                            const int32_t* __restrict__ rm_new,
                            int32_t E, int32_t R, int retire_rm,
                            int32_t* __restrict__ add,
                            int32_t* __restrict__ rm) {
  const int32_t r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int32_t c0 = clock0[r];
  const int32_t c = clock[r];
  for (int64_t e = blockIdx.y; e < E; e += gridDim.y) {
    const int64_t i = e * R + r;
    int32_t g = add_new[i];
    g = g > c0 ? g : 0;  // cell-level replay gate
    int32_t av = max(add0[i], g);
    int32_t rv = max(rm0[i], rm_new[i]);
    av = av > rv ? av : 0;  // a horizon kills every dot it covers
    if (retire_rm) rv = rv > c ? rv : 0;  // a caught-up horizon has applied
    add[i] = av;
    rm[i] = rv;
  }
}

}  // namespace

extern "C" int orset_scatter_launch(const void* kind, const void* member,
                                    const void* actor, const void* counter,
                                    int64_t n, int32_t E, int32_t R,
                                    void* add_new, void* rm_new, void* clock,
                                    void* stream) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  if (blocks < 1) blocks = 1;
  scatter_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)kind, (const int32_t*)member, (const int32_t*)actor,
      (const int32_t*)counter, n, E, R, (int32_t*)add_new, (int32_t*)rm_new,
      (int32_t*)clock);
  return (int)cudaGetLastError();
}

extern "C" int orset_fold_tail_launch(const void* clock0, const void* clock,
                                      const void* add0, const void* rm0,
                                      const void* add_new, const void* rm_new,
                                      int32_t E, int32_t R, int32_t retire_rm,
                                      void* add, void* rm, void* stream) {
  const unsigned gx = (unsigned)((R + kThreads - 1) / kThreads);
  const unsigned gy = (unsigned)(E < 65535 ? E : 65535);
  tail_kernel<<<dim3(gx, gy), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)clock0, (const int32_t*)clock, (const int32_t*)add0,
      (const int32_t*)rm0, (const int32_t*)add_new, (const int32_t*)rm_new, E,
      R, retire_rm, (int32_t*)add, (int32_t*)rm);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
