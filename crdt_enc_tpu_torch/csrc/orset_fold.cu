// OR-Set fold kernels for Hopper (sm_90a): one cell-range bucketed fold
// with two epilogues, behind crdt_enc_tpu_torch.ops.orset_fold_cuda.
//
// Replaces, in crdt_enc_tpu/ops/pallas_fold.py:
//   * orset_scatter_pallas (pallas_call at :628, kernel
//     _fold_tile_kernel_ablk, prologue _ablk_prologue) -> the raw epilogue;
//   * orset_fold_pallas_fused (:830, kernel _fold_tile_kernel_ablk_fused)
//     and the XLA tail orset_fold_pallas runs after the scatter
//     (_normalize_tail, orset_retire) -> the fold epilogue;
//   * _fold_wide (:259, kernel _fold_tile_kernel_wide), the same contract
//     past the ablk layout's int32 keys: cells are int64 here throughout.
//
// The TPU kernels sort the rows and recast scatter-max as one-hot bf16
// limb matmuls because the TPU has no fast scatter; that is why they
// bound counters below 2^14 and pad to (8, 128) tiles.  Here only the
// output must match, bit for bit.
//
// What bounds it on this card: bytes.  The fold must read add0 and rm0
// and write add and rm (4 x 164 MB at config 3, E = 4096, R = 10,000);
// the rows are 13 bytes each.  A scatter straight into device memory
// (one atomicMax per row into two zeroed scratch planes, then a tail
// that re-reads them) moves twice that: the zero fill, the scattered
// read-modify-writes of 32-byte sectors, and the re-read.  So the design
// writes every output cell exactly once, from shared memory, and keeps
// no scratch plane:
//
//   0. prep_kernel   zero the range counts, seed the clock with clock0;
//   1. bin_kernel    one thread per row: count the valid rows of each
//                    cell range (C = 2^range_shift consecutive flat cells
//                    member * R + actor), and raise the clock; the block
//                    that finishes last turns the counts into each range's
//                    first row slot (an exclusive prefix sum) and a cursor;
//   2. place_kernel  one thread per row: claim a slot in its range, write
//                    one packed 64-bit word (offset in range, kind, counter);
//   3. range_kernel  one block per range: zero two C-cell tiles in shared
//                    memory, apply the range's rows with shared atomicMax,
//                    then walk the range once, coalesced (int4 where the
//                    planes are 16-byte aligned), through one epilogue:
//                      raw  - write the tiles (every cell, zeros included);
//                      fold - the tail: gate add_new > clock0[a],
//                             add = max(add0, gated), rm = max(rm0, rm_new),
//                             add killed where <= rm, and with retire_rm
//                             rm zeroed where <= clock[a].
//
// Bucketing by flat range, not by member, takes any (E, R): a small R
// packs several members into one block, a large R spreads one member over
// several.  Max is order-free, so the slot order inside a range does not
// matter and the output is deterministic.
//
// The row passes cut the rows into one contiguous chunk per block.  Where
// the range counters fit in shared memory (n_ranges <= dense_max), a block
// counts its chunk there and adds its counts to the global ones with
// coalesced atomics, and the place pass reserves one stretch of slots per
// (block, range) the same way and ranks its rows in shared memory: no
// global atomic per row.  Past that (K3's shape: 130,500 ranges of a few
// rows each), each row counts and claims its slot with one global atomic,
// merged per warp where rows share a range (__match_any_sync).
//
// Why the clock is final when bin_kernel ends:
//   max(clock0[r], colmax(where(add_new > clock0, add_new, 0))[r])
//     == max(clock0[r], max add counter of actor r)
// because the cell-level gate only zeroes cells <= clock0[r].  So the bin
// pass raises a clock seeded with clock0 by atomicMax, and the epilogue
// needs no cross-block column reduction.  Where R fits in shared memory
// each bin block keeps its own clock there and merges it into the global
// one with coalesced atomics at the end; otherwise each warp merges its
// rows per actor (__match_any_sync, __reduce_max_sync) and one lane
// updates the global clock.
//
// Where trouble is likely, and what the code does about it:
//   * Skew: a hot member or a hot cell sends many rows to one range.  The
//     row passes count it in shared memory (or merge per warp); the range
//     kernel loads sixteen rows per thread before applying them and skips
//     the shared atomic when the tile already holds as much.  The heavy block
//     still runs longer than the rest, which chip_smoke.py times on a
//     hot-member and a hot-cell batch.
//   * Indices: cells and range bases are int64 (E * R may pass 2^31);
//     range counts, cursors and row slots are int32, so the wrapper
//     refuses N >= 2^31 and more than 2^31 - 1 ranges.
//   * counter <= 0 changes no plane (the tiles start at 0, as zeroed
//     planes did), so such rows are not placed; an ADD row still raises
//     the clock with it.
//   * N = 0, E * R < C and a ragged last range: the range kernel still
//     writes every cell; the last range stops at E * R.
//
// The entry point launches on the given stream, checks each launch with
// cudaGetLastError() and returns the first nonzero code; the Python
// wrapper raises on it.


#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kKindAdd = 0;
constexpr int kKindRm = 1;
constexpr int kRowThreads = 1024;
constexpr int kRowBlocksPerSM = 2;
constexpr int kScanPer = 4;  // counts per thread and step of the scan
constexpr int kRangeThreads = 512;
constexpr int kRowUnroll = 16;  // rows in flight per thread in a range
constexpr int32_t kNoClock = INT_MIN;  // a shared clock slot no row raised

using u64 = unsigned long long;  // the type __ldcs takes for 64-bit words

// A row's range, or -1 when it places nothing: an actor outside [0, R)
// (the actor = R padding sentinel included), a member outside [0, E), a
// kind other than ADD/RM, or a counter <= 0.  Also gives whether it is an
// ADD row (for the clock), its actor and counter, and (word != nullptr)
// its packed word: offset in the range << 32 | kind << 31 | counter.
__device__ __forceinline__ int32_t row_range(
    const int8_t* kind, const int32_t* member, const int32_t* actor,
    const int32_t* counter, int64_t i, int32_t E, int32_t R, int range_shift,
    bool* add_row, int32_t* a, int32_t* c, u64* word) {
  *a = actor[i];
  const int32_t m = member[i];
  const int k = kind[i];
  *add_row = false;
  *c = 0;
  if (*a < 0 || *a >= R || m < 0 || m >= E) return -1;
  if (k != kKindAdd && k != kKindRm) return -1;
  *c = counter[i];
  *add_row = k == kKindAdd;
  if (*c <= 0) return -1;
  const int64_t cell = (int64_t)m * R + *a;
  if (word != nullptr)
    *word = ((u64)(cell & (((int64_t)1 << range_shift) - 1)) << 32) |
            ((u64)(k == kKindRm) << 31) | (u64)(uint32_t)*c;
  return (int32_t)(cell >> range_shift);
}

// The rows of a block: one contiguous chunk, a multiple of blockDim long,
// so the loops below step uniformly and whole warps reach the warp
// intrinsics together.
__device__ __forceinline__ void chunk_of(int64_t n, int64_t chunk,
                                         int64_t* lo, int64_t* hi) {
  *lo = (int64_t)blockIdx.x * chunk;
  *hi = min(n, *lo + chunk);
}

// The exclusive prefix of x over a kRowThreads block; *total gets the
// block's sum.  warp_sum holds kRowThreads / 32 ints of shared memory.
__device__ __forceinline__ int32_t block_scan(int32_t x, int32_t* warp_sum,
                                              int32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int32_t w = warp_sum[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  *total = warp_sum[kRowThreads / 32 - 1];
  const int32_t out = (warp ? warp_sum[warp - 1] : 0) + inc - x;
  __syncthreads();  // warp_sum is free again for the next call
  return out;
}

// The prefix sum, run by the bin block that finishes last: count[j]
// becomes the exclusive prefix (the range's cursor) and begin[j] the
// same; begin[nb] is the number of placed rows.  The counts come from
// other blocks' atomics, so they are read past L1 (__ldcg).
__device__ void scan_counts(int32_t* count, int32_t* begin, int32_t nb) {
  __shared__ int32_t warp_sum[kRowThreads / 32];
  int32_t carry = 0;
  for (int64_t t0 = 0; t0 < nb; t0 += (int64_t)kRowThreads * kScanPer) {
    const int64_t j0 = t0 + (int64_t)threadIdx.x * kScanPer;
    int32_t v[kScanPer];
    int32_t s = 0;
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      v[k] = j0 + k < nb ? __ldcg(count + j0 + k) : 0;
      s += v[k];
    }
    int32_t total;
    int32_t run = carry + block_scan(s, warp_sum, &total);
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      if (j0 + k < nb) {
        begin[j0 + k] = run;
        count[j0 + k] = run;
      }
      run += v[k];
    }
    carry += total;
  }
  if (threadIdx.x == 0) begin[nb] = carry;
}

// Pass 1.  Dynamic shared memory: with kDense the block's range counts
// (n_ranges int32), then with smem_clock the block's clock (R int32).
// count[n_ranges] is the finish ticket; at least one block runs, so the
// scan runs for N = 0 too.
template <bool kDense>
__global__ void __launch_bounds__(kRowThreads)
    bin_kernel(const int8_t* __restrict__ kind,
               const int32_t* __restrict__ member,
               const int32_t* __restrict__ actor,
               const int32_t* __restrict__ counter, int64_t n, int64_t chunk,
               int32_t E, int32_t R, int range_shift, int32_t n_ranges,
               int32_t* __restrict__ count, int32_t* __restrict__ begin,
               int32_t* __restrict__ clock, int smem_clock) {
  extern __shared__ int32_t smem[];
  int32_t* s_count = smem;
  int32_t* s_clock = smem + (kDense ? n_ranges : 0);
  const bool shared_clock = clock != nullptr && smem_clock;
  if (kDense)
    for (int32_t b = threadIdx.x; b < n_ranges; b += blockDim.x) s_count[b] = 0;
  if (shared_clock)
    for (int32_t a = threadIdx.x; a < R; a += blockDim.x) s_clock[a] = kNoClock;
  __syncthreads();
  const unsigned lane = threadIdx.x & 31u;
  int64_t lo, hi;
  chunk_of(n, chunk, &lo, &hi);
  for (int64_t base = lo; base < hi; base += blockDim.x) {
    const int64_t i = base + threadIdx.x;
    bool add_row = false;
    int32_t b = -1, a = 0, c = 0;
    if (i < hi)
      b = row_range(kind, member, actor, counter, i, E, R, range_shift,
                    &add_row, &a, &c, nullptr);
    if (kDense) {
      if (b >= 0) atomicAdd(s_count + b, 1);
    } else {
      const unsigned pmask = __ballot_sync(0xffffffffu, b >= 0);
      if (b >= 0) {
        const unsigned peers = __match_any_sync(pmask, b);
        if (lane == (unsigned)(__ffs(peers) - 1))
          atomicAdd(count + b, __popc(peers));
      }
    }
    if (shared_clock) {
      if (add_row && c > s_clock[a]) atomicMax(s_clock + a, c);
    } else if (clock != nullptr) {
      const unsigned amask = __ballot_sync(0xffffffffu, add_row);
      if (add_row) {
        const unsigned peers = __match_any_sync(amask, a);
        const int32_t top = __reduce_max_sync(peers, c);
        if (lane == (unsigned)(__ffs(peers) - 1)) atomicMax(clock + a, top);
      }
    }
  }
  __syncthreads();
  // consecutive threads on consecutive counters: coalesced atomics
  if (kDense)
    for (int32_t b = threadIdx.x; b < n_ranges; b += blockDim.x) {
      const int32_t v = s_count[b];
      if (v) atomicAdd(count + b, v);
    }
  if (shared_clock)
    for (int32_t a = threadIdx.x; a < R; a += blockDim.x) {
      const int32_t v = s_clock[a];
      if (v != kNoClock) atomicMax(clock + a, v);
    }
  // the last block to finish scans the counts every block has added
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(count + n_ranges, 1) == (int32_t)gridDim.x - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    scan_counts(count, begin, n_ranges);
  }
}

// Pass 0: zero the range counts and the finish ticket (count[n_ranges]),
// and in the fold seed the clock with clock0.
__global__ void prep_kernel(int32_t* __restrict__ count, int32_t n_ranges,
                            const int32_t* __restrict__ clock0,
                            int32_t* __restrict__ clock, int32_t R) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       j <= n_ranges || (clock0 != nullptr && j < R); j += stride) {
    if (j <= n_ranges) count[j] = 0;
    if (clock0 != nullptr && j < R) clock[j] = clock0[j];
  }
}

// Pass 2: the rows pass 1 counted take slots of their range.  kDense: the
// block counts its chunk per range again in shared memory, reserves one
// stretch of slots for each range it holds (coalesced atomics on the
// cursors), then hands them out in shared memory.  Otherwise one cursor
// atomic per (warp, range) group.
template <bool kDense>
__global__ void __launch_bounds__(kRowThreads)
    place_kernel(const int8_t* __restrict__ kind,
                 const int32_t* __restrict__ member,
                 const int32_t* __restrict__ actor,
                 const int32_t* __restrict__ counter, int64_t n,
                 int64_t chunk, int32_t E, int32_t R, int range_shift,
                 int32_t n_ranges, int32_t* __restrict__ cursor,
                 u64* __restrict__ packed) {
  extern __shared__ int32_t s_slot[];  // kDense: n_ranges int32
  const unsigned lane = threadIdx.x & 31u;
  int64_t lo, hi;
  chunk_of(n, chunk, &lo, &hi);
  bool add_row;
  int32_t a, c;
  u64 word = 0;
  if (kDense) {
    for (int32_t b = threadIdx.x; b < n_ranges; b += blockDim.x) s_slot[b] = 0;
    __syncthreads();
    for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const int32_t b = row_range(kind, member, actor, counter, i, E, R,
                                  range_shift, &add_row, &a, &c, nullptr);
      if (b >= 0) atomicAdd(s_slot + b, 1);
    }
    __syncthreads();
    for (int32_t b = threadIdx.x; b < n_ranges; b += blockDim.x) {
      const int32_t v = s_slot[b];
      if (v) s_slot[b] = atomicAdd(cursor + b, v);
    }
    __syncthreads();
    for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const int32_t b = row_range(kind, member, actor, counter, i, E, R,
                                  range_shift, &add_row, &a, &c, &word);
      if (b >= 0) packed[atomicAdd(s_slot + b, 1)] = word;
    }
    return;
  }
  for (int64_t base = lo; base < hi; base += blockDim.x) {
    const int64_t i = base + threadIdx.x;
    int32_t b = -1;
    if (i < hi)
      b = row_range(kind, member, actor, counter, i, E, R, range_shift,
                    &add_row, &a, &c, &word);
    const unsigned pmask = __ballot_sync(0xffffffffu, b >= 0);
    if (b >= 0) {
      const unsigned peers = __match_any_sync(pmask, b);
      const int leader = __ffs(peers) - 1;
      const int rank = __popc(peers & ((1u << lane) - 1u));
      int32_t slot = 0;
      if ((int)lane == leader) slot = atomicAdd(cursor + b, __popc(peers));
      slot = __shfl_sync(peers, slot, leader) + rank;
      packed[slot] = word;
    }
  }
}

__device__ __forceinline__ void apply_row(u64 w, int32_t* t_add,
                                          int32_t* t_rm) {
  const int32_t v = (int32_t)(w & 0x7fffffffu);  // 0 for an empty load
  int32_t* t = ((w >> 31) & 1u) ? t_rm : t_add;
  int32_t* p = t + (uint32_t)(w >> 32);
  if (v > *p) atomicMax(p, v);  // a stale read only costs an atomic
}

// The fold epilogue for one cell of actor a.
__device__ __forceinline__ void fold_cell(int32_t g, int32_t r_new,
                                          int32_t a0v, int32_t r0v,
                                          int32_t c0, int32_t c,
                                          int retire_rm, int32_t* av,
                                          int32_t* rv) {
  g = g > c0 ? g : 0;  // cell-level replay gate
  int32_t x = max(a0v, g);
  int32_t y = max(r0v, r_new);
  x = x > y ? x : 0;  // a horizon kills every dot it covers
  if (retire_rm) y = y > c ? y : 0;  // a caught-up horizon has applied
  *av = x;
  *rv = y;
}

// Pass 3.  kFold selects the epilogue; vec says every plane pointer is
// 16-byte aligned (range bases are multiples of C >= 4 cells, so each
// range's int4 walk is aligned too).
template <bool kFold>
__global__ void __launch_bounds__(kRangeThreads)
    range_kernel(const u64* __restrict__ packed,
                 const int32_t* __restrict__ begin, int64_t cells,
                 int32_t R, int range_shift,
                 const int32_t* __restrict__ clock0,
                 const int32_t* __restrict__ clock,
                 const int32_t* __restrict__ add0,
                 const int32_t* __restrict__ rm0, int retire_rm, int vec,
                 int32_t* __restrict__ add, int32_t* __restrict__ rm) {
  extern __shared__ int4 tiles[];  // add tile, then rm tile: 2 * C int32
  const int32_t C = 1 << range_shift;
  int32_t* t_add = reinterpret_cast<int32_t*>(tiles);
  int32_t* t_rm = t_add + C;
  for (int32_t q = threadIdx.x; q < C / 2; q += blockDim.x)
    tiles[q] = make_int4(0, 0, 0, 0);
  __syncthreads();

  const int32_t lo = begin[blockIdx.x], hi = begin[blockIdx.x + 1];
  for (int32_t i = lo + threadIdx.x; i < hi; i += kRowUnroll * blockDim.x) {
    u64 w[kRowUnroll];
#pragma unroll
    for (int k = 0; k < kRowUnroll; ++k) {
      const int32_t j = i + k * (int32_t)blockDim.x;
      w[k] = j < hi ? __ldcs(packed + j) : 0;
    }
#pragma unroll
    for (int k = 0; k < kRowUnroll; ++k) apply_row(w[k], t_add, t_rm);
  }
  __syncthreads();

  const int64_t base = (int64_t)blockIdx.x << range_shift;
  const int32_t L = (int32_t)min((int64_t)C, cells - base);
  const uint32_t a_base = (uint32_t)(base % R);
  int32_t done = 0;
  if (vec) {
    const int32_t L4 = L >> 2;
    const int4* g4 = tiles;
    const int4* r4 = tiles + C / 4;
    for (int32_t q = threadIdx.x; q < L4; q += blockDim.x) {
      const int4 g = g4[q], rn = r4[q];
      const int64_t cell = base + 4 * (int64_t)q;
      if (!kFold) {
        *reinterpret_cast<int4*>(add + cell) = g;
        *reinterpret_cast<int4*>(rm + cell) = rn;
        continue;
      }
      const int4 a0v = __ldcs(reinterpret_cast<const int4*>(add0 + cell));
      const int4 r0v = __ldcs(reinterpret_cast<const int4*>(rm0 + cell));
      uint32_t a = (a_base + 4u * (uint32_t)q) % (uint32_t)R;
      int4 ao, ro;
      fold_cell(g.x, rn.x, a0v.x, r0v.x, __ldg(clock0 + a), __ldg(clock + a),
                retire_rm, &ao.x, &ro.x);
      a = a + 1 == (uint32_t)R ? 0 : a + 1;
      fold_cell(g.y, rn.y, a0v.y, r0v.y, __ldg(clock0 + a), __ldg(clock + a),
                retire_rm, &ao.y, &ro.y);
      a = a + 1 == (uint32_t)R ? 0 : a + 1;
      fold_cell(g.z, rn.z, a0v.z, r0v.z, __ldg(clock0 + a), __ldg(clock + a),
                retire_rm, &ao.z, &ro.z);
      a = a + 1 == (uint32_t)R ? 0 : a + 1;
      fold_cell(g.w, rn.w, a0v.w, r0v.w, __ldg(clock0 + a), __ldg(clock + a),
                retire_rm, &ao.w, &ro.w);
      *reinterpret_cast<int4*>(add + cell) = ao;
      *reinterpret_cast<int4*>(rm + cell) = ro;
    }
    done = L4 * 4;
  }
  for (int32_t j = done + threadIdx.x; j < L; j += blockDim.x) {
    const int64_t cell = base + j;
    if (!kFold) {
      add[cell] = t_add[j];
      rm[cell] = t_rm[j];
      continue;
    }
    const uint32_t a = (a_base + (uint32_t)j) % (uint32_t)R;
    fold_cell(t_add[j], t_rm[j], add0[cell], rm0[cell], clock0[a], clock[a],
              retire_rm, add + cell, rm + cell);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// Opt a kernel in to `bytes` of dynamic shared memory on the current
// device, once per (kernel, device, size).
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int* granted, int dev, size_t bytes) {
  if (dev >= 0 && dev < 64 && granted[dev] >= (int)bytes) return cudaSuccess;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc == cudaSuccess && dev >= 0 && dev < 64) granted[dev] = (int)bytes;
  return rc;
}

int granted_range[2][64], granted_bin[2][64], granted_place[2][64];
int sm_count[64];

template <bool kDense>
cudaError_t launch_rows(const void* kind, const void* member,
                        const void* actor, const void* counter, int64_t n,
                        int32_t E, int32_t R, int32_t range_shift,
                        int32_t n_ranges, int smem_clock, void* count,
                        void* begin, void* clock, void* packed, int dev,
                        int sms, cudaStream_t s) {
  int64_t blocks = (n + kRowThreads - 1) / kRowThreads;
  if (blocks > (int64_t)sms * kRowBlocksPerSM)
    blocks = (int64_t)sms * kRowBlocksPerSM;
  if (blocks < 1) blocks = 1;
  // a multiple of the block size, so each block's loop steps uniformly
  const int64_t chunk = ((n + blocks - 1) / blocks + kRowThreads - 1) /
                        kRowThreads * kRowThreads;
  if (chunk > 0) blocks = (n + chunk - 1) / chunk;
  if (blocks < 1) blocks = 1;  // N = 0: one block still runs the scan
  const size_t count_smem = kDense ? (size_t)n_ranges * sizeof(int32_t) : 0;
  const size_t bin_smem =
      count_smem + (smem_clock ? (size_t)R * sizeof(int32_t) : 0);
  cudaError_t rc = allow_smem(bin_kernel<kDense>, granted_bin[kDense], dev,
                              bin_smem);
  if (rc == cudaSuccess)
    rc = allow_smem(place_kernel<kDense>, granted_place[kDense], dev,
                    count_smem);
  if (rc != cudaSuccess) return rc;
  bin_kernel<kDense><<<(unsigned)blocks, kRowThreads, bin_smem, s>>>(
      (const int8_t*)kind, (const int32_t*)member, (const int32_t*)actor,
      (const int32_t*)counter, n, chunk, E, R, range_shift, n_ranges,
      (int32_t*)count, (int32_t*)begin, (int32_t*)clock, smem_clock);
  if ((rc = cudaGetLastError()) != cudaSuccess || n == 0) return rc;
  place_kernel<kDense><<<(unsigned)blocks, kRowThreads, count_smem, s>>>(
      (const int8_t*)kind, (const int32_t*)member, (const int32_t*)actor,
      (const int32_t*)counter, n, chunk, E, R, range_shift, n_ranges,
      (int32_t*)count, (u64*)packed);
  return cudaGetLastError();
}

}  // namespace

// Scratch from the caller: packed (n u64), count (n_ranges + 1 int32:
// the range counts and a finish ticket), begin (n_ranges + 1 int32).  The
// row passes count in shared memory when n_ranges <= dense_max, and a bin
// block keeps its clock there when R <= clock_smem_max.  add0 == nullptr
// selects the raw epilogue: add/rm receive the scatter planes and clock
// (optional) is raised in place.  Otherwise the fold epilogue: clock
// receives clock0 raised by the batch's adds, add/rm the normalized
// planes.
extern "C" int orset_fold_launch(
    const void* kind, const void* member, const void* actor,
    const void* counter, int64_t n, int32_t E, int32_t R, int32_t range_shift,
    int32_t n_ranges, int32_t dense_max, int32_t clock_smem_max,
    void* packed, void* count, void* begin, const void* clock0, void* clock,
    const void* add0, const void* rm0, int32_t retire_rm, void* add, void* rm,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool fold = add0 != nullptr;
  const int64_t cells = (int64_t)E * R;
  const size_t smem = (size_t)2 * ((size_t)1 << range_shift) * sizeof(int32_t);
  const int smem_clock = clock != nullptr && R <= clock_smem_max;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    rc = cudaDeviceGetAttribute(&sm_count[dev],
                                cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return (int)rc;
  }
  rc = fold ? allow_smem(range_kernel<true>, granted_range[1], dev, smem)
            : allow_smem(range_kernel<false>, granted_range[0], dev, smem);
  if (rc != cudaSuccess) return (int)rc;
  const int64_t prep_n = fold && R > n_ranges ? R : (int64_t)n_ranges + 1;
  prep_kernel<<<(unsigned)((prep_n + 255) / 256), 256, 0, s>>>(
      (int32_t*)count, n_ranges, fold ? (const int32_t*)clock0 : nullptr,
      (int32_t*)clock, R);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  rc = n_ranges <= dense_max
           ? launch_rows<true>(kind, member, actor, counter, n, E, R,
                               range_shift, n_ranges, smem_clock, count,
                               begin, clock, packed, dev, sm_count[dev], s)
           : launch_rows<false>(kind, member, actor, counter, n, E, R,
                                range_shift, n_ranges, smem_clock, count,
                                begin, clock, packed, dev, sm_count[dev], s);
  if (rc != cudaSuccess) return (int)rc;
  const int vec = aligned16(add) && aligned16(rm) &&
                  (!fold || (aligned16(add0) && aligned16(rm0)));
  if (fold) {
    range_kernel<true><<<(unsigned)n_ranges, kRangeThreads, smem, s>>>(
        (const u64*)packed, (const int32_t*)begin, cells, R, range_shift,
        (const int32_t*)clock0, (const int32_t*)clock, (const int32_t*)add0,
        (const int32_t*)rm0, retire_rm, vec, (int32_t*)add, (int32_t*)rm);
  } else {
    range_kernel<false><<<(unsigned)n_ranges, kRangeThreads, smem, s>>>(
        (const u64*)packed, (const int32_t*)begin, cells, R, range_shift,
        nullptr, nullptr, nullptr, nullptr, 0, vec, (int32_t*)add,
        (int32_t*)rm);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
