// LWW-map winner fold for Hopper (sm_90a): the per-key lexicographic max
// of crdt_enc_tpu_torch.ops.lww.lww_fold, as one persistent cooperative
// launch behind crdt_enc_tpu_torch.ops.lww_fold_cuda.
//
// Replaces, in crdt_enc_tpu/ops/pallas_lww.py, lww_fold_pallas ->
// _lww_fold_pallas_impl (pallas_call at :332, kernel _lww_tile_kernel).
//
// The TPU kernel sorts the rows by (key, ts_hi, ts_lo, actor*V + value)
// and materializes each key run's last row with one-hot bf16 limb matmuls
// over 16,384-key tiles, because the TPU has no fast scatter; that is why
// it bounds rows at 2^22 and needs a packed rank.  Hopper has a 64-bit
// atomicMax in L2, so the fold needs no sort, no key tiles and no row
// bound.  Only the output must match, bit for bit.
//
// Packing.  t = ((ts_hi << 31) | ts_lo) + 1: the +1 makes 0 mean "no row",
// so a real timestamp of 0 is still present; t <= 2^62.  A key's winner is
// its max t, then among those rows the max (actor, value).  Two modes:
//   one word   where the batch's bit widths allow (bits(t) + bits(actor) +
//              bits(value) <= pack_bits, normally 64): w = t << (A + V) |
//              actor << V | value, with A and V the bit widths of the OR of
//              all actors and of all values that fold.  One atomicMax of w
//              a row decides the whole order.  Config 4 (ts < 2^40, 10,000
//              actors, 100 values) packs into 41 + 14 + 7 bits.
//   two words  otherwise (timestamps near 2^62): slot 0 takes max t, then
//              every row whose t equals it raises slot 1 to ((actor << 31)
//              | value) + 1, the whole (actor, value) order in 62 bits —
//              the same winner as the packed rank actor*V + value whenever
//              value < V (the caller's contract), and as the JAX 4-cascade
//              without num_values.
// Neither mode needs num_values, so the kernel ignores it.  Rows with
// key < 0 or key >= K (the padding sentinel) drop out.
//
// What bounds it on this card.  The least traffic is 20 bytes a row read
// once and 17 bytes a key written once (37 MB at config 4, N = K = 1M:
// 11 us at 3.35 TB/s).  The table (8 bytes a key and slot, 8 or 16 MB at
// config 4) must be zeroed and read back, but stays in the 50 MB L2.  What
// the card showed holds the fold back is random L2 traffic, not bytes:
// the first version (a memset, then three kernels reading every row
// twice) took 67 us of device time at config 4 on an H100 SXM, and this
// kernel made to raise two slots a row (chip_smoke.py's "two words" mode)
// still takes 53-57 us with every row read once.  So the design packs one
// word a row where it can (one random L2 atomic a row, one barrier less:
// 31 us), and raises global slots without reading them first.
//
// One cooperative launch of every block the card holds at once, phases
// apart by grid barriers:
//   0. zero slot 0 with 16-byte stores (no memset); each thread loads up
//      to kRowsMax rows of its block's contiguous stretch (coalesced,
//      streaming loads, so the rows do not evict the table) and keeps key,
//      t, actor and value in registers; each block ORs the widths of its
//      rows into its own partial (no shared word to zero first);
//   1. every block ORs the partials and picks the mode.  One word: raise
//      slot 0 to w.  Two words: zero slot 1, raise slot 0 to t; barrier;
//      rows whose t equals slot 0 raise slot 1;
//   2. decode, grid-stride over groups of four keys: present = slot 0 > 0,
//      (hi, lo, actor, value) unpacked, else -1; int4 stores.
//
// Batches past register residency (N > blocks * kThreads * rows) loop over
// chunks of that many rows: phase 0 reads them all for the widths, and each
// later pass runs the chunk still in registers, then re-reads the others.
// Row indices are int64, so N has no bound.
//
// The shared route (tile_keys > 0): each block folds the rows of keys
// [0, tile_keys) into its own copy of their slots in shared memory first
// (reading a slot before it raises it: the tile only grows, so a stale
// read is never too high, and under heavy ties most rows issue no shared
// atomic), then merges the slots it touched into the global table with
// one atomic a key (again only where it raises).  The rank pass compares
// a row with the block's own maximum before it reads the global one.
// That takes a hot key's contention out of L2.  Keys past tile_keys go straight to the global table, so the
// route is exact for any K; the wrapper takes it where the whole table
// fits a block's shared memory.
//
// The entry point launches with cudaLaunchCooperativeKernel (grid
// barriers need every block resident; the wrapper sizes the grid from
// lww_fold_occupancy) and returns the launch's error, which the Python
// wrapper raises on.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 512;  // THREADS in ops/lww_fold_cuda.py
constexpr int kRowsMax = 16;   // ROWS_MAX there
constexpr int kGroup = 4;      // rows whose tile reads are in flight together
constexpr int kWarps = kThreads / 32;
constexpr int kBits = 31;
constexpr u64 kMask = (1ull << kBits) - 1;
constexpr u64 kNone = ~0ull;   // a read slot that raises nothing
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const int32_t* key;
  const int32_t* ts_hi;
  const int32_t* ts_lo;
  const int32_t* actor;
  const int32_t* value;
  int64_t n;
  int32_t K;
  int32_t k_pad;      // K rounded up to 4: the slots' and outputs' length
  int32_t tile_keys;  // keys [0, tile_keys) fold in shared memory first
  int32_t rows;       // rows per thread per chunk, <= kRowsMax
  int32_t chunks;
  int32_t pack_bits;  // the widest word the one-word mode takes
  u64* table;         // (2, k_pad): slot 0, then slot 1
  ulonglong2* partial;  // (gridDim): each block's OR of t, of actor | value
  int32_t* win;       // (4, k_pad): hi, lo, actor, value
  uint32_t* present;  // (k_pad,) bool, four to a word
};

struct Rows {
  int32_t key[kRowsMax];  // -1: no row, or a row that drops out
  u64 ts[kRowsMax];       // t
  int32_t actor[kRowsMax];
  int32_t value[kRowsMax];
};

struct Mode {
  bool word;  // the one-word mode
  int a, v;   // bit widths of actor and value in it
};

__device__ __forceinline__ u64 pack(int32_t hi, int32_t lo) {
  return (((u64)(uint32_t)hi << kBits) | (uint32_t)lo) + 1;
}

// Rows first, first + kThreads, ... of this thread; all five columns are
// loaded before any is tested, so every load is in flight at once.
__device__ __forceinline__ void load_rows(const Params& p, int64_t first,
                                          Rows& r) {
#pragma unroll
  for (int j = 0; j < kRowsMax; ++j) {
    const int64_t i = first + (int64_t)j * kThreads;
    int32_t k = -1, hi = 0, lo = 0, a = 0, v = 0;
    if (j < p.rows && i < p.n) {
      k = __ldcs(p.key + i);
      hi = __ldcs(p.ts_hi + i);
      lo = __ldcs(p.ts_lo + i);
      a = __ldcs(p.actor + i);
      v = __ldcs(p.value + i);
    }
    r.key[j] = (k >= 0 && k < p.K) ? k : -1;
    r.ts[j] = pack(hi, lo);
    r.actor[j] = a;
    r.value[j] = v;
  }
}

// Run f over every chunk of this thread's rows: first the chunk still in
// the registers (`held`), then the others, re-read.
template <class F>
__device__ __forceinline__ void for_chunks(const Params& p, Rows& r, int& held,
                                           int64_t first, int64_t per_chunk,
                                           F f) {
  const int skip = held;
  if (skip >= 0) f(r);
  for (int c = 0; c < p.chunks; ++c) {
    if (c == skip) continue;
    load_rows(p, c * per_chunk + first, r);
    f(r);
    held = c;
  }
}

template <bool kTile>
__device__ __forceinline__ bool in_tile(const Params& p, int32_t k) {
  return kTile && k < p.tile_keys;
}

// Raise slot `slot` of each key[q] >= 0 to x[q].  A global slot takes the
// atomic straight away: at config 4 (about one row a key) a read first
// costs more L2 traffic than it saves, and on a hot key it saves nothing
// either.  A tile slot is read first (the group's reads, then the atomics
// that can raise: the tile only grows, so a stale read is never too high),
// which under heavy ties spares most shared atomics.
template <bool kTile>
__device__ __forceinline__ void raise_slots(const Params& p, u64* tile,
                                            int slot,
                                            const int32_t (&key)[kGroup],
                                            const u64 (&x)[kGroup]) {
  u64* table = p.table + (int64_t)slot * p.k_pad;
  u64* mine = tile + slot * p.tile_keys;
  u64 cur[kGroup];
#pragma unroll
  for (int q = 0; q < kGroup; ++q) {
    const int32_t k = key[q];
    cur[q] = k < 0 ? kNone : in_tile<kTile>(p, k) ? mine[k] : 0;
  }
#pragma unroll
  for (int q = 0; q < kGroup; ++q) {
    if (cur[q] >= x[q]) continue;
    if (in_tile<kTile>(p, key[q])) {
      atomicMax(mine + key[q], x[q]);
    } else {
      atomicMax(table + key[q], x[q]);
    }
  }
}

// One word: slot 0 to w = t << (A + V) | actor << V | value.
template <bool kTile>
__device__ __forceinline__ void raise_words(const Params& p, const Rows& r,
                                            u64* tile, Mode m) {
#pragma unroll
  for (int j0 = 0; j0 < kRowsMax; j0 += kGroup) {
    int32_t key[kGroup];
    u64 x[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const int j = j0 + q;
      key[q] = r.key[j];
      x[q] = (r.ts[j] << (m.a + m.v)) | ((u64)(uint32_t)r.actor[j] << m.v) |
             (uint32_t)r.value[j];
    }
    raise_slots<kTile>(p, tile, 0, key, x);
  }
}

// Two words, first pass: slot 0 to t.
template <bool kTile>
__device__ __forceinline__ void raise_ts(const Params& p, const Rows& r,
                                         u64* tile) {
#pragma unroll
  for (int j0 = 0; j0 < kRowsMax; j0 += kGroup) {
    int32_t key[kGroup];
    u64 x[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      key[q] = r.key[j0 + q];
      x[q] = r.ts[j0 + q];
    }
    raise_slots<kTile>(p, tile, 0, key, x);
  }
}

// Two words, second pass: rows whose t equals the key's final t raise
// slot 1 to their (actor, value).  A tile row below its block's own
// maximum cannot hold the key's, so it reads no global slot.
template <bool kTile>
__device__ __forceinline__ void raise_ranks(const Params& p, const Rows& r,
                                            u64* tile) {
#pragma unroll
  for (int j0 = 0; j0 < kRowsMax; j0 += kGroup) {
    u64 cur[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const int j = j0 + q;
      const int32_t k = r.key[j];
      cur[q] = 0;  // t >= 1, so 0 matches no row
      if (k >= 0 && (!in_tile<kTile>(p, k) || tile[k] == r.ts[j])) {
        cur[q] = __ldcg(p.table + k);
      }
    }
    int32_t key[kGroup];
    u64 x[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const int j = j0 + q;
      key[q] = cur[q] == r.ts[j] ? r.key[j] : -1;
      x[q] = pack(r.actor[j], r.value[j]);
    }
    raise_slots<kTile>(p, tile, 1, key, x);
  }
}

// The shared route: raise the global slot `slot` of every key this block
// touched to the block's own, eight keys a thread in flight at a time.
__device__ __forceinline__ void merge_tile(const Params& p, const u64* tile,
                                           int slot) {
  constexpr int B = 8;
  u64* table = p.table + (int64_t)slot * p.k_pad;
  const u64* mine = tile + slot * p.tile_keys;
  for (int k0 = threadIdx.x; k0 < p.tile_keys; k0 += B * kThreads) {
    u64 v[B], cur[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int k = k0 + b * kThreads;
      v[b] = k < p.tile_keys ? mine[k] : 0;
      cur[b] = v[b] ? __ldcg(table + k) : kNone;
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (cur[b] < v[b]) atomicMax(table + k0 + b * kThreads, v[b]);
    }
  }
}

// OR over a warp of a 64-bit word.
__device__ __forceinline__ u64 warp_or(u64 x) {
  const u64 lo = __reduce_or_sync(kFull, (uint32_t)x);
  const u64 hi = __reduce_or_sync(kFull, (uint32_t)(x >> 32));
  return (hi << 32) | lo;
}

// The block's OR of t and of (actor | value << 32) over its rows that fold,
// into partial[blockIdx.x].
__device__ __forceinline__ void write_partial(const Params& p, u64 t_or,
                                              u64 av_or, ulonglong2* red) {
  t_or = warp_or(t_or);
  av_or = warp_or(av_or);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = make_ulonglong2(t_or, av_or);
  __syncthreads();
  if (threadIdx.x == 0) {
    ulonglong2 all = red[0];
    for (int w = 1; w < kWarps; ++w) {
      all.x |= red[w].x;
      all.y |= red[w].y;
    }
    p.partial[blockIdx.x] = all;
  }
}

// Every block's partials ORed, and the mode they allow.
__device__ __forceinline__ Mode read_mode(const Params& p, ulonglong2* red) {
  __syncthreads();  // red is free again
  if (threadIdx.x < 32) {
    u64 t_or = 0, av_or = 0;
    for (int b = threadIdx.x; b < gridDim.x; b += 32) {
      const ulonglong2 e = __ldcg(p.partial + b);
      t_or |= e.x;
      av_or |= e.y;
    }
    t_or = warp_or(t_or);
    av_or = warp_or(av_or);
    if (threadIdx.x == 0) red[0] = make_ulonglong2(t_or, av_or);
  }
  __syncthreads();
  const ulonglong2 all = red[0];
  const int t = 64 - __clzll(all.x);
  const int a = 32 - __clz((uint32_t)all.y);
  const int v = 32 - __clz((uint32_t)(all.y >> 32));
  return Mode{t + a + v <= p.pack_bits && a + v < 64, a, v};
}

__device__ __forceinline__ void zero_slots(u64* slots, int32_t k_pad,
                                           int64_t tid, int64_t stride) {
  ulonglong2* two = reinterpret_cast<ulonglong2*>(slots);
  for (int64_t i = tid; i < k_pad / 2; i += stride) two[i] = make_ulonglong2(0, 0);
}

__device__ __forceinline__ void decode(const Params& p, Mode m, int64_t tid,
                                       int64_t stride) {
  const ulonglong2* s0 = reinterpret_cast<const ulonglong2*>(p.table);
  const ulonglong2* s1 = reinterpret_cast<const ulonglong2*>(p.table + p.k_pad);
  int4* hi4 = reinterpret_cast<int4*>(p.win);
  int4* lo4 = reinterpret_cast<int4*>(p.win + p.k_pad);
  int4* ac4 = reinterpret_cast<int4*>(p.win + 2 * (int64_t)p.k_pad);
  int4* va4 = reinterpret_cast<int4*>(p.win + 3 * (int64_t)p.k_pad);
  const u64 mask_a = (1ull << m.a) - 1, mask_v = (1ull << m.v) - 1;
  for (int64_t g = tid; g < p.k_pad / 4; g += stride) {
    const ulonglong2 e01 = __ldcg(s0 + 2 * g), e23 = __ldcg(s0 + 2 * g + 1);
    const u64 e[4] = {e01.x, e01.y, e23.x, e23.y};
    u64 f[4] = {0, 0, 0, 0};
    if (!m.word) {
      const ulonglong2 f01 = __ldcg(s1 + 2 * g), f23 = __ldcg(s1 + 2 * g + 1);
      f[0] = f01.x, f[1] = f01.y, f[2] = f23.x, f[3] = f23.y;
    }
    int32_t h[4], l[4], a[4], v[4];
    uint32_t pres = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool on = e[q] > 0;
      u64 ts, ac, va;
      if (m.word) {
        ts = (e[q] >> (m.a + m.v)) - 1;
        ac = (e[q] >> m.v) & mask_a;
        va = e[q] & mask_v;
      } else {
        ts = e[q] - 1;
        ac = (f[q] - 1) >> kBits;
        va = (f[q] - 1) & kMask;
      }
      h[q] = on ? (int32_t)(ts >> kBits) : -1;
      l[q] = on ? (int32_t)(ts & kMask) : -1;
      a[q] = on ? (int32_t)ac : -1;
      v[q] = on ? (int32_t)va : -1;
      pres |= (uint32_t)on << (8 * q);
    }
    hi4[g] = make_int4(h[0], h[1], h[2], h[3]);
    lo4[g] = make_int4(l[0], l[1], l[2], l[3]);
    ac4[g] = make_int4(a[0], a[1], a[2], a[3]);
    va4[g] = make_int4(v[0], v[1], v[2], v[3]);
    p.present[g] = pres;
  }
}

template <bool kTile>
__global__ void __launch_bounds__(kThreads) lww_fold_kernel(const Params p) {
  extern __shared__ u64 tile[];  // (2, tile_keys) on the shared route
  __shared__ ulonglong2 red[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t per_chunk = stride * p.rows;
  const int64_t first = (int64_t)blockIdx.x * kThreads * p.rows + threadIdx.x;

  // 0. zero slot 0 (and the tile); load the rows and OR their widths
  zero_slots(p.table, p.k_pad, tid, stride);
  if (kTile) {
    for (int i = threadIdx.x; i < 2 * p.tile_keys; i += kThreads) tile[i] = 0;
  }
  Rows r;
  int held = -1;
  u64 t_or = 0, av_or = 0;
  for (int c = 0; c < p.chunks; ++c) {
    load_rows(p, c * per_chunk + first, r);
    held = c;
#pragma unroll
    for (int j = 0; j < kRowsMax; ++j) {
      if (r.key[j] < 0) continue;
      t_or |= r.ts[j];
      av_or |= (uint32_t)r.actor[j] | ((u64)(uint32_t)r.value[j] << 32);
    }
  }
  write_partial(p, t_or, av_or, red);
  grid.sync();

  // 1. the raises
  const Mode m = read_mode(p, red);
  if (m.word) {
    for_chunks(p, r, held, first, per_chunk,
               [&](const Rows& x) { raise_words<kTile>(p, x, tile, m); });
    if (kTile) {
      __syncthreads();
      merge_tile(p, tile, 0);
    }
    grid.sync();
  } else {
    zero_slots(p.table + p.k_pad, p.k_pad, tid, stride);
    for_chunks(p, r, held, first, per_chunk,
               [&](const Rows& x) { raise_ts<kTile>(p, x, tile); });
    if (kTile) {
      __syncthreads();
      merge_tile(p, tile, 0);
    }
    grid.sync();
    for_chunks(p, r, held, first, per_chunk,
               [&](const Rows& x) { raise_ranks<kTile>(p, x, tile); });
    if (kTile) {
      __syncthreads();
      merge_tile(p, tile, 1);
    }
    grid.sync();
  }

  // 2. decode, four keys a thread per step
  decode(p, m, tid, stride);
}

const void* kernel_for(bool tile) {
  return tile ? (const void*)lww_fold_kernel<true>
              : (const void*)lww_fold_kernel<false>;
}

}  // namespace

// The current device's SM count and how many blocks of the route's kernel
// (kThreads threads, smem bytes of dynamic shared memory) one SM holds at
// once.  Also lifts the shared route's dynamic shared memory limit to the
// device's opt-in maximum, which every later launch relies on.
extern "C" int lww_fold_occupancy(int tile, int64_t smem, int* sms,
                                  int* blocks_per_sm) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess && tile) {
    int optin = 0;
    cudaFuncAttributes attr;
    rc = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
    if (rc == cudaSuccess) rc = cudaFuncGetAttributes(&attr, kernel_for(true));
    if (rc == cudaSuccess)  // what the static shared memory leaves
      rc = cudaFuncSetAttribute(kernel_for(true),
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                optin - (int)attr.sharedSizeBytes);
  }
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel_for(tile), kThreads, (size_t)smem);
  cudaGetLastError();  // leave no sticky error for the next caller
  return (int)rc;
}

// table: 2 * k_pad + 2 * blocks uint64 of scratch (the slots, then the
// blocks' partials); win: 4 * k_pad int32; present: k_pad bytes.
extern "C" int lww_fold_launch(const void* key, const void* ts_hi,
                               const void* ts_lo, const void* actor,
                               const void* value, int64_t n, int32_t K,
                               int32_t k_pad, int32_t tile_keys, int64_t smem,
                               int32_t threads, int32_t blocks, int32_t rows,
                               int32_t chunks, int32_t pack_bits, void* table,
                               void* win, void* present, void* stream) {
  if (threads != kThreads || rows < 1 || rows > kRowsMax || k_pad % 4)
    return (int)cudaErrorInvalidValue;
  Params p{(const int32_t*)key, (const int32_t*)ts_hi, (const int32_t*)ts_lo,
           (const int32_t*)actor, (const int32_t*)value, n, K, k_pad,
           tile_keys, rows, chunks, pack_bits, (u64*)table,
           (ulonglong2*)((u64*)table + 2 * (int64_t)k_pad), (int32_t*)win,
           (uint32_t*)present};
  void* args[] = {&p};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      kernel_for(tile_keys > 0), dim3((unsigned)blocks), dim3(kThreads), args,
      (size_t)smem, (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(rc != cudaSuccess ? rc : last);
}

extern "C" const char* cuda_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
