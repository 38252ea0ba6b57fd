// LWW-map winner fold for Hopper (sm_90a): the per-key lexicographic max
// of crdt_enc_tpu_torch.ops.lww.lww_fold.
//
// Replaces, in crdt_enc_tpu/ops/pallas_lww.py, lww_fold_pallas ->
// _lww_fold_pallas_impl (pallas_call at :332, kernel _lww_tile_kernel).
//
// The TPU kernel sorts the rows by (key, ts_hi, ts_lo, actor*V + value)
// and materializes each key run's last row with one-hot bf16 limb matmuls
// over 16,384-key tiles, because the TPU has no fast scatter; that is why
// it bounds rows at 2^22 and needs a packed rank.  Hopper has a fast
// 64-bit atomicMax in L2, so the fold is two scatter passes and a decode,
// with no sort, no tiles and no row bound.  Only the output must match,
// bit for bit.
//
//   pass 1  one thread per row: t = ((ts_hi << 31) | ts_lo) + 1, atomicMax
//           into best_ts[key].  The +1 makes 0 mean "no row", so a real
//           timestamp of 0 is still present; t <= 2^62 cannot overflow.
//   pass 2  one thread per row whose t equals best_ts[key]: atomicMax of
//           ((actor << 31) | value) + 1 into best_av[key].  Ranks lie in
//           [0, 2^31), so this is the whole (actor, value) order in 62
//           bits — the same winner as the packed rank actor*V + value
//           whenever value < V (the caller's contract), and as the JAX
//           4-cascade without num_values.
//   pass 3  elementwise over K: present = best_ts > 0; hi, lo, actor,
//           value unpacked from best_ts - 1 and best_av - 1, else -1.
//
// Rows with key < 0 or key >= K (the padding sentinel) drop out.
//
// What bounds it on this card: bytes, and contention where many rows share
// a key.  The rows are read twice (20 bytes each pass 1, again in pass 2)
// and the two (K,) uint64 scratch tables live in L2 at config 4
// (K = 1M: 16 MB).  A row first reads its key's current maximum and skips
// the atomic when it cannot raise it (the table only grows, so a stale
// read is never too high): under heavy ties (~1,000 rows a key) most rows
// then issue no atomic at all.
//
// The entry point zeroes the scratch, launches the three passes on the
// given stream and returns cudaGetLastError(); the Python wrapper raises
// when that is nonzero.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBits = 31;
constexpr uint64_t kMask = (1ull << kBits) - 1;

__device__ __forceinline__ uint64_t pack(int32_t hi, int32_t lo) {
  return (((uint64_t)(uint32_t)hi << kBits) | (uint32_t)lo) + 1;
}

__device__ __forceinline__ void raise_to(unsigned long long* slot,
                                         unsigned long long v) {
  if (__ldcg(slot) < v) atomicMax(slot, v);
}

__global__ void ts_max_kernel(const int32_t* __restrict__ key,
                              const int32_t* __restrict__ ts_hi,
                              const int32_t* __restrict__ ts_lo, int64_t n,
                              int32_t K, unsigned long long* best_ts) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t k = key[i];
    if (k < 0 || k >= K) continue;
    raise_to(best_ts + k, pack(ts_hi[i], ts_lo[i]));
  }
}

__global__ void av_max_kernel(const int32_t* __restrict__ key,
                              const int32_t* __restrict__ ts_hi,
                              const int32_t* __restrict__ ts_lo,
                              const int32_t* __restrict__ actor,
                              const int32_t* __restrict__ value, int64_t n,
                              int32_t K,
                              const unsigned long long* __restrict__ best_ts,
                              unsigned long long* best_av) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t k = key[i];
    if (k < 0 || k >= K) continue;
    if (pack(ts_hi[i], ts_lo[i]) != best_ts[k]) continue;
    raise_to(best_av + k, pack(actor[i], value[i]));
  }
}

__global__ void decode_kernel(const unsigned long long* __restrict__ best_ts,
                              const unsigned long long* __restrict__ best_av,
                              int32_t K, int32_t* __restrict__ win_hi,
                              int32_t* __restrict__ win_lo,
                              int32_t* __restrict__ win_actor,
                              int32_t* __restrict__ win_value,
                              bool* __restrict__ present) {
  const int32_t k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const uint64_t t = best_ts[k];
  const bool p = t > 0;
  const uint64_t ts = t - 1;
  const uint64_t av = best_av[k] - 1;
  win_hi[k] = p ? (int32_t)(ts >> kBits) : -1;
  win_lo[k] = p ? (int32_t)(ts & kMask) : -1;
  win_actor[k] = p ? (int32_t)(av >> kBits) : -1;
  win_value[k] = p ? (int32_t)(av & kMask) : -1;
  present[k] = p;
}

}  // namespace

extern "C" int lww_fold_launch(const void* key, const void* ts_hi,
                               const void* ts_lo, const void* actor,
                               const void* value, int64_t n, int32_t K,
                               void* scratch, void* win_hi, void* win_lo,
                               void* win_actor, void* win_value,
                               void* present, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* best_ts = (unsigned long long*)scratch;
  unsigned long long* best_av = best_ts + K;
  cudaError_t rc = cudaMemsetAsync(scratch, 0, 2 * sizeof(uint64_t) * K, s);
  if (rc != cudaSuccess) return (int)rc;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  if (blocks < 1) blocks = 1;
  ts_max_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const int32_t*)key, (const int32_t*)ts_hi, (const int32_t*)ts_lo, n,
      K, best_ts);
  av_max_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const int32_t*)key, (const int32_t*)ts_hi, (const int32_t*)ts_lo,
      (const int32_t*)actor, (const int32_t*)value, n, K, best_ts, best_av);
  const unsigned kblocks = (unsigned)((K + kThreads - 1) / kThreads);
  decode_kernel<<<kblocks, kThreads, 0, s>>>(
      best_ts, best_av, K, (int32_t*)win_hi, (int32_t*)win_lo,
      (int32_t*)win_actor, (int32_t*)win_value, (bool*)present);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
