// S-way OR-Set state merge for Hopper (sm_90a): the kernel behind
// crdt_enc_tpu_torch.ops.orset.orset_merge_many on CUDA tensors.
//
// Replaces crdt_enc_tpu/ops/pallas_merge.py orset_merge_many_pallas
// (pallas_call at :111, kernel _merge_step_kernel at :35).  On the TPU
// the S states stream through VMEM along a sequential grid axis, with
// the output block resident across the S steps.  Blocks here run in
// parallel and in no order, so the S axis becomes a loop inside each
// thread: one thread per (e, r) cell keeps the accumulator in registers
// and applies merge_rule (crdt_enc_tpu_torch/ops/orset.py) for
// s = 1 .. S-1, a left fold that is legal because the merge is
// associative.  The running merged clock (the cummax over S) and its
// predecessor come precomputed from the wrapper, as in pallas_merge.py.
//
// What bounds it on this card: bytes.  Every input plane is read once
// and the two output planes are written once, coalesced along R:
// (S + 1) * 2 * E * R * 4 bytes plus the three (S, R) clock rows, which
// stay in L1/L2.  At S = 8, E = 4096, R = 10,000 that is ~2.95 GB.
// The work per cell is a handful of integer compares per step.
//
// A second entry, orset_stack_cells_launch, builds the stacks K4 reads
// from the states' cells instead of from dense host planes (it replaces
// no TPU kernel: the JAX package densifies on the host).  Sparse
// snapshots fill about one plane slot in a thousand, so shipping
// coordinates moves a few MB where the dense stacks are
// S * 2 * E * R * 4 bytes (1.47 GB for nine config-3 snapshots).  The
// host lists each cell once as (e * R + r, counter), grouped by plane
// (adds, then removes) and state, with 2S + 1 group offsets; the entry
// zero-fills one (2, S, E, R) buffer with cudaMemsetAsync and launches
// stack_cells_kernel, one thread per cell, which finds its group by a
// binary search over the offsets and stores its counter.  A state holds
// a cell once, so plain stores suffice.  What bounds it: the memset's
// 2 * S * E * R * 4 bytes; the cells are 8 bytes each, read once.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError() (or the memset's error); the Python wrapper raises
// when that is nonzero.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void merge_kernel(const int32_t* __restrict__ clocks,
                             const int32_t* __restrict__ prev_run,
                             const int32_t* __restrict__ run,
                             const int32_t* __restrict__ adds,
                             const int32_t* __restrict__ rms, int32_t S,
                             int32_t E, int32_t R,
                             int32_t* __restrict__ out_add,
                             int32_t* __restrict__ out_rm) {
  const int32_t r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int64_t plane = (int64_t)E * R;
  for (int64_t e = blockIdx.y; e < E; e += gridDim.y) {
    const int64_t i = e * R + r;
    int32_t acc_add = adds[i];
    int32_t acc_rm = rms[i];
#pragma unroll 4
    for (int32_t s = 1; s < S; ++s) {
      const int64_t j = s * plane + i;
      const int64_t k = (int64_t)s * R + r;
      const int32_t b = adds[j];
      const int32_t b_rm = rms[j];
      const int32_t clock_a = prev_run[k];  // clock of the fold so far
      const int32_t clock_b = clocks[k];    // clock of state s
      const int32_t clock_m = run[k];       // merged clock after step s
      // merge_rule: a dot survives when both sides hold it or the other
      // side has not seen it yet
      const bool same = acc_add == b;
      const int32_t surv_a = (same || acc_add > clock_b) ? acc_add : 0;
      const int32_t surv_b = (same || b > clock_a) ? b : 0;
      int32_t av = max(surv_a, surv_b);
      int32_t rv = max(acc_rm, b_rm);
      av = av > rv ? av : 0;
      rv = rv > clock_m ? rv : 0;
      acc_add = av;
      acc_rm = rv;
    }
    out_add[i] = acc_add;
    out_rm[i] = acc_rm;
  }
}

// cells: (n, 2) int32 rows (e * R + r, counter); offsets: 2S + 1 int64,
// offsets[g] the first row of group g = plane * S + s, offsets[2S] = n.
__global__ void stack_cells_kernel(const int2* __restrict__ cells,
                                   const int64_t* __restrict__ offsets,
                                   int32_t groups, int64_t n, int64_t plane,
                                   int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // the last group whose first row is at or before i (groups may be empty)
  int32_t lo = 0, hi = groups;
  while (hi - lo > 1) {
    const int32_t mid = (lo + hi) >> 1;
    if (offsets[mid] <= i) lo = mid; else hi = mid;
  }
  const int2 c = cells[i];
  out[(int64_t)lo * plane + c.x] = c.y;
}

}  // namespace

extern "C" int orset_stack_cells_launch(const void* cells,
                                        const void* offsets, int64_t n,
                                        int32_t S, int32_t E, int32_t R,
                                        void* out, void* stream) {
  const int64_t plane = (int64_t)E * R;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(out, 0, (size_t)(2 * S * plane) * 4, st);
  if (rc != cudaSuccess) return (int)rc;
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    stack_cells_kernel<<<blocks, kThreads, 0, st>>>(
        (const int2*)cells, (const int64_t*)offsets, 2 * S, n, plane,
        (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int orset_merge_many_launch(const void* clocks,
                                       const void* prev_run, const void* run,
                                       const void* adds, const void* rms,
                                       int32_t S, int32_t E, int32_t R,
                                       void* out_add, void* out_rm,
                                       void* stream) {
  const unsigned gx = (unsigned)((R + kThreads - 1) / kThreads);
  const unsigned gy = (unsigned)(E < 65535 ? E : 65535);
  merge_kernel<<<dim3(gx, gy), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)clocks, (const int32_t*)prev_run,
      (const int32_t*)run, (const int32_t*)adds, (const int32_t*)rms, S, E,
      R, (int32_t*)out_add, (int32_t*)out_rm);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
