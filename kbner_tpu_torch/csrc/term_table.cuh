// A query's term set as an open-addressed hash table in shared memory, for
// the pass-2 rescore kernels (delta16_rescore.cu, bm25_rescore.cu).
//
// One warp builds the table of a query's n term slots; every thread of the
// block then looks a document term up with one probe as a rule, in place of
// a compare with each of the n slots. The table maps a term to the sum of
// the weights of all the slots that hold it, summed in slot order, so the
// build is deterministic. The table has 2^log_t >= 2n entries (at most
// half full), a multiplicative hash, linear probing, and kEmpty (INT32_MIN)
// as the empty marker. Every other id is a key, -1 included (the two-array
// rescore compares ids raw, so a -1 query pad matches a -1 document pad); a
// query term equal to kEmpty keeps its weight beside the table, in
// w_empty. The kernels' launches are planned here too: a block per query
// and a run of candidates, with the query's table in dynamic shared memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace term_table {

constexpr int32_t kEmpty = INT32_MIN;
constexpr unsigned kFull = 0xffffffffu;

// log2 of the table size for n term slots: at least 32 entries, and at
// least twice n, so a probe run stays short.
inline int log_size(int n) {
  int lg = 5;
  while ((1 << lg) < 2 * n) ++lg;
  return lg;
}

// Bytes of dynamic shared memory for a table of 2^log_t entries, w_empty
// and the table warp's scratch row.
inline size_t smem_bytes(int log_t) {
  return (sizeof(int32_t) + sizeof(float)) * ((size_t)1 << log_t) +
         33 * sizeof(float);
}

// A pass-2 kernel's grid, dynamic shared memory and table size for Q
// queries of n term slots and C candidates per query, cand_per_block of
// them per block.
struct Launch {
  dim3 grid;
  size_t smem;
  int log_t;
};

inline Launch plan(int Q, int n, int C, int cand_per_block) {
  Launch p;
  p.grid = dim3((C + cand_per_block - 1) / cand_per_block, Q);
  p.log_t = log_size(n);
  p.smem = smem_bytes(p.log_t);
  return p;
}

// Opts kernel in to smem bytes of dynamic shared memory where that is more
// than the 48 KB any kernel may take; a table of up to 6144 terms (131 KB)
// then fits. At the serve shapes it makes no call.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// An empty kernel. Launched on a pass-2 kernel's grid, block and shared
// memory, its time is the least a launch of that kernel can take.
static __global__ void floor_kernel() {}

inline cudaError_t launch_floor(const Launch& p, int threads,
                                cudaStream_t stream) {
  const cudaError_t err = allow_smem(floor_kernel, p.smem);
  if (err != cudaSuccess) return err;
  floor_kernel<<<p.grid, threads, p.smem, stream>>>();
  return cudaGetLastError();
}

struct Table {
  int32_t* keys;
  float* wts;
  float* w_empty;
  float* scratch;  // the table warp's 32 weights of one chunk
  int log_t;
};

__device__ __forceinline__ Table carve(unsigned char* smem, int log_t) {
  Table tb;
  tb.keys = reinterpret_cast<int32_t*>(smem);
  tb.wts = reinterpret_cast<float*>(tb.keys + (1 << log_t));
  tb.w_empty = tb.wts + (1 << log_t);
  tb.scratch = tb.w_empty + 1;
  tb.log_t = log_t;
  return tb;
}

__device__ __forceinline__ int slot(int32_t t, int log_t) {
  return (int)(((uint32_t)t * 2654435761u) >> (32 - log_t));
}

// Called by one whole warp: clears the table and inserts the n slots
// (qt[l], qw[l]), 32 at a time in slot order. The build sits on the
// kernels' critical path (the other warps wait for it at the block
// barrier before their first probe), so a chunk costs few steps:
// __match_any_sync finds its repeats in one instruction, and the next
// chunk's slots load while this one is inserted. Within a chunk, the first
// slot of each term sums the weights of the chunk's slots that hold it, in
// slot order, and inserts the term; a term that an earlier chunk inserted
// gets the chunk's sum added, so each entry sums its slots in slot order.
// With kKeepNegative false, negative terms are dropped.
template <bool kKeepNegative>
__device__ void build(const Table& tb, const int32_t* __restrict__ qt,
                      const float* __restrict__ qw, int n) {
  const int lane = threadIdx.x & 31;
  const int T = 1 << tb.log_t;
  int32_t t_next = lane < n ? qt[lane] : kEmpty;
  float w_next = lane < n ? qw[lane] : 0.f;
  for (int s = lane; s < T; s += 32) {
    tb.keys[s] = kEmpty;
    tb.wts[s] = 0.f;
  }
  if (lane == 0) *tb.w_empty = 0.f;
  __syncwarp();
  for (int base = 0; base < n; base += 32) {
    const bool in = base + lane < n;
    const int32_t t = t_next;  // kEmpty with weight 0 past n
    const float w = w_next;
    if (base + 32 + lane < n) {  // the next chunk loads meanwhile
      t_next = qt[base + 32 + lane];
      w_next = qw[base + 32 + lane];
    }
    const unsigned same = __match_any_sync(kFull, t);
    tb.scratch[lane] = w;
    __syncwarp();
    if (in && (kKeepNegative || t >= 0) && __ffs(same) - 1 == lane) {
      float sum = 0.f;  // lanes past n add weight 0
      for (unsigned m = same; m != 0u; m &= m - 1u)
        sum += tb.scratch[__ffs(m) - 1];
      if (t == kEmpty) {
        *tb.w_empty += sum;
      } else {
        int h = slot(t, tb.log_t);
        for (;;) {
          const int32_t prev = atomicCAS(&tb.keys[h], kEmpty, t);
          if (prev == kEmpty || prev == t) break;
          h = (h + 1) & (T - 1);
        }
        tb.wts[h] += sum;  // the chunk's first slots hold distinct keys
      }
    }
    __syncwarp();  // the scratch row and the entries are done
  }
}

// Whether term t is in the table; w is its summed weight (0 on a miss).
__device__ __forceinline__ bool lookup(const Table& tb, int32_t t, float& w) {
  const int mask = (1 << tb.log_t) - 1;
  int h = slot(t, tb.log_t);
  int32_t k = tb.keys[h];
  while (k != t && k != kEmpty) {
    h = (h + 1) & mask;
    k = tb.keys[h];
  }
  w = t == kEmpty ? *tb.w_empty : tb.wts[h];
  return k == t;
}

}  // namespace term_table
