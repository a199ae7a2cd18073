// Exhaustive BM25 block scoring for Hopper (sm_90a).
//
// Replaces the TPU kernel kbner_tpu/ops/bm25.py:_bm25_kernel, called
// through kbner_tpu/ops/bm25.py:bm25_score_block_pallas. It computes
//
//   score[q, d] = sum_l sum_j di_t[j, d] * qw[q, l] * [dt_t[j, d] == qt[q, l]]
//
// over queries qt/qw [Q, Lq] and the transposed document slots dt_t/di_t
// [Ld, N] (row stride doc_stride, so a doc-axis slice at any column offset
// needs no copy), and writes out [Q, N] float32 (row stride N). Negative ids
// never match: the index pads doc slots with -1 and queries with -2 (out of
// vocabulary). Here a negative doc slot is skipped and negative query terms
// are dropped when the block builds its term table.
//
// Bound on this card. The function needs one membership test of each
// non-pad doc slot in each query's term set, integer work on the CUDA cores
// (no tensor-core form), and must read N*Ld*8 bytes of index and write
// Q*N*4 bytes of scores. At the serve shape (Q = 32, Lq = 64, Ld = 52,
// N = 1M) that is 0.54 GB, 0.16 ms at 3.35 TB/s, against 0.68 G lookups,
// 0.04 ms at the int32 rate (64 int32 lanes per SM): the function is bound
// by bytes, and the design keeps the lookups far below that line.
//
// Design.
//  * Term table. A block owns a tile of kQueries queries. It hashes the
//    tile's real terms into an open-addressed table in shared memory
//    (multiplicative hash, linear probing, key -1 = empty, at most half
//    full). Each key holds a 32-bit mask of the queries that contain it and
//    the start of its run of weights, one per set bit in query order; a
//    term repeated within a query has its weights summed in slot order.
//    One warp builds each query from registers, so the build is short and
//    deterministic. A doc slot then costs one probe (usually one shared
//    load) for all queries of the tile, and most slots miss.
//  * Persistent grid. One kThreads block per SM walks doc tiles of kTile
//    documents with a grid stride, so each block builds its table once. The
//    first pipeline stages are started before the build and overlap it.
//  * Pipelined doc tiles. Each thread owns one document column of the tile
//    and its [Ld] slots stream through a kStages-deep ring of kSlots rows in
//    shared memory with cp.async, so the next slots load while the current
//    ones are probed. A warp copies only the 32 columns it reads itself, so
//    the stream needs no block barrier. Where the operands are 16-byte
//    aligned with a row stride of a multiple of 4 (a fresh [Ld, N] index),
//    the copies are 16 bytes wide; a 16-byte chunk that straddles N never
//    crosses a 16-byte boundary, so it stays inside the allocation. Other
//    operands (doc-axis slices at odd offsets, N not a multiple of 4) take
//    4-byte copies of each thread's own column, legal at any offset.
//  * Sums. The hits of one slot row go through the warp's queue in shared
//    memory and are broadcast across the warp, kBatch at a time: lane q
//    adds w(q) * impact into the shared sum of (query q, that document).
//    The sums are laid out [q][doc] with a row pitch of kTile + 1, so both
//    this write and the column read-out are free of bank conflicts, and a
//    batch's hits lie in distinct columns, so its loads all go before its
//    stores. No register array is indexed at run time.
//  * Output. At the end of a tile each thread writes its column's kQueries
//    sums, so every warp stores 128 contiguous bytes per query row.
//  * Any Lq. Queries are taken kMaxTermTile terms at a time; past the
//    first term tile the block adds into the scores it wrote before.
//
// What holds it back (PERF.md): instruction throughput and latency in the
// hit batches, not bytes; a slot row with hits costs the warp one batch per
// 4 hits whatever the number of queries each hit adds to.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 640;            // one document column per thread
constexpr int kTile = kThreads;          // documents per tile
constexpr int kQueries = 32;             // queries per block: one mask bit
constexpr int kSlots = 4;                // doc slots per pipeline stage
constexpr int kStages = 3;               // ring depth
constexpr int kBatch = 4;                // hits of one slot summed together
constexpr int kMaxTermTile = 64;         // query-term slots per table build
constexpr int kWarps = kThreads / 32;
// queries each warp builds the table entries of
constexpr int kRounds = (kQueries + kWarps - 1) / kWarps;
constexpr int kAccPitch = kTile + 1;     // shared accumulator row pitch
constexpr unsigned kFull = 0xffffffffu;
constexpr int kQueue = 32 + kBatch;  // a warp's hits of one slot, padded
static_assert(kSlots % 2 == 0, "16-byte copies: kSlots / 2 chunks a lane");
static_assert(kMaxTermTile == 64, "the build holds two term slots per lane");
static_assert(kQueries == 32, "one mask bit per query");
static_assert(kThreads % 32 == 0 && kThreads / 32 <= 32,
              "whole warps; one scan partial per warp");

constexpr size_t kAccBytes = sizeof(float) * kQueries * kAccPitch;
constexpr size_t kRingBytes =
    (sizeof(int32_t) + sizeof(float)) * kStages * kSlots * kTile;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int slot_hash(int32_t t, int shift) {
  return (int)(((uint32_t)t * 2654435761u) >> shift);
}

// Bytes of dynamic shared memory for a table of T keys and E entries.
size_t smem_bytes(int T, int E) {
  return kAccBytes + kRingBytes + kWarps * kQueue * sizeof(int4) +
         (size_t)T * (sizeof(int2) + sizeof(int32_t))
         + (size_t)E * sizeof(float) + 32 * sizeof(int);
}

// kVec16: the doc operands' base pointers are 16-byte aligned and their row
// stride a multiple of 4 elements, so a warp loads its 32 columns of each
// slot row as 8 aligned 16-byte copies; otherwise each thread copies its own
// column 4 bytes at a time, which is legal at any offset and stride.
template <bool kVec16>
__global__ void __launch_bounds__(kThreads, 1)
bm25_score_kernel(const int32_t* __restrict__ qt,
                  const float* __restrict__ qw,
                  const int32_t* __restrict__ dt,
                  const float* __restrict__ di,
                  float* __restrict__ out,
                  int Q, int Lq, int Ld, int N, long long doc_stride,
                  int term_tile, int n_term_tiles, int log_t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = 1 << log_t;
  const int E = kQueries * term_tile;
  float* acc = reinterpret_cast<float*>(smem);
  int32_t* ring_t = reinterpret_cast<int32_t*>(smem + kAccBytes);
  float* ring_i = reinterpret_cast<float*>(ring_t + kStages * kSlots * kTile);
  int4* queue = reinterpret_cast<int4*>(smem + kAccBytes + kRingBytes);
  int2* info = reinterpret_cast<int2*>(queue + kWarps * kQueue);
  int32_t* keys = reinterpret_cast<int32_t*>(info + T);
  float* wts = reinterpret_cast<float*>(keys + T);
  int* scan = reinterpret_cast<int*>(wts + E);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int q0 = blockIdx.y * kQueries;
  const int nq = min(kQueries, Q - q0);
  const int shift = 32 - log_t;

  const long long n_tiles = ((long long)N + kTile - 1) / kTile;
  const long long G = gridDim.x;
  const long long my_tiles =
      blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / G + 1 : 0;
  const int n_chunks = max(1, (Ld + kSlots - 1) / kSlots);
  const int n_items = (int)(my_tiles * n_chunks);

  // a pipeline item: slots [chunk * kSlots, +kSlots) of doc tile `tile`,
  // in ring stage `stage`; this block's tiles are blockIdx.x + k * G
  struct Cursor {
    long long tile;
    int chunk;
    int stage;
  };
  auto advance = [&](Cursor& c) {
    if (++c.chunk == n_chunks) {
      c.chunk = 0;
      c.tile += G;
    }
    c.stage = c.stage + 1 == kStages ? 0 : c.stage + 1;
  };
  auto prefetch = [&](const Cursor& c) {
    if constexpr (kVec16) {
      // the warp's kSlots x 2 rows of 32 columns are 16 * kSlots chunks of
      // 16 bytes; a chunk at or past N is not copied (no lane reads it)
#pragma unroll
      for (int i = 0; i < kSlots / 2; ++i) {
        const int ci = lane + 32 * i;
        const int row = ci >> 3;
        const int jj = row % kSlots;
        const int j = c.chunk * kSlots + jj;
        const int col = warp * 32 + (ci & 7) * 4;  // in the tile
        const long long d = c.tile * kTile + col;
        if (j >= Ld || d >= N) continue;
        const long long at = (long long)j * doc_stride + d;
        const int r = (c.stage * kSlots + jj) * kTile + col;
        if (row < kSlots) {
          cp_async16(ring_t + r, dt + at);
        } else {
          cp_async16(ring_i + r, di + at);
        }
      }
      return;
    }
    const long long d = c.tile * kTile + tid;
    if (d >= N) return;
#pragma unroll
    for (int jj = 0; jj < kSlots; ++jj) {
      const int j = c.chunk * kSlots + jj;
      if (j >= Ld) break;
      const long long at = (long long)j * doc_stride + d;
      const int r = (c.stage * kSlots + jj) * kTile + tid;
      cp_async4(ring_t + r, dt + at);
      cp_async4(ring_i + r, di + at);
    }
  };

  for (int pass = 0; pass < n_term_tiles; ++pass) {
    const int l0 = pass * term_tile;
    const int nl = min(term_tile, Lq - l0);

    // the first stages load while the table is built
    Cursor load{blockIdx.x, 0, 0};
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_items) prefetch(load);
      cp_async_commit();
      advance(load);
    }
    __syncthreads();  // the previous pass no longer reads acc or the table

    // -- build the term table of queries [q0, q0 + nq), terms [l0, l0 + nl)
    for (int s = tid; s < T; s += kThreads) {
      keys[s] = -1;
      info[s] = make_int2(0, 0);
    }
    __syncthreads();
    // one warp per query: lane holds slots l = lane and lane + 32 of the
    // term tile. A slot's term is inserted by its first occurrence in the
    // query, with the weights of all its occurrences summed in slot order.
    int slot[kRounds][2];
    float weight[kRounds][2];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int ql = warp + r * kWarps;  // >= kQueries: nothing to insert
      int32_t t[2] = {-1, -1};
      float w[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int l = lane + 32 * i;
        if (ql < nq && l < nl) {  // nq <= kQueries
          const long long at = (long long)(q0 + ql) * Lq + l0 + l;
          t[i] = max(qt[at], -1);
          w[i] = qw[at];
        }
      }
      bool first[2] = {t[0] >= 0, t[1] >= 0};
      float sum[2] = {0.f, 0.f};
#pragma unroll 8
      for (int k = 0; k < nl; ++k) {  // the same for every lane
        const int32_t tk = __shfl_sync(kFull, k < 32 ? t[0] : t[1], k & 31);
        const float wk = __shfl_sync(kFull, k < 32 ? w[0] : w[1], k & 31);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (tk != t[i]) continue;
          if (k < lane + 32 * i) {
            first[i] = false;
          } else {
            sum[i] += wk;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        slot[r][i] = -1;
        weight[r][i] = sum[i];
        if (!first[i]) continue;
        int h = slot_hash(t[i], shift);
        for (;;) {
          const int32_t prev = atomicCAS(&keys[h], -1, t[i]);
          if (prev == -1 || prev == t[i]) break;
          h = (h + 1) & (T - 1);
        }
        atomicOr(reinterpret_cast<unsigned*>(&info[h].x), 1u << ql);
        slot[r][i] = h;
      }
    }
    __syncthreads();
    {  // each key's run starts after the runs of the keys before it: a
       // warp scans a range of consecutive keys, 32 at a time
      const int per = (T + kWarps - 1) / kWarps;
      const int end = min(T, (warp + 1) * per);
      int carry = 0;
      for (int s0 = warp * per; s0 < end; s0 += 32) {
        const int s = s0 + lane;
        const int c = s < end ? __popc((unsigned)info[s].x) : 0;
        int incl = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += v;
        }
        if (s < end) info[s].y = carry + incl - c;
        carry += __shfl_sync(kFull, incl, 31);
      }
      if (lane == 0) scan[warp] = carry;
      __syncthreads();
      int offset = 0;
      for (int v = 0; v < warp; ++v) offset += scan[v];
      for (int s = warp * per + lane; s < end; s += 32) info[s].y += offset;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int ql = warp + r * kWarps;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (slot[r][i] < 0) continue;
        const int2 in = info[slot[r][i]];
        wts[in.y + __popc((unsigned)in.x & ((1u << ql) - 1u))] =
            weight[r][i];
      }
    }
    __syncthreads();

    // -- stream this block's doc tiles through the ring ---------------------
#pragma unroll 4
    for (int q = 0; q < kQueries; ++q) acc[q * kAccPitch + tid] = 0.f;
    __syncwarp();
    Cursor use{blockIdx.x, 0, 0};
    for (int item = 0; item < n_items; ++item, advance(use)) {
      cp_async_wait<kStages - 2>();  // this thread's copies of `use` landed
      if constexpr (kVec16) __syncwarp();  // and the rest of the warp's
      const int chunk = use.chunk;
      const long long d = use.tile * kTile + tid;
      const bool valid = d < N;
      // probe the item's kSlots slots together: their first loads are
      // independent, and most slots end there (a miss on an empty key).
      // Slots that are padding in all of the warp's documents (the tail of
      // the longest one) cost no probe.
      int32_t t[kSlots], k[kSlots];
      float imp[kSlots];
      int h[kSlots];
      bool real_any = false;
#pragma unroll
      for (int jj = 0; jj < kSlots; ++jj) {
        const int r = (use.stage * kSlots + jj) * kTile + tid;
        const bool real = valid && chunk * kSlots + jj < Ld;
        t[jj] = real ? ring_t[r] : -1;
        imp[jj] = real ? ring_i[r] : 0.f;
        real_any |= t[jj] >= 0;
      }
      if (__any_sync(kFull, real_any)) {
#pragma unroll
        for (int jj = 0; jj < kSlots; ++jj) {
          h[jj] = slot_hash(t[jj], shift);
          k[jj] = t[jj] >= 0 ? keys[h[jj]] : -1;
        }
#pragma unroll
        for (int jj = 0; jj < kSlots; ++jj) {
          while (k[jj] != t[jj] && k[jj] >= 0) {
            h[jj] = (h[jj] + 1) & (T - 1);
            k[jj] = keys[h[jj]];
          }
        }
        // each slot's hits go through the warp's queue in shared memory as
        // (query mask, run start, impact, doc column), padded with entries
        // that add nothing; every lane reads an entry with one broadcast
        // load and lane q adds w(q) * impact into the sum of (q, column)
        int4* wq = queue + warp * kQueue;
#pragma unroll
        for (int jj = 0; jj < kSlots; ++jj) {
          const bool hit = t[jj] >= 0 && k[jj] == t[jj];
          const unsigned hits = __ballot_sync(kFull, hit);
          if (!hits) continue;
          if (hit) {
            const int2 in = info[h[jj]];
            wq[__popc(hits & lanes_below)] =
                make_int4(in.x, in.y, __float_as_int(imp[jj]), lane);
          }
          const int n = __popc(hits);
          if (lane < kBatch) wq[n + lane] = make_int4(0, 0, 0, 0);  // no add
          __syncwarp();
          // kBatch entries at a time: one slot's hits lie in distinct
          // columns, so all their loads can go before any store
          for (int i0 = 0; i0 < n; i0 += kBatch) {
            int4 e[kBatch];
            float w[kBatch], a[kBatch];
#pragma unroll
            for (int b = 0; b < kBatch; ++b) e[b] = wq[i0 + b];
#pragma unroll
            for (int b = 0; b < kBatch; ++b) {
              const unsigned m = (unsigned)e[b].x;
              if ((m >> lane) & 1u) {
                w[b] = wts[e[b].y + __popc(m & lanes_below)];
                a[b] = acc[lane * kAccPitch + warp * 32 + e[b].w];
              }
            }
#pragma unroll
            for (int b = 0; b < kBatch; ++b) {
              if (((unsigned)e[b].x >> lane) & 1u)
                acc[lane * kAccPitch + warp * 32 + e[b].w] =
                    fmaf(w[b], __int_as_float(e[b].z), a[b]);
            }
          }
          __syncwarp();  // the queue is read before the next slot refills it
        }
      }
      if (chunk == n_chunks - 1) {  // the tile is done: write its sums
        __syncwarp();
        if (valid) {
          for (int q = 0; q < nq; ++q) {
            float* o = out + (long long)(q0 + q) * N + d;
            const float s = acc[q * kAccPitch + tid];
            if (pass == 0) {
              __stcs(o, s);
            } else {
              *o += s;
            }
          }
        }
#pragma unroll 4
        for (int q = 0; q < kQueries; ++q) acc[q * kAccPitch + tid] = 0.f;
        __syncwarp();
      }
      if (item + kStages - 1 < n_items) prefetch(load);
      cp_async_commit();
      advance(load);
    }
    cp_async_wait<0>();
  }
}

// The launch of a call: term tiles, hash table size, shared memory and the
// persistent grid (one block per SM in all, split among the query tiles).
struct Plan {
  int term_tile, n_term_tiles, log_t;
  size_t smem;
  dim3 grid;
};

cudaError_t plan(int Q, int Lq, int N, const void* kernel, Plan* p) {
  p->n_term_tiles = std::max(1, (Lq + kMaxTermTile - 1) / kMaxTermTile);
  p->term_tile = std::max(1, (Lq + p->n_term_tiles - 1) / p->n_term_tiles);
  const int E = kQueries * p->term_tile;
  p->log_t = 1;
  while ((1 << p->log_t) < 2 * E) ++p->log_t;  // the table at most half full
  p->smem = smem_bytes(1 << p->log_t, E);

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)p->smem);
  if (err != cudaSuccess) return err;

  const long long n_tiles = ((long long)N + kTile - 1) / kTile;
  const int n_qtiles = (Q + kQueries - 1) / kQueries;
  if (n_qtiles > 65535) return cudaErrorInvalidConfiguration;
  const long long per_qtile = std::max(1, sms / n_qtiles);
  p->grid = dim3((unsigned)std::min(n_tiles, per_qtile), n_qtiles);
  return cudaSuccess;
}

// An empty kernel: launched on bm25_score_kernel's grid, block and shared
// memory, its time is the least a launch of that kernel can take.
__global__ void floor_kernel() {}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` and returns
// 0 on success, else the CUDA error (a refused launch included); it
// allocates and synchronises nothing.
extern "C" int bm25_score_block_launch(const void* qt, const void* qw,
                                       const void* dt, const void* di,
                                       void* out, int Q, int Lq, int Ld,
                                       int N, long long doc_stride,
                                       void* stream) {
  const bool vec16 = ((uintptr_t)dt % 16 == 0) && ((uintptr_t)di % 16 == 0) &&
                     doc_stride % 4 == 0;
  auto kernel = vec16 ? bm25_score_kernel<true> : bm25_score_kernel<false>;
  Plan p;
  const cudaError_t err = plan(Q, Lq, N, (const void*)kernel, &p);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.grid, kThreads, p.smem, (cudaStream_t)stream>>>(
      (const int32_t*)qt, (const float*)qw, (const int32_t*)dt,
      (const float*)di, (float*)out, Q, Lq, Ld, N, doc_stride, p.term_tile,
      p.n_term_tiles, p.log_t);
  return (int)cudaGetLastError();
}

// The launch floor at these sizes: floor_kernel on the grid, block and
// shared memory bm25_score_block_launch would use. For measurement only.
extern "C" int bm25_score_floor_launch(int Q, int Lq, int N, void* stream) {
  Plan p;
  cudaError_t err = plan(Q, Lq, N, (const void*)floor_kernel, &p);
  if (err != cudaSuccess) return (int)err;
  floor_kernel<<<p.grid, kThreads, p.smem, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
