// Pass-2 BM25 rescoring over the two-array row layout for Hopper (sm_90a).
//
// Replaces the TPU kernel kbner_tpu/ops/bm25.py:_rescore_kernel, called
// through kbner_tpu/ops/bm25.py:bm25_rescore_pallas, together with the
// candidate-row gather and transpose that the TPU path leaves to XLA (the
// two-array branch of _rescore_candidates). For each query q and candidate
// document d = cand[q, c] it computes
//
//   out[q, c] = sum_l qw[q, l] * sum_j [dt[d, j] == qt[q, l]] * di(dc[d, j])
//   di(code)  = code > 0 ? exp(lo + (code - 1) * step) : 0
//
// over the document's doc-major row of Ld term ids (int32) and Ld 16-bit
// log impact codes. Ids are compared raw, as the reference compares them:
// a query pad -1 matches a document pad -1, which adds nothing only where
// the pad's code is 0.
//
// Bound on this card. The function needs each distinct candidate's two rows
// once (the 32-byte sectors of Ld * 4 B of terms and Ld * 2 B of codes),
// the candidate ids (4 B each), the query block and 4 B out per candidate,
// and one lookup of each row slot in the query's term set, integer work on
// the CUDA cores. At the serve shape (Q = 32, C = 1024, Ld = 52) that is at
// most about 10 MB, about 3 us at 3.35 TB/s, against about 0.1 us of
// lookups at 16.75 T int32 operations/s: it is bound by bytes, and at this
// size by launch and by the latency of two dependent loads (the candidate
// id, then its rows) (chip_smoke.py prints the bound and an empty kernel's
// time on this grid). A candidate that repeats across queries is read once
// per query: the copies hit in L2.
//
// Design.
//  * Candidates in flight. A block takes one query and kCandPerBlock
//    candidates. Each candidate gets a group of kGroup = 16 lanes, and each
//    lane holds kCandPerGroup candidates, so a warp has 8 in flight and the
//    serve shape's 32,768 (q, c) pairs fit on the card in one wave. Every
//    lane issues its candidates' id loads, then their row loads, before it
//    uses any of them.
//  * Coalesced loads. Lane i of a group reads slots i, i + 16, i + 32 and
//    i + 48, so each of its 4-byte term and 2-byte code loads reads 16
//    consecutive slots of the row with the group's other lanes, at any Ld
//    and alignment. A pass covers 64 slots; a longer row takes more
//    passes. Wider loads (4 slots per lane in one 16-byte and one 8-byte
//    load) read slower at the serve shape (PERF.md section 6).
//  * A hashed term table. One extra warp per block builds the query's term
//    table in shared memory (term_table.cuh) while the other warps' loads
//    are in flight. Every id is a key, -1 included, and the table marks an
//    empty entry with INT32_MIN, keeping a query term of that value beside
//    it. One probe gives the summed weight of all the equal query slots. A
//    slot with code 0 adds nothing and is not looked up; only a hit
//    dequantizes its code (expf, round-to-nearest intrinsics in the
//    reference's float32 order: (code - 1) * step, then + lo, no fma
//    contraction).
//  Ragged Q and C need no padding (the reference's Q % 8 and C % 128
//  conditions are TPU tiling rules): a candidate past C loads nothing and
//  writes nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "term_table.cuh"

namespace {

constexpr int kGroup = 16;          // lanes per candidate
constexpr int kSlotsPerLane = 4;
constexpr int kPassSlots = kGroup * kSlotsPerLane;  // 64 slots per pass
constexpr int kCandWarps = 8;       // warps that rescore; one more builds
constexpr int kThreads = (kCandWarps + 1) * 32;
constexpr int kGroups = kCandWarps * 32 / kGroup;  // 16
constexpr int kCandPerGroup = 4;
constexpr int kCandPerBlock = kGroups * kCandPerGroup;  // 64
constexpr int kMinBlocks = 4;       // per SM: the serve shape in one wave
constexpr unsigned kFull = 0xffffffffu;

// A lane's 4 slots of one pass: terms and codes (code 0 where the slot lies
// past the row or the candidate past C).
struct Slots {
  int32_t t[kSlotsPerLane];
  uint32_t code[kSlotsPerLane];
};

// The lane's slots j0 + sub + 16 * k of the pass starting at slot j0 of row
// `row` (an element offset into both arrays).
__device__ __forceinline__ Slots load_slots(
    const int32_t* __restrict__ terms, const uint16_t* __restrict__ codes,
    long long row, int j0, int sub, int Ld, bool valid) {
  Slots s;
#pragma unroll
  for (int k = 0; k < kSlotsPerLane; ++k) {
    s.t[k] = 0;
    s.code[k] = 0u;
  }
  if (!valid) return s;
#pragma unroll
  for (int k = 0; k < kSlotsPerLane; ++k) {
    const int j = j0 + sub + kGroup * k;
    if (j < Ld) {
      s.t[k] = terms[row + j];
      s.code[k] = codes[row + j];
    }
  }
  return s;
}

__device__ __forceinline__ void rescore_slots(const term_table::Table& tb,
                                              const Slots& s, float lo,
                                              float step, float& acc) {
#pragma unroll
  for (int k = 0; k < kSlotsPerLane; ++k) {
    if (s.code[k] == 0u) continue;  // di = 0: adds nothing
    float w;
    if (!term_table::lookup(tb, s.t[k], w)) continue;
    const float di =
        expf(__fadd_rn(lo, __fmul_rn((float)s.code[k] - 1.0f, step)));
    acc += w * di;
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
bm25_rescore_kernel(const int32_t* __restrict__ qt,
                    const float* __restrict__ qw,
                    const int32_t* __restrict__ cand,
                    const int32_t* __restrict__ doc_terms,
                    const uint16_t* __restrict__ doc_codes,
                    float* __restrict__ out,
                    int Lq, int C, int Ld, float lo, float step, int log_t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const term_table::Table tb = term_table::carve(smem, log_t);
  const int q = blockIdx.y;
  const bool table_warp = (int)(threadIdx.x >> 5) == kCandWarps;
  const int group = threadIdx.x / kGroup;
  const int sub = threadIdx.x % kGroup;
  int c[kCandPerGroup];
  bool valid[kCandPerGroup];
  long long row[kCandPerGroup];
  Slots first[kCandPerGroup];
  if (table_warp) {
    term_table::build<true>(tb, qt + (long long)q * Lq,
                            qw + (long long)q * Lq, Lq);
  } else {
#pragma unroll
    for (int i = 0; i < kCandPerGroup; ++i) {
      c[i] = blockIdx.x * kCandPerBlock + i * kGroups + group;
      valid[i] = c[i] < C;
      row[i] = valid[i] ? (long long)cand[(long long)q * C + c[i]] * Ld : 0;
    }
#pragma unroll
    for (int i = 0; i < kCandPerGroup; ++i) {
      first[i] = load_slots(doc_terms, doc_codes, row[i], 0, sub, Ld,
                                  valid[i]);
    }
  }
  __syncthreads();  // the term table is built
  if (table_warp) return;

#pragma unroll
  for (int i = 0; i < kCandPerGroup; ++i) {
    float acc = 0.f;
    rescore_slots(tb, first[i], lo, step, acc);
    for (int j0 = kPassSlots; j0 < Ld; j0 += kPassSlots) {  // long rows
      rescore_slots(tb, load_slots(doc_terms, doc_codes, row[i], j0,
                                         sub, Ld, valid[i]),
                    lo, step, acc);
    }
#pragma unroll
    for (int s = kGroup / 2; s > 0; s >>= 1)
      acc += __shfl_xor_sync(kFull, acc, s);
    if (sub == 0 && valid[i]) out[(long long)q * C + c[i]] = acc;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` and returns
// 0 on success, else the CUDA error (a refused launch included); it
// allocates and synchronises nothing. cand must hold ids in [0, N) of the
// [N, Ld] row arrays.
extern "C" int bm25_rescore_launch(const void* qt, const void* qw,
                                   const void* cand, const void* doc_terms,
                                   const void* doc_codes, void* out, int Q,
                                   int Lq, int C, int Ld, float lo,
                                   float step, void* stream) {
  const term_table::Launch p = term_table::plan(Q, Lq, C, kCandPerBlock);
  const cudaError_t err = term_table::allow_smem(bm25_rescore_kernel, p.smem);
  if (err != cudaSuccess) return (int)err;
  bm25_rescore_kernel<<<p.grid, kThreads, p.smem, (cudaStream_t)stream>>>(
      (const int32_t*)qt, (const float*)qw, (const int32_t*)cand,
      (const int32_t*)doc_terms, (const uint16_t*)doc_codes, (float*)out, Lq,
      C, Ld, lo, step, p.log_t);
  return (int)cudaGetLastError();
}

// The launch floor of bm25_rescore_launch at these sizes, for timing only:
// the same grid, block and shared memory, and no work.
extern "C" int bm25_rescore_floor_launch(int Q, int Lq, int C, void* stream) {
  return (int)term_table::launch_floor(
      term_table::plan(Q, Lq, C, kCandPerBlock), kThreads,
      (cudaStream_t)stream);
}
