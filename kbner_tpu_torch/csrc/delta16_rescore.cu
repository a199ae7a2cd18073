// Pass-2 BM25 rescoring over delta16 rows for Hopper (sm_90a).
//
// Replaces the TPU kernel kbner_tpu/ops/bm25.py:_d16_rescore_kernel, called
// through kbner_tpu/ops/bm25.py:delta16_rescore_pallas, together with the
// row gather and the r2 > 1 case that the TPU path leaves to XLA (the
// delta16 branch of _rescore_candidates). For each query q and candidate
// document cand[q, c] it computes
//
//   out[q, c] = sum_w qw[q, w] * sum_slots [id(slot) == qt[q, w]] * tf / (tf + norm)
//
// over the document's segment of 16-bit slots (gap13 << 3) | tf3 in the
// flat [NR, 128] rows: the segment starts at slot off[d] and holds len[d]
// slots; a slot's term id is the inclusive prefix sum of the gaps from the
// segment start (over the r2 rows that cover it); a slot counts when it
// lies in the segment and tf > 0 (tf = 0 marks a continuation slot that
// carries only gap); norm = k1 * ((1 - b) + b * dl / avgdl) with dl decoded
// from the document's 1-byte Lucene norm code as (bits | 8) << shift.
// Negative query terms (the -1 pad) never match: every valid id is >= 0.
//
// Bound on this card. The function needs each candidate's segment, not its
// whole rows: the 32-byte sectors that slots [off, off + len) occupy, each
// distinct sector once (a segment of 12-38 slots is one to three sectors),
// each distinct candidate's offset, length and norm code (9 B), the
// candidate ids (4 B each), the query block, and 4 B out per candidate; and
// one lookup of each segment slot in the query's term set, integer work on
// the CUDA cores. At the serve shape (Q = 32, C = 1024) that is about 2 MB,
// under a microsecond at 3.35 TB/s, against well under a microsecond of
// lookups at 16.75 T int32 operations/s: it is bound by bytes, and at this
// size by launch and by the latency of three dependent loads (the candidate
// id, its segment's place, the segment), which no design removes
// (chip_smoke.py prints the bound and an empty kernel's time on this grid).
//
// Design.
//  * Candidates in flight. A block takes one query and kCandPerBlock
//    candidates. Each candidate gets a group of kGroup lanes, and each lane
//    holds kCandPerGroup candidates, so a warp has 8 in flight and the
//    serve shape's 32,768 (q, c) pairs fit on the card in one wave. Every
//    lane issues its candidates' id loads, then their offset, length and
//    norm loads, then their segment loads, before it uses any of them.
//  * Only the segment. A group reads slots from the 32-byte sector that
//    holds off, kSlotsPerLane per lane (16 bytes as two 8-byte loads: the
//    wrapper passes 8-byte aligned rows), so one pass covers 64 slots: a
//    segment of up to 49 slots in one pass, a longer one in more
//    (a segment that runs into the next row is just the next slots of
//    flat). A lane loads only a chunk that meets [off, off + len).
//  * Prefix sums in the group. A lane sums its chunk's gaps (those at or
//    after off), the group scans the lane totals with shuffles, and the
//    group total carries into the next pass.
//  * A hashed term table. One extra warp per block builds the query's term
//    table in shared memory (term_table.cuh: negative terms dropped,
//    repeated terms' weights summed in slot order) while the other warps'
//    loads are in flight; a slot then costs one probe as a rule, and
//    tf / (tf + norm) is computed only on a hit. norm is computed once per
//    candidate with round-to-nearest intrinsics in the reference's order,
//    so it carries no contraction into fma.
//  Ragged Q and C need no padding: a candidate past C loads nothing and
//  writes nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "term_table.cuh"

namespace {

constexpr int kRowSlots = 128;      // slots per row of flat
constexpr int kSectorSlots = 16;    // 2-byte slots in a 32-byte sector
constexpr int kGroup = 8;           // lanes per candidate
constexpr int kSlotsPerLane = 8;    // 16 bytes per lane
constexpr int kPassSlots = kGroup * kSlotsPerLane;  // 64 slots per pass
constexpr int kCandWarps = 8;       // warps that rescore; one more builds
constexpr int kThreads = (kCandWarps + 1) * 32;
constexpr int kGroups = kCandWarps * 32 / kGroup;  // 32
constexpr int kCandPerGroup = 2;
constexpr int kCandPerBlock = kGroups * kCandPerGroup;  // 64
constexpr int kMinBlocks = 4;       // per SM: the serve shape in one wave
constexpr unsigned kFull = 0xffffffffu;

// The lane's kSlotsPerLane slots from slot `first`, where they meet the
// segment [off, end); zero elsewhere. first is a multiple of 8 slots and
// flat is 8-byte aligned, so the chunk is two 8-byte loads.
__device__ __forceinline__ uint4 load_chunk(const uint16_t* __restrict__ flat,
                                            int first, int off, int end) {
  if (first >= end || first + kSlotsPerLane <= off) {
    return make_uint4(0u, 0u, 0u, 0u);
  }
  const uint2 a = *reinterpret_cast<const uint2*>(flat + first);
  const uint2 b = *reinterpret_cast<const uint2*>(flat + first + 4);
  return make_uint4(a.x, a.y, b.x, b.y);
}

// One pass of a group over slots [pass, pass + kPassSlots): the lane's
// chunk is v. Adds the pass's matches into acc and its gaps into carry.
__device__ __forceinline__ void rescore_pass(const term_table::Table& tb,
                                             uint4 v, int pass, int sub,
                                             int off, int end, float norm,
                                             int& carry, float& acc) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
  const int first = pass + sub * kSlotsPerLane;
  int pre[kSlotsPerLane];
  int run = 0;
#pragma unroll
  for (int k = 0; k < kSlotsPerLane; ++k) {
    const uint32_t s = (words[k >> 1] >> (16 * (k & 1))) & 0xffffu;
    if (first + k >= off) run += (int)(s >> 3);
    pre[k] = run;
  }
  int incl = run;  // inclusive scan of the group's lane totals
#pragma unroll
  for (int s = 1; s < kGroup; s <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, s, kGroup);
    if (sub >= s) incl += t;
  }
  const int before = carry + incl - run;
#pragma unroll
  for (int k = 0; k < kSlotsPerLane; ++k) {
    const int g = first + k;
    const uint32_t tf3 = (words[k >> 1] >> (16 * (k & 1))) & 7u;
    if (g < off || g >= end || tf3 == 0) continue;
    float w;
    if (term_table::lookup(tb, before + pre[k], w)) {
      const float tf = (float)tf3;
      acc += w * __fdiv_rn(tf, __fadd_rn(tf, norm));
    }
  }
  carry += __shfl_sync(kFull, incl, kGroup - 1, kGroup);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
delta16_rescore_kernel(const int32_t* __restrict__ qt,
                       const float* __restrict__ qw,
                       const int32_t* __restrict__ cand,
                       const uint16_t* __restrict__ flat,
                       const int32_t* __restrict__ doc_off,
                       const int32_t* __restrict__ doc_len,
                       const uint8_t* __restrict__ norm_code,
                       float* __restrict__ out,
                       int W, int C, int r2,
                       float k1, float one_minus_b, float b, float avgdl,
                       int log_t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const term_table::Table tb = term_table::carve(smem, log_t);
  const int q = blockIdx.y;
  const bool table_warp = (int)(threadIdx.x >> 5) == kCandWarps;
  const int group = threadIdx.x / kGroup;
  const int sub = threadIdx.x % kGroup;
  int c[kCandPerGroup], d[kCandPerGroup];
  int off[kCandPerGroup], end[kCandPerGroup], code[kCandPerGroup];
  uint4 raw[kCandPerGroup];
  if (table_warp) {
    term_table::build<false>(tb, qt + (long long)q * W,
                             qw + (long long)q * W, W);
  } else {
#pragma unroll
    for (int i = 0; i < kCandPerGroup; ++i) {
      c[i] = blockIdx.x * kCandPerBlock + i * kGroups + group;
      d[i] = c[i] < C ? cand[(long long)q * C + c[i]] : -1;
    }
#pragma unroll
    for (int i = 0; i < kCandPerGroup; ++i) {
      off[i] = end[i] = code[i] = 0;
      if (d[i] < 0) continue;
      off[i] = doc_off[d[i]];
      const int len = doc_len[d[i]];
      code[i] = norm_code[d[i]];
      // the r2 rows from off's row cover what the reference reads
      const long long cover =
          ((long long)off[i] / kRowSlots + r2) * kRowSlots;
      end[i] = (int)min((long long)off[i] + len, cover);
    }
#pragma unroll
    for (int i = 0; i < kCandPerGroup; ++i) {
      const int pass = off[i] & ~(kSectorSlots - 1);
      raw[i] = load_chunk(flat, pass + sub * kSlotsPerLane, off[i],
                                  end[i]);
    }
  }
  __syncthreads();  // the term table is built
  if (table_warp) return;

#pragma unroll
  for (int i = 0; i < kCandPerGroup; ++i) {
    const float bits = (float)(code[i] & 7);
    const int shift = (code[i] >> 3) - 1;
    const float dl = shift < 0 ? bits : ldexpf(bits + 8.0f, shift);
    const float norm = __fmul_rn(
        k1, __fadd_rn(one_minus_b, __fdiv_rn(__fmul_rn(b, dl), avgdl)));
    float acc = 0.f;
    int carry = 0;  // sum of the gaps of the passes before this one
    int pass = off[i] & ~(kSectorSlots - 1);
    uint4 v = raw[i];
    for (;;) {  // warp-uniform trip count: the shuffles see every lane
      rescore_pass(tb, v, pass, sub, off[i], end[i], norm, carry, acc);
      pass += kPassSlots;
      if (!__any_sync(kFull, pass < end[i])) break;
      v = load_chunk(flat, pass + sub * kSlotsPerLane, off[i],
                             end[i]);
    }
#pragma unroll
    for (int s = kGroup / 2; s > 0; s >>= 1)
      acc += __shfl_xor_sync(kFull, acc, s);
    if (sub == 0 && d[i] >= 0) out[(long long)q * C + c[i]] = acc;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` and returns
// 0 on success, else the CUDA error (a refused launch included); it
// allocates and synchronises nothing. flat must be 8-byte aligned; cand
// must hold ids in [0, N).
extern "C" int delta16_rescore_launch(const void* qt, const void* qw,
                                      const void* cand, const void* flat,
                                      const void* doc_off,
                                      const void* doc_len,
                                      const void* norm_code, void* out,
                                      int Q, int W, int C, int r2, float k1,
                                      float one_minus_b, float b, float avgdl,
                                      void* stream) {
  const term_table::Launch p = term_table::plan(Q, W, C, kCandPerBlock);
  const cudaError_t err =
      term_table::allow_smem(delta16_rescore_kernel, p.smem);
  if (err != cudaSuccess) return (int)err;
  delta16_rescore_kernel<<<p.grid, kThreads, p.smem, (cudaStream_t)stream>>>(
      (const int32_t*)qt, (const float*)qw, (const int32_t*)cand,
      (const uint16_t*)flat, (const int32_t*)doc_off,
      (const int32_t*)doc_len, (const uint8_t*)norm_code, (float*)out, W, C,
      r2, k1, one_minus_b, b, avgdl, p.log_t);
  return (int)cudaGetLastError();
}

// The launch floor of delta16_rescore_launch at these sizes, for timing
// only: the same grid, block and shared memory, and no work.
extern "C" int delta16_rescore_floor_launch(int Q, int W, int C,
                                            void* stream) {
  return (int)term_table::launch_floor(
      term_table::plan(Q, W, C, kCandPerBlock), kThreads,
      (cudaStream_t)stream);
}
