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
// Design. One warp per candidate; a block takes one query and kCandPerBlock
// candidates, kWarps at a time, after staging the query's W terms and
// weights in shared memory (every later read is a broadcast). A lane reads
// 4 consecutive slots (8 bytes) of a row, so a warp reads one 256-byte row
// in one coalesced transaction. The lane takes its local prefix of the 4
// gaps, the warp adds the lane totals with __shfl_up_sync, and the warp
// total is carried into the next covering row. Each valid slot is compared
// with the W staged terms; a warp reduction writes out[q, c]. Rows past the
// segment's end are not read, so any r2 costs only the rows a document
// really covers. Ragged Q and C need no padding. The norm is computed with
// round-to-nearest intrinsics in the reference's order, so it carries no
// contraction into fma.
//
// Bound on this card. The function needs each candidate's segment, not its
// whole rows: the 32-byte sectors that slots [off, off + len) occupy, each
// distinct sector once (a segment of 12-38 slots is one to three sectors),
// each distinct candidate's offset, length and norm code (9 B), the
// candidate ids (4 B each), the query block, and 4 B out per candidate; and
// one lookup of each segment slot in the query's term set, integer work on
// the CUDA cores. At the serve shape (Q = 32, C = 1024) that is a few MB,
// under a microsecond at 3.35 TB/s, against well under a microsecond of
// lookups at 16.75 T int32 operations/s: it is bound by bytes, and at this
// size by launch and latency (chip_smoke.py prints the count for the
// served candidates). This kernel reads more than that: a whole 256-byte
// row per covering row of each candidate (Q * C * R2 * 256 B at most), and
// it compares each valid slot with all W terms; several candidates per
// warp, cp.async row prefetch and a binary search in sorted query terms
// are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;        // slots per row
constexpr int kSlotsPerLane = 4;   // 8 bytes per lane, 32 lanes per row
constexpr int kWarps = 8;          // candidates in flight per block
constexpr int kCandPerBlock = 64;  // candidates per block
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
delta16_rescore_kernel(const int32_t* __restrict__ qt,
                       const float* __restrict__ qw,
                       const int32_t* __restrict__ cand,
                       const uint16_t* __restrict__ flat,
                       const int32_t* __restrict__ doc_off,
                       const int32_t* __restrict__ doc_len,
                       const uint8_t* __restrict__ norm_code,
                       float* __restrict__ out,
                       int W, int C, int r2,
                       float k1, float one_minus_b, float b, float avgdl) {
  extern __shared__ int32_t smem[];
  int32_t* s_term = smem;
  float* s_weight = reinterpret_cast<float*>(smem + W);

  const int q = blockIdx.y;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    s_term[w] = qt[(long long)q * W + w];
    s_weight[w] = qw[(long long)q * W + w];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c_end = min(C, (int)(blockIdx.x + 1) * kCandPerBlock);
  for (int c = blockIdx.x * kCandPerBlock + warp; c < c_end; c += kWarps) {
    const long long qc = (long long)q * C + c;
    const int d = cand[qc];
    const long long off = doc_off[d];
    const long long end = off + doc_len[d];
    const int code = norm_code[d];
    const float bits = (float)(code & 7);
    const int shift = (code >> 3) - 1;
    const float dl = shift < 0 ? bits : ldexpf(bits + 8.0f, shift);
    const float norm = __fmul_rn(
        k1, __fadd_rn(one_minus_b, __fdiv_rn(__fmul_rn(b, dl), avgdl)));

    float acc = 0.f;
    int carry = 0;  // sum of the gaps of the rows before this one
    for (int rr = 0; rr < r2; ++rr) {
      const long long base = (off / kLanes + rr) * kLanes;
      if (base >= end) break;  // warp-uniform: the segment has ended
      const long long first = base + lane * kSlotsPerLane;
      const uint2 raw = *reinterpret_cast<const uint2*>(flat + first);
      const uint32_t v[kSlotsPerLane] = {raw.x & 0xffffu, raw.x >> 16,
                                         raw.y & 0xffffu, raw.y >> 16};
      int pre[kSlotsPerLane];
      int run = 0;
#pragma unroll
      for (int j = 0; j < kSlotsPerLane; ++j) {
        if (first + j >= off) run += (int)(v[j] >> 3);
        pre[j] = run;
      }
      int incl = run;  // inclusive scan of the lane totals
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, s);
        if (lane >= s) incl += t;
      }
      const int before = carry + incl - run;
#pragma unroll
      for (int j = 0; j < kSlotsPerLane; ++j) {
        const long long g = first + j;
        const uint32_t tf3 = v[j] & 7u;
        if (g < off || g >= end || tf3 == 0) continue;
        const int id = before + pre[j];
        const float tf = (float)tf3;
        const float tfn = __fdiv_rn(tf, __fadd_rn(tf, norm));
        for (int w = 0; w < W; ++w) {
          if (s_term[w] == id) acc += s_weight[w] * tfn;
        }
      }
      carry += __shfl_sync(kFull, incl, 31);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(kFull, acc, s);
    if (lane == 0) out[qc] = acc;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it allocates and synchronises nothing.
// flat must be 8-byte aligned; cand must hold ids in [0, N).
extern "C" int delta16_rescore_launch(const void* qt, const void* qw,
                                      const void* cand, const void* flat,
                                      const void* doc_off,
                                      const void* doc_len,
                                      const void* norm_code, void* out,
                                      int Q, int W, int C, int r2, float k1,
                                      float one_minus_b, float b, float avgdl,
                                      void* stream) {
  const dim3 grid((C + kCandPerBlock - 1) / kCandPerBlock, Q);
  const size_t smem = (size_t)W * (sizeof(int32_t) + sizeof(float));
  delta16_rescore_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const int32_t*)qt, (const float*)qw, (const int32_t*)cand,
      (const uint16_t*)flat, (const int32_t*)doc_off,
      (const int32_t*)doc_len, (const uint8_t*)norm_code, (float*)out, W, C,
      r2, k1, one_minus_b, b, avgdl);
  return (int)cudaGetLastError();
}
