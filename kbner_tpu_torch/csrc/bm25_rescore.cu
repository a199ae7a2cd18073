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
// Design. One warp per candidate; a block takes one query and kCandPerBlock
// candidates, kWarps at a time, after staging the query's Lq terms and
// weights in shared memory (every later read is a broadcast). The lanes
// stride over the candidate's contiguous term row and code row, so a warp
// reads a row in coalesced 128-byte (terms) and 64-byte (codes) pieces; no
// [Q, Ld, C] tensor is gathered. Each slot sums the weights of the query
// terms it equals, and only a slot with a match dequantizes its code
// (expf, round-to-nearest intrinsics in the reference's float32 order:
// (code - 1) * step, then + lo, no fma contraction). A warp reduction writes
// out[q, c]. Ragged Q and C need no padding: the reference's Q % 8 and
// C % 128 conditions are TPU tiling rules.
//
// Bound on this card. The function needs each distinct candidate's two rows
// once (the 32-byte sectors of Ld * 4 B of terms and Ld * 2 B of codes),
// the candidate ids (4 B each), the query block and 4 B out per candidate,
// and one lookup of each row slot in the query's term set, integer work on
// the CUDA cores. At the serve shape (Q = 32, C = 1024, Ld = 52) that is at
// most about 10 MB, about 3 us at 3.35 TB/s, against about 0.1 us of
// lookups at 16.75 T int32 operations/s: it is bound by bytes, and at this
// size by launch and latency (chip_smoke.py prints the count for the
// candidates the two-operand path hands it). This kernel reads a repeated
// candidate's rows once per occurrence and compares each slot with all Lq
// staged terms; a sorted query block with a binary search, and several
// candidates per warp with the next rows prefetched, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // candidates in flight per block
constexpr int kCandPerBlock = 64;  // candidates per block
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
bm25_rescore_kernel(const int32_t* __restrict__ qt,
                    const float* __restrict__ qw,
                    const int32_t* __restrict__ cand,
                    const int32_t* __restrict__ doc_terms,
                    const uint16_t* __restrict__ doc_codes,
                    float* __restrict__ out,
                    int Lq, int C, int Ld, float lo, float step) {
  extern __shared__ int32_t smem[];
  int32_t* s_term = smem;
  float* s_weight = reinterpret_cast<float*>(smem + Lq);

  const int q = blockIdx.y;
  for (int l = threadIdx.x; l < Lq; l += blockDim.x) {
    s_term[l] = qt[(long long)q * Lq + l];
    s_weight[l] = qw[(long long)q * Lq + l];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c_end = min(C, (int)(blockIdx.x + 1) * kCandPerBlock);
  for (int c = blockIdx.x * kCandPerBlock + warp; c < c_end; c += kWarps) {
    const long long qc = (long long)q * C + c;
    const long long row = (long long)cand[qc] * Ld;
    float acc = 0.f;
    for (int j = lane; j < Ld; j += 32) {
      const int32_t t = doc_terms[row + j];
      float wsum = 0.f;
      bool hit = false;
      for (int l = 0; l < Lq; ++l) {
        if (s_term[l] == t) {
          wsum += s_weight[l];
          hit = true;
        }
      }
      if (!hit) continue;
      const uint32_t code = doc_codes[row + j];
      if (code == 0) continue;
      const float di =
          expf(__fadd_rn(lo, __fmul_rn((float)code - 1.0f, step)));
      acc += wsum * di;
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(kFull, acc, s);
    if (lane == 0) out[qc] = acc;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it allocates and synchronises nothing.
// cand must hold ids in [0, N) of the [N, Ld] row arrays.
extern "C" int bm25_rescore_launch(const void* qt, const void* qw,
                                   const void* cand, const void* doc_terms,
                                   const void* doc_codes, void* out, int Q,
                                   int Lq, int C, int Ld, float lo,
                                   float step, void* stream) {
  const dim3 grid((C + kCandPerBlock - 1) / kCandPerBlock, Q);
  const size_t smem = (size_t)Lq * (sizeof(int32_t) + sizeof(float));
  bm25_rescore_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const int32_t*)qt, (const float*)qw, (const int32_t*)cand,
      (const int32_t*)doc_terms, (const uint16_t*)doc_codes, (float*)out, Lq,
      C, Ld, lo, step);
  return (int)cudaGetLastError();
}
