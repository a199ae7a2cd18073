// Host-side postings helpers of the pruned retrieval engine (a copy of
// kbner_tpu/native/postings.cc with two changes: pack_ragged, and
// tiny_exact's per-query table in place of per-doc accumulators).
//
// The engine builds its device arrays on the host: the impact-ordered
// term-major CSR, the left-compacted doc rows without tiny terms, the
// ragged packed32 and delta16 pass-2 rows; per batch it gathers the exact
// sums of the tiny query terms. These loops are memory movement with
// little arithmetic, which numpy does in several passes over large
// temporaries; here each is one pass.
//
// Build: g++ -O3 -shared -fPIC postings.cc -o libpostings.so
// (kbner_tpu_torch/native/__init__.py builds it at first use and binds
// every entry point below with ctypes; each has a numpy twin there that
// the tests hold it equal to).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Each query's terms' posting ranges concatenated into a [Q, P] buffer
// (out_doc pre-filled -1): terms with df above df_cap (when df_cap > 0)
// are skipped, and copying stops when P slots are used.
void gather_postings(const int64_t* offsets,
                     const int32_t* postings_doc,
                     const float* postings_imp,
                     const int32_t* q_terms,
                     int64_t Q, int64_t M, int64_t P, int64_t df_cap,
                     int32_t* out_doc, float* out_imp) {
  for (int64_t q = 0; q < Q; ++q) {
    int64_t used = 0;
    int32_t* od = out_doc + q * P;
    float* oi = out_imp + q * P;
    for (int64_t m = 0; m < M && used < P; ++m) {
      int32_t t = q_terms[q * M + m];
      if (t < 0) continue;
      int64_t lo = offsets[t];
      int64_t hi = offsets[t + 1];
      int64_t df = hi - lo;
      if (df_cap > 0 && df > df_cap) continue;
      int64_t n = df;
      if (used + n > P) n = P - used;
      std::memcpy(od + used, postings_doc + lo, n * sizeof(int32_t));
      std::memcpy(oi + used, postings_imp + lo, n * sizeof(float));
      used += n;
    }
  }
}

// The exact block of the tiny query terms: per query, every posting of
// every tiny term summed per doc, the impacts (candidate ranking) and the
// weighted impacts (the exact score contribution), in float32 in posting
// order. Docs are listed in the order they are first seen.
//
// The reference deduplicates through dense per-doc accumulators, one
// entry per doc of the collection, and walks the postings twice (measure,
// then fill). Here each query walks its postings once through a small
// open-addressing table (doc -> slot) sized to its own posting count, so
// the work stays in cache, touches no per-collection array, and calls
// may run at once. Query q writes row q of the [Q, T] outputs (out_doc
// pre-filled -1, out_imp and out_ex zeroed); T must be at least every
// query's tiny posting count, which bounds its distinct docs. Returns
// the largest distinct-doc count, or -1 if a query has more than T
// postings (its row is left as it was).
int64_t tiny_exact(const int64_t* offsets,
                   const int32_t* postings_doc,
                   const float* postings_imp,
                   const int32_t* q_terms,
                   const float* q_weights,
                   const uint8_t* is_tiny,
                   int64_t Q, int64_t L, int64_t T,
                   int32_t* out_doc, float* out_imp, float* out_ex) {
  int64_t max_docs = 0;
  std::vector<int32_t> table_doc, table_slot;
  for (int64_t q = 0; q < Q; ++q) {
    const int32_t* qt = q_terms + q * L;
    const uint8_t* tiny = is_tiny + q * L;
    int64_t n_post = 0;
    for (int64_t l = 0; l < L; ++l)
      if (tiny[l] && qt[l] >= 0) n_post += offsets[qt[l] + 1] - offsets[qt[l]];
    if (n_post > T) return -1;
    uint64_t size = 16;
    while (size < 2 * (uint64_t)n_post) size <<= 1;
    const uint64_t mask = size - 1;
    if (table_doc.size() < size) {
      table_doc.resize(size);
      table_slot.resize(size);
    }
    std::fill(table_doc.begin(), table_doc.begin() + size, -1);
    int32_t* od = out_doc + q * T;
    float* oi = out_imp + q * T;
    float* oe = out_ex + q * T;
    int64_t n_touched = 0;
    for (int64_t l = 0; l < L; ++l) {
      if (!tiny[l]) continue;
      int32_t t = qt[l];
      if (t < 0) continue;
      float w = q_weights[q * L + l];
      for (int64_t p = offsets[t]; p < offsets[t + 1]; ++p) {
        int32_t d = postings_doc[p];
        float imp = postings_imp[p];
        uint64_t h = ((uint32_t)d * 0x9E3779B1u) & mask;
        while (table_doc[h] != d && table_doc[h] != -1) h = (h + 1) & mask;
        if (table_doc[h] == -1) {
          table_doc[h] = d;
          table_slot[h] = (int32_t)n_touched;
          od[n_touched++] = d;
        }
        int32_t slot = table_slot[h];
        oi[slot] += imp;
        oe[slot] += w * imp;
      }
    }
    if (n_touched > max_docs) max_docs = n_touched;
  }
  return max_docs;
}

// The impact-ordered CSR from the padded doc-major arrays, in the order
// of np.lexsort((-imps, terms)): a counting sort by term (df counts,
// prefix sums, a scatter in doc order), then each term's postings sorted
// by (impact descending, doc ascending). offsets [V+1] and df [V] come
// zeroed; every term id is below V.
void build_csr(const int32_t* doc_terms, const float* doc_impacts,
               int64_t N, int64_t Ld, int64_t V,
               int64_t* offsets, int64_t* df,
               int32_t* out_doc, float* out_imp) {
  const int64_t total = N * Ld;
  for (int64_t i = 0; i < total; ++i) {
    int32_t t = doc_terms[i];
    if (t >= 0) df[t]++;
  }
  offsets[0] = 0;
  for (int64_t v = 0; v < V; ++v) offsets[v + 1] = offsets[v] + df[v];
  std::vector<int64_t> cursor(offsets, offsets + V);
  for (int64_t d = 0; d < N; ++d) {
    const int32_t* row_t = doc_terms + d * Ld;
    const float* row_i = doc_impacts + d * Ld;
    for (int64_t l = 0; l < Ld; ++l) {
      int32_t t = row_t[l];
      if (t < 0) continue;
      int64_t c = cursor[t]++;
      out_doc[c] = (int32_t)d;
      out_imp[c] = row_i[l];
    }
  }
  std::vector<std::pair<float, int32_t>> buf;
  for (int64_t v = 0; v < V; ++v) {
    int64_t lo = offsets[v], hi = offsets[v + 1];
    if (hi - lo < 2) continue;
    buf.resize(hi - lo);
    for (int64_t p = lo; p < hi; ++p)
      buf[p - lo] = {out_imp[p], out_doc[p]};
    std::sort(buf.begin(), buf.end(),
              [](const std::pair<float, int32_t>& a,
                 const std::pair<float, int32_t>& b) {
                if (a.first != b.first) return a.first > b.first;
                return a.second < b.second;
              });
    for (int64_t p = lo; p < hi; ++p) {
      out_imp[p] = buf[p - lo].first;
      out_doc[p] = buf[p - lo].second;
    }
  }
}

// Left-compacted doc rows without the slots of tiny terms (df <=
// tiny_cap). Two calls: with Ld2 == 0 it only counts each row's kept
// slots into out_len; then it fills the caller's [N, Ld2] rows (out_dt
// pre-filled -1, out_di zeroed).
void compact_tiny(const int32_t* doc_terms, const float* doc_impacts,
                  const int64_t* df, int64_t tiny_cap,
                  int64_t N, int64_t Ld, int64_t Ld2,
                  int32_t* out_dt, float* out_di, int32_t* out_len) {
  for (int64_t d = 0; d < N; ++d) {
    const int32_t* row_t = doc_terms + d * Ld;
    const float* row_i = doc_impacts + d * Ld;
    int32_t n = 0;
    if (Ld2 == 0) {
      for (int64_t l = 0; l < Ld; ++l) {
        int32_t t = row_t[l];
        if (t >= 0 && df[t] > tiny_cap) n++;
      }
    } else {
      int32_t* o_t = out_dt + d * Ld2;
      float* o_i = out_di + d * Ld2;
      for (int64_t l = 0; l < Ld; ++l) {
        int32_t t = row_t[l];
        if (t >= 0 && df[t] > tiny_cap) {
          o_t[n] = t;
          o_i[n] = row_i[l];
          n++;
        }
      }
    }
    out_len[d] = n;
  }
}

// Ragged packed32 pass-2 rows: one int32 (code << term_bits) | term per
// real slot, the impact log-quantized on the way (code 0 for impact 0,
// else 1 + rint((ln imp - base) / step) clipped to [0, levels]), with
// base the per-term term_lo[t] or, where term_lo is null, the scalar lo.
//
// The change from the reference's copy here: slot l of doc d goes to
// flat[off[d] + l], its column, as the numpy packer puts it, and not to
// the next free place of the segment. The two agree on left-packed rows
// (all the engine builds); on a row with a -1 between real slots the
// slots after the pad fall outside the segment, exactly as in numpy,
// later writes winning where they land on one place.
void pack_ragged(const int32_t* dt, const float* di, const int64_t* off,
                 int64_t N, int64_t Ld, int64_t term_bits,
                 double lo, double step, int64_t levels,
                 const float* term_lo,
                 int32_t* flat /* prefilled -1 */) {
  const uint32_t mask =
      term_bits >= 32 ? 0xFFFFFFFFu : ((1u << term_bits) - 1u);
  for (int64_t d = 0; d < N; ++d) {
    const int32_t* rt = dt + d * Ld;
    const float* ri = di + d * Ld;
    const int64_t base = off[d];
    for (int64_t l = 0; l < Ld; ++l) {
      int32_t t = rt[l];
      if (t < 0) continue;
      float imp = ri[l];
      uint32_t code = 0;
      if (imp > 0.0f) {
        double base_lo = term_lo ? (double)term_lo[t] : lo;
        double v = std::rint((std::log((double)imp) - base_lo) / step);
        if (v < 0.0) v = 0.0;
        if (v > (double)levels) v = (double)levels;
        code = (uint32_t)v + 1u;
      }
      flat[base + l] = (int32_t)((code << term_bits) | ((uint32_t)t & mask));
    }
  }
}

// The capped, min_df-filtered copy of the CSR: each term's first
// out_off[v + 1] - out_off[v] postings (its highest impacts; the caller
// computes the output offsets from df, cap and min_df).
void csr_cap(const int64_t* offsets, const int32_t* p_doc,
             const float* p_imp, int64_t V, int64_t cap, int64_t min_df,
             const int64_t* out_off, int32_t* out_doc, float* out_imp) {
  for (int64_t v = 0; v < V; ++v) {
    int64_t n = out_off[v + 1] - out_off[v];
    if (n <= 0) continue;
    std::memcpy(out_doc + out_off[v], p_doc + offsets[v],
                n * sizeof(int32_t));
    std::memcpy(out_imp + out_off[v], p_imp + offsets[v],
                n * sizeof(float));
  }
  (void)cap;
  (void)min_df;
}

// The delta16 slot stream from its fields: per valid (doc, j) posting,
// n_cont continuation slots (gap field 8191, tf 0) then the real slot
// (rem << 3) | tf, written from the doc's off cursor.
void pack_delta16(const int32_t* rem, const int32_t* tf,
                  const int32_t* n_cont, const uint8_t* valid,
                  const int64_t* off, int64_t N, int64_t L,
                  uint16_t* flat) {
  const uint16_t cont = (uint16_t)(8191u << 3);
  for (int64_t d = 0; d < N; ++d) {
    int64_t cursor = off[d];
    const int64_t base = d * L;
    for (int64_t j = 0; j < L; ++j) {
      if (!valid[base + j]) continue;
      for (int32_t c = 0; c < n_cont[base + j]; ++c)
        flat[cursor++] = cont;
      flat[cursor++] =
          (uint16_t)(((uint32_t)rem[base + j] << 3) |
                     ((uint32_t)tf[base + j] & 7u));
    }
  }
}

}  // extern "C"

// The whole delta16 row transform of a doc in one pass: its remapped
// (id, tf) pairs, insertion-sorted by id (rows are short), then either
// counted (out null) or emitted. tf is inverted from the stored impact:
// x = imp / idf = tf / (tf + norm), tf = norm * x / (1 - x) rounded half
// up and clipped to [1, 7]; the numpy twin rounds half to even, which
// differs only on an exact .5.
namespace {
constexpr int kMaxGap = 8191;
constexpr uint16_t kCont = (uint16_t)(8191u << 3);

inline int64_t d16_doc(const int32_t* dt, const float* di,
                       const int32_t* remap, const float* idf,
                       float norm, int64_t L, int32_t* ids, int32_t* tfs,
                       uint16_t* out) {
  int n = 0;
  for (int64_t j = 0; j < L; ++j) {
    int32_t t = dt[j];
    if (t < 0) continue;
    int32_t r = remap[t];
    if (r < 0) continue;  // a tiny term: the host's exact block has it
    double x = (double)di[j] / (idf[t] > 1e-30f ? (double)idf[t] : 1e-30);
    if (x < 0.0) x = 0.0;
    if (x > 1.0 - 1e-9) x = 1.0 - 1e-9;
    int tf = (int)(norm * x / (1.0 - x) + 0.5);
    if (tf < 1) tf = 1;
    if (tf > 7) tf = 7;
    int k = n++;
    while (k > 0 && ids[k - 1] > r) {
      ids[k] = ids[k - 1];
      tfs[k] = tfs[k - 1];
      --k;
    }
    ids[k] = r;
    tfs[k] = tf;
  }
  int64_t slots = 0;
  int32_t prev = 0;
  for (int i = 0; i < n; ++i) {
    int64_t gap = ids[i] - prev;
    int64_t nc = gap / kMaxGap;
    int64_t rem = gap - nc * kMaxGap;
    if (out != nullptr) {
      for (int64_t c = 0; c < nc; ++c) out[slots + c] = kCont;
      out[slots + nc] =
          (uint16_t)(((uint32_t)rem << 3) | ((uint32_t)tfs[i] & 7u));
    }
    slots += nc + 1;
    prev = ids[i];
  }
  return slots;
}
}  // namespace

extern "C" {

// Pass 1: each doc's slot count (the caller places the segments).
void delta16_lens(const int32_t* dt, const float* di, const int32_t* remap,
                  const float* idf, const float* norm, int64_t N, int64_t L,
                  int64_t* lens) {
  std::vector<int32_t> ids(L), tfs(L);
  for (int64_t d = 0; d < N; ++d)
    lens[d] = d16_doc(dt + d * L, di + d * L, remap, idf, norm[d], L,
                      ids.data(), tfs.data(), nullptr);
}

// Pass 2: each doc's slots written at its offset.
void delta16_emit(const int32_t* dt, const float* di, const int32_t* remap,
                  const float* idf, const float* norm, const int64_t* off,
                  int64_t N, int64_t L, uint16_t* flat) {
  std::vector<int32_t> ids(L), tfs(L);
  for (int64_t d = 0; d < N; ++d)
    d16_doc(dt + d * L, di + d * L, remap, idf, norm[d], L, ids.data(),
            tfs.data(), flat + off[d]);
}

}  // extern "C"
