// Batch text analyzer: UAX#29 word-break segmentation and lowercasing of
// many documents in one call (a copy of kbner_tpu/native/analyzer.cc).
//
// Elasticsearch's `standard` analyzer (Lucene's StandardTokenizer and
// LowerCaseFilter) is what the KB is indexed with. The state machine below
// is the one of kbner_tpu_torch/retrieval/analyzer.py's
// analyze_with_offsets (and cjk_analyze's Han bigrams in cjk mode). The
// Unicode tables are not compiled in: kbner_tpu_torch/native/__init__.py
// generates them from that module's own _wb_class and str.lower, so the
// two cannot classify a character differently; the tests hold their
// tokens equal.
//
// Build: g++ -O3 -shared -fPIC analyzer.cc -o libanalyzer.so
//
// Entry point (C ABI, ctypes):
//   analyze_batch(
//     text, text_len,                 // UTF-8, all docs concatenated
//     doc_offsets[n_docs+1],          // byte ranges per doc
//     n_docs,
//     wb_class[0x110000] uint8,       // codepoint -> word-break class
//     lower_map[0x110000] uint32,     // codepoint -> simple lowercase;
//                                     //   0xFFFFFFFF = context/multi-char
//                                     //   (token flagged; Python re-lowers)
//     cjk_bigrams,                    // 1 = append Han bigram tokens (zh)
//     out_text, out_cap,              // lowered UTF-8 token bytes
//     tok_offsets[tok_cap+1],         // byte offsets into out_text
//     tok_doc[tok_cap],               // owning doc per token
//     tok_flags[tok_cap],             // 1 = needs Python .lower()
//     tok_cap,
//     out_text_len)                   // -> bytes written
//   returns n_tokens, or -1 if a capacity was exceeded.

#include <cstdint>

namespace {

// word-break classes: analyzer.py's enumeration
enum {
  K_OTHER = 0, K_ALETTER = 1, K_NUMERIC = 2, K_KATAKANA = 3, K_HAN = 4,
  K_HIRAGANA = 5, K_ENL = 6, K_MID_LET = 7, K_MID_NUMLET = 8,
  K_MID_NUM = 9, K_SQ = 10, K_EXTEND = 11
};

constexpr uint32_t kLowerSentinel = 0xFFFFFFFFu;

// no-break pairs among word classes (WB5, WB8-10, WB13, WB13a/b),
// analyzer.py's _JOINS
inline bool joins(int a, int b) {
  if (a == K_ENL || b == K_ENL) {
    // ExtendNumLet joins with every word class (and itself)
    return (a == K_ALETTER || a == K_NUMERIC || a == K_KATAKANA ||
            a == K_ENL) &&
           (b == K_ALETTER || b == K_NUMERIC || b == K_KATAKANA ||
            b == K_ENL);
  }
  if (a == K_KATAKANA || b == K_KATAKANA) return a == b;
  return (a == K_ALETTER || a == K_NUMERIC) &&
         (b == K_ALETTER || b == K_NUMERIC);
}

inline bool is_word_class(int c) {
  return c == K_ALETTER || c == K_NUMERIC || c == K_KATAKANA || c == K_ENL;
}

// UTF-8 decode one codepoint at p (valid input: Python encoded it, lone
// surrogates as 3-byte sequences); returns its byte length.
inline int decode(const uint8_t* p, const uint8_t* end, uint32_t* cp) {
  uint8_t b = p[0];
  if (b < 0x80) { *cp = b; return 1; }
  if ((b >> 5) == 0x6 && p + 1 < end) {
    *cp = ((b & 0x1F) << 6) | (p[1] & 0x3F);
    return 2;
  }
  if ((b >> 4) == 0xE && p + 2 < end) {
    *cp = ((b & 0x0F) << 12) | ((p[1] & 0x3F) << 6) | (p[2] & 0x3F);
    return 3;
  }
  if ((b >> 3) == 0x1E && p + 3 < end) {
    *cp = ((b & 0x07) << 18) | ((p[1] & 0x3F) << 12) |
          ((p[2] & 0x3F) << 6) | (p[3] & 0x3F);
    return 4;
  }
  *cp = 0xFFFD;
  return 1;
}

inline int encode(uint32_t cp, uint8_t* out) {
  if (cp < 0x80) { out[0] = (uint8_t)cp; return 1; }
  if (cp < 0x800) {
    out[0] = 0xC0 | (cp >> 6);
    out[1] = 0x80 | (cp & 0x3F);
    return 2;
  }
  if (cp < 0x10000) {
    out[0] = 0xE0 | (cp >> 12);
    out[1] = 0x80 | ((cp >> 6) & 0x3F);
    out[2] = 0x80 | (cp & 0x3F);
    return 3;
  }
  out[0] = 0xF0 | (cp >> 18);
  out[1] = 0x80 | ((cp >> 12) & 0x3F);
  out[2] = 0x80 | ((cp >> 6) & 0x3F);
  out[3] = 0x80 | (cp & 0x3F);
  return 4;
}

struct Emitter {
  uint8_t* out_text;
  int64_t out_cap;
  int64_t* tok_offsets;
  int64_t* tok_doc;
  uint8_t* tok_flags;
  int64_t tok_cap;
  int64_t pos = 0;       // write cursor in out_text
  int64_t n_tok = 0;
  bool overflow = false;

  bool emit_end(int64_t start, int64_t doc, bool dirty) {
    if (n_tok >= tok_cap || pos >= out_cap) { overflow = true; return false; }
    tok_offsets[n_tok] = start;
    tok_offsets[n_tok + 1] = pos;  // next slot holds the end; overwritten
    tok_doc[n_tok] = doc;
    tok_flags[n_tok] = dirty ? 1 : 0;
    ++n_tok;
    out_text[pos++] = 0;  // NUL separator: Python bulk-decodes + splits
    return true;
  }

  bool put(uint32_t cp) {
    if (pos + 4 > out_cap) { overflow = true; return false; }
    pos += encode(cp, out_text + pos);
    return true;
  }
};

}  // namespace

extern "C" {

int64_t analyze_batch(const uint8_t* text, int64_t text_len,
                      const int64_t* doc_offsets, int64_t n_docs,
                      const uint8_t* wb_class, const uint32_t* lower_map,
                      int32_t cjk_bigrams,
                      uint8_t* out_text, int64_t out_cap,
                      int64_t* tok_offsets, int64_t* tok_doc,
                      uint8_t* tok_flags, int64_t tok_cap,
                      int64_t* out_text_len) {
  (void)text_len;
  Emitter em{out_text, out_cap, tok_offsets, tok_doc, tok_flags, tok_cap};

  for (int64_t d = 0; d < n_docs; ++d) {
    const uint8_t* p = text + doc_offsets[d];
    const uint8_t* end = text + doc_offsets[d + 1];
    int64_t tok_start = em.pos;
    bool open = false, has_core = false, dirty = false;
    int prev_cls = K_OTHER;
    uint32_t prev_han = 0;  // last emitted single-Han token (bigram state)

    auto append = [&](uint32_t cp) {
      uint32_t lc = lower_map[cp];
      if (lc == kLowerSentinel) { dirty = true; lc = cp; }
      em.put(lc);
    };
    // flush: emit the open token if it has a core word char, else rewind
    auto flush = [&]() {
      if (open && has_core) {
        em.emit_end(tok_start, d, dirty);
        prev_han = 0;  // multi-char word token resets the bigram chain
      } else {
        em.pos = tok_start;
      }
      open = false;
      has_core = false;
      dirty = false;
      prev_cls = K_OTHER;
      tok_start = em.pos;
    };

    while (p < end && !em.overflow) {
      uint32_t cp;
      int len = decode(p, end, &cp);
      int c = wb_class[cp];

      if (c == K_EXTEND) {
        // WB4: combining/format chars attach, don't change the class
        if (open) append(cp);
        p += len;
        continue;
      }
      if (c == K_HAN || c == K_HIRAGANA) {
        // ideographic / hiragana single-char tokens
        flush();
        uint32_t save_prev = prev_han;
        append(cp);
        em.emit_end(tok_start, d, dirty);
        dirty = false;
        tok_start = em.pos;
        if (cjk_bigrams && c == K_HAN) {
          if (save_prev) {  // bigram of two adjacent single-Han tokens
            int64_t bstart = em.pos;
            uint32_t pl = lower_map[save_prev];
            uint32_t cl = lower_map[cp];
            em.put(pl == kLowerSentinel ? save_prev : pl);
            em.put(cl == kLowerSentinel ? cp : cl);
            em.emit_end(bstart, d, false);
            tok_start = em.pos;
          }
          prev_han = cp;
        } else {
          prev_han = 0;
        }
        p += len;
        continue;
      }
      if (is_word_class(c)) {
        if (open && !joins(prev_cls, c)) flush();
        append(cp);
        open = true;
        prev_cls = c;
        has_core = has_core || c != K_ENL;
        p += len;
        continue;
      }
      if ((c == K_MID_LET || c == K_MID_NUMLET || c == K_MID_NUM ||
           c == K_SQ) && open) {
        // WB6/7, WB11/12: join iff a matching word char follows
        // (skipping Extend/Format chars)
        const uint8_t* q = p + len;
        uint32_t ncp = 0;
        int nc = K_OTHER;
        while (q < end) {
          int nlen = decode(q, end, &ncp);
          nc = wb_class[ncp];
          if (nc != K_EXTEND) break;
          q += nlen;
        }
        if (q >= end) nc = K_OTHER;
        bool letter_join = prev_cls == K_ALETTER && nc == K_ALETTER &&
                           (c == K_MID_LET || c == K_MID_NUMLET ||
                            c == K_SQ);
        bool numeric_join = prev_cls == K_NUMERIC && nc == K_NUMERIC &&
                            (c == K_MID_NUM || c == K_MID_NUMLET ||
                             c == K_SQ);
        if (letter_join || numeric_join) {
          append(cp);  // prev_cls stays the base class
          p += len;
          continue;
        }
        flush();
        p += len;
        continue;
      }
      flush();
      p += len;
    }
    flush();
    if (em.overflow) return -1;
  }
  *out_text_len = em.pos;
  return em.n_tok;
}

}  // extern "C"
