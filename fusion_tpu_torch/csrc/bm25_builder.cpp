// Host-side BM25 posting-list builder.
//
// The index build is pure host work (tokenize, vocab, tf/df counting —
// reference does it with Python dicts, src/retrievers/bm25.py:52-87).
// At mMARCO scale (8.8M passages, ~5e8 tokens) the Python path takes
// minutes; this C++ builder does one pass over a newline-separated UTF-8
// corpus buffer and emits the COO arrays the device scorer consumes.
//
// API (C, ctypes-friendly): handle-based two-phase — build, query sizes,
// export into caller-allocated numpy buffers, free.

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>
#include <deque>
#include <algorithm>

namespace {

struct Index {
  std::deque<std::string> vocab;           // term id -> term (deque: stable refs)
  std::vector<int32_t> entry_term;         // doc-major COO
  std::vector<int32_t> entry_doc;
  std::vector<float> entry_tf;
  std::vector<float> doc_len;
  std::vector<int64_t> df;
  int64_t vocab_bytes = 0;
};

inline bool is_space(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f';
}

}  // namespace

extern "C" {

// text: newline-separated documents (already preprocessed/tokenized on
// whitespace, same contract as the Python builder).
void* bm25_build(const char* text, int64_t text_len) {
  auto* idx = new Index();
  std::unordered_map<std::string_view, int32_t> vocab_ids;
  vocab_ids.reserve(1 << 20);

  // per-document term counting, reusing a scratch map keyed by term id
  std::vector<std::pair<int32_t, int32_t>> doc_counts;  // (term, tf)
  std::unordered_map<int32_t, int32_t> tf_map;

  const char* p = text;
  const char* end = text + text_len;
  int32_t doc_id = 0;
  while (p <= end) {
    const char* line_end = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    if (line_end == nullptr) line_end = end;

    tf_map.clear();
    int64_t n_tokens = 0;
    const char* q = p;
    while (q < line_end) {
      while (q < line_end && is_space(static_cast<unsigned char>(*q))) ++q;
      const char* tok_start = q;
      while (q < line_end && !is_space(static_cast<unsigned char>(*q))) ++q;
      if (q > tok_start) {
        ++n_tokens;
        std::string_view tok(tok_start, static_cast<size_t>(q - tok_start));
        auto it = vocab_ids.find(tok);
        int32_t tid;
        if (it == vocab_ids.end()) {
          tid = static_cast<int32_t>(idx->vocab.size());
          idx->vocab.emplace_back(tok);
          // key must reference stable storage: view into idx->vocab
          vocab_ids.emplace(std::string_view(idx->vocab.back()), tid);
          idx->vocab_bytes += static_cast<int64_t>(tok.size()) + 1;
        } else {
          tid = it->second;
        }
        ++tf_map[tid];
      }
    }

    idx->doc_len.push_back(static_cast<float>(n_tokens));
    doc_counts.assign(tf_map.begin(), tf_map.end());
    std::sort(doc_counts.begin(), doc_counts.end());
    for (const auto& [tid, tf] : doc_counts) {
      idx->entry_term.push_back(tid);
      idx->entry_doc.push_back(doc_id);
      idx->entry_tf.push_back(static_cast<float>(tf));
    }

    ++doc_id;
    if (line_end == end) break;
    p = line_end + 1;
  }

  idx->df.assign(idx->vocab.size(), 0);
  for (int32_t t : idx->entry_term) ++idx->df[static_cast<size_t>(t)];
  return idx;
}

int64_t bm25_nnz(void* h) { return static_cast<Index*>(h)->entry_term.size(); }
int64_t bm25_vocab_size(void* h) { return static_cast<Index*>(h)->vocab.size(); }
int64_t bm25_ndocs(void* h) { return static_cast<Index*>(h)->doc_len.size(); }
int64_t bm25_vocab_bytes(void* h) { return static_cast<Index*>(h)->vocab_bytes; }

void bm25_export(void* h, int32_t* entry_term, int32_t* entry_doc,
                 float* entry_tf, float* doc_len, int64_t* df,
                 char* vocab_buf) {
  auto* idx = static_cast<Index*>(h);
  memcpy(entry_term, idx->entry_term.data(), idx->entry_term.size() * 4);
  memcpy(entry_doc, idx->entry_doc.data(), idx->entry_doc.size() * 4);
  memcpy(entry_tf, idx->entry_tf.data(), idx->entry_tf.size() * 4);
  memcpy(doc_len, idx->doc_len.data(), idx->doc_len.size() * 4);
  memcpy(df, idx->df.data(), idx->df.size() * 8);
  char* v = vocab_buf;
  for (const auto& term : idx->vocab) {
    memcpy(v, term.data(), term.size());
    v += term.size();
    *v++ = '\n';
  }
}

void bm25_free(void* h) { delete static_cast<Index*>(h); }

}  // extern "C"
