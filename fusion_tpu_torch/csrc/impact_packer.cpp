// Host-side chunked-impact index packer.
//
// build_chunked_impact_index (fusion_tpu/index/inverted.py) selects, for
// every (term, doc-range chunk) group, the top cap_per_chunk postings by
// impact.  The numpy path does it with a global lexsort over all postings —
// at mMARCO scale (8.8M passages × ~128 SPLADE terms ≈ 1.1e9 postings) that
// is a multi-minute, ~30 GB sort.  This packer does ONE pass with a bounded
// min-heap per group (heap size = cap_per_chunk ≤ 64), so memory is the
// output size plus one f32 impact mirror, and time is O(nnz · log capc).
//
// The reference leans on faiss/colbert-ai C++ for its index builds; this is
// the equivalent native component for the impact-index family.
//
// API (C, ctypes-friendly): one call, caller-allocated outputs.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint16_t kSentinel = 0xFFFF;  // CHUNK_SENTINEL in inverted.py

// f32 -> IEEE binary16 bits, round-to-nearest-even (matches numpy astype).
inline uint16_t f32_to_f16_bits(float f) {
  uint32_t x;
  memcpy(&x, &f, 4);
  uint32_t sign = (x >> 16) & 0x8000u;
  int32_t exp = static_cast<int32_t>((x >> 23) & 0xFF) - 127 + 15;
  uint32_t mant = x & 0x7FFFFFu;
  if (exp >= 31) {  // inf/overflow/NaN
    // NaN must stay NaN (numpy astype preserves it); collapsing it to +inf
    // would silently dominate every ranking for its term
    if (exp == 143 && mant != 0)  // f32 exp 255 → biased-16 143
      return static_cast<uint16_t>(sign | 0x7E00u);  // quiet NaN
    return static_cast<uint16_t>(sign | 0x7C00u);
  }
  if (exp <= 0) {
    if (exp < -10) return static_cast<uint16_t>(sign);  // underflow -> 0
    // subnormal: shift mantissa (with implicit bit) right
    mant |= 0x800000u;
    int shift = 14 - exp;
    uint32_t half = mant >> shift;
    uint32_t rem = mant & ((1u << shift) - 1);
    uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (half & 1u))) ++half;
    return static_cast<uint16_t>(sign | half);
  }
  uint32_t half = (static_cast<uint32_t>(exp) << 10) | (mant >> 13);
  uint32_t rem = mant & 0x1FFFu;
  if (rem > 0x1000u || (rem == 0x1000u && (half & 1u))) ++half;  // RNE
  return static_cast<uint16_t>(sign | half);
}

}  // namespace

extern "C" {

// Select the top cap_per_chunk postings by impact per (term, chunk) group
// and pack them into the [vocab_size+1, num_chunks, cap_per_chunk] layout
// (row vocab_size is the query-pad sentinel row, left all-sentinel).
//
// post_doc / post_imp: caller-allocated uint16 buffers of
// (vocab_size+1)*num_chunks*cap_per_chunk entries; post_imp receives IEEE
// f16 bit patterns.  Returns the number of postings kept, or -1 on invalid
// arguments (term/doc out of range, docs_per_chunk >= 0xFFFF).
int64_t pack_chunked_impact(const int64_t* entry_term, const int64_t* entry_doc,
                            const float* impacts, int64_t nnz,
                            int64_t vocab_size, int64_t n_docs,
                            int64_t docs_per_chunk, int64_t cap_per_chunk,
                            uint16_t* post_doc, uint16_t* post_imp) {
  if (docs_per_chunk <= 0 || docs_per_chunk >= kSentinel || cap_per_chunk <= 0)
    return -1;
  const int64_t num_chunks = (n_docs + docs_per_chunk - 1) / docs_per_chunk;
  const int64_t capc = cap_per_chunk;
  const int64_t groups = (vocab_size + 1) * num_chunks;
  const int64_t total = groups * capc;

  std::fill(post_doc, post_doc + total, kSentinel);
  std::fill(post_imp, post_imp + total, static_cast<uint16_t>(0));
  std::vector<float> imp(static_cast<size_t>(total), 0.0f);
  std::vector<uint32_t> count(static_cast<size_t>(groups), 0);

  auto sift_down = [&](int64_t base, int64_t cnt, int64_t i) {
    // min-heap on imp, entries at [base, base+cnt)
    while (true) {
      int64_t l = 2 * i + 1, r = 2 * i + 2, m = i;
      if (l < cnt && imp[base + l] < imp[base + m]) m = l;
      if (r < cnt && imp[base + r] < imp[base + m]) m = r;
      if (m == i) break;
      std::swap(imp[base + i], imp[base + m]);
      std::swap(post_doc[base + i], post_doc[base + m]);
      i = m;
    }
  };

  for (int64_t e = 0; e < nnz; ++e) {
    const int64_t t = entry_term[e];
    const int64_t d = entry_doc[e];
    if (t < 0 || t >= vocab_size || d < 0 || d >= n_docs) return -1;
    const int64_t g = t * num_chunks + d / docs_per_chunk;
    const int64_t base = g * capc;
    const uint32_t cnt = count[g];
    const float v = impacts[e];
    if (cnt < capc) {
      imp[base + cnt] = v;
      post_doc[base + cnt] = static_cast<uint16_t>(d % docs_per_chunk);
      count[g] = cnt + 1;
      if (cnt + 1 == capc)  // slice is full: heapify once
        for (int64_t i = capc / 2 - 1; i >= 0; --i) sift_down(base, capc, i);
    } else if (v > imp[base]) {  // beat the current minimum: replace root
      imp[base] = v;
      post_doc[base] = static_cast<uint16_t>(d % docs_per_chunk);
      sift_down(base, capc, 0);
    }
  }

  // impact-descending order within each group (the numpy builder's layout)
  // + f16 conversion
  int64_t kept = 0;
  std::vector<int32_t> order(static_cast<size_t>(capc));
  std::vector<float> tmp_imp(static_cast<size_t>(capc));
  std::vector<uint16_t> tmp_doc(static_cast<size_t>(capc));
  for (int64_t g = 0; g < groups; ++g) {
    const int64_t cnt = count[g];
    if (cnt == 0) continue;
    kept += cnt;
    const int64_t base = g * capc;
    for (int64_t i = 0; i < cnt; ++i) order[i] = static_cast<int32_t>(i);
    std::stable_sort(order.begin(), order.begin() + cnt,
                     [&](int32_t a, int32_t b) {
                       return imp[base + a] > imp[base + b];
                     });
    for (int64_t i = 0; i < cnt; ++i) {
      tmp_imp[i] = imp[base + order[i]];
      tmp_doc[i] = post_doc[base + order[i]];
    }
    for (int64_t i = 0; i < cnt; ++i) {
      post_doc[base + i] = tmp_doc[i];
      post_imp[base + i] = f32_to_f16_bits(tmp_imp[i]);
    }
  }
  return kept;
}

// Flat (term-major, global-cap) variant: the ImpactIndex layout
// [vocab_size+1, cap] with int32 doc ids (pad = n_docs) — same bounded
// min-heap selection, one group per term.
int64_t pack_flat_impact(const int64_t* entry_term, const int64_t* entry_doc,
                         const float* impacts, int64_t nnz,
                         int64_t vocab_size, int64_t n_docs, int64_t cap,
                         int32_t* post_doc, uint16_t* post_imp) {
  if (cap <= 0) return -1;
  const int64_t total = (vocab_size + 1) * cap;
  std::fill(post_doc, post_doc + total, static_cast<int32_t>(n_docs));
  std::fill(post_imp, post_imp + total, static_cast<uint16_t>(0));
  std::vector<float> imp(static_cast<size_t>(total), 0.0f);
  std::vector<uint32_t> count(static_cast<size_t>(vocab_size + 1), 0);

  auto sift_down = [&](int64_t base, int64_t cnt, int64_t i) {
    while (true) {
      int64_t l = 2 * i + 1, r = 2 * i + 2, m = i;
      if (l < cnt && imp[base + l] < imp[base + m]) m = l;
      if (r < cnt && imp[base + r] < imp[base + m]) m = r;
      if (m == i) break;
      std::swap(imp[base + i], imp[base + m]);
      std::swap(post_doc[base + i], post_doc[base + m]);
      i = m;
    }
  };

  for (int64_t e = 0; e < nnz; ++e) {
    const int64_t t = entry_term[e];
    const int64_t d = entry_doc[e];
    if (t < 0 || t >= vocab_size || d < 0 || d >= n_docs) return -1;
    const int64_t base = t * cap;
    const uint32_t cnt = count[t];
    const float v = impacts[e];
    if (cnt < cap) {
      imp[base + cnt] = v;
      post_doc[base + cnt] = static_cast<int32_t>(d);
      count[t] = cnt + 1;
      if (cnt + 1 == cap)
        for (int64_t i = cap / 2 - 1; i >= 0; --i) sift_down(base, cap, i);
    } else if (v > imp[base]) {
      imp[base] = v;
      post_doc[base] = static_cast<int32_t>(d);
      sift_down(base, cap, 0);
    }
  }

  int64_t kept = 0;
  std::vector<int32_t> order(static_cast<size_t>(cap));
  std::vector<float> tmp_imp(static_cast<size_t>(cap));
  std::vector<int32_t> tmp_doc(static_cast<size_t>(cap));
  for (int64_t t = 0; t < vocab_size; ++t) {
    const int64_t cnt = count[t];
    if (cnt == 0) continue;
    kept += cnt;
    const int64_t base = t * cap;
    for (int64_t i = 0; i < cnt; ++i) order[i] = static_cast<int32_t>(i);
    std::stable_sort(order.begin(), order.begin() + cnt,
                     [&](int32_t a, int32_t b) {
                       return imp[base + a] > imp[base + b];
                     });
    for (int64_t i = 0; i < cnt; ++i) {
      tmp_imp[i] = imp[base + order[i]];
      tmp_doc[i] = post_doc[base + order[i]];
    }
    for (int64_t i = 0; i < cnt; ++i) {
      post_doc[base + i] = tmp_doc[i];
      post_imp[base + i] = f32_to_f16_bits(tmp_imp[i]);
    }
  }
  return kept;
}

}  // extern "C"
