// BLEU n-gram match counting (native-equivalent of the reference's
// fairseq/fairseq/clib/libbleu/libbleu.cpp — sentence-pair clipped n-gram
// match counts accumulated corpus-level in Python).
#include <cstddef>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

// 64-bit FNV-1a over the n-gram's token ids
inline uint64_t hash_ngram(const int32_t* toks, int64_t start, int n) {
  uint64_t h = 1469598103934665603ull;
  for (int i = 0; i < n; ++i) {
    uint64_t v = static_cast<uint64_t>(static_cast<uint32_t>(toks[start + i]));
    for (int b = 0; b < 4; ++b) {
      h ^= (v >> (8 * b)) & 0xff;
      h *= 1099511628211ull;
    }
  }
  return h;
}

}  // namespace

extern "C" {

// Count clipped n-gram matches for orders 1..max_order between one system
// output and one reference.  matches/totals are arrays of length max_order,
// accumulated (+=) so the caller can loop over a corpus.
void mmvc_bleu_counts(const int32_t* sys, int64_t sys_len,
                      const int32_t* ref, int64_t ref_len,
                      int64_t max_order,
                      int64_t* matches, int64_t* totals) {
  for (int n = 1; n <= max_order; ++n) {
    const int64_t n_sys = sys_len - n + 1;
    const int64_t n_ref = ref_len - n + 1;
    if (n_sys > 0) totals[n - 1] += n_sys;
    if (n_sys <= 0 || n_ref <= 0) continue;
    std::unordered_map<uint64_t, int64_t> ref_counts;
    ref_counts.reserve(static_cast<size_t>(n_ref) * 2);
    for (int64_t i = 0; i < n_ref; ++i) ++ref_counts[hash_ngram(ref, i, n)];
    for (int64_t i = 0; i < n_sys; ++i) {
      auto it = ref_counts.find(hash_ngram(sys, i, n));
      if (it != ref_counts.end() && it->second > 0) {
        --it->second;
        ++matches[n - 1];
      }
    }
  }
}

}  // extern "C"
