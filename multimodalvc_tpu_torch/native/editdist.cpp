// Levenshtein edit distance on int32 token sequences.
//
// Native-equivalent of the reference's C++ edit-distance plumbing
// (fairseq/fairseq/clib/libnat/edit_dist.cpp) and the editdistance pip dep
// used for WER (src/criterion.py:121-134).  Row-rolling DP, O(min(la,lb))
// memory, no dependencies.
#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

int64_t mmvc_edit_distance_i32(const int32_t* a, int64_t la, const int32_t* b,
                               int64_t lb) {
  if (la == 0) return lb;
  if (lb == 0) return la;
  if (lb > la) {
    std::swap(a, b);
    std::swap(la, lb);
  }
  std::vector<int64_t> prev(lb + 1), cur(lb + 1);
  for (int64_t j = 0; j <= lb; ++j) prev[j] = j;
  for (int64_t i = 1; i <= la; ++i) {
    cur[0] = i;
    const int32_t ai = a[i - 1];
    for (int64_t j = 1; j <= lb; ++j) {
      const int64_t cost = (ai == b[j - 1]) ? 0 : 1;
      cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost});
    }
    std::swap(prev, cur);
  }
  return prev[lb];
}

// Batched corpus edit distance: sequences are concatenated, offsets give
// boundaries; returns total errors (for corpus WER in one call).
int64_t mmvc_edit_distance_batch(const int32_t* hyp, const int64_t* hyp_off,
                                 const int32_t* ref, const int64_t* ref_off,
                                 int64_t n) {
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    total += mmvc_edit_distance_i32(hyp + hyp_off[i], hyp_off[i + 1] - hyp_off[i],
                                    ref + ref_off[i], ref_off[i + 1] - ref_off[i]);
  }
  return total;
}

}  // extern "C"
