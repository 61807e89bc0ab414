// Banned-token computation for no-repeat-ngram decoding.
//
// Native-equivalent of the reference's CUDA kernel
// (fairseq/fairseq/clib/cuda/ngram_repeat_block_cuda_kernel.cu): for each
// hypothesis row, find tokens that would complete an n-gram already present
// in the sequence.  Host-side variant serving CPU decode paths and tests;
// the device decode path applies the same ban in ops/beam_search.py
// (apply_ngram_block).
#include <cstdint>

extern "C" {

// tokens: [bsz x len]; for each row, scan for (ngram-1)-suffix matches and
// emit the token that followed.  banned: [bsz x max_banned]; n_banned: [bsz].
void mmvc_ngram_repeat_block(const int32_t* tokens, int64_t bsz, int64_t len,
                             int64_t ngram, int32_t* banned, int64_t max_banned,
                             int32_t* n_banned) {
  const int64_t k = ngram - 1;
  for (int64_t b = 0; b < bsz; ++b) {
    const int32_t* row = tokens + b * len;
    int64_t count = 0;
    if (len >= k && k > 0) {
      const int32_t* suffix = row + len - k;
      for (int64_t start = 0; start + ngram <= len; ++start) {
        bool match = true;
        for (int64_t i = 0; i < k; ++i) {
          if (row[start + i] != suffix[i]) {
            match = false;
            break;
          }
        }
        if (match && count < max_banned) {
          banned[b * max_banned + count] = row[start + k];
          ++count;
        }
      }
    }
    n_banned[b] = (int32_t)count;
  }
}

}  // extern "C"
