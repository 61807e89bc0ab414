// Length-bucketed batch construction hot loop.
//
// Native-equivalent of fairseq's Cython batch_by_size
// (fairseq/fairseq/data/data_utils_fast.pyx) extended with bucket snapping:
// cost of a batch is n * bucket(max_len) tokens.
//
// Inputs: sizes[n], order[n] (length-sorted indices), buckets[nb] ascending.
// Output: out_batch_ids[i] = batch index of order[i].  Returns #batches.
//
// required_multiple follows fairseq semantics (data_utils_fast.pyx
// mod_len = max(k*(len//k), len%k)): when a batch flushes at a size that is
// not a multiple of k, the remainder CARRIES into the next batch — no sample
// is ever dropped.  The final batch keeps its remainder as-is.
#include <cstdint>

extern "C" {

static inline int64_t bucket_of(int64_t len, const int64_t* buckets, int64_t nb) {
  for (int64_t i = 0; i < nb; ++i)
    if (len <= buckets[i]) return buckets[i];
  return buckets[nb - 1];
}

int64_t mmvc_batch_by_size(const int64_t* sizes, const int64_t* order, int64_t n,
                           const int64_t* buckets, int64_t nb, int64_t max_tokens,
                           int64_t batch_size, int64_t required_multiple,
                           int32_t* out_batch_ids) {
  int64_t batch = 0;
  int64_t count = 0;
  int64_t cur_bucket = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t b = bucket_of(sizes[order[i]], buckets, nb);
    int64_t new_bucket = b > cur_bucket ? b : cur_bucket;
    const bool over_tokens = max_tokens > 0 && (count + 1) * new_bucket > max_tokens;
    const bool over_batch = batch_size > 0 && count + 1 > batch_size;
    if (count > 0 && (over_tokens || over_batch || b != cur_bucket)) {
      int64_t keep = count;
      if (required_multiple > 1 && count >= required_multiple)
        keep = (count / required_multiple) * required_multiple;
      const int64_t rem = count - keep;
      // retro-assign the carried tail (positions i-rem .. i-1) to the new
      // batch; order is length-sorted so their buckets are <= b.
      for (int64_t j = i - rem; j < i; ++j)
        out_batch_ids[j] = static_cast<int32_t>(batch + 1);
      ++batch;
      count = rem;
      new_bucket = b;
    }
    out_batch_ids[i] = static_cast<int32_t>(batch);
    ++count;
    cur_bucket = new_bucket;
  }
  return count > 0 ? batch + 1 : batch;
}

// Token-block packing for LM datasets: greedy whole-sentence packing up to
// block_size ('complete'), optionally respecting document boundaries
// ('complete_doc').  Host analog of fairseq's Cython
// _get_slice_indices_fast (fairseq/fairseq/data/token_block_utils_fast.pyx:
// 52-106); original implementation (single forward pass, no torch deps).
// Returns the number of blocks written; out must hold 2 * n entries
// (worst case: one block per sentence).
int64_t mmvc_token_blocks_complete(const int64_t* sizes, int64_t n,
                                   int64_t block_size, int64_t complete_doc,
                                   int64_t document_sep_len, int64_t* out) {
  int64_t tok_idx = 0, curr = 0, nb = 0, i = 0;
  while (i < n) {
    bool is_sep = complete_doc && sizes[i] == document_sep_len;
    if ((curr + sizes[i] <= block_size || curr == 0) && !is_sep) {
      curr += sizes[i];
      ++i;
    } else {
      // 'complete_doc' drops single-token blocks (pyx:88-90)
      if (curr > (complete_doc ? 1 : 0)) {
        out[2 * nb] = tok_idx;
        out[2 * nb + 1] = tok_idx + curr;
        ++nb;
      }
      tok_idx += curr;
      curr = 0;
      if (is_sep) {
        tok_idx += sizes[i];
        ++i;
      }
    }
  }
  if (curr > (complete_doc ? 1 : 0)) {
    out[2 * nb] = tok_idx;
    out[2 * nb + 1] = tok_idx + curr;
    ++nb;
  }
  return nb;
}

}  // extern "C"
