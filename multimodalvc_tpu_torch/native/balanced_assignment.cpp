// Balanced token->expert assignment via epsilon-scaling auction.
//
// Native-equivalent of the reference's BASE-layer router
// (fairseq/fairseq/clib/libbase/balanced_assignment.cpp, used by
// fairseq/fairseq/modules/base_layer.py): given scores[workers x jobs],
// assign each worker exactly jobs/workers jobs maximizing total score.
//
// Capacitated forward auction ("similar objects" formulation): each worker
// holds up to C winning bids; its price is its lowest winning bid once at
// capacity.  A bidding job raises the price by (best - second + eps); the
// displaced job (lowest bid) re-enters the queue.  eps-scaling phases give
// near-optimal assignments.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

void mmvc_balanced_assignment(const float* scores, int64_t n_workers,
                              int64_t n_jobs, int32_t* out_worker) {
  const int64_t cap = n_jobs / n_workers;
  std::vector<int32_t> owner(n_jobs, -1);

  float max_abs = 1e-6f;
  for (int64_t i = 0; i < n_workers * n_jobs; ++i)
    max_abs = std::max(max_abs, std::abs(scores[i]));

  struct Bid {
    int32_t job;
    float value;
  };
  std::vector<std::vector<Bid>> held(n_workers);
  std::vector<float> price(n_workers, 0.f);

  const float eps_final = max_abs / std::max<int64_t>(n_jobs, 1) / 4.f;
  for (float eps = max_abs / 4.f;; eps = std::max(eps / 4.f, eps_final)) {
    std::fill(owner.begin(), owner.end(), -1);
    for (auto& h : held) h.clear();
    std::fill(price.begin(), price.end(), 0.f);
    std::vector<int32_t> queue(n_jobs);
    for (int64_t j = 0; j < n_jobs; ++j) queue[j] = (int32_t)j;

    while (!queue.empty()) {
      const int32_t j = queue.back();
      queue.pop_back();
      int64_t best = -1;
      float best_v = -1e30f, second_v = -1e30f;
      for (int64_t w = 0; w < n_workers; ++w) {
        const float v = scores[w * n_jobs + j] - price[w];
        if (v > best_v) {
          second_v = best_v;
          best_v = v;
          best = w;
        } else if (v > second_v) {
          second_v = v;
        }
      }
      // the job is willing to pay up to the point of indifference
      const float bid = price[best] + (best_v - second_v) + eps;
      auto& h = held[best];
      h.push_back({j, bid});
      owner[j] = (int32_t)best;
      if ((int64_t)h.size() > cap) {
        // evict lowest winning bid
        size_t lo = 0;
        for (size_t p = 1; p < h.size(); ++p)
          if (h[p].value < h[lo].value) lo = p;
        owner[h[lo].job] = -1;
        queue.push_back(h[lo].job);
        h[lo] = h.back();
        h.pop_back();
      }
      if ((int64_t)h.size() == cap) {
        float mn = 1e30f;
        for (const auto& bd : h) mn = std::min(mn, bd.value);
        price[best] = mn;
      }
    }
    if (eps <= eps_final * 1.0001f) break;
  }
  for (int64_t j = 0; j < n_jobs; ++j) out_worker[j] = owner[j];
}

}  // extern "C"
