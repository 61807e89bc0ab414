// K4 · beam_topk_columns and K5 · beam_topk / beam_topk_from_logits: the beam
// search's top-2K candidates, exact in values and indices.
//
// Replaces two Pallas kernels of multimodalvc_tpu/ops/topk.py, each together
// with the gather + (value desc, flat asc) merge its caller runs:
//   K4 beam_topk_columns (pallas_call at :271, body _column_champion_kernel
//      :189): raw f32 unembed logits with row max m and logsumexp ls, V % 8 == 0;
//   K5 _run_and_merge (pallas_call at :125, body _block_topk_kernel :58),
//      entries beam_topk (:303: f32 or bf16 log-probs, m = ls = 0) and
//      beam_topk_from_logits (:157: as K4, any V).
// The V -> 8 sublane fold of K4 and the column blocks of K5 are TPU tiling;
// both compute one function, which one kernel family computes here for any V,
// templated on the input element type.  Per batch element:
//   x[r, c] = max(((logit[r, c] - m[r]) - ls[r]) + s[r], -2.9e38)   (f32)
// in exactly that order (XLA's and PyTorch's log_softmax order), with a null
// m / ls pointer meaning 0.0f, so that ((x - 0) - 0) + s is bit-identical to
// logp + score, the contract of beam_topk; each
// column's champion is its best row, lowest row on ties; the top-n champion
// columns are taken by (value desc, flat index asc); the K rows of those n
// columns are the provable superset of the true top-n, which is then picked
// by (value desc, flat index asc) with flat = r*V + c.  The result equals a
// stable descending sort of x over the flat K*V candidates, first n.
//
// Design for Hopper.  The TPU version folds V into 8 sublanes and runs the n
// extraction passes over one VMEM-resident [8, V/8] champion array.  Here:
// pass 1, one block of 256 threads per (2048-column chunk, batch element)
// reads the K rows of its chunk once (coalesced), forms the column champions
// in registers and extracts the chunk's top-n champions with n block-wide
// arg-best rounds; pass 2, one block per batch element merges the
// chunks*n candidates, gathers the K*n values of the winning columns and
// extracts the final top-n.  No fast-math: the values are bit-identical to
// the plain PyTorch version.
//
// What bounds it on the H100: one read of the [B*K, V] input against 3.35
// TB/s: 123 MB, ~37 us, at [240, 128256] f32 (K4, and K5 from logits);
// 10.3 MB, ~3.1 us, at K5's [4, 5, 128256] f32 selftest shape (half of that
// in bf16).  The n block-wide reductions of pass 1 add latency per block,
// which the 63 x B blocks hide only partly.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 8;
constexpr int CHUNK = THREADS * PER_THREAD;  // columns per pass-1 block
constexpr float kClamp = -2.9e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// m and ls may be null: 0.0f
__device__ __forceinline__ float candidate(float logit, const float* m, const float* ls,
                                           const float* s, int row) {
  const float mr = m ? m[row] : 0.0f, lr = ls ? ls[row] : 0.0f;
  return fmaxf(((logit - mr) - lr) + s[row], kClamp);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
column_champions(const T* __restrict__ logits, const float* __restrict__ m,
                 const float* __restrict__ ls, const float* __restrict__ s,
                 float* __restrict__ cand_v, int* __restrict__ cand_f, int K, int V, int n,
                 int nchunks) {
  __shared__ float sv[32];
  __shared__ int si[32];
  const int chunk = blockIdx.x, b = blockIdx.y;
  float bv[PER_THREAD];
  int bf[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int col = chunk * CHUNK + i * THREADS + threadIdx.x;
    bv[i] = -INFINITY;
    bf[i] = INT_MAX;
    if (col < V) {
      for (int r = 0; r < K; ++r) {
        const int row = b * K + r;
        const float x = candidate(to_f32(logits[size_t(row) * V + col]), m, ls, s, row);
        if (r == 0 || x > bv[i]) {  // strict: the lowest row keeps a tie
          bv[i] = x;
          bf[i] = r * V + col;
        }
      }
    }
  }
  const size_t out0 = (size_t(b) * nchunks + chunk) * n;
  for (int j = 0; j < n; ++j) {
    float v = -INFINITY;
    int f = INT_MAX;
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i)
      if (mmvc::ranks_before(bv[i], bf[i], v, f)) {
        v = bv[i];
        f = bf[i];
      }
    mmvc::block_best(v, f, sv, si);
    if (threadIdx.x == 0) {
      cand_v[out0 + j] = v;
      cand_f[out0 + j] = f;
    }
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i)
      if (bf[i] == f) {  // whole-column knockout
        bv[i] = -INFINITY;
        bf[i] = INT_MAX;
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
merge_champions(const T* __restrict__ logits, const float* __restrict__ m,
                const float* __restrict__ ls, const float* __restrict__ s,
                const float* __restrict__ cand_v, const int* __restrict__ cand_f,
                float* __restrict__ out_v, int* __restrict__ out_f, int K, int V, int n,
                int nchunks) {
  extern __shared__ float smem[];
  __shared__ float sv[32];
  __shared__ int si[32];
  const int b = blockIdx.x, total = nchunks * n, kn = K * n;
  float* pv = smem;                                        // [total]
  int* pf = reinterpret_cast<int*>(pv + total);            // [total]
  int* cols = pf + total;                                  // [n]
  float* gv = reinterpret_cast<float*>(cols + n);          // [K*n]
  int* gf = reinterpret_cast<int*>(gv + kn);               // [K*n]
  for (int i = threadIdx.x; i < total; i += THREADS) {
    pv[i] = cand_v[size_t(b) * total + i];
    pf[i] = cand_f[size_t(b) * total + i];
  }
  __syncthreads();

  // global top-n champion columns; each thread only touches its own slots
  for (int j = 0; j < n; ++j) {
    float v = -INFINITY;
    int f = INT_MAX;
    for (int i = threadIdx.x; i < total; i += THREADS)
      if (mmvc::ranks_before(pv[i], pf[i], v, f)) {
        v = pv[i];
        f = pf[i];
      }
    mmvc::block_best(v, f, sv, si);
    if (threadIdx.x == 0) cols[j] = f == INT_MAX ? 0 : f % V;
    for (int i = threadIdx.x; i < total; i += THREADS)
      if (pf[i] == f) {
        pv[i] = -INFINITY;
        pf[i] = INT_MAX;
      }
  }
  __syncthreads();

  // every beam row of the champion columns, values recomputed in the same order
  for (int t = threadIdx.x; t < kn; t += THREADS) {
    const int r = t / n, col = cols[t % n], row = b * K + r;
    gv[t] = candidate(to_f32(logits[size_t(row) * V + col]), m, ls, s, row);
    gf[t] = r * V + col;
  }
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    float v = -INFINITY;
    int f = INT_MAX;
    for (int i = threadIdx.x; i < kn; i += THREADS)
      if (mmvc::ranks_before(gv[i], gf[i], v, f)) {
        v = gv[i];
        f = gf[i];
      }
    mmvc::block_best(v, f, sv, si);
    if (threadIdx.x == 0) {
      out_v[size_t(b) * n + j] = v;
      out_f[size_t(b) * n + j] = f;
    }
    for (int i = threadIdx.x; i < kn; i += THREADS)
      if (gf[i] == f) {
        gv[i] = -INFINITY;
        gf[i] = INT_MAX;
      }
  }
}

template <typename T>
int launch(const void* logits, const void* m, const void* ls, const void* s, void* cand_v,
           void* cand_f, void* out_v, void* out_f, int B, int K, int V, int n, void* stream) {
  if (B <= 0 || K <= 0 || V <= 0 || n <= 0 || n > K * V || B > 65535 ||
      (long long)K * V >= INT_MAX)
    return cudaErrorInvalidValue;
  const int nchunks = (V + CHUNK - 1) / CHUNK;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* lg = static_cast<const T*>(logits);
  const float* mm = static_cast<const float*>(m);
  const float* ll = static_cast<const float*>(ls);
  const float* ss = static_cast<const float*>(s);
  column_champions<T><<<dim3(nchunks, B), THREADS, 0, st>>>(
      lg, mm, ll, ss, static_cast<float*>(cand_v), static_cast<int*>(cand_f), K, V, n, nchunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t bytes = size_t(nchunks) * n * 8 + size_t(n) * 4 + size_t(K) * n * 8;
  if (bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(merge_champions<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(bytes));
    if (e != cudaSuccess) return e;
  }
  merge_champions<T><<<B, THREADS, bytes, st>>>(
      lg, mm, ll, ss, static_cast<const float*>(cand_v), static_cast<const int*>(cand_f),
      static_cast<float*>(out_v), static_cast<int*>(out_f), K, V, n, nchunks);
  return cudaGetLastError();
}

}  // namespace

// Columns per pass-1 chunk: the wrappers size their [B, chunks, n] scratch by it.
extern "C" int mmvc_beam_topk_chunk_columns() { return CHUNK; }

// K4, and K5 from logits: f32 logits [B*K, V] with f32 row statistics m, ls [B*K].
extern "C" int mmvc_beam_topk_columns(const void* logits, const void* m, const void* ls,
                                      const void* s, void* cand_v, void* cand_f, void* out_v,
                                      void* out_f, int B, int K, int V, int n, void* stream) {
  if (m == nullptr || ls == nullptr) return cudaErrorInvalidValue;
  return launch<float>(logits, m, ls, s, cand_v, cand_f, out_v, out_f, B, K, V, n, stream);
}

// K5 beam_topk: log-probs [B, K, V], f32 (bf16 == 0) or bf16 (bf16 == 1); m = ls = 0.
extern "C" int mmvc_beam_topk(const void* logp, int bf16, const void* s, void* cand_v,
                              void* cand_f, void* out_v, void* out_f, int B, int K, int V, int n,
                              void* stream) {
  if (bf16)
    return launch<__nv_bfloat16>(logp, nullptr, nullptr, s, cand_v, cand_f, out_v, out_f, B, K,
                                 V, n, stream);
  return launch<float>(logp, nullptr, nullptr, s, cand_v, cand_f, out_v, out_f, B, K, V, n,
                       stream);
}
