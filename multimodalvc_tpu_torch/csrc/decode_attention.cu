// K2 · prompt_attention and K3 · gen_attention_ancestor: beam-decode
// attention partials over an int8 KV cache with per-vector f32 scales, or a
// bf16 KV cache with no scales.
//
// Replace the Pallas kernels of multimodalvc_tpu/ops/decode_attention.py:
//   K2 prompt_attention (pallas_call at :370, body _prompt_kernel :278): the
//      K beam queries of one batch element against its shared prompt KV
//      [g, Tp, d] under a [Tp] validity mask;
//   K3 gen_attention_ancestor (pallas_call at :195, body _kernel :38): the
//      generated segment [B*K, L, g, d]; slot l < valid_len of row (b, k)
//      reads its key/value from beam row anc[b*K+k, l] of the same batch
//      element, so the beam reorder never moves the cache.
// Both return unnormalised f32 out [B*K, h, d] with the row max m and row
// sum l [B*K, h] (m = -1e30, l = 0, out = 0 for a row with no valid key),
// which the caller merges (merge_softmax_segments).  Each kernel is a
// template on the KV element type, as the TPU kernels take either
// (``quantized``): int8 with f32 scales, or bf16 read as it is.
//
// Design for Hopper.  One block per (kv head, batch element) serves the
// K*rep query rows that share that kv head (GQA rep = h/g; beam 5 with 24
// query and 8 kv heads gives 15 rows), so each key/value row is read once
// per block, not once per query head.  Phase 1: one thread per key slot
// converts its key row to f32 in registers (16 bytes at a time: 16 int8 or
// 8 bf16 values) and dots it with the 15 query rows staged in shared
// memory.  Phase 2: a warp per query row takes the masked max, exp and sum.
// Phase 3: one thread per head-dim column accumulates P.V over the slots;
// the value reads are coalesced across the block.  Scores stay in shared
// memory.
//
// What bounds it on the H100: the KV bytes (per decode step and layer,
// ~2*B*g*(Tp + L)*d elements, 1 byte each in int8 and 2 in bf16) against
// 3.35 TB/s; the arithmetic is ~2 flops a byte.  At serving batch the grid
// is g*B = 384 blocks of 128 threads, a few per SM, and the per-slot thread
// mapping reads each key row with strided 16-byte loads; a split-KV layout
// fused with the merge is later work.
#include "common.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int THREADS = 128;
constexpr int MAXX = 16;   // beams * rep query rows per block
constexpr int MAXREP = 8;  // query heads per kv head

// Stage the K*rep query rows of kv head gi as f32: row x = beam*rep + r
// holds q[b*K + beam, gi*rep + r, :].
__device__ void load_queries(const bf16* __restrict__ q, float* qs, int b, int gi, int K,
                             int h, int rep, int d) {
  for (int i = threadIdx.x; i < K * rep * d; i += blockDim.x) {
    const int x = i / d, j = i % d;
    const int beam = x / rep, r = x % rep;
    qs[i] = __bfloat162float(q[(size_t(b * K + beam) * h + gi * rep + r) * d + j]);
  }
}

// The KV element types: 16 bytes hold 16 int8 or 8 bf16 values.
__device__ __forceinline__ float to_f32(int8_t v) { return float(v); }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// The f32 scale of one key/value row; a bf16 cache has none.
__device__ __forceinline__ float row_scale(const float* s, size_t i) { return s ? s[i] : 1.f; }

// acc[x] += q[x] . (krow * ksc) for x < nx, 16 bytes of krow at a time.
template <typename T>
__device__ __forceinline__ void dot_row(const float* qs, int nx, const T* krow, float ksc, int d,
                                        float* acc) {
  constexpr int V = 16 / sizeof(T);
  for (int d0 = 0; d0 < d; d0 += V) {
    const int4 raw = *reinterpret_cast<const int4*>(krow + d0);
    const T* kv = reinterpret_cast<const T*>(&raw);
    float kf[V];
#pragma unroll
    for (int j = 0; j < V; ++j) kf[j] = to_f32(kv[j]) * ksc;
#pragma unroll
    for (int x = 0; x < MAXX; ++x) {
      if (x < nx) {
        const float* qr = qs + x * d + d0;
        float a = acc[x];
#pragma unroll
        for (int j = 0; j < V; ++j) a += qr[j] * kf[j];
        acc[x] = a;
      }
    }
  }
}

// Row-wise masked softmax partials of S [X, T] in place; writes m and l.
__device__ void softmax_rows(float* S, int X, int T, const int* mask, int valid, int b,
                             int gi, int K, int h, int rep, float* m_out, float* l_out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int x = warp; x < X; x += blockDim.x >> 5) {
    float* srow = S + x * T;
    float mx = mmvc::kNeg;
    for (int t = lane; t < T; t += 32) mx = fmaxf(mx, srow[t]);
    mx = mmvc::warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < T; t += 32) {
      const bool ok = mask ? mask[t] != 0 : t < valid;
      const float e = ok ? expf(srow[t] - mx) : 0.f;
      srow[t] = e;
      sum += e;
    }
    sum = mmvc::warp_sum(sum);
    if (lane == 0) {
      const size_t o = size_t(b * K + x / rep) * h + gi * rep + x % rep;
      m_out[o] = mx;
      l_out[o] = sum;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
prompt_attention_kernel(const bf16* __restrict__ q, const T* __restrict__ pk,
                        const T* __restrict__ pv, const float* __restrict__ pks,
                        const float* __restrict__ pvs, const int* __restrict__ mask,
                        float* __restrict__ out, float* __restrict__ m_out,
                        float* __restrict__ l_out, int K, int h, int g, int Tp, int d,
                        float scale) {
  extern __shared__ float sm[];
  const int gi = blockIdx.x, b = blockIdx.y;
  const int rep = h / g, X = K * rep;
  float* qs = sm;          // [X, d]
  float* S = sm + X * d;   // [X, Tp]
  load_queries(q, qs, b, gi, K, h, rep, d);
  __syncthreads();

  const size_t kv0 = (size_t(b) * g + gi) * Tp;  // (b, gi, slot 0)
  const int* mrow = mask + size_t(b) * Tp;
  for (int p = threadIdx.x; p < Tp; p += blockDim.x) {
    float acc[MAXX];
#pragma unroll
    for (int x = 0; x < MAXX; ++x) acc[x] = 0.f;
    const bool ok = mrow[p] != 0;
    if (ok) dot_row(qs, X, pk + (kv0 + p) * d, row_scale(pks, kv0 + p), d, acc);
#pragma unroll
    for (int x = 0; x < MAXX; ++x)
      if (x < X) S[x * Tp + p] = ok ? acc[x] * scale : mmvc::kNeg;
  }
  __syncthreads();
  softmax_rows(S, X, Tp, mrow, 0, b, gi, K, h, rep, m_out, l_out);
  __syncthreads();

  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float acc[MAXX];
#pragma unroll
    for (int x = 0; x < MAXX; ++x) acc[x] = 0.f;
    for (int p = 0; p < Tp; ++p) {
      const float vv = to_f32(pv[(kv0 + p) * d + j]) * row_scale(pvs, kv0 + p);
#pragma unroll
      for (int x = 0; x < MAXX; ++x)
        if (x < X) acc[x] += S[x * Tp + p] * vv;
    }
#pragma unroll
    for (int x = 0; x < MAXX; ++x)
      if (x < X) out[(size_t(b * K + x / rep) * h + gi * rep + x % rep) * d + j] = acc[x];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gen_attention_kernel(const bf16* __restrict__ q, const T* __restrict__ gk,
                     const T* __restrict__ gv, const float* __restrict__ gks,
                     const float* __restrict__ gvs, const int* __restrict__ anc, int valid,
                     float* __restrict__ out, float* __restrict__ m_out,
                     float* __restrict__ l_out, int K, int h, int g, int L, int d,
                     float scale) {
  extern __shared__ float sm[];
  const int gi = blockIdx.x, b = blockIdx.y;
  const int rep = h / g, X = K * rep;
  float* qs = sm;                                  // [X, d]
  float* S = sm + X * d;                           // [X, L]
  int* src = reinterpret_cast<int*>(S + X * L);    // [K, L] source beam row
  load_queries(q, qs, b, gi, K, h, rep, d);
  for (int i = threadIdx.x; i < K * L; i += blockDim.x)
    src[i] = b * K + min(max(anc[size_t(b) * K * L + i], 0), K - 1);
  __syncthreads();

  // one thread per (beam, slot): the slot's key comes from its ancestor row
  for (int pr = threadIdx.x; pr < K * L; pr += blockDim.x) {
    const int beam = pr / L, l = pr % L;
    float acc[MAXX];
#pragma unroll
    for (int x = 0; x < MAXX; ++x) acc[x] = 0.f;
    const bool ok = l < valid;
    if (ok) {
      const size_t kvrow = (size_t(src[pr]) * L + l) * g + gi;
      dot_row(qs + beam * rep * d, rep, gk + kvrow * d, row_scale(gks, kvrow), d, acc);
    }
#pragma unroll
    for (int r = 0; r < MAXREP; ++r)
      if (r < rep) S[(beam * rep + r) * L + l] = ok ? acc[r] * scale : mmvc::kNeg;
  }
  __syncthreads();
  softmax_rows(S, X, L, nullptr, valid, b, gi, K, h, rep, m_out, l_out);
  __syncthreads();

  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    for (int beam = 0; beam < K; ++beam) {
      float acc[MAXREP];
#pragma unroll
      for (int r = 0; r < MAXREP; ++r) acc[r] = 0.f;
      for (int l = 0; l < valid; ++l) {
        const size_t kvrow = (size_t(src[beam * L + l]) * L + l) * g + gi;
        const float vv = to_f32(gv[kvrow * d + j]) * row_scale(gvs, kvrow);
#pragma unroll
        for (int r = 0; r < MAXREP; ++r)
          if (r < rep) acc[r] += S[(beam * rep + r) * L + l] * vv;
      }
#pragma unroll
      for (int r = 0; r < MAXREP; ++r)
        if (r < rep) out[(size_t(b * K + beam) * h + gi * rep + r) * d + j] = acc[r];
    }
  }
}

int check_dims(int B, int K, int h, int g, int T, int d) {
  if (B <= 0 || K <= 0 || g <= 0 || T <= 0 || h % g != 0 || d % 16 != 0 || d <= 0 ||
      K * (h / g) > MAXX || h / g > MAXREP || B > 65535 || g > 65535)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  return cudaSuccess;
}

template <typename T>
int launch_prompt(const void* q, const void* pk, const void* pv, const void* pks, const void* pvs,
                  const void* mask, void* out, void* m, void* l, int B, int K, int h, int g,
                  int Tp, int d, float scale, cudaStream_t stream) {
  const int X = K * (h / g);
  const size_t bytes = size_t(X) * (d + Tp) * sizeof(float);
  int e = set_smem(reinterpret_cast<const void*>(prompt_attention_kernel<T>), bytes);
  if (e) return e;
  prompt_attention_kernel<T><<<dim3(g, B), THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const T*>(pk), static_cast<const T*>(pv),
      static_cast<const float*>(pks), static_cast<const float*>(pvs),
      static_cast<const int*>(mask), static_cast<float*>(out), static_cast<float*>(m),
      static_cast<float*>(l), K, h, g, Tp, d, scale);
  return cudaGetLastError();
}

template <typename T>
int launch_gen(const void* q, const void* gk, const void* gv, const void* gks, const void* gvs,
               const void* anc, int valid, void* out, void* m, void* l, int B, int K, int h,
               int g, int L, int d, float scale, cudaStream_t stream) {
  const int X = K * (h / g);
  const size_t bytes = size_t(X) * (d + L) * sizeof(float) + size_t(K) * L * sizeof(int);
  int e = set_smem(reinterpret_cast<const void*>(gen_attention_kernel<T>), bytes);
  if (e) return e;
  gen_attention_kernel<T><<<dim3(g, B), THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const T*>(gk), static_cast<const T*>(gv),
      static_cast<const float*>(gks), static_cast<const float*>(gvs),
      static_cast<const int*>(anc), valid, static_cast<float*>(out), static_cast<float*>(m),
      static_cast<float*>(l), K, h, g, L, d, scale);
  return cudaGetLastError();
}

}  // namespace

// kv_bf16 = 0: int8 K/V with f32 scales pks/pvs [B, g, Tp];
// kv_bf16 = 1: bf16 K/V, pks/pvs null.
extern "C" int mmvc_prompt_attention(const void* q, const void* pk, const void* pv,
                                     const void* pks, const void* pvs, const void* mask,
                                     void* out, void* m, void* l, int B, int K, int h, int g,
                                     int Tp, int d, float scale, int kv_bf16, void* stream) {
  int e = check_dims(B, K, h, g, Tp, d);
  if (e) return e;
  if (!kv_bf16 && (!pks || !pvs)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return kv_bf16 ? launch_prompt<bf16>(q, pk, pv, nullptr, nullptr, mask, out, m, l, B, K, h, g,
                                       Tp, d, scale, st)
                 : launch_prompt<int8_t>(q, pk, pv, pks, pvs, mask, out, m, l, B, K, h, g, Tp,
                                         d, scale, st);
}

// kv_bf16 as above; scales gks/gvs [B*K, L, g] for int8.
extern "C" int mmvc_gen_attention_ancestor(const void* q, const void* gk, const void* gv,
                                           const void* gks, const void* gvs, const void* anc,
                                           int valid, void* out, void* m, void* l, int B,
                                           int K, int h, int g, int L, int d, float scale,
                                           int kv_bf16, void* stream) {
  int e = check_dims(B, K, h, g, L, d);
  if (e) return e;
  if (!kv_bf16 && (!gks || !gvs)) return cudaErrorInvalidValue;
  valid = min(max(valid, 0), L);
  auto st = static_cast<cudaStream_t>(stream);
  return kv_bf16 ? launch_gen<bf16>(q, gk, gv, nullptr, nullptr, anc, valid, out, m, l, B, K, h,
                                    g, L, d, scale, st)
                 : launch_gen<int8_t>(q, gk, gv, gks, gvs, anc, valid, out, m, l, B, K, h, g, L,
                                      d, scale, st);
}
