// K6 · gather_rows: out[i] = x[src[i]] along dim 0, trailing dims copied whole.
//
// Replaces the Pallas kernel multimodalvc_tpu/ops/beam_gather.py:
// gather_rows (pallas_call at :57, body _copy_kernel :33), where the
// scalar-prefetched src drives each output block's input index so the DMA
// engine performs the gather.  Its caller is the physical beam reorder of
// the large generated-KV leaves (ops/beam_search.py: _gather_beams).
//
// Design for Hopper.  Block (i, j) copies chunk j of output row i from
// source row src[i]: each thread moves UNROLL 16-byte vectors, all loads
// issued before the stores, neighbouring threads on neighbouring addresses.
// The source index is read once per block; an index outside [0, n) is
// clamped (the wrapper's callers build it from beam indices in range).
//
// What bounds it on the H100: one read and one write of every output byte
// against 3.35 TB/s, with no arithmetic: [240, 64, 8, 128] bf16 is 31.5 MB
// each way, ~19 us at the memory roofline.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr long long CHUNK = THREADS * UNROLL;  // 16-byte vectors per block

__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const uint4* __restrict__ x, const int* __restrict__ src,
                   uint4* __restrict__ out, int n, long long row_vec) {
  const int i = blockIdx.x;
  const int s = min(max(src[i], 0), n - 1);
  const uint4* from = x + size_t(s) * row_vec;
  uint4* to = out + size_t(i) * row_vec;
  const long long base = blockIdx.y * CHUNK + threadIdx.x;
  uint4 v[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long e = base + u * THREADS;
    if (e < row_vec) v[u] = from[e];
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long e = base + u * THREADS;
    if (e < row_vec) to[e] = v[u];
  }
}

}  // namespace

// x [n, row_bytes] and out [m, row_bytes] 16-byte aligned; src int32 [m].
extern "C" int mmvc_gather_rows(const void* x, const void* src, void* out, int n, int m,
                                long long row_bytes, void* stream) {
  if (n <= 0 || m <= 0 || row_bytes <= 0 || row_bytes % 16) return cudaErrorInvalidValue;
  const long long row_vec = row_bytes / 16;
  const long long chunks = (row_vec + CHUNK - 1) / CHUNK;
  if (chunks > 65535) return cudaErrorInvalidValue;
  gather_rows_kernel<<<dim3(m, unsigned(chunks)), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const int*>(src), static_cast<uint4*>(out), n,
      row_vec);
  return cudaGetLastError();
}
