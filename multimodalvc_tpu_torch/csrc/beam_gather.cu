// K6 · gather_rows: out[i] = x[src[i]] along dim 0, trailing dims copied whole,
// for one leaf or for every leaf of a beam reorder in one launch.
//
// Replaces the Pallas kernel multimodalvc_tpu/ops/beam_gather.py:
// gather_rows (pallas_call at :57, body _copy_kernel :33), where the
// scalar-prefetched src drives each output block's input index so the DMA
// engine performs the gather.  Its caller is the physical beam reorder of
// the large generated-KV leaves (ops/beam_search.py: _gather_beams), which
// moves every leaf of a decode step (56 of LLaMA-3.2-3B's: k and v of 28
// layers) by the same beam indices.
//
// What bounds it on the H100: one read of every distinct source row and one
// write of every output row against 3.35 TB/s, with no arithmetic: a step's
// 56 leaves of [40, 16, 8, 128] bf16 move 73.4 MB each way under a
// permutation, ~44 us; of the full cache [40, 8, 146, 128], 670 MB each
// way, ~400 us.  One leaf of the first (1.3 MB) is below a microsecond of
// bandwidth, so a launch a leaf is set by the launch and one round trip,
// and the step by 56 of them.
//
// Design for Hopper: the copy goes through the bulk-copy (TMA) engine, as
// the TPU kernel's goes through its DMA engine.
// - One launch for all leaves.  The leaf table (source, output, row bytes,
//   source rows, and the first work item of each leaf) is a __grid_constant__
//   kernel parameter: no host-to-device copy, no state between launches.
//   All leaves share one src [m].
// - Work items are (leaf, output row, chunk of at most CHUNK bytes), in leaf
//   order, one a block: block i takes item i, so neighbouring blocks stream
//   neighbouring bytes, and the block scheduler keeps 13 of them an SM in
//   flight (16 KB of shared memory each).  A persistent grid of two blocks
//   an SM with a 4-slot ring ran 4% slower a step; chunks of 8 and 32 KB,
//   and a copy by all threads in 16-byte vectors, no faster (PERF.md).
// - One thread a block issues both copies: cp.async.bulk global -> shared,
//   completion on an mbarrier (expect_tx of the chunk's bytes), then
//   cp.async.bulk shared -> global as one bulk group, and the block ends
//   once that store has read its shared memory.  No thread touches the data.
// - An index outside [0, n) is clamped (the callers build src from beam
//   indices in range).  Rows are multiples of 16 bytes, 16-byte aligned.
#include "common.cuh"

namespace {

constexpr int MAX_LEAVES = 64;  // leaves a launch (a decode step has 56)
constexpr int CHUNK = 16384;    // bytes a work item, a multiple of 16
constexpr int THREADS = 32;     // one warp; its first thread issues the copies
constexpr int SMEM = CHUNK + 16;  // the chunk, then its mbarrier

struct Leaf {
  const unsigned char* x;  // [n, row_bytes]
  unsigned char* out;      // [m, row_bytes]
  long long row_bytes;
  int n;
  int chunks;  // a row's work items: row_bytes / CHUNK rounded up
};

// The kernel's parameter: 64 leaves are 2.6 KB, inside the 4 KB parameter
// space.
struct Table {
  Leaf leaf[MAX_LEAVES];
  long long first[MAX_LEAVES + 1];  // first work item of each leaf; first[count]: the total
  const int* src;                   // [m] int32, shared by every leaf
  int count, m;
};

// work item `item`: its leaf, output row, byte offset in the row, and bytes
__device__ __forceinline__ void locate(const Table& t, long long item, int& leaf, int& row,
                                       long long& off, int& bytes) {
  leaf = 0;
  while (item >= t.first[leaf + 1]) ++leaf;
  const Leaf& L = t.leaf[leaf];
  const long long local = item - t.first[leaf];
  row = int(local / L.chunks);
  off = (local - (long long)row * L.chunks) * CHUNK;
  bytes = int(min((long long)CHUNK, L.row_bytes - off));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// wait for the phase of `bar` with this parity to complete; a wait that
// outlasts ~2^34 clocks (seconds) is a fault, and traps rather than hangs
__device__ __forceinline__ void mbar_wait(unsigned bar, int parity) {
  const long long t0 = clock64();
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

__global__ void __launch_bounds__(THREADS) gather_rows_kernel(const __grid_constant__ Table t) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x != 0) return;  // one thread issues both copies
  int leaf, row, bytes;
  long long off;
  locate(t, blockIdx.x, leaf, row, off, bytes);
  const Leaf& L = t.leaf[leaf];
  const int s = min(max(t.src[row], 0), L.n - 1);
  const unsigned buf = smem_addr(smem), bar = buf + CHUNK;
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  // global -> shared, completing on the mbarrier, which expects the bytes
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(buf), "l"(L.x + s * L.row_bytes + off), "r"(bytes), "r"(bar)
      : "memory");
  mbar_wait(bar, 0);
  // shared -> global as one bulk group; the block's shared memory may go once
  // the store has read it (the writes complete on their own, before any
  // later kernel on the stream)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(L.out + row * L.row_bytes + off), "r"(buf), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

int gather(int count, const void* const* xs, void* const* outs, const long long* row_bytes,
           const int* ns, const void* src, int m, cudaStream_t stream) {
  if (count <= 0 || count > MAX_LEAVES || m <= 0 || !src) return cudaErrorInvalidValue;
  Table t = {};
  t.count = count;
  t.m = m;
  t.src = static_cast<const int*>(src);
  for (int l = 0; l < count; ++l) {
    Leaf& L = t.leaf[l];
    L = Leaf{static_cast<const unsigned char*>(xs[l]), static_cast<unsigned char*>(outs[l]),
             row_bytes[l], ns[l], int((row_bytes[l] + CHUNK - 1) / CHUNK)};
    if (!L.x || !L.out || L.n <= 0 || L.row_bytes <= 0 || L.row_bytes % 16 ||
        reinterpret_cast<uintptr_t>(L.x) % 16 || reinterpret_cast<uintptr_t>(L.out) % 16)
      return cudaErrorInvalidValue;
    t.first[l + 1] = t.first[l] + (long long)m * L.chunks;
  }
  if (t.first[count] > INT_MAX) return cudaErrorInvalidValue;  // one block an item
  gather_rows_kernel<<<unsigned(t.first[count]), THREADS, SMEM, stream>>>(t);
  return cudaGetLastError();
}

}  // namespace

// Every leaf l: out_l [m, row_bytes_l] = x_l [n_l, row_bytes_l] at rows src
// (int32 [m], clamped to each leaf's rows), in one launch; 1..64 leaves,
// pointers and rows 16-byte aligned.
extern "C" int mmvc_gather_rows_many(int count, const void* const* xs, void* const* outs,
                                     const long long* row_bytes, const int* ns, const void* src,
                                     int m, void* stream) {
  return gather(count, xs, outs, row_bytes, ns, src, m, static_cast<cudaStream_t>(stream));
}

