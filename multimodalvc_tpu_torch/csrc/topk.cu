// K4 · beam_topk_columns and K5 · beam_topk / beam_topk_from_logits: the beam
// search's top-2K candidates, exact in values and indices, in one launch.
//
// Replaces two Pallas kernels of multimodalvc_tpu/ops/topk.py, each together
// with the gather + (value desc, flat asc) merge its caller runs:
//   K4 beam_topk_columns (pallas_call at :271, body _column_champion_kernel
//      :189): raw f32 unembed logits with row max m and logsumexp ls, V % 8 == 0;
//   K5 _run_and_merge (pallas_call at :125, body _block_topk_kernel :58),
//      entries beam_topk (:303: f32 or bf16 log-probs, m = ls = 0) and
//      beam_topk_from_logits (:157: as K4, any V);
// and, where the caller gives no m and ls, the row statistics the JAX step
// computes outside its kernel (multimodalvc_tpu/ops/beam_search.py:234-241).
// The V -> 8 sublane fold of K4 and the column blocks of K5 are TPU tiling;
// both compute one function, which one kernel template computes here for any
// V.  Per batch element:
//   x[r, c] = max(((logit[r, c] - m[r]) - ls[r]) + s[r], -2.9e38)   (f32)
// in exactly that order (XLA's and PyTorch's log_softmax order), with m = ls
// = 0 for log-probs, so that ((x - 0) - 0) + s is bit-identical to logp + s;
// the first n of a stable descending sort of x over the flat K*V candidates,
// flat = r*V + c.  Without given statistics, m[r] is the exact row max and
// ls[r] = log(sum(exp(x - m))) in f32 with accurate expf/logf (no fast math).
//
// What bounds it on the H100: one read of the [B*K, V] input against 3.35
// TB/s: 20.5 MB, ~6.1 us, at the decode's [40, 128256] f32; 123 MB, ~37 us,
// at [240, 128256].  What holds it at batch 8: phase A on 64 SMs (~11 us:
// an accurate expf an element, and the stream), then the combines, the
// cluster barriers and the merge (~8 us).
//
// The design (ops/topk.py: topk_plan chooses the cluster size, the columns a
// block, the depth of its copy ring and whether the chunks that leave the
// ring keep their unit maxima, from the shapes alone; the C entries only
// check that the plan covers V and that its shared memory fits).  The grid
// is (C, B): the C blocks of one batch element are one thread block cluster,
// each owning a contiguous range of columns of the element's K rows.  512
// threads a block, one block an SM.  At batch 8, clusters of 8 (the card
// runs 15 of them at once, but 7 of 16).
// - The stream.  A thread owns 16-byte units (4 f32 or 8 bf16 columns) of
//   the block's range, unit tid + 512 j for j = 0, 1, ...: "chunk j".  It
//   copies a chunk, all K rows, into its own slots of a shared-memory ring
//   with cp.async, `stages` chunks ahead (160 KB in flight an SM at batch 8),
//   and reads back only what it copied itself: the ring needs no barrier.
//   A chunk that leaves the ring keeps, per row, the max of its unit (the
//   "unit maxima"), where the plan says so.
// - Phase A, one pass over the stream: each row's max and (statistics not
//   given) its online sum of exp(x - max), rescaled without a branch.  Warp,
//   then block (one warp a row), then cluster: each block pushes its per-row
//   (max, sum) to every block through distributed shared memory, one cluster
//   barrier, and every block combines the C parts in block order, so every
//   block holds the same bits of m and ls.
// - The filter.  The C*K block row maxima are distinct candidates, so the
//   n-th largest of their values, theta, bounds the n-th best from below: no
//   value under theta is among the n.  A row's raw values map under theta
//   below a per-row threshold (with a margin for the roundings).
// - Phase B, the selection.  The chunks still in the ring are tested from
//   their data, the others from their unit maxima (else streamed in again);
//   only a chunk with a value at its row's threshold computes its columns'
//   champions: the best row by strict > (the lowest row keeps a tie), in the
//   contract's op order.  A candidate is one 64-bit key, (order-preserving
//   bits of the value) << 32 | ~flat, so that the larger key ranks first
//   under (value desc, flat asc) and an arg-best is a max.  A thread keeps
//   its best 4 keys at or above theta and the best it dropped; a warp merges
//   its lanes' lists in rounds of two redux.sync.  If a lane dropped a key
//   that would have made the warp's n (5 of them among one thread's columns),
//   the warp recomputes its n exactly.  The block ranks the warps' keys above
//   the highest warp n-th (a key's rank: the number of larger keys).
// - Phase C, the merge, in the same launch.  The block sends the K keys of
//   each of its n columns (from L2) and its n-th key into the cluster
//   leader's shared memory; one cluster barrier.  The leader ranks the keys
//   above every block's n-th and theta: the true top n, since a column
//   holding one of them has a champion among the top n
//   (multimodalvc_tpu/ops/topk.py:220-225).
// No global workspace, no counters, no second launch: the grid and the work
// depend on the shapes alone (the work on the values only through the
// filter).
// - More than 16 beams, or n > 32: the wide instance (MAXR = 0) takes any K
//   and n <= 256.  A ring chunk of K rows would pass shared memory from
//   about 20 rows, so it streams from global memory: phase A in groups of 16
//   rows (each value read once, 16 rows' statistics in registers), phase B
//   over every row.  A lane keeps up to 8 list entries (n / 32).  Phase C
//   ranks the K keys of each of the block's n columns in the block itself,
//   and sends the leader only the block's n best at or above theta (the
//   n x K keys of every block would not fit the leader's shared memory).
//   ops/topk.py gives it the shapes whose block fits a cluster
//   (topk_max_beams(): 104 beams at n = 2K).
// - Past that, any K and n: the select form at the end of this file, a
//   radix select over the candidates' order bits in a few launches.
#include <cooperative_groups.h>

#include "common.cuh"

using bf16 = __nv_bfloat16;
using u64 = unsigned long long;
namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 16;  // blocks a cluster; above 8 the non-portable size
constexpr int MAX_ROWS = 16;     // K of the narrow instances
constexpr int MAX_N = 32;        // n of the narrow instances: one list entry a lane
constexpr int WIDE_MAX_N = 256;  // n of the wide instance: up to 8 list entries a lane
constexpr int GROUP = 16;        // rows a phase-A pass of the wide instance
constexpr int MAX_STAGES = 8;    // ring depth (cp_async_wait takes up to 7 pending)
constexpr int KT = 4;            // champion keys a thread keeps
constexpr int TILE_KEYS = 16;    // keys a lane holds in the exact recompute
constexpr int UNIT = 16;         // bytes a unit
constexpr int SMEM_MAX = 232448;
constexpr float kClamp = -2.9e38f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* x;    // [B*K, V] logits (f32) or log-probs (f32, bf16)
  const float* m;   // [B*K] given row max, or null: computed (STATS) or 0 (log-probs)
  const float* ls;  // [B*K] given row logsumexp, or null, as m
  const float* s;   // [B*K] beam scores
  float* m_out;     // [B*K] or null: the statistics a STATS launch used
  float* ls_out;
  float* out_v;     // [B, n]
  int* out_f;
  int K, V, n, cols, stages;  // cols: the columns a block owns, a multiple of 8
  int sum_chunks;  // chunks that leave the ring and keep their unit maxima, or 0
};

// chip_smoke.py --phases builds this source with MMVC_TOPK_MARKS defined:
// thread 0 of each block reads %globaltimer at the phase boundaries MARK(0)
// .. MARK(7) into g_marks, which mmvc_topk_marks copies out.
#ifdef MMVC_TOPK_MARKS
constexpr int N_MARKS = 8;
__device__ unsigned long long g_marks[2048 * N_MARKS];
#define MARK(i)                                                         \
  if (threadIdx.x == 0) {                                               \
    unsigned long long t;                                               \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));               \
    g_marks[(blockIdx.y * gridDim.x + blockIdx.x) * N_MARKS + (i)] = t; \
  }
#else
#define MARK(i)
#endif

__host__ __device__ constexpr int align16(int b) { return (b + 15) / 16 * 16; }

// the shapes the wide instance (MAXR = 0) takes, and only it
__host__ __device__ constexpr bool wide_shape(int K, int n) { return K > MAX_ROWS || n > MAX_N; }

// entries of the per-row arrays: at least 16, a multiple of 4 (16-byte offsets after them)
__host__ __device__ constexpr int rows_of(int K) {
  return K > MAX_ROWS ? (K + 3) / 4 * 4 : MAX_ROWS;
}

// Shared memory of one block (byte offsets), mirrored by ops/topk.py:
// topk_smem_bytes: per row m, ls, s and the filter's threshold [R] each
// (R = rows_of(K)), the bound theta [R] (one used), the values of the
// blocks' row maxima [MAX_CLUSTER * R], the block's row statistics (max,
// sum) [R], the warps' [WARPS][K] and the cluster's blocks' [C][K]; the
// warps' lists [WARPS][n] and n-th keys [WARPS]; a merge's candidates
// [max(WARPS * n, C * n * G)] (wide: and the block's n * K); the blocks' n-th
// keys [C] and a merge's output [n], a counter; what the blocks send the
// leader, the K keys of each of their n columns (wide: their n best)
// [C][n][G]; the ring [stages][K][THREADS] units and the unit maxima
// [sum_chunks][K][THREADS] (wide: neither).
struct Smem {
  int bvals_off, bpart_off, wpart_off, part_off, wlist_off, wth_off, cand_off, bth_off,
      top_off, counter_off, gather_off, ring_off, sum_off, bytes;
  __host__ __device__ Smem(int K, int n, int C, int stages, int sum_chunks) {
    const bool wide = wide_shape(K, n);
    const int R = rows_of(K), G = wide ? 1 : K;
    int merge = WARPS * n > C * n * G ? WARPS * n : C * n * G;
    if (wide && n * K > merge) merge = n * K;
    if (wide) stages = sum_chunks = 0;
    bvals_off = 5 * R * 4;
    bpart_off = bvals_off + MAX_CLUSTER * R * 4;
    wpart_off = bpart_off + R * 8;
    part_off = wpart_off + align16(WARPS * K * 8);
    wlist_off = part_off + align16(C * K * 8);
    wth_off = wlist_off + align16(WARPS * n * 8);
    cand_off = wth_off + align16(WARPS * 8);
    bth_off = cand_off + align16(merge * 8);
    top_off = bth_off + align16(C * 8);
    counter_off = top_off + align16(n * 8);
    gather_off = counter_off + 16;
    ring_off = gather_off + align16(C * n * G * 8);
    sum_off = ring_off + stages * K * THREADS * UNIT;
    bytes = sum_off + sum_chunks * K * THREADS * 4;
  }
};

__device__ __forceinline__ float candidate(float x, float m, float ls, float s) {
  return fmaxf(((x - m) - ls) + s, kClamp);
}

// order-preserving bits of a float (-0 as +0), and back
__device__ __forceinline__ unsigned float_ord(float v) {
  unsigned b = __float_as_uint(v);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float ord_float(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

// The candidate's key: the larger key ranks first under (value desc, flat
// asc); 0 is no candidate.
__device__ __forceinline__ u64 make_key(float v, int flat) {
  return (u64(float_ord(v)) << 32) | (0xFFFFFFFFu - unsigned(flat));
}
__device__ __forceinline__ float key_value(u64 k) { return ord_float(unsigned(k >> 32)); }
__device__ __forceinline__ int key_flat(u64 k) { return int(0xFFFFFFFFu - unsigned(k)); }
__device__ __forceinline__ u64 kmax(u64 a, u64 b) { return a > b ? a : b; }

// the warp's largest key, on every lane: two redux.sync
__device__ __forceinline__ u64 warp_max_key(u64 k) {
  const unsigned hi = unsigned(k >> 32);
  const unsigned top = __reduce_max_sync(FULL, hi);
  const unsigned lo = __reduce_max_sync(FULL, hi == top ? unsigned(k) : 0u);
  return (u64(top) << 32) | lo;
}

// f(i) for i = first, first + step, ... below end.  The narrow instances'
// shapes give at most one (first < end), which they take without a loop.
template <bool LOOP, typename F>
__device__ __forceinline__ void strided(int first, int end, int step, F&& f) {
  if constexpr (LOOP) {
    for (int i = first; i < end; i += step) f(i);
  } else if (first < end) {
    f(first);
  }
}

// A warp's list of n keys, largest first: entry j in lane j % 32, slot j / 32.
template <int NL>
__device__ __forceinline__ void list_set(u64 (&list)[NL], int j, u64 k) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < NL; ++e)
    if (lane + 32 * e == j) list[e] = k;
}

// entry j of the list, on every lane
template <int NL>
__device__ __forceinline__ u64 list_at(const u64 (&list)[NL], int j) {
  u64 v = list[0];
#pragma unroll
  for (int e = 1; e < NL; ++e)
    if (j / 32 == e) v = list[e];
  return __shfl_sync(FULL, v, j % 32);
}

// The n largest of the warp's keys (L a lane, consumed) into `out`, largest
// first (0 where fewer than n keys are nonzero).  n rounds, each a warp max
// and a knockout on the lane that held the winner.
template <int L, int NL>
__device__ __forceinline__ void warp_top_n(u64 (&keys)[L], int n, u64 (&out)[NL]) {
  u64 best = 0;
#pragma unroll
  for (int e = 0; e < NL; ++e) out[e] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) best = kmax(best, keys[i]);
  for (int j = 0; j < n; ++j) {
    const u64 win = warp_max_key(best);
    if (win == 0) break;  // warp-uniform
    list_set(out, j, win);
    if (best == win) {  // keys are distinct: one lane
      best = 0;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        if (keys[i] == win) keys[i] = 0;
        best = kmax(best, keys[i]);
      }
    }
  }
}

// out[rank] = key for the keys of src[0, count) (distinct) whose rank, the
// number of larger keys, is below n; every thread of the block takes some.
__device__ __forceinline__ void rank_into(const u64* src, int count, int n, u64* out) {
  for (int i = threadIdx.x; i < count; i += THREADS) {
    const u64 k = src[i];
    int above = 0;
#pragma unroll 8
    for (int j = 0; j < count; ++j) above += src[j] > k;
    if (above < n) out[above] = k;
  }
}

// keep the thread's KT best keys (largest first) and the best it dropped
__device__ __forceinline__ void offer(u64 (&top)[KT], u64& dropped, u64 k) {
  if (k > top[KT - 1]) {
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      const u64 a = top[i];
      top[i] = a > k ? a : k;
      k = a > k ? k : a;
    }
  }
  dropped = kmax(dropped, k);
}

// sum of exp(v[c] - shift), pairwise
template <int W>
__device__ __forceinline__ float exp_sum(const float (&v)[W], float shift) {
  float e[W];
#pragma unroll
  for (int c = 0; c < W; ++c) e[c] = expf(v[c] - shift);
#pragma unroll
  for (int w = W / 2; w > 0; w /= 2)
#pragma unroll
    for (int c = 0; c < w; ++c) e[c] += e[c + w];
  return e[0];
}

// A row's (max, sum of exp(x - max)) over the parts the warp's lanes hold,
// on every lane: the max exact, the sum added in a fixed order (the same bits
// for the same parts in the same lanes).  A part with m = -inf adds nothing.
__device__ __forceinline__ float2 warp_stats(float m, float s) {
  const float M = ord_float(__reduce_max_sync(FULL, float_ord(m)));
  return make_float2(M, mmvc::warp_sum(m == -INFINITY ? 0.0f : s * expf(m - M)));
}

// W consecutive values as f32 from 16 bytes (shared memory, or aligned global)
__device__ __forceinline__ void load_unit(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}
__device__ __forceinline__ void load_unit(const bf16* p, float (&v)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most `pending` of this thread's commit groups are in flight
// (more than 7: 7, which waits for more)
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// the cluster's split barrier: arrive (releasing this thread's writes), wait
// (acquiring the others')
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// T: the input type; STATS: compute m and ls (f32 logits only); COPY: how a
// unit reaches the ring: 16 (one 16-byte copy: rows 16-byte aligned), 4 (four
// 4-byte copies, f32), 0 (no ring: loads from global memory, bf16 rows that
// are not 4-byte aligned); MAXR: rows a batch element, at most (16), or
// exactly (5: beam 5, every row loop unrolled without a test), or 0: the
// wide instance, any K and n <= 256, no ring (16-byte or 4-byte loads from
// global memory by COPY).
template <typename T, bool STATS, int COPY, int MAXR>
__device__ __forceinline__ void beam_topk(const Args& p) {
  constexpr int W = UNIT / int(sizeof(T));  // columns a unit
  constexpr bool EXACT = MAXR == 5, WIDE = MAXR == 0, RING = COPY != 0 && !WIDE;
  constexpr int AR = WIDE ? GROUP : MAXR;       // rows a phase-A pass
  constexpr int NL = WIDE ? WIDE_MAX_N / 32 : 1;  // list entries a lane
  static_assert(!STATS || (COPY && sizeof(T) == 4), "statistics from f32 logits, by the ring");
  static_assert(COPY != 4 || sizeof(T) == 4, "4-byte copies of f32 only");
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x, rank = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = EXACT ? MAXR : p.K, V = p.V, n = p.n, R = WIDE ? rows_of(K) : MAX_ROWS;
  const Smem L(K, n, C, RING ? p.stages : 0, p.sum_chunks);
  float* st_m = reinterpret_cast<float*>(smem);
  float* st_ls = st_m + R;
  float* st_s = st_ls + R;
  float* st_t = st_s + R;  // the filter: a row's values below it are not among the n
  float* st_theta = st_t + R;  // [0]: no value below it is among the n
  float* bvals = reinterpret_cast<float*>(smem + L.bvals_off);
  float2* bpart = reinterpret_cast<float2*>(smem + L.bpart_off);
  float2* wpart = reinterpret_cast<float2*>(smem + L.wpart_off);
  float2* part = reinterpret_cast<float2*>(smem + L.part_off);
  u64* wlist = reinterpret_cast<u64*>(smem + L.wlist_off);
  u64* wth = reinterpret_cast<u64*>(smem + L.wth_off);
  u64* cand = reinterpret_cast<u64*>(smem + L.cand_off);
  u64* bth = reinterpret_cast<u64*>(smem + L.bth_off);
  u64* topbuf = reinterpret_cast<u64*>(smem + L.top_off);
  int* counter = reinterpret_cast<int*>(smem + L.counter_off);
  u64* gather = reinterpret_cast<u64*>(smem + L.gather_off);
  unsigned char* ring = smem + L.ring_off;
  float* summ = reinterpret_cast<float*>(smem + L.sum_off);
  const int c0 = rank * p.cols, ncols = min(p.cols, V - c0);
  const int units = (ncols + W - 1) / W, J = (units + THREADS - 1) / THREADS;
  const int S = RING ? min(p.stages, J) : 1;  // ring slots in use
  // the chunks that leave the ring keep their unit maxima, or are streamed again
  const bool summarized = RING && p.sum_chunks >= J - S;
  const T* x = static_cast<const T*>(p.x) + size_t(b) * K * V + c0;  // row r at x + r*V

  cluster_arrive_relaxed();  // every block has started before any writes to another's memory
  MARK(0);

  // chunk j of this thread: unit j*THREADS + tid, `valid` of its W columns
  auto valid_of = [&](int j) {
    const int u = j * THREADS + tid;
    return j < J && u < units ? min(W, ncols - u * W) : 0;
  };
  // one commit group: chunk j, all K rows, into ring slot `slot`
  auto issue = [&](int j, int slot) {
    if constexpr (RING) {
      const int valid = valid_of(j), u = j * THREADS + tid;
      for (int r = 0; valid > 0 && r < K; ++r) {
        unsigned char* dst = ring + ((slot * K + r) * THREADS + tid) * UNIT;
        const T* src = x + size_t(r) * V + u * W;
        if constexpr (COPY == 16) {
          cp_async<16>(dst, src);
        } else {
          for (int c = 0; c < valid; ++c) cp_async<4>(dst + 4 * c, src + c);
        }
      }
      cp_async_commit();
    }
  };
  // row r of chunk j: from its ring slot, or (slot < 0) from global memory;
  // columns past `valid` are -inf
  auto load = [&](int j, int slot, int r, int valid, float (&v)[W]) {
    if (RING && slot >= 0) {
      load_unit(reinterpret_cast<const T*>(ring + ((slot * K + r) * THREADS + tid) * UNIT), v);
    } else {
      const T* src = x + size_t(r) * V + (j * THREADS + tid) * W;
      if constexpr (COPY == 16) {
        load_unit(src, v);
      } else {
#pragma unroll
        for (int c = 0; c < W; ++c) v[c] = c < valid ? to_f32(src[c]) : 0.0f;
      }
    }
    if (valid < W) {
#pragma unroll
      for (int c = 0; c < W; ++c) v[c] = c < valid ? v[c] : -INFINITY;
    }
  };
  // the champion keys of chunk j's columns at or above theta, to `take(column, key)`
  auto champions = [&](int j, int slot, int valid, auto&& take) {
    float bv[W];
    int br[W];
    for (int r = 0; r < K; ++r) {
      const float mr = st_m[r], lr = st_ls[r], sr = st_s[r];
      float v[W];
      load(j, slot, r, valid, v);
#pragma unroll
      for (int c = 0; c < W; ++c) {
        const float cv = candidate(v[c], mr, lr, sr);
        if (r == 0 || cv > bv[c]) {  // strict: the lowest row keeps a tie
          bv[c] = cv;
          br[c] = r;
        }
      }
    }
    const int col = c0 + (j * THREADS + tid) * W;
    const float theta = st_theta[0];
#pragma unroll
    for (int c = 0; c < W; ++c)
      if (c < valid && bv[c] >= theta) take(c, make_key(bv[c], br[c] * V + col + c));
  };

  // ---- phase A: each row's max and (STATS) sum of exp(x - max) ----------------
  // (the wide instance: AR rows a pass over the stream, every row once)
  strided<WIDE>(0, K, AR, [&](int r0) {
    float m[AR], s[AR];
#pragma unroll
    for (int i = 0; i < AR; ++i) m[i] = -INFINITY, s[i] = 0.0f;
    for (int q = 0; q < S; ++q) issue(q, q);
    for (int j = 0, slot = 0; j < J; ++j) {
      if (RING) cp_async_wait(S - 1);  // chunk j has landed
      const int valid = valid_of(j);
      if (valid > 0) {
#pragma unroll
        for (int i = 0; i < AR; ++i) {
          const int r = r0 + i;
          if (EXACT || r < K) {
            float v[W];
            load(j, slot, r, valid, v);
            float top = v[0];
#pragma unroll
            for (int c = 1; c < W; ++c) top = fmaxf(top, v[c]);
            if (summarized && j < J - S) summ[(j * K + r) * THREADS + tid] = top;
            const float mx = fmaxf(m[i], top);
            if constexpr (STATS) {
              // rescale to the new max (by exp(0) = 1 where it did not move):
              // no branch
              s[i] = m[i] == -INFINITY ? 0.0f : s[i] * expf(m[i] - mx);
              s[i] += exp_sum(v, mx == -INFINITY ? 0.0f : mx);
            }
            m[i] = mx;
          }
        }
      }
      if (j + S < J)
        issue(j + S, slot);  // into the slot just read
      else if (RING)
        cp_async_commit();
      slot = slot + 1 == S ? 0 : slot + 1;
    }
    MARK(1);
    // the warp's statistics a row
#pragma unroll
    for (int i = 0; i < AR; ++i) {
      const int r = r0 + i;
      if (EXACT || r < K) {
        const float2 w = warp_stats(m[i], s[i]);
        if (lane == 0) wpart[warp * K + r] = w;
      }
    }
  });
  __syncthreads();
  strided<WIDE>(warp, K, WARPS, [&](int r) {  // the block's, over its warps (lane w: warp w's)
    const float2 w = lane < WARPS ? wpart[lane * K + r] : make_float2(-INFINITY, 0.0f);
    const float2 t = warp_stats(w.x, w.y);
    if (lane == 0) bpart[r] = t;
  });
  __syncthreads();
  cluster_wait();
  if (warp == 0)
    for (int i = lane; i < C * K; i += 32)
      cluster.map_shared_rank(part, i / K)[rank * K + i % K] = bpart[i % K];
  cluster_arrive();
  cluster_wait();  // every block's statistics have arrived
  MARK(2);
  // the cluster's, over its blocks in block order: every block the same bits
  strided<WIDE>(warp, K, WARPS, [&](int r) {
    const float2 c = lane < C ? part[lane * K + r] : make_float2(-INFINITY, 0.0f);
    const float2 w = warp_stats(c.x, c.y);
    if (lane == 0) {
      const float m = STATS ? w.x : (p.m ? p.m[b * K + r] : 0.0f);
      const float ls = STATS ? logf(w.y) : (p.ls ? p.ls[b * K + r] : 0.0f);
      st_m[r] = m;
      st_ls[r] = ls;
      st_s[r] = p.s[b * K + r];
      if (STATS && rank == 0 && p.m_out) {
        p.m_out[b * K + r] = m;
        p.ls_out[b * K + r] = ls;
      }
    }
  });
  __syncthreads();
  if (warp == 0) {
    // Each block's row maxima are C*K distinct candidates, so no value below
    // the n-th largest of theirs, theta, is among the n.  A row value x maps
    // below theta where x < theta - s + ls + m by more than the three
    // roundings of ((x - m) - ls) + s and those of the bound itself: a
    // margin of 2^-18 of the magnitudes.
    const int nb = C * K;
    for (int i = lane; i < nb; i += 32) {
      const int r = i % K;
      bvals[i] = part[i].x == -INFINITY ? -INFINITY
                                        : candidate(part[i].x, st_m[r], st_ls[r], st_s[r]);
    }
    __syncwarp();
    float least = INFINITY;  // the least value with fewer than n larger ones
    for (int i = lane; i < nb; i += 32) {
      const float v = bvals[i];
      int above = 0;
#pragma unroll 8
      for (int k = 0; k < nb; ++k) above += bvals[k] > v;
      if (above < n) least = fminf(least, v);
    }
    const float theta = ord_float(__reduce_min_sync(FULL, float_ord(least)));
    const bool on = nb >= n && theta > kClamp && theta < INFINITY;
    strided<WIDE>(lane, K, 32, [&](int r) {
      const float m = st_m[r], ls = st_ls[r], sr = st_s[r];
      const float margin = 0x1p-18f * (fabsf(theta) + fabsf(m) + fabsf(ls) + fabsf(sr));
      st_t[r] = on ? ((theta - sr) + ls) + m - margin : -INFINITY;
    });
    if (lane == 0) st_theta[0] = on ? theta : -INFINITY;
  }
  __syncthreads();
  MARK(3);

  // ---- phase B: the block's top n champion columns ----------------------------
  // The chunks still in the ring first, then the others: from their unit
  // maxima (summarized) or streamed in again.  Sequence q: chunk (q < P ?
  // J - P + q : q - P), its ring slot (J - P + q) % S; a chunk whose values
  // all fall below their row's filter holds none of the n.
  const int P = RING ? S : 0;
  u64 top[KT] = {};
  u64 dropped = 0;
  auto keep = [&](int, u64 k) { offer(top, dropped, k); };
  for (int q = 0, slot = (J - P) % S; q < J; ++q) {
    const bool staged = q < P;
    const int j = staged ? J - P + q : q - P, valid = valid_of(j);
    if (RING && !staged && !summarized) cp_async_wait(S - 1);
    if (valid > 0) {
      bool pass = false;
      if (!staged && summarized) {
        for (int r = 0; r < K; ++r) pass |= summ[(j * K + r) * THREADS + tid] >= st_t[r];
        if (pass) champions(j, -1, valid, keep);
      } else {
        for (int r = 0; r < K; ++r) {
          float v[W];
          load(j, slot, r, valid, v);
          const float t = st_t[r];
#pragma unroll
          for (int c = 0; c < W; ++c) pass |= v[c] >= t;
        }
        if (pass) champions(j, slot, valid, keep);
      }
    }
    if (!summarized) {
      if (q + S < J)
        issue(q + S - P, slot);  // sequence q + S >= P
      else if (RING)
        cp_async_commit();
    }
    slot = slot + 1 == S ? 0 : slot + 1;
  }
  MARK(4);
  // the warp's n best of its lanes' lists
  u64 list[NL] = {};
  for (int j = 0; j < n; ++j) {
    const u64 win = warp_max_key(top[0]);
    if (win == 0) break;  // warp-uniform
    list_set(list, j, win);
    if (top[0] == win) {
#pragma unroll
      for (int i = 0; i + 1 < KT; ++i) top[i] = top[i + 1];
      top[KT - 1] = 0;
    }
  }
  u64 nth = list_at(list, n - 1);
  if (__any_sync(FULL, dropped > nth)) {
    // A lane dropped a key that belongs among the warp's n: recompute them
    // exactly over the chunks that pass the filter, in tiles of TILE_KEYS
    // keys a lane, the staged chunks from the ring, the others from global
    // memory.
    constexpr int CPT = TILE_KEYS / W;  // chunks a tile
#pragma unroll
    for (int e = 0; e < NL; ++e) list[e] = 0;
    for (int q0 = 0; q0 < J; q0 += CPT) {
      u64 keys[TILE_KEYS + NL];
#pragma unroll
      for (int i = 0; i < TILE_KEYS; ++i) keys[i] = 0;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int q = q0 + i, staged = q < P && summarized;
        const int j = q < P ? J - P + q : q - P, valid = q < J ? valid_of(j) : 0;
        if (valid == 0) continue;
        bool pass = false;
        if (summarized && !staged) {
          for (int r = 0; r < K; ++r) pass |= summ[(j * K + r) * THREADS + tid] >= st_t[r];
        } else {
          for (int r = 0; r < K; ++r) {
            float v[W];
            load(j, staged ? (J - P + q) % S : -1, r, valid, v);
            const float t = st_t[r];
#pragma unroll
            for (int c = 0; c < W; ++c) pass |= v[c] >= t;
          }
        }
        if (pass)
          champions(j, staged ? (J - P + q) % S : -1, valid,
                    [&](int c, u64 k) { keys[i * W + c] = k; });
      }
      bool any = false;
#pragma unroll
      for (int i = 0; i < TILE_KEYS; ++i) any |= keys[i] != 0;
      if (__any_sync(FULL, any)) {
#pragma unroll
        for (int e = 0; e < NL; ++e) keys[TILE_KEYS + e] = list[e];
        warp_top_n(keys, n, list);
      }
    }
    nth = list_at(list, n - 1);
  }
  MARK(5);
#pragma unroll
  for (int e = 0; e < NL; ++e)
    if (lane + 32 * e < n) wlist[warp * n + lane + 32 * e] = list[e];
  if (lane == 0) wth[warp] = nth;
  if (tid < n) topbuf[tid] = 0;
  if (tid == 0) *counter = 0;
  __syncthreads();
  // The block's n best: only the warps' keys at or above the highest warp
  // n-th and theta, gathered by every thread, then ranked (a key's rank is
  // the number of larger ones).
  const u64 theta_key = st_theta[0] == -INFINITY ? 0 : u64(float_ord(st_theta[0])) << 32;
  {
    u64 floor_key = theta_key;
    for (int w = 0; w < WARPS; ++w) floor_key = kmax(floor_key, wth[w]);
    strided<WIDE>(tid, WARPS * n, THREADS, [&](int i) {
      if (wlist[i] != 0 && wlist[i] >= floor_key) cand[atomicAdd(counter, 1)] = wlist[i];
    });
    __syncthreads();
    rank_into(cand, *counter, n, topbuf);
    __syncthreads();
  }
  if constexpr (WIDE) {
    // The block's n best at or above theta (each in one of its n champion
    // columns, and at or above the n-th champion): every row of those
    // columns from L2, ranked here, sent to the leader with the block's n-th.
    const u64 floor_key = kmax(theta_key, topbuf[n - 1]);
    if (tid == 0) *counter = 0;
    __syncthreads();
    for (int i = tid; i < n * K; i += THREADS) {
      const u64 ck = topbuf[i / K];
      const int r = i % K, col = ck ? key_flat(ck) % V - c0 : 0;
      if (ck == 0) continue;
      const u64 k = make_key(candidate(to_f32(x[size_t(r) * V + col]), st_m[r], st_ls[r], st_s[r]),
                             r * V + c0 + col);
      if (k >= floor_key) cand[atomicAdd(counter, 1)] = k;
    }
    __syncthreads();
    const int count = *counter;
    if (tid < n) topbuf[tid] = 0;
    __syncthreads();
    rank_into(cand, count, n, topbuf);
    __syncthreads();
    u64* dst = cluster.map_shared_rank(gather, 0) + rank * n;
    for (int i = tid; i < n; i += THREADS) dst[i] = topbuf[i];
    if (tid == 0) cluster.map_shared_rank(bth, 0)[rank] = topbuf[n - 1];
  } else if (warp == 0) {
    const u64 col_key = lane < n ? topbuf[lane] : 0;
    // the K keys of the block's n columns, and its n-th key, sent to the
    // leader: every load issued before the first store
    constexpr int G = (MAX_N * MAXR + 31) / 32;
    const int nk = n * K;
    u64 keys[G];
#pragma unroll
    for (int t = 0; t < G; ++t) {
      const int i = lane + 32 * t, j = min(i / K, n - 1), r = i - (i / K) * K;
      const u64 ck = __shfl_sync(FULL, col_key, j);
      keys[t] = 0;
      if (i < nk && ck) {
        const int col = key_flat(ck) % V - c0;
        keys[t] = make_key(candidate(to_f32(x[size_t(r) * V + col]), st_m[r], st_ls[r], st_s[r]),
                           r * V + c0 + col);
      }
    }
    u64* dst = cluster.map_shared_rank(gather, 0) + rank * nk;
#pragma unroll
    for (int t = 0; t < G; ++t)
      if (lane + 32 * t < nk) dst[lane + 32 * t] = keys[t];
    const u64 block_nth = __shfl_sync(FULL, col_key, n - 1);
    if (lane == 0) cluster.map_shared_rank(bth, 0)[rank] = block_nth;
  }
  if (tid == 0) *counter = 0;
  cluster_arrive();
  cluster_wait();  // every block's columns have arrived; no one writes to another block again
  MARK(6);
  if (rank != 0) return;

  // ---- phase C (the leader): the top n ---------------------------------------
  // Each block's n-th key and theta bound the cluster's n-th from below, so
  // only keys at or above the highest of them are candidates; every one of
  // the n is in some block's n columns.  Every thread gathers, then ranks.
  u64 floor_key = theta_key;
  for (int c = 0; c < C; ++c) floor_key = kmax(floor_key, bth[c]);
  for (int i = tid; i < C * n * (WIDE ? 1 : K); i += THREADS)
    if (gather[i] != 0 && gather[i] >= floor_key) cand[atomicAdd(counter, 1)] = gather[i];
  __syncthreads();
  const int count = *counter;
  for (int i = tid; i < count; i += THREADS) {
    const u64 k = cand[i];
    int above = 0;
#pragma unroll 8
    for (int j = 0; j < count; ++j) above += cand[j] > k;
    if (above < n) {
      p.out_v[b * n + above] = key_value(k);
      p.out_f[b * n + above] = key_flat(k);
    }
  }
  MARK(7);
  if (tid >= count && tid < n) {  // fewer than n candidates
    p.out_v[b * n + tid] = -INFINITY;
    p.out_f[b * n + tid] = INT_MAX;
  }
}

// one __global__ name a TPU kernel, so that a profile tells them apart: K4 and
// K5 from logits, then K5 from log-probs
template <bool STATS, int COPY, int MAXR>
__global__ void __launch_bounds__(THREADS, 1) beam_topk_columns_kernel(Args p) {
  beam_topk<float, STATS, COPY, MAXR>(p);
}

template <typename T, int COPY, int MAXR>
__global__ void __launch_bounds__(THREADS, 1) beam_topk_kernel(Args p) {
  beam_topk<T, false, COPY, MAXR>(p);
}

// The shapes and the plan the kernel takes: K rows a batch element, n <= K*V,
// K*V < 2^31, n <= 32 and K <= 16 (the narrow instances) or n <= 256 (the
// wide one, which takes no ring and no unit maxima); `cluster` blocks of
// `cols` columns (a multiple of 8) that cover V, each with at least one; a
// ring of 1..8 stages; the unit maxima of none or of all the chunks that
// leave the ring (`itemsize` bytes a column); the block's shared memory
// within 227 KB.
bool plan_ok(int B, int K, int V, int n, int cluster, int cols, int stages, int sum_chunks,
             int itemsize) {
  const int chunks = ((cols * itemsize + UNIT - 1) / UNIT + THREADS - 1) / THREADS;
  const bool wide = wide_shape(K, n);
  return B > 0 && B <= 65535 && K > 0 && V > 0 && n > 0 && n <= (wide ? WIDE_MAX_N : MAX_N) &&
         n <= (long long)K * V && (long long)K * V < INT_MAX && cluster >= 1 &&
         cluster <= MAX_CLUSTER && cols > 0 && cols % 8 == 0 &&
         (long long)(cluster - 1) * cols < V && (long long)cluster * cols >= V && stages >= 1 &&
         stages <= MAX_STAGES && (sum_chunks == 0 || (!wide && sum_chunks == chunks - stages)) &&
         Smem(K, n, cluster, stages, sum_chunks).bytes <= SMEM_MAX;
}

template <typename Kernel>
cudaError_t configure(Kernel kernel, int bytes, int cluster) {
  cudaError_t e = cudaSuccess;
  if (bytes > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

cudaLaunchConfig_t launch_config(int B, int cluster, int bytes, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename Kernel>
int launch(Kernel kernel, const Args& p, int B, int cluster, bool ring, void* stream) {
  const int bytes = Smem(p.K, p.n, cluster, ring ? p.stages : 0, p.sum_chunks).bytes;
  cudaError_t e = configure(kernel, bytes, cluster);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(B, cluster, bytes, static_cast<cudaStream_t>(stream), attr);
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The kernel for exactly 5 rows a batch element with 16-byte rows (beam 5,
// the beam search's default: 5.1 us faster at [40, 128256] than an instance
// for up to 8 rows, PERF.md), else the kernel for up to 16 rows and n <= 32,
// else the wide one.
template <bool STATS, int COPY>
int launch_columns(const Args& p, int B, int cluster, void* stream) {
  if (wide_shape(p.K, p.n))
    return launch(beam_topk_columns_kernel<STATS, COPY, 0>, p, B, cluster, false, stream);
  if constexpr (COPY == 16)
    if (p.K == 5)
      return launch(beam_topk_columns_kernel<STATS, COPY, 5>, p, B, cluster, true, stream);
  return launch(beam_topk_columns_kernel<STATS, COPY, 16>, p, B, cluster, true, stream);
}

// (the wide bf16 instance loads every row 2 bytes at a time, aligned or not)
template <typename T, int COPY>
int launch_logp(const Args& p, int B, int cluster, void* stream) {
  if (wide_shape(p.K, p.n))
    return launch(beam_topk_kernel<T, sizeof(T) == 2 ? 0 : COPY, 0>, p, B, cluster, false, stream);
  if constexpr (COPY == 16)
    if (p.K == 5) return launch(beam_topk_kernel<T, COPY, 5>, p, B, cluster, true, stream);
  return launch(beam_topk_kernel<T, COPY, 16>, p, B, cluster, COPY != 0, stream);
}

bool aligned(const void* p, int bytes) { return (reinterpret_cast<uintptr_t>(p) % bytes) == 0; }

// ---- the select form: any K and n ----------------------------------------------
// Past the wide instance (its block's n x K keys and the warps' lists would
// pass shared memory; ops/topk.py: topk_plan takes it where the wide block
// does not fit a cluster of 16), the same function by a radix select over
// the candidates' order-preserving bits, in a few launches with a zeroed
// global workspace.  The grid of the streaming kernels is (G, B): block g of
// batch element b owns the flat range [g span, (g + 1) span) of its K*V
// candidates, row by row.
//  1. the row statistics (computed: exact max; sum of exp(x - max) in
//     double, a fixed order; given; or 0 for log-probs), one block a row;
//  2. three passes of 11, 11 and 10 bits: each block counts the candidates
//     whose higher bits equal the prefix chosen so far into a shared
//     histogram, added to the batch element's global one; one block a batch
//     element then finds the bin that holds the n-th largest and narrows the
//     prefix, so that after the third pass the prefix is the n-th largest
//     value's bits t and `need` the candidates equal to t among the n;
//  3. each block counts its candidates equal to t;
//  4. each block writes its candidates above t to the batch element's n
//     slots (an atomic counter) and its candidates equal to t whose rank in
//     flat order (the counts of the blocks before it, then a block scan)
//     is below `need`: the lowest flat indices win a tie, as the contract
//     says;
//  5. the n keys ranked among themselves (the number of larger keys) into
//     the outputs.
constexpr int SEL_THREADS = 512;
constexpr int SEL_BINS = 2048;
constexpr int SEL_SCAN_THREADS = SEL_BINS / 2;

struct Sel {
  const void* x;      // [B*K, V] f32 logits or log-probs, or bf16 log-probs
  const float* m;     // [B*K] given statistics, or null
  const float* ls;
  const float* s;     // [B*K] beam scores
  float* m_out;       // [B*K] or null: the statistics computed
  float* ls_out;
  float* out_v;       // [B, n]
  int* out_f;
  float2* st;         // [B*K] the statistics used (workspace)
  unsigned* hist;     // [B][SEL_BINS] (workspace, zeroed)
  unsigned* state;    // [B][4]: prefix, need, candidates written above t (workspace)
  unsigned* ties;     // [B][G] candidates equal to t a block (workspace)
  u64* keys;          // [B][n] (workspace)
  int K, V, n, G, stats;
};

template <typename T>
__device__ __forceinline__ float sel_load(const Sel& p, size_t i) {
  return to_f32(static_cast<const T*>(p.x)[i]);
}

// f(r, c) over the candidates of block g of batch element b, in flat order;
// each tile of SEL_THREADS consecutive columns of a row, one a thread, with
// `tile(valid)` called by every thread of the block before its elements
template <typename F>
__device__ __forceinline__ void sel_range(const Sel& p, int g, F&& f) {
  const long long N = (long long)p.K * p.V, span = (N + p.G - 1) / p.G;
  const long long f0 = min(N, g * span), f1 = min(N, f0 + span);
  for (long long r = f0 / p.V; r < p.K && r * p.V < f1; ++r) {
    const int c0 = int(max(f0 - r * p.V, 0ll)), c1 = int(min(f1 - r * p.V, (long long)p.V));
    for (int t0 = c0; t0 < c1; t0 += SEL_THREADS) f(int(r), t0 + threadIdx.x, t0 + threadIdx.x < c1);
  }
}

// the candidate's value (the contract's op order) and its order bits
template <typename T>
__device__ __forceinline__ float sel_value(const Sel& p, int b, int r, int c) {
  const float2 st = p.st[b * p.K + r];
  return candidate(sel_load<T>(p, (size_t(b) * p.K + r) * p.V + c), st.x, st.y, p.s[b * p.K + r]);
}

// 1. row statistics, one block a row
template <typename T>
__global__ void __launch_bounds__(SEL_THREADS) beam_topk_select_stats_kernel(Sel p) {
  __shared__ double red[SEL_THREADS / 32];
  __shared__ float mred[SEL_THREADS / 32];
  const int row = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float m = 0.0f, ls = 0.0f;
  if (p.stats) {
    const size_t base = size_t(row) * p.V;
    float mx = -INFINITY;
    for (int c = tid; c < p.V; c += SEL_THREADS) mx = fmaxf(mx, sel_load<T>(p, base + c));
    mx = mmvc::warp_max(mx);
    if (lane == 0) mred[warp] = mx;
    __syncthreads();
    m = mred[0];
    for (int w = 1; w < SEL_THREADS / 32; ++w) m = fmaxf(m, mred[w]);
    double sum = 0.0;
    for (int c = tid; c < p.V; c += SEL_THREADS) sum += double(expf(sel_load<T>(p, base + c) - m));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
    if (lane == 0) red[warp] = sum;
    __syncthreads();
    double total = 0.0;
    for (int w = 0; w < SEL_THREADS / 32; ++w) total += red[w];
    ls = logf(float(total));
  } else if (p.m) {
    m = p.m[row];
    ls = p.ls[row];
  }
  if (tid == 0) {
    p.st[row] = make_float2(m, ls);
    if (p.stats && p.m_out) {
      p.m_out[row] = m;
      p.ls_out[row] = ls;
    }
  }
}

// 2a. one radix pass: the histogram of bits [shift, shift + bits) of the
// candidates whose bits above them equal the prefix
template <typename T>
__global__ void __launch_bounds__(SEL_THREADS) beam_topk_select_hist_kernel(Sel p, int shift,
                                                                             int bits) {
  __shared__ unsigned h[SEL_BINS];
  const int g = blockIdx.x, b = blockIdx.y;
  for (int i = threadIdx.x; i < SEL_BINS; i += SEL_THREADS) h[i] = 0;
  __syncthreads();
  const unsigned prefix = p.state[b * 4], top = shift + bits, mask = (1u << bits) - 1u;
  sel_range(p, g, [&](int r, int c, bool ok) {
    if (!ok) return;
    const unsigned o = float_ord(sel_value<T>(p, b, r, c));
    if (top == 32 || (o >> top) == prefix) atomicAdd(&h[(o >> shift) & mask], 1u);
  });
  __syncthreads();
  for (int i = threadIdx.x; i < SEL_BINS; i += SEL_THREADS)
    if (h[i]) atomicAdd(&p.hist[b * SEL_BINS + i], h[i]);
}

// 2b. the bin of the n-th largest, from the top: the prefix grows by its
// `bits`, `need` loses the candidates of the bins above it; the histogram is
// cleared for the next pass
__global__ void __launch_bounds__(SEL_SCAN_THREADS) beam_topk_select_scan_kernel(Sel p, int bits,
                                                                                int first) {
  __shared__ unsigned wsum[SEL_SCAN_THREADS / 32];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned* hist = p.hist + b * SEL_BINS;
  const unsigned need = first ? unsigned(p.n) : p.state[b * 4 + 1];
  const int nb = 1 << bits;
  // thread t: bins nb - 1 - 2t and nb - 2 - 2t (descending order)
  const int hi = nb - 1 - 2 * tid;
  const unsigned c0 = hi >= 0 ? hist[hi] : 0u, c1 = hi >= 1 ? hist[hi - 1] : 0u;
  unsigned incl = c0 + c1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned v = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  unsigned before = 0;
  for (int w = 0; w < warp; ++w) before += wsum[w];
  const unsigned excl = before + incl - (c0 + c1);  // candidates in the bins above hi
  const unsigned prefix = first ? 0u : p.state[b * 4];
  __syncthreads();  // every thread has read the state
  if (hi >= 0 && excl < need && need <= excl + c0) {
    p.state[b * 4] = (prefix << bits) | unsigned(hi);
    p.state[b * 4 + 1] = need - excl;
  } else if (hi >= 1 && excl + c0 < need && need <= excl + c0 + c1) {
    p.state[b * 4] = (prefix << bits) | unsigned(hi - 1);
    p.state[b * 4 + 1] = need - excl - c0;
  }
  if (hi >= 0) hist[hi] = 0;
  if (hi >= 1) hist[hi - 1] = 0;
}

// 3. the candidates equal to t a block
template <typename T>
__global__ void __launch_bounds__(SEL_THREADS) beam_topk_select_ties_kernel(Sel p) {
  __shared__ unsigned count;
  const int g = blockIdx.x, b = blockIdx.y;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  const unsigned t = p.state[b * 4];
  unsigned mine = 0;
  sel_range(p, g, [&](int r, int c, bool ok) {
    mine += ok && float_ord(sel_value<T>(p, b, r, c)) == t;
  });
  mine = __reduce_add_sync(FULL, mine);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(&count, mine);
  __syncthreads();
  if (threadIdx.x == 0) p.ties[b * p.G + g] = count;
}

// 4. the n keys of batch element b into its slots
template <typename T>
__global__ void __launch_bounds__(SEL_THREADS) beam_topk_select_write_kernel(Sel p) {
  __shared__ unsigned wcount[SEL_THREADS / 32];
  __shared__ unsigned base_sh;
  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) base_sh = 0;
  __syncthreads();
  unsigned before = 0;  // ties in the blocks before this one
  for (int i = tid; i < g; i += SEL_THREADS) before += p.ties[b * p.G + i];
  before = __reduce_add_sync(FULL, before);
  if (lane == 0 && before) atomicAdd(&base_sh, before);
  __syncthreads();
  const unsigned t = p.state[b * 4], need = p.state[b * 4 + 1], above = unsigned(p.n) - need;
  unsigned rank0 = base_sh;  // the rank in flat order of this tile's first tie
  u64* keys = p.keys + size_t(b) * p.n;
  sel_range(p, g, [&](int r, int c, bool ok) {
    const float v = ok ? sel_value<T>(p, b, r, c) : 0.0f;
    const unsigned o = ok ? float_ord(v) : 0u;
    const int flat = r * p.V + c;
    if (ok && o > t) keys[atomicAdd(&p.state[b * 4 + 2], 1u)] = make_key(v, flat);
    const bool tie = ok && o == t;
    if (!__syncthreads_or(tie)) return;  // block-uniform
    const unsigned ball = __ballot_sync(FULL, tie);
    if (lane == 0) wcount[warp] = __popc(ball);
    __syncthreads();
    unsigned rank = rank0 + __popc(ball & ((1u << lane) - 1u)), total = 0;
    for (int w = 0; w < SEL_THREADS / 32; ++w) {
      rank += w < warp ? wcount[w] : 0u;
      total += wcount[w];
    }
    if (tie && rank < need) keys[above + rank] = make_key(v, flat);
    rank0 += total;
    __syncthreads();  // wcount is read before the next tile writes it
  });
}

// 5. the n keys ranked among themselves (distinct keys: ranks 0 .. n - 1)
__global__ void __launch_bounds__(256) beam_topk_select_rank_kernel(Sel p) {
  __shared__ u64 tile[256];
  const int b = blockIdx.y, i = blockIdx.x * 256 + threadIdx.x;
  const u64* keys = p.keys + size_t(b) * p.n;
  const u64 k = i < p.n ? keys[i] : 0;
  int above = 0;
  for (int j0 = 0; j0 < p.n; j0 += 256) {
    __syncthreads();
    tile[threadIdx.x] = j0 + threadIdx.x < p.n ? keys[j0 + threadIdx.x] : 0;
    __syncthreads();
    const int len = min(256, p.n - j0);
    for (int j = 0; j < len; ++j) above += tile[j] > k;
  }
  if (i < p.n) {
    p.out_v[size_t(b) * p.n + above] = key_value(k);
    p.out_f[size_t(b) * p.n + above] = key_flat(k);
  }
}

template <typename T>
int launch_select(const Sel& p, int B, cudaStream_t stream) {
  beam_topk_select_stats_kernel<T><<<B * p.K, SEL_THREADS, 0, stream>>>(p);
  const int shifts[3] = {21, 10, 0}, bits[3] = {11, 11, 10};
  for (int pass = 0; pass < 3; ++pass) {
    beam_topk_select_hist_kernel<T>
        <<<dim3(p.G, B), SEL_THREADS, 0, stream>>>(p, shifts[pass], bits[pass]);
    beam_topk_select_scan_kernel<<<B, SEL_SCAN_THREADS, 0, stream>>>(p, bits[pass], pass == 0);
  }
  beam_topk_select_ties_kernel<T><<<dim3(p.G, B), SEL_THREADS, 0, stream>>>(p);
  beam_topk_select_write_kernel<T><<<dim3(p.G, B), SEL_THREADS, 0, stream>>>(p);
  beam_topk_select_rank_kernel<<<dim3((p.n + 255) / 256, B), 256, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// K4, and K5 from logits: f32 logits [B*K, V], scores [B*K].  Given row
// statistics m, ls [B*K] (both, or neither: the kernel computes them, and
// writes them to m_out, ls_out where those are not null).  Out: values f32
// and flat indices int32 [B, n].  The plan: `cluster` blocks of `cols`
// columns a batch element, a copy ring of `stages` chunks, the unit maxima
// of `sum_chunks` chunks.
extern "C" int mmvc_beam_topk_columns(const void* logits, const void* m, const void* ls,
                                      const void* s, void* m_out, void* ls_out, void* out_v,
                                      void* out_f, int B, int K, int V, int n, int cluster,
                                      int cols, int stages, int sum_chunks, void* stream) {
  const bool stats = m == nullptr;
  if ((ls == nullptr) != stats || (m_out == nullptr) != (ls_out == nullptr) ||
      !aligned(logits, 4) || !plan_ok(B, K, V, n, cluster, cols, stages, sum_chunks, 4))
    return cudaErrorInvalidValue;
  const Args p{logits, static_cast<const float*>(m), static_cast<const float*>(ls),
               static_cast<const float*>(s), static_cast<float*>(m_out),
               static_cast<float*>(ls_out), static_cast<float*>(out_v), static_cast<int*>(out_f),
               K, V, n, cols, stages, sum_chunks};
  const bool vec = V % 4 == 0 && aligned(logits, 16);
  if (stats)
    return vec ? launch_columns<true, 16>(p, B, cluster, stream)
               : launch_columns<true, 4>(p, B, cluster, stream);
  return vec ? launch_columns<false, 16>(p, B, cluster, stream)
             : launch_columns<false, 4>(p, B, cluster, stream);
}

// K5 beam_topk: log-probs [B, K, V], f32 (bf16 == 0) or bf16 (bf16 == 1); m =
// ls = 0.  The plan as above (bf16 rows that are not 16-byte aligned take no
// ring).
extern "C" int mmvc_beam_topk(const void* logp, int bf16_in, const void* s, void* out_v,
                              void* out_f, int B, int K, int V, int n, int cluster, int cols,
                              int stages, int sum_chunks, void* stream) {
  if (!plan_ok(B, K, V, n, cluster, cols, stages, sum_chunks, bf16_in ? 2 : 4) ||
      !aligned(logp, bf16_in ? 2 : 4))
    return cudaErrorInvalidValue;
  const bool ring = !bf16_in || (V % 8 == 0 && aligned(logp, 16));
  const Args p{logp, nullptr, nullptr, static_cast<const float*>(s), nullptr, nullptr,
               static_cast<float*>(out_v), static_cast<int*>(out_f), K, V, n, cols, stages,
               ring ? sum_chunks : 0};
  if (bf16_in)
    return ring ? launch_logp<bf16, 16>(p, B, cluster, stream)
                : launch_logp<bf16, 0>(p, B, cluster, stream);
  return V % 4 == 0 && aligned(logp, 16) ? launch_logp<float, 16>(p, B, cluster, stream)
                                         : launch_logp<float, 4>(p, B, cluster, stream);
}

// How many clusters of the plan the card runs at once
// (cudaOccupancyMaxActiveClusters) for the from-logits kernel (stats = 1:
// computing its statistics) or the f32 log-probs kernel (stats = 0), rows
// 16-byte aligned.  Written to *out; returns the CUDA error.
extern "C" int mmvc_beam_topk_max_clusters(int stats, int B, int K, int V, int n, int cluster,
                                           int cols, int stages, int sum_chunks, int* out) {
  if (!plan_ok(B, K, V, n, cluster, cols, stages, sum_chunks, 4)) return cudaErrorInvalidValue;
  const int bytes = Smem(K, n, cluster, stages, sum_chunks).bytes;
  const bool wide = wide_shape(K, n);
  auto kernel = stats ? (wide     ? beam_topk_columns_kernel<true, 16, 0>
                         : K == 5 ? beam_topk_columns_kernel<true, 16, 5>
                                  : beam_topk_columns_kernel<true, 16, 16>)
                      : (wide     ? beam_topk_kernel<float, 16, 0>
                         : K == 5 ? beam_topk_kernel<float, 16, 5>
                                  : beam_topk_kernel<float, 16, 16>);
  cudaError_t e = configure(kernel, bytes, cluster);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(B, cluster, bytes, nullptr, attr);
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

#ifdef MMVC_TOPK_MARKS
extern "C" int mmvc_topk_marks(void* dst) {
  return cudaMemcpyFromSymbol(dst, g_marks, sizeof(g_marks));
}
#endif

// The select form (K4, K5 from logits or from log-probs) for any K and n <=
// K*V < 2^31: x [B*K, V], f32 (kind 0: logits; 1: log-probs) or bf16 log-probs
// (kind 2); statistics as mmvc_beam_topk_columns (log-probs: none); G blocks
// a batch element; `ws` a zeroed workspace, 16-byte aligned, of 8 B K (the
// statistics) + 8 B n (the keys) + 4 B 2048 (the histograms) + 16 B (the
// state) + 4 B G (the ties) bytes (ops/topk.py: select_workspace_bytes).

extern "C" int mmvc_beam_topk_select(const void* x, int kind, const void* m, const void* ls,
                                     const void* s, void* m_out, void* ls_out, void* out_v,
                                     void* out_f, void* ws, int B, int K, int V, int n, int G,
                                     void* stream) {
  const bool stats = kind == 0 && m == nullptr;
  if (B <= 0 || B > 65535 || K <= 0 || V <= 0 || n <= 0 || G <= 0 || G > 65535 ||
      (long long)K * V >= INT_MAX || n > (long long)K * V || kind < 0 || kind > 2 ||
      (kind != 0 && (m || ls || m_out || ls_out)) || (m == nullptr) != (ls == nullptr) ||
      (m_out == nullptr) != (ls_out == nullptr) || (m_out && !stats) || !ws ||
      !aligned(ws, 16) || !aligned(x, kind == 2 ? 2 : 4))
    return cudaErrorInvalidValue;
  unsigned char* w = static_cast<unsigned char*>(ws);
  Sel p{};
  p.x = x;
  p.m = static_cast<const float*>(m);
  p.ls = static_cast<const float*>(ls);
  p.s = static_cast<const float*>(s);
  p.m_out = static_cast<float*>(m_out);
  p.ls_out = static_cast<float*>(ls_out);
  p.out_v = static_cast<float*>(out_v);
  p.out_f = static_cast<int*>(out_f);
  p.st = reinterpret_cast<float2*>(w);
  w += size_t(B) * K * 8;
  p.keys = reinterpret_cast<u64*>(w);
  w += size_t(B) * n * 8;
  p.hist = reinterpret_cast<unsigned*>(w);
  w += size_t(B) * SEL_BINS * 4;
  p.state = reinterpret_cast<unsigned*>(w);
  w += size_t(B) * 16;
  p.ties = reinterpret_cast<unsigned*>(w);
  p.K = K, p.V = V, p.n = n, p.G = G, p.stats = stats;
  auto st = static_cast<cudaStream_t>(stream);
  return kind == 2 ? launch_select<bf16>(p, B, st) : launch_select<float>(p, B, st);
}
