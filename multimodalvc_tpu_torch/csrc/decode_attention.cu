// K2 · prompt_attention, K3 · gen_attention_ancestor and the merged ancestry
// attention of a decode step: one split-KV decode-attention kernel template
// with three entries.
//
// Replaces the Pallas kernels of multimodalvc_tpu/ops/decode_attention.py:
//   K2 prompt_attention (pallas_call at :370, body _prompt_kernel :278): the
//      K beam queries of one batch element against its shared prompt KV
//      [g, Tp, d] under a [Tp] validity mask;
//   K3 gen_attention_ancestor (pallas_call at :195, body _kernel :38): the
//      generated segment [B*K, L, g, d]; slot l < valid_len of row (b, k)
//      reads its key/value from beam row anc[b*K+k, l] of the same batch
//      element, so the beam reorder never moves the cache;
// and what the JAX decode does with them (multimodalvc_tpu/nn/llama.py:
// 342-377): merge_softmax_segments of the two, cast to the model dtype.
// The K2 and K3 entries return unnormalised f32 out [B*K, h, d] with the row
// max m and row sum l [B*K, h] (m = -1e30, l = 0, out = 0 for a row with no
// valid key).  The merged entry returns both segments combined and
// normalised, bf16 or f32, exact zeros where neither has a valid key.  KV is
// int8 with one f32 scale a row, or bf16 with none (K2, K3; the merged entry
// takes int8).
//
// What bounds it on the H100: the KV bytes (2 * (Tp + L) * d a batch element
// and kv head, 1 byte each in int8) against 3.35 TB/s.  One decode step at
// batch 8 moves ~2.2 MB a layer, a bound under 1 us, so latency and
// parallelism set the time, not bandwidth or arithmetic (~2 flops a byte).
//
// The design (ops/decode_attention.py: decode_plan chooses the chunks and
// splits; the C entries only check them):
// - split KV.  A segment is cut into chunks of cp prompt slots or cg
//   generated slots.  The grid is (splits, g, B) and the `splits` blocks of
//   one (batch element, kv head) form a thread block cluster; block r takes
//   chunks r, r + splits, ... in order, with an online softmax across them
//   (at batch 8: 7 chunks and blocks a pair, 448 blocks, where one block a
//   pair gave 64 on 132 SMs; at batch 48, 6 chunks over 3 blocks a pair).  The
//   grid depends on (B, g, Tp, L) only, never on valid_len: a generated chunk
//   at or past valid_len is skipped unread.
// - row tiles.  A block serves the K * rep query rows that share its kv
//   head in m16 tiles (the last one padded), one tile after another: its
//   chunks, then the tile's combine.  The scores [16, keys], the running m
//   and l and the combine's buffers serve every tile, so shared memory does
//   not grow with the beams.  A block with one chunk stages it once and
//   keeps it for every tile (each K/V byte read once; batch 8 at every beam
//   width); a block with more re-stages its chunks for each tile, from L2.
//   Beam 5 at rep 3 (15 rows) is one tile, the loop's one pass.
// - whole rows by cp.async.  A chunk's key rows and value rows (128 bytes
//   each in int8, 8 lanes a row) go to shared memory in two commit groups,
//   keys (with the scales, the mask or anc) first, so the scores run while
//   the values are in flight; no thread waits on a load of its own.  A
//   generated chunk reads its slots from all K source rows of its batch
//   element, each row once, as the TPU kernel's one-hot select does; slots
//   at or past valid_len are zero-filled without a read.  Past 336 beams
//   (a slot of every source row would pass shared memory) a chunk holds one
//   slot of a piece of the source rows (`kb` of them, ops/decode_attention.py:
//   gen_chunk_beams), and the online softmax merges the pieces as it merges
//   chunks (the PIECES instances).
// - scores.  K2 and K3 use the tensor cores: S = Q K^T by
//   mma.sync.m16n8k16 with bf16 inputs, q held in registers, int8 keys
//   converted to bf16 exactly, the key scale and the softmax scale applied
//   to the f32 sum; within each 16-wide step of the head dim the order of k
//   is permuted (both operands alike), so a thread reads 4 consecutive key
//   bytes in one load.  The merged entry's output feeds the model, so its
//   scores are summed as the plain version's are: f32 FMAs over the head dim
//   in order, on keys dequantized as k * ks rounded to f32, 4 query rows x 2
//   keys a thread.  (With tensor-core scores, which round the sums
//   otherwise, the random-weight model carried the merged entry's
//   differences past chip_smoke.py's 2e-2 gate on the step logits against
//   the plain versions'.)  A key counts for a query row when its slot is
//   valid (prompt mask; generated: l < valid_len and anc[row's beam, l]
//   names this source row).
// - the softmax in shared memory (8 threads a row), then P.V by mma with the
//   value scale folded into P and P split into three bf16 terms, which keep
//   all 24 bits of P; each term's mma starts from zero and the partials are
//   added in f32, rounding to nearest (an mma that accumulates rounds its
//   running sum toward zero).
// - the combine inside the launch, through distributed shared memory: each
//   block pushes its (m, l) to every block of its cluster and its o of each
//   unit (query row, 4 columns) to that unit's owner, one cluster barrier,
//   then each block combines the units it owns from its own shared memory,
//   every block's partial in block order (the same bits every run).  No
//   workspace, no counters, no global round trip.  K2/K3 write the segment's
//   partials; the merged entry combines both segments and divides by
//   max(l, 1e-30): one launch a layer where K2, K3 and the PyTorch merge
//   took 20.
// - few instructions: at these sizes a block's loads land before it has
//   issued them all, so the divisions by the runtime cg and rep are
//   multiplies (div_by).
#include <cooperative_groups.h>

#include "common.cuh"

using bf16 = __nv_bfloat16;
namespace cg = cooperative_groups;

namespace {

constexpr int D = 128;            // head dim
constexpr int THREADS = 128;      // 4 warps
constexpr int ROWS = 16;          // query rows a tile: K * rep in m16 tiles, the last padded
constexpr int MAX_KEYS = 128;     // key rows a chunk (a generated chunk of one slot: K)
constexpr int SMEM_MAX = 232448;  // 227 KB a block
constexpr int MAX_SPLITS = 8;     // blocks a cluster (the portable cluster size)
constexpr int BLOCKS_PER_SM = 5;  // registers for 5 blocks an SM (<= 102 a thread)
constexpr int UNITS = ROWS * D / 4;  // combine units: (query row, 4 columns)
constexpr int Q_PITCH = D + 4;       // floats: the merged entry's q in f32

enum Mode { PROMPT_PARTIALS, GEN_PARTIALS, MERGED };

struct Args {
  const bf16* q;        // [B*K, h, D]
  const void* pk;       // [B, g, Tp, D]
  const void* pv;
  const float* pks;     // [B, g, Tp] (int8)
  const float* pvs;
  const int* mask;      // [B, Tp]
  const void* gk;       // [B*K, L, g, D]
  const void* gv;
  const float* gks;     // [B*K, L, g] (int8)
  const float* gvs;
  const int* anc;       // [B*K, L]
  void* out;            // partials: f32 [B*K, h, D]; merged: bf16 or f32
  float* m_out;         // partials: [B*K, h]
  float* l_out;
  int K, h, g, Tp, L, valid;
  int cp, p_chunks;     // prompt slots a chunk, prompt chunks
  int cg, g_chunks;     // generated slots a chunk, generated chunks
  int keys;             // key rows of the largest chunk, a multiple of 16
  unsigned long long cg_m, rep_m;  // magic(cg), magic(h / g): see div_by
  int out_f32;
  float scale;
  int tiles;            // m16 tiles of the K * rep query rows (set by the launch)
  int kb;               // source beams a generated chunk: K, or fewer in pieces
  int pieces;           // generated chunks a slot range: ceil(K / kb) (set by the launch)
};

// Shared memory of one block (byte offsets) for chunks of at most `keys`
// key rows, so that small chunks leave room for more blocks an SM: the
// running m, l and the last rescale factor; what the cluster's blocks send
// this one for the combine: each block's (m, l) [MAX_SPLITS][2][ROWS] and
// the o of the units this block owns, [owned unit][sending block] float4;
// then the key and value tiles, the scores [ROWS, s_pitch] f32, the key and
// value scales and what decides validity (at least `preds` entries: a
// generated chunk's anc of every query beam); for the merged entry, q in f32
// [ROWS, Q_PITCH].
template <typename T>
struct Smem {
  static constexpr int K_PITCH = D * sizeof(T) + 16 * sizeof(T);  // conflict-free key loads
  static constexpr int V_PITCH = D * sizeof(T) + 16;
  int s_pitch;  // floats, 16 mod 32: conflict-free float4 loads
  int ml_off, rml_off, ro_off, k_off, v_off, s_off, ks_off, vs_off, pred_off, qf_off, bytes;
  __host__ __device__ Smem(int keys, bool merged, int preds) {
    s_pitch = (keys + 31) / 32 * 32 + 16;
    ml_off = 0;
    rml_off = ml_off + 4 * ROWS * 4;
    ro_off = rml_off + MAX_SPLITS * 2 * ROWS * 4;
    k_off = ro_off + (UNITS + MAX_SPLITS) * 16;
    v_off = k_off + keys * K_PITCH;
    s_off = v_off + keys * V_PITCH;
    ks_off = s_off + ROWS * s_pitch * 4;
    vs_off = ks_off + keys * 4;
    pred_off = vs_off + keys * 4;
    qf_off = pred_off + (preds > keys ? (preds + 3) / 4 * 4 : keys) * 4;  // 16-byte aligned
    bytes = qf_off + (merged ? ROWS * Q_PITCH * 4 : 0);
  }
};

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, through L2 only; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// 4 bytes global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// n / d for 0 <= n, d < 2^16 by one multiply with m = magic(d) = 2^32 / d
// rounded up: exact, since n * (m d - 2^32) < 2^32 d.  The kernel divides by
// the runtime cg and rep this way instead of by integer division sequences.
__host__ __device__ __forceinline__ unsigned long long magic(int d) {
  return 0xFFFFFFFFull / unsigned(d) + 1;
}
__device__ __forceinline__ int div_by(int n, unsigned long long m) {
  return int(static_cast<unsigned long long>(unsigned(n)) * m >> 32);
}

__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&v);
}

// {a, b} = t[0] + t[1] + t[2], each a bf16 pair: t[0] rounds {a, b}, t[1]
// rounds the rest, t[2] what is left (each subtraction exact in f32), so the
// three keep all 24 bits of an f32 significand
__device__ __forceinline__ void split_bf16(float a, float b, unsigned (&t)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    t[i] = pack_bf16(a, b);
    a -= __uint_as_float(t[i] << 16);
    b -= __uint_as_float(t[i] & 0xFFFF0000u);
  }
}

// 4 consecutive key elements -> the bf16 pairs {e0, e1} and {e2, e3}, exactly
__device__ __forceinline__ void key_pairs(const int8_t* p, unsigned& b0, unsigned& b1) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  b0 = pack_bf16(float(c.x), float(c.y));
  b1 = pack_bf16(float(c.z), float(c.w));
}
__device__ __forceinline__ void key_pairs(const bf16* p, unsigned& b0, unsigned& b1) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  b0 = u.x;
  b1 = u.y;
}

// four int8 (one word) -> f32, exactly, by a byte permute and a subtraction
// (2^23 + (b ^ 0x80) as a float, less 2^23 + 128) instead of the quarter-rate
// integer conversion
__device__ __forceinline__ float4 int8x4_to_f32(unsigned w) {
  w ^= 0x80808080u;
  return make_float4(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540)) - 8388736.0f,
                     __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7541)) - 8388736.0f,
                     __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7542)) - 8388736.0f,
                     __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7543)) - 8388736.0f);
}

// one value element -> its bf16 bits, exactly
__device__ __forceinline__ unsigned value_bits(int8_t v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(float(v)));
}
__device__ __forceinline__ unsigned value_bits(bf16 v) { return __bfloat16_as_ushort(v); }

// TILES: more than one 16-row tile of query rows (K * rep > 16); the
// instance for one tile compiles the loop away, with the registers of a
// kernel without it.  PIECES: a generated chunk holds the slots of kb < K
// source beams (a slot of all K would pass shared memory), so a slot range
// is read in ceil(K / kb) chunks, one a piece of the source beams; a query
// row's key of a slot is in the piece of its ancestor there, and the
// online softmax across chunks merges the pieces as it merges slot ranges.
template <typename T, int MODE, bool TILES, bool PIECES = false>
__device__ __forceinline__ void decode_attention(const Args& p) {
  using L = Smem<T>;
  // (without PIECES every chunk's key rows hold its ancestor entries: the
  // layout of an instance without pieces)
  const L lay(p.keys, MODE == MERGED, PIECES ? p.K * p.cg : p.keys);
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  // every block of the cluster has started before any writes to another's
  // shared memory (the matching wait comes after the chunks)
  cluster_arrive_relaxed();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;  // the mma fragment's row group and thread
  const int r = blockIdx.x, splits = gridDim.x, gi = blockIdx.y, b = blockIdx.z;
  const int g = p.g, K = p.K, rep = p.h / g, X = K * rep;
  const int pair = b * g + gi;
  float* ksc = reinterpret_cast<float*>(smem + lay.ks_off);
  float* vsc = reinterpret_cast<float*>(smem + lay.vs_off);
  int* pred = reinterpret_cast<int*>(smem + lay.pred_off);
  float* S = reinterpret_cast<float*>(smem + lay.s_off);
  float* rml = reinterpret_cast<float*>(smem + lay.rml_off);
  float4* ro = reinterpret_cast<float4*>(smem + lay.ro_off);
  float* m_run = reinterpret_cast<float*>(smem + lay.ml_off);  // [ROWS], -inf: no valid key yet
  float* l_run = m_run + ROWS;
  float* alpha = l_run + ROWS;  // the rescale of the running o by the last chunk

  float* qf = reinterpret_cast<float*>(smem + lay.qf_off);
  // a block with one chunk stages it once and keeps it for every row tile
  const bool keep = r + splits >= p.p_chunks + p.g_chunks;
  for (int tile = 0; tile < (TILES ? p.tiles : 1); ++tile) {
    const int row0 = tile * ROWS;  // the tile's first query row
    // this thread's query rows row0 + gq and row0 + gq + 8: (row x, its beam),
    // and q, once a tile, straight into the mma A fragments: elements 4t .. 4t
    // + 3 of each 16-wide step of the head dim (the permuted k order), zeros
    // for the padding rows
    int beam_of[2];
    unsigned qa[D / 16][4];
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int x = row0 + gq + 8 * h8;
      beam_of[h8] = div_by(x, p.rep_m);
      const size_t q_row = size_t(b * K + beam_of[h8]) * p.h + gi * rep + x - beam_of[h8] * rep;
      const uint2* qrow = reinterpret_cast<const uint2*>(p.q + q_row * D + 4 * t);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint2 v = x < X ? __ldg(qrow + kk * 4) : make_uint2(0u, 0u);
        if constexpr (MODE == MERGED) {  // q in f32: elements 16kk + 4t .. + 3 of row x
          float* dst = qf + (gq + 8 * h8) * Q_PITCH + kk * 16 + 4 * t;
          *reinterpret_cast<float4*>(dst) =
              make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xFFFF0000u),
                          __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xFFFF0000u));
        } else {
          qa[kk][h8] = v.x;
          qa[kk][2 + h8] = v.y;
        }
      }
    }
    if (tid < ROWS) {
      m_run[tid] = -INFINITY;
      l_run[tid] = 0.f;
    }
    float o[D / 32][4];  // the running P.V: rows gq, gq + 8 of columns 32w + 8j + 2t, +1
#pragma unroll
    for (int j = 0; j < D / 32; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

    for (int c = r; c < p.p_chunks + p.g_chunks; c += splits) {
      const bool prompt = c < p.p_chunks;
      // generated chunk: slots l0 .. l0 + cg - 1 of source rows s0 .. s0 + kb - 1
      // (every source row, s0 = 0 and kb = K, but with PIECES)
      int l0 = prompt ? 0 : (c - p.p_chunks) * p.cg, s0 = 0, kb = K;
      if constexpr (PIECES) {
        if (!prompt) {
          const int range = (c - p.p_chunks) / p.pieces;
          s0 = (c - p.p_chunks - range * p.pieces) * p.kb;
          kb = min(p.kb, K - s0);
          l0 = range * p.cg;
        }
      }
      if (!prompt && l0 >= p.valid) break;  // no valid slot here or in a later chunk
      const int n_keys = prompt ? p.cp : (kb * p.cg + 15) / 16 * 16;
      const unsigned char* kv_k = static_cast<const unsigned char*>(prompt ? p.pk : p.gk);
      const unsigned char* kv_v = static_cast<const unsigned char*>(prompt ? p.pv : p.gv);
      const float* ksrc = prompt ? p.pks : p.gks;
      const float* vsrc = prompt ? p.pvs : p.gvs;
      // key row n of the chunk: its row in the cache and whether it is read
      auto key_row = [&](int n, size_t& row, bool& ok) {
        if (prompt) {
          const int slot = c * p.cp + n;
          ok = slot < p.Tp;
          row = size_t(pair) * p.Tp + (ok ? slot : 0);
        } else {
          const int s = div_by(n, p.cg_m), l = l0 + n - s * p.cg;
          ok = n < kb * p.cg && l < p.valid;
          row = ok ? (size_t(b * K + s0 + s) * p.L + l) * g + gi : 0;
        }
      };

      __syncthreads();  // the previous chunk's tiles are no longer read
      // group 0: the keys, the key and value scales and what decides validity
      // (the prompt mask, or the generated chunk's source rows [beam][slot -
      // l0]); group 1: the values.  No thread waits on a load of its own.
      // staged for this tile, or (one chunk) still there from the first
      if (tile == 0 || !keep) {
        constexpr int PIECES = D * sizeof(T) / 16;
        for (int i = tid; i < n_keys * PIECES; i += THREADS) {
          const int n = i / PIECES, piece = i % PIECES;
          size_t row;
          bool ok;
          key_row(n, row, ok);
          cp_async16(smem_addr(smem + lay.k_off + n * L::K_PITCH + piece * 16),
                     kv_k + row * D * sizeof(T) + piece * 16, ok ? 16 : 0);
        }
        for (int n = tid; n < n_keys; n += THREADS) {
          size_t row;
          bool ok;
          key_row(n, row, ok);
          if (ksrc) {
            cp_async4(smem_addr(ksc + n), ksrc + row, ok ? 4 : 0);
            cp_async4(smem_addr(vsc + n), vsrc + row, ok ? 4 : 0);
          } else {
            ksc[n] = vsc[n] = 1.f;
          }
          if (prompt) {
            const int slot = min(c * p.cp + n, p.Tp - 1);
            cp_async4(smem_addr(pred + n), p.mask + size_t(b) * p.Tp + slot, ok ? 4 : 0);
          }
        }
        if (!prompt) {
          for (int i = tid; i < K * p.cg; i += THREADS) {
            const int beam = div_by(i, p.cg_m), l = min(l0 + i - beam * p.cg, p.L - 1);
            cp_async4(smem_addr(pred + i), p.anc + size_t(b * K + beam) * p.L + l, 4);
          }
        }
        cp_async_commit();
        for (int i = tid; i < n_keys * PIECES; i += THREADS) {
          const int n = i / PIECES, piece = i % PIECES;
          size_t row;
          bool ok;
          key_row(n, row, ok);
          cp_async16(smem_addr(smem + lay.v_off + n * L::V_PITCH + piece * 16),
                     kv_v + row * D * sizeof(T) + piece * 16, ok ? 16 : 0);
        }
        cp_async_commit();
      }
      cp_async_wait<1>();
      __syncthreads();

      // whether key n of the chunk counts for query row x (with x's beam)
      auto valid = [&](int x, int beam, int n) {
        if (x >= X) return false;
        if (prompt) return pred[n] != 0;
        // slot l0 + j of source row s0 + s: the row's beam's ancestor there?
        const int s = div_by(n, p.cg_m), j = n - s * p.cg;
        return n < kb * p.cg && l0 + j < p.valid &&
               min(max(pred[beam * p.cg + j], 0), K - 1) == s0 + s;
      };
      if constexpr (MODE == MERGED) {
        // f32 FMAs over the head dim in order, on keys dequantized as k * ks
        // rounded to f32, as the plain version sums them (see the note at the
        // top); a thread takes 4 query rows x 2 keys
        for (int i = tid; i < 4 * (n_keys / 2); i += THREADS) {
          const int x0 = 4 * (i & 3), n0 = 2 * (i >> 2);
          const unsigned char* k0 = smem + lay.k_off + n0 * L::K_PITCH;
          const float ks0 = ksc[n0], ks1 = ksc[n0 + 1];
          float acc[4][2] = {};
          for (int d0 = 0; d0 < D; d0 += 4) {
            const float4 c0 = int8x4_to_f32(*reinterpret_cast<const unsigned*>(k0 + d0));
            const float4 c1 =
                int8x4_to_f32(*reinterpret_cast<const unsigned*>(k0 + L::K_PITCH + d0));
            const float kv[2][4] = {{c0.x * ks0, c0.y * ks0, c0.z * ks0, c0.w * ks0},
                                    {c1.x * ks1, c1.y * ks1, c1.z * ks1, c1.w * ks1}};
#pragma unroll
            for (int r4 = 0; r4 < 4; ++r4) {
              const float4 qv = *reinterpret_cast<const float4*>(qf + (x0 + r4) * Q_PITCH + d0);
              const float qs[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int c = 0; c < 2; ++c) acc[r4][c] = fmaf(qs[j], kv[c][j], acc[r4][c]);
            }
          }
#pragma unroll
          for (int r4 = 0; r4 < 4; ++r4)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int x = x0 + r4, n = n0 + c, xg = row0 + x;
              S[x * lay.s_pitch + n] =
                  valid(xg, div_by(xg, p.rep_m), n) ? acc[r4][c] * p.scale : -INFINITY;
            }
        }
      } else {
        // tensor cores: warp w takes key tiles w, w + 4, ...
        for (int nt = warp; nt < n_keys / 8; nt += 4) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          const T* krow = reinterpret_cast<const T*>(smem + lay.k_off + (nt * 8 + gq) * L::K_PITCH);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            unsigned b0, b1;
            key_pairs(krow + kk * 16 + 4 * t, b0, b1);
            mma(acc, qa[kk], b0, b1);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = gq + 8 * (e >> 1), n = nt * 8 + 2 * t + (e & 1);
            S[x * lay.s_pitch + n] =
                valid(row0 + x, beam_of[e >> 1], n) ? acc[e] * ksc[n] * p.scale : -INFINITY;
          }
        }
      }
      __syncthreads();

      // the online softmax, 8 threads a query row: the new running max, the
      // rescale of what came before, P = exp(s - m) times the value scale
      {
        const int x = tid >> 3, sub = tid & 7;
        float* srow = S + x * lay.s_pitch;
        float mx = m_run[x];
        for (int n = sub; n < n_keys; n += 8) mx = fmaxf(mx, srow[n]);
#pragma unroll
        for (int off = 4; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        float sum = 0.f;
        for (int n = sub; n < n_keys; n += 8) {
          const float s = srow[n];
          const float e = s == -INFINITY ? 0.f : expf(s - mx);
          sum += e;
          srow[n] = e * vsc[n];
        }
#pragma unroll
        for (int off = 4; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (sub == 0) {
          // nothing to rescale while no key was valid (the running o and l are 0)
          const float a = m_run[x] == -INFINITY ? 0.f : expf(m_run[x] - mx);
          alpha[x] = a;
          l_run[x] = l_run[x] * a + sum;
          m_run[x] = mx;
        }
      }
      cp_async_wait<0>();
      __syncthreads();

      // P.V into the running o: warp w owns columns 32w .. 32w + 31 (four n8
      // tiles), the keys in 16-wide steps in the permuted order: thread (gq, t)
      // takes keys 4t .. 4t + 3 of the step
      {
        const float a0 = alpha[gq], a1 = alpha[gq + 8];
#pragma unroll
        for (int j = 0; j < D / 32; ++j) {
          o[j][0] *= a0, o[j][1] *= a0, o[j][2] *= a1, o[j][3] *= a1;
        }
      }
      for (int kb = 0; kb < n_keys; kb += 16) {
        const float4 p0 = *reinterpret_cast<const float4*>(S + gq * lay.s_pitch + kb + 4 * t);
        const float4 p1 = *reinterpret_cast<const float4*>(S + (gq + 8) * lay.s_pitch + kb + 4 * t);
        unsigned part[4][3], a[3][4];  // A fragment register r of term i: a[i][r]
        split_bf16(p0.x, p0.y, part[0]);
        split_bf16(p1.x, p1.y, part[1]);
        split_bf16(p0.z, p0.w, part[2]);
        split_bf16(p1.z, p1.w, part[3]);
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int r4 = 0; r4 < 4; ++r4) a[i][r4] = part[r4][i];
        const T* vrow = reinterpret_cast<const T*>(smem + lay.v_off + (kb + 4 * t) * L::V_PITCH);
        constexpr int VP = L::V_PITCH / sizeof(T);
#pragma unroll
        for (int j = 0; j < D / 32; ++j) {
          const int col = warp * (D / 4) + j * 8 + gq;
          const unsigned b0 = value_bits(vrow[col]) | value_bits(vrow[VP + col]) << 16;
          const unsigned b1 = value_bits(vrow[2 * VP + col]) | value_bits(vrow[3 * VP + col]) << 16;
          // each term's product from a zero accumulator, added in f32
          float c[3][4] = {};
#pragma unroll
          for (int i = 0; i < 3; ++i) mma(c[i], a[i], b0, b1);
#pragma unroll
          for (int e = 0; e < 4; ++e) o[j][e] += c[2][e] + c[1][e] + c[0][e];
        }
      }
    }
    __syncthreads();  // the running m and l are final
    cluster_wait();

    // the combine, pushed: unit u = (query row x, columns 4c .. 4c + 3) is
    // owned by block u % splits; every block writes its (m, l) to every block
    // and its o of each unit to the unit's owner, [u / splits][this block]
    const int owned = (UNITS + splits - 1) / splits;
    if (tid < ROWS * splits) {
      const int x = tid % ROWS, k = tid / ROWS;
      float* dst = cluster.map_shared_rank(rml, k) + r * 2 * ROWS;
      dst[x] = m_run[x] == -INFINITY ? mmvc::kNeg : m_run[x];
      dst[ROWS + x] = l_run[x];
    }
#pragma unroll
    for (int j = 0; j < D / 32; ++j) {
      const int col = warp * (D / 4) + j * 8 + 2 * t;
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int x = gq + 8 * h8;
        if (row0 + x < X) {
          const int u = x * (D / 4) + col / 4;
          float4* slot = cluster.map_shared_rank(ro, u % splits) + (u / splits) * splits + r;
          reinterpret_cast<float2*>(slot)[(col / 2) & 1] =
              make_float2(o[j][2 * h8], o[j][2 * h8 + 1]);
        }
      }
    }
    cluster_arrive();
    // every block's partial has arrived; no one writes to this block's memory
    // again before this tile's combine is done
    cluster_wait();

    // this block's units: every block's partial in block order
    for (int i = tid; i < owned; i += THREADS) {
      const int u = i * splits + r, x = u / (D / 4), col = (u % (D / 4)) * 4;
      const int xg = row0 + x;  // the query row
      if (xg >= X) continue;
      float M = mmvc::kNeg;
      for (int k = 0; k < splits; ++k) M = fmaxf(M, rml[k * 2 * ROWS + x]);
      // a block without a valid key adds exact zeros (o = 0, l = 0)
      float den = 0.f;
      float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < splits; ++k) {
        const float w = expf(rml[k * 2 * ROWS + x] - M);
        const float4 v = ro[i * splits + k];
        den += rml[k * 2 * ROWS + ROWS + x] * w;
        num.x += v.x * w;
        num.y += v.y * w;
        num.z += v.z * w;
        num.w += v.w * w;
      }
      const int beam = div_by(xg, p.rep_m);
      const size_t orow = size_t(b * K + beam) * p.h + gi * rep + xg - beam * rep;
      if constexpr (MODE == MERGED) {
        const float dd = fmaxf(den, 1e-30f);
        const float4 y = make_float4(num.x / dd, num.y / dd, num.z / dd, num.w / dd);
        if (p.out_f32) {
          *reinterpret_cast<float4*>(static_cast<float*>(p.out) + orow * D + col) = y;
        } else {
          uint2 w2;
          w2.x = pack_bf16(y.x, y.y);
          w2.y = pack_bf16(y.z, y.w);
          *reinterpret_cast<uint2*>(static_cast<bf16*>(p.out) + orow * D + col) = w2;
        }
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(p.out) + orow * D + col) = num;
        if (col == 0) {
          p.m_out[orow] = M;
          p.l_out[orow] = den;
        }
      }
    }
    // this block has read its combine buffers: the others may write the
    // next tile's into them (the wait before the next push)
    if (TILES && tile + 1 < p.tiles) cluster_arrive();
  }
}

// one __global__ name an entry, so that a profile tells them apart
template <typename T, bool TILES>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) prompt_attention_kernel(Args p) {
  decode_attention<T, PROMPT_PARTIALS, TILES>(p);
}

template <typename T, bool TILES, bool PIECES>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) gen_attention_kernel(Args p) {
  decode_attention<T, GEN_PARTIALS, TILES, PIECES>(p);
}

template <bool TILES, bool PIECES>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) ancestry_attention_kernel(Args p) {
  decode_attention<int8_t, MERGED, TILES, PIECES>(p);
}

// the instance for one query-row tile or for several, and for generated
// chunks of every source beam or in pieces (pieces only come with tiles:
// more beams than a slot's chunk fits)
template <typename T, int MODE>
int launch(Args p, int B, int splits, cudaStream_t stream) {
  p.kb = p.g_chunks ? p.kb : p.K;
  p.pieces = (p.K + p.kb - 1) / p.kb;
  p.keys = max(p.p_chunks ? p.cp : 0, p.g_chunks ? (p.kb * p.cg + 15) / 16 * 16 : 0);
  p.tiles = (p.K * (p.h / p.g) + ROWS - 1) / ROWS;
  p.cg_m = magic(max(p.cg, 1));
  p.rep_m = magic(p.h / p.g);
  const bool pieces = p.pieces > 1;
  if (pieces && p.tiles == 1) return cudaErrorInvalidValue;
  void (*kernel)(Args);
  if constexpr (MODE == MERGED)
    kernel = pieces ? ancestry_attention_kernel<true, true>
                    : p.tiles > 1 ? ancestry_attention_kernel<true, false>
                                  : ancestry_attention_kernel<false, false>;
  else if constexpr (MODE == GEN_PARTIALS)
    kernel = pieces ? gen_attention_kernel<T, true, true>
                    : p.tiles > 1 ? gen_attention_kernel<T, true, false>
                                  : gen_attention_kernel<T, false, false>;
  else
    kernel = p.tiles > 1 ? prompt_attention_kernel<T, true> : prompt_attention_kernel<T, false>;
  const int bytes = Smem<T>(p.keys, MODE == MERGED, pieces ? p.K * p.cg : p.keys).bytes;
  if (bytes > SMEM_MAX) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, p.g, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The shapes and the plan the kernel takes: d = 128, any K * rep < 2^16
// query rows a kv head; prompt chunks of cp slots (a multiple of 16, <= 128)
// that cover Tp; generated chunks of cg slots of kb source beams, kb * cg <=
// 128 key rows (or one slot of kb > 128 rows), ceil(K / kb) chunks a slot
// range (kb < K: one slot a chunk), that cover L; 1..8 splits, no more than
// the chunks.  The launch also refuses a plan whose shared memory passes 227
// KB.
bool plan_ok(const Args& p, int B, int d, int splits) {
  const bool dims = B > 0 && B <= 65535 && p.K > 0 && p.g > 0 && p.g <= 65535 && p.h > 0 &&
                    p.h % p.g == 0 && p.K * (p.h / p.g) < 65536 && d == D;
  const bool prompt = p.p_chunks == 0 ||
                      (p.cp > 0 && p.cp % 16 == 0 && p.cp <= MAX_KEYS &&
                       (p.p_chunks - 1) * p.cp < p.Tp && p.p_chunks * p.cp >= p.Tp);
  const int pieces = p.kb > 0 ? (p.K + p.kb - 1) / p.kb : 0, ranges = pieces ? p.g_chunks / pieces : 0;
  const bool gen = p.g_chunks == 0 ||
                   (p.cg > 0 && p.kb > 0 && p.kb <= p.K && (pieces == 1 || p.cg == 1) &&
                    ((p.kb * p.cg + 15) / 16 * 16 <= MAX_KEYS || p.cg == 1) &&
                    p.g_chunks % pieces == 0 && (ranges - 1) * p.cg < p.L && ranges * p.cg >= p.L);
  return dims && prompt && gen && splits >= 1 && splits <= MAX_SPLITS &&
         splits <= p.p_chunks + p.g_chunks;
}

}  // namespace

// K2.  q bf16 [B*K, h, d]; kv_bf16 = 0: int8 K/V [B, g, Tp, d] with f32
// scales pks/pvs [B, g, Tp]; kv_bf16 = 1: bf16 K/V, no scales; mask int32
// [B, Tp].  Partials out f32 [B*K, h, d], m, l [B*K, h].  The plan:
// p_chunks chunks of cp slots over `splits` blocks a (b, kv head).
extern "C" int mmvc_prompt_attention(const void* q, const void* pk, const void* pv,
                                     const void* pks, const void* pvs, const void* mask,
                                     void* out, void* m, void* l, int B, int K, int h, int g,
                                     int Tp, int d, int cp, int p_chunks, int splits,
                                     float scale, int kv_bf16, void* stream) {
  Args p{static_cast<const bf16*>(q), pk, pv, static_cast<const float*>(pks),
         static_cast<const float*>(pvs), static_cast<const int*>(mask), nullptr, nullptr,
         nullptr, nullptr, nullptr, out, static_cast<float*>(m), static_cast<float*>(l), K, h,
         g, Tp, 0, 0, cp, p_chunks, 0, 0, 0, 0, 0, 0, scale};
  if (!plan_ok(p, B, d, splits) || p_chunks < 1 || (!kv_bf16 && (!pks || !pvs)))
    return cudaErrorInvalidValue;
  if (kv_bf16) p.pks = p.pvs = nullptr;
  auto st = static_cast<cudaStream_t>(stream);
  return kv_bf16 ? launch<bf16, PROMPT_PARTIALS>(p, B, splits, st)
                 : launch<int8_t, PROMPT_PARTIALS>(p, B, splits, st);
}

// K3.  kv as K2's; K/V [B*K, L, g, d], scales [B*K, L, g]; anc int32 [B*K, L]
// (clamped to 0..K-1); valid_len clamped to 0..L.  Partials as K2's.  The
// plan: g_chunks chunks of cg slots of kb source beams over `splits` blocks.
extern "C" int mmvc_gen_attention_ancestor(const void* q, const void* gk, const void* gv,
                                           const void* gks, const void* gvs, const void* anc,
                                           int valid, void* out, void* m, void* l, int B, int K,
                                           int h, int g, int L, int d, int cg, int g_chunks,
                                           int splits, int kb, float scale, int kv_bf16,
                                           void* stream) {
  Args p{static_cast<const bf16*>(q), nullptr, nullptr, nullptr, nullptr, nullptr, gk, gv,
         static_cast<const float*>(gks), static_cast<const float*>(gvs),
         static_cast<const int*>(anc), out, static_cast<float*>(m), static_cast<float*>(l), K,
         h, g, 0, L, min(max(valid, 0), L), 0, 0, cg, g_chunks, 0, 0, 0, 0, scale, 0, kb};
  if (!plan_ok(p, B, d, splits) || g_chunks < 1 || (!kv_bf16 && (!gks || !gvs)))
    return cudaErrorInvalidValue;
  if (kv_bf16) p.gks = p.gvs = nullptr;
  auto st = static_cast<cudaStream_t>(stream);
  return kv_bf16 ? launch<bf16, GEN_PARTIALS>(p, B, splits, st)
                 : launch<int8_t, GEN_PARTIALS>(p, B, splits, st);
}

// The merged entry: K2's and K3's int8 operands (both scales required), both
// segments combined and normalised into out [B*K, h, d], f32 if out_f32 else
// bf16.  The plan: p_chunks + g_chunks chunks (generated: of kb source
// beams) over `splits` blocks.
extern "C" int mmvc_ancestry_attention(const void* q, const void* pk, const void* pv,
                                       const void* pks, const void* pvs, const void* mask,
                                       const void* gk, const void* gv, const void* gks,
                                       const void* gvs, const void* anc, int valid, void* out,
                                       int B, int K, int h, int g, int Tp, int L, int d, int cp,
                                       int p_chunks, int cg, int g_chunks, int splits, int kb,
                                       float scale, int out_f32, void* stream) {
  const Args p{static_cast<const bf16*>(q), pk, pv, static_cast<const float*>(pks),
               static_cast<const float*>(pvs), static_cast<const int*>(mask), gk, gv,
               static_cast<const float*>(gks), static_cast<const float*>(gvs),
               static_cast<const int*>(anc), out, nullptr, nullptr, K, h, g, Tp, L,
               min(max(valid, 0), L), cp, p_chunks, cg, g_chunks, 0, 0, 0, out_f32, scale, 0,
               kb};
  if (!plan_ok(p, B, d, splits) || p_chunks < 1 || g_chunks < 1 || !pks || !pvs || !gks ||
      !gvs)
    return cudaErrorInvalidValue;
  return launch<int8_t, MERGED>(p, B, splits,
                        static_cast<cudaStream_t>(stream));
}
