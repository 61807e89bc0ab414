// K7 · int8_matmul and K8 · int4_matmul: the weight-only quantized matmuls
// of the decode, one kernel template on one schedule, with the weight format
// as its parameter.
//
// K7 (W8A16): y = (bf16(x) @ bf16(w_q)) * scale with f32 accumulation, the
// f32 column scale applied to the f32 sum, then the cast to bf16 or f32.
// Replaces multimodalvc_tpu/ops/int8_matmul.py: int8_matmul (pallas_call at
// :113, body _int8_matmul_kernel :26).  W is int8 [d_in, d_out] with one f32
// scale per output column.
// K8 (W4A16): y = bf16(x) @ W with f32 accumulation and no scale after the
// sum, each weight bf16(bf16(nibble) * bf16(scale)).  Replaces int4_matmul
// (pallas_call at :326, body _int4_matmul_kernel :209).  W is int8 [d_in/2,
// d_out], two nibbles a byte split half and half along d_in (packed[r] =
// lo(q[r]) | q[r + d_in/2] << 4), with one f32 scale per (group of `qgroup`
// logical rows, column).
// Both layouts are byte for byte the JAX package's, so one checkpoint serves
// both packages.
//
// What bounds them on the H100: the weight bytes.  At the decode's 40-240
// rows K7 does 2 * rows flops a weight byte and K8 4 * rows, far under the
// ~295 a byte at which the bf16 tensor cores would bound them; a decode step
// of the 3B trunk plus the tied unembed reads ~3.2 GB of int8 weight (0.96
// ms at 3.35 TB/s) or half that in int4.  To stream at that rate each SM
// needs ~20 KB of loads in flight (Little's law at ~1 us of device-memory
// latency), and every SM has to take part.
//
// The schedule (ops/int8_matmul.py: k7_plan and k8_plan choose splits, KC,
// the row tile and the sum's groups; the C entries only check them):
// - grid (row tiles, d_out / 128, splits).  A block owns 128 output columns,
//   so each weight row it reads is one full 128-byte line, one row tile of
//   at most 64 rows, and one K chunk of KC weight rows (K8: packed rows;
//   split-K).  The plan takes the fewest splits that give the grid 128
//   blocks (KC >= 128); the unembed's 1002 column tiles need none.
// - a ring of STAGES cp.async stages in shared memory, each 32 weight rows x
//   128 columns (4 KB) and the same 32 columns of the row tile's x (bf16,
//   L2-resident): 6 stages, 24 KB of weight, in flight a block.  x streams
//   beside the weights instead of being loaded once, because the unsplit
//   unembed's x slice (40 rows x 3072 bf16, 240 KB) does not fit.  A K8
//   stage also holds the x columns of the high nibbles (d_in/2 further on)
//   and the two scale rows of its 32 packed rows, one a half: a stage lies
//   in one scale group of each half because qgroup % 32 == 0.
// - the products run on the tensor cores as mma.sync.m16n8k16 (bf16 in, f32
//   accumulate) with the weights on the M side, out^T = W^T x^T: 40 rows are
//   five n8 tiles, no dead rows.  A warp owns 32 columns.  Each thread reads
//   4 bytes (4 columns) from each of 2 consecutive weight rows and makes one
//   bf16 pair a column, exactly (Int8Weights, Int4Weights below); a K8 pair
//   of words feeds two products, the low nibbles with x's first half and the
//   high nibbles with its second.  Thread g holds columns 4g..4g+3, so the
//   fragments' M rows are a permutation of the columns, which the epilogue
//   undoes.
// - one launch a call, deterministic.  With one split the epilogue stores
//   from registers (K7 scales first).  Otherwise each split writes its f32
//   partial tile to the workspace [splits, rows, d_out] and counts its
//   arrival; the partials are summed in a fixed order (below), so the output
//   has the same bits from run to run whichever block arrives last, and each
//   counter is set back to 0 once all it counts have arrived, for the next
//   launch (a graph replay included).  The counters belong to one stream at
//   a time; K7 and K8 each have their own.
// No TMA, wgmma, clusters or persistent blocks: at these rows the tensor
// cores idle most of the time either way.
#include <type_traits>

#include "common.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int BN = 128;                 // output columns a block
constexpr int KS = 32;                  // weight rows (K8: packed rows) a stage
constexpr int STAGES = 6;
constexpr int THREADS = 128;            // 4 warps, 32 columns each
// shared-memory pitches in bytes.  Weight rows: +16 shifts row r by 4r banks,
// so the rows 2t, 2t+1, 2t+8, 2t+9 that a warp's four thread groups read
// land on disjoint banks.  x rows: 80 bytes, conflict-free for ldmatrix.
constexpr int W_PITCH = BN + 16;
constexpr int X_PITCH = KS * 2 + 16;
constexpr int W_STAGE = KS * W_PITCH;

struct Args {
  const bf16* x;         // [rows, d_in]
  const int8_t* w;       // K7 [d_in, d_out]; K8 [d_in / 2, d_out]
  const float* scale;    // K7 [d_out]; K8 [d_in / qgroup, d_out]
  void* out;             // [rows, d_out], f32 if out_f32 else bf16
  float* ws;             // [splits, rows, d_out] with splits > 1
  int* counters;
  int rows, d_in, d_out;
  int kc;                // weight rows (K8: packed rows) a split
  int sum_group;         // splits summed together first
  int qgroup;            // K8: logical rows a scale
  int out_f32;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, through L2 only; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned fma_bf16x2(unsigned a, unsigned b, unsigned c) {
  unsigned d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// ---- the weight formats -----------------------------------------------------
// Each says what a stage holds beside its weight tile (x slices and scale
// bytes), how a thread turns the words it reads (4 columns of weight rows
// 2t, 2t+1, 2t+8, 2t+9 of a 16-row step) into the A fragments of x slice H,
// and whether a column scale follows the sum.  Fragment m's M row g is the
// thread's column 2m (byte 2m of each word), its row g + 8 column 2m + 1.
// The loops over H are unrolled, so H is a constant wherever it is used.

// K7: int8 rows, one x slice, the column scale applied to the sum.
struct Int8Weights {
  static constexpr int X_SLICES = 1;
  static constexpr int SCALE_BYTES = 0;
  static constexpr bool COLUMN_SCALE = true;

  // Byte B of lo and of hi (weight rows k and k+1 of one column, each byte
  // already XORed with 0x80) -> bf16x2 {w[k], w[k+1]}, exactly.
  template <int B>
  __device__ __forceinline__ static unsigned pair(unsigned lo, unsigned hi) {
    constexpr unsigned sel = 0x7540u + B;  // byte B, 0, 0, 0x4B: 2^23 + (b ^ 0x80)
    const float a = __uint_as_float(__byte_perm(lo, 0x4B000000u, sel)) - 8388736.0f;
    const float b = __uint_as_float(__byte_perm(hi, 0x4B000000u, sel)) - 8388736.0f;
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const unsigned*>(&v);
  }

  __device__ __forceinline__ static void scales(unsigned (&)[X_SLICES][4], const unsigned char*,
                                                int) {}

  __device__ __forceinline__ static void fragments(unsigned (&a)[2][4], const unsigned (&w)[4],
                                                   const unsigned (&)[4], int) {
    const unsigned w0 = w[0] ^ 0x80808080u, w1 = w[1] ^ 0x80808080u;
    const unsigned w2 = w[2] ^ 0x80808080u, w3 = w[3] ^ 0x80808080u;
    a[0][0] = pair<0>(w0, w1), a[0][1] = pair<1>(w0, w1);
    a[0][2] = pair<0>(w2, w3), a[0][3] = pair<1>(w2, w3);
    a[1][0] = pair<2>(w0, w1), a[1][1] = pair<3>(w0, w1);
    a[1][2] = pair<2>(w2, w3), a[1][3] = pair<3>(w2, w3);
  }
};

// K8: packed rows whose low nibbles are logical rows k and whose high
// nibbles are rows d_in/2 + k; x slice 0 is x's columns k, slice 1 its
// columns d_in/2 + k.  The stage's scale rows [2][BN] f32 follow its x.
struct Int4Weights {
  static constexpr int X_SLICES = 2;
  static constexpr int SCALE_BYTES = 2 * BN * 4;
  static constexpr bool COLUMN_SCALE = false;

  // Nibble 0 of byte B of lo and of hi (rows k and k+1 of one column) ->
  // bf16x2 {bf16(n[k] * s), bf16(n[k+1] * s)} for s2 = {s, s} in bf16,
  // exactly as bf16(n) * bf16(s) rounds: one lop3 makes each the bf16 128 +
  // (n ^ 8) (n sign-extended is (n ^ 8) - 8), one fma subtracts 136, exactly,
  // one fma multiplies, exact until its one rounding (4 x 8 significant bits).
  template <int B>
  __device__ __forceinline__ static unsigned pair(unsigned lo, unsigned hi, unsigned s2) {
    const unsigned v = (__byte_perm(lo, hi, B | (4 + B) << 8) & 0x000F000Fu) ^ 0x43084308u;
    const unsigned n = fma_bf16x2(v, 0x3F803F80u, 0xC308C308u);  // v * 1 - 136
    return fma_bf16x2(n, s2, 0x80008000u);                       // n * s - 0
  }

  // this thread's 4 columns of both scale rows, each as the bf16 pair {s, s}
  __device__ __forceinline__ static void scales(unsigned (&s)[X_SLICES][4],
                                                const unsigned char* rows, int col) {
#pragma unroll
    for (int h = 0; h < X_SLICES; ++h) {
      const float4 f = *reinterpret_cast<const float4*>(rows + (h * BN + col) * 4);
      const float v[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(v[c], v[c]);
        s[h][c] = *reinterpret_cast<const unsigned*>(&p);
      }
    }
  }

  __device__ __forceinline__ static void fragments(unsigned (&a)[2][4], const unsigned (&w)[4],
                                                   const unsigned (&s)[4], int H) {
    // the high nibbles of every byte moved down to its low nibble
    const unsigned w0 = w[0] >> (4 * H), w1 = w[1] >> (4 * H);
    const unsigned w2 = w[2] >> (4 * H), w3 = w[3] >> (4 * H);
    a[0][0] = pair<0>(w0, w1, s[0]), a[0][1] = pair<1>(w0, w1, s[1]);
    a[0][2] = pair<0>(w2, w3, s[0]), a[0][3] = pair<1>(w2, w3, s[1]);
    a[1][0] = pair<2>(w0, w1, s[2]), a[1][1] = pair<3>(w0, w1, s[3]);
    a[1][2] = pair<2>(w2, w3, s[2]), a[1][3] = pair<3>(w2, w3, s[3]);
  }
};

template <class F>
__host__ __device__ constexpr int stage_bytes(int row_tile) {
  return W_STAGE + F::X_SLICES * row_tile * X_PITCH + F::SCALE_BYTES;
}

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void store4(void* out, size_t o, float4 v, int out_f32) {
  if (out_f32) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + o) = v;
  } else {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<bf16*>(out) + o) = u;
  }
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// Weight format F, NT n8 tiles: a row tile of 8 * NT rows.
template <class F, int NT>
__device__ __forceinline__ void quant_matmul(const Args& p) {
  constexpr int RT = 8 * NT;
  constexpr int X_SLICE = RT * X_PITCH;
  constexpr int STAGE = stage_bytes<F>(RT);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int is_last;

  const int rows = p.rows, d_in = p.d_in, d_out = p.d_out;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * RT, col0 = blockIdx.y * BN;
  const int split = blockIdx.z, splits = gridDim.z;
  const int k0 = split * p.kc, steps = p.kc / KS;

  auto load = [&](int s) {
    unsigned char* st = smem + (s % STAGES) * STAGE;
    const int kb = k0 + s * KS;
#pragma unroll
    for (int j = 0; j < KS * BN / 16 / THREADS; ++j) {  // weight: 32 rows of 8 x 16 B
      const int i = tid + j * THREADS, r = i >> 3, c = (i & 7) * 16;
      cp_async16(smem_addr(st + r * W_PITCH + c), p.w + size_t(kb + r) * d_out + col0 + c, 16);
    }
#pragma unroll
    for (int h = 0; h < F::X_SLICES; ++h) {  // K8's slice 1: d_in / 2 further on
      const int xk = kb + h * (d_in / 2);
#pragma unroll
      for (int j = 0; j < (RT * 4 + THREADS - 1) / THREADS; ++j) {  // x: RT rows of 4 x 16 B
        const int i = tid + j * THREADS, r = i >> 2, c = (i & 3) * 8;
        if (i < RT * 4) {
          const bool valid = row0 + r < rows;  // rows past the end read as zeros
          cp_async16(smem_addr(st + W_STAGE + h * X_SLICE + r * X_PITCH + c * 2),
                     p.x + size_t(valid ? row0 + r : 0) * d_in + xk + c, valid ? 16 : 0);
        }
      }
    }
    if constexpr (F::SCALE_BYTES > 0) {  // K8: scale row h of the group of kb + h * d_in / 2
      if (tid < F::SCALE_BYTES / 16) {
        const int h = tid / (BN / 4), c = (tid % (BN / 4)) * 4;
        const int srow = (kb + h * (d_in / 2)) / p.qgroup;
        cp_async16(smem_addr(st + W_STAGE + F::X_SLICES * X_SLICE + (h * BN + c) * 4),
                   p.scale + size_t(srow) * d_out + col0 + c, 16);
      }
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s landed for every thread; stage s-1 is free
    if (s + STAGES - 1 < steps) load(s + STAGES - 1);
    cp_async_commit();
    const unsigned char* st = smem + (s % STAGES) * STAGE;
    const unsigned xs = smem_addr(st + W_STAGE);
    unsigned sc[F::X_SLICES][4];
    F::scales(sc, st + W_STAGE + F::X_SLICES * X_SLICE, warp * 32 + 4 * g);
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      // A: weight rows 16kk + 2t + {0, 1, 8, 9}, columns 32 warp + 4g + {0..3}
      const unsigned char* wp = st + (kk * 16 + 2 * t) * W_PITCH + warp * 32 + 4 * g;
      const unsigned w[4] = {
          *reinterpret_cast<const unsigned*>(wp), *reinterpret_cast<const unsigned*>(wp + W_PITCH),
          *reinterpret_cast<const unsigned*>(wp + 8 * W_PITCH),
          *reinterpret_cast<const unsigned*>(wp + 9 * W_PITCH)};
      // B: x rows of n tile j, k columns 16kk..16kk+15 of slice h (ldmatrix
      // matrix q of lane 8q + r: row r of n tile j + q / 2, k half q % 2)
      const int q = lane >> 3, r = lane & 7;
#pragma unroll
      for (int h = 0; h < F::X_SLICES; ++h) {
        unsigned a[2][4];
        F::fragments(a, w, sc[h], h);
        const unsigned xh = xs + h * X_SLICE;
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          if (j + 1 < NT) {
            unsigned b[4];
            ldmatrix_x4(b, xh + ((j + (q >> 1)) * 8 + r) * X_PITCH + (kk * 16 + (q & 1) * 8) * 2);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              mma(acc[m][j], a[m], b[0], b[1]);
              mma(acc[m][j + 1], a[m], b[2], b[3]);
            }
          } else {
            unsigned b[2];
            ldmatrix_x2(b, xh + (j * 8 + r) * X_PITCH + (kk * 16 + (q & 1) * 8) * 2);
#pragma unroll
            for (int m = 0; m < 2; ++m) mma(acc[m][j], a[m], b[0], b[1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups remain; leave none behind

  // This thread's sums: columns col .. col + 3 of rows row0 + 8j + 2t + e.
  // The split-K partials are exchanged in the same layout, so a block that
  // sums them keeps its own in registers.
  const int col = col0 + warp * 32 + 4 * g;
  float4 v[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      v[j][e] = make_float4(acc[0][j][e], acc[0][j][2 + e], acc[1][j][e], acc[1][j][2 + e]);
  auto row_of = [&](int j, int e) { return row0 + 8 * j + 2 * t + e; };
  auto finish = [&]() {
    float4 sc = make_float4(1.f, 1.f, 1.f, 1.f);
    if constexpr (F::COLUMN_SCALE) sc = *reinterpret_cast<const float4*>(p.scale + col);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (row_of(j, e) < rows)
          store4(p.out, size_t(row_of(j, e)) * d_out + col,
                 F::COLUMN_SCALE ? mul4(v[j][e], sc) : v[j][e], p.out_f32);
  };
  if (splits == 1) {
    finish();
    return;
  }

  // Split-K: the partials of one tile are summed in a fixed order, whichever
  // block arrives when.  Splits form groups of `sum_group`; the last block of
  // a group to arrive sums the group's partials in split order and, with
  // more than one group, writes that sum over the group's first slot; the
  // last group to finish sums the groups' sums in group order.  With many
  // splits the two levels spread the reading of the partials, which one
  // block does slowly, over several SMs.
  const size_t split_stride = size_t(rows) * d_out;
  auto slot = [&](int s, int j, int e) {
    return reinterpret_cast<float4*>(p.ws + s * split_stride + size_t(row_of(j, e)) * d_out + col);
  };
  auto publish = [&](int s) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (row_of(j, e) < rows) __stcg(slot(s, j, e), v[j][e]);
  };
  // true in every thread of the last of n blocks to arrive at *count
  auto arrive = [&](int* count, int n) {
    __threadfence();  // this block's slot is visible device-wide before the count
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(count, 1) == n - 1;
    __syncthreads();
    const bool last = is_last;
    if (last) __threadfence();
    return last;
  };
  // v = the sum of the slots base, base + step, ... (n of them) in that
  // order, this block's own v standing in for slot number `own` where the
  // registers allow (8 n tiles would need 3 x 64 for v, the sum and the loads)
  constexpr bool KEEP_OWN = NT <= 5;
  auto ordered_sum = [&](int base, int step, int n, int own) {
    float4 sum[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) sum[j][e] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < n; ++k) {
      float4 u[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          u[j][e] = KEEP_OWN && k == own ? v[j][e]
                    : row_of(j, e) < rows ? __ldcg(slot(base + k * step, j, e))
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // the first term is added to zero, exactly
          sum[j][e].x += u[j][e].x;
          sum[j][e].y += u[j][e].y;
          sum[j][e].z += u[j][e].z;
          sum[j][e].w += u[j][e].w;
        }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) v[j][e] = sum[j][e];
  };

  const int group = p.sum_group;
  const int groups = (splits + group - 1) / group, gi = split / group;
  const int first = gi * group, members = min(group, splits - first);
  int* count = p.counters + (blockIdx.y * gridDim.x + blockIdx.x) * (groups > 1 ? groups + 1 : 1);
  publish(split);
  if (!arrive(count + (groups > 1 ? gi : 0), members)) return;
  ordered_sum(first, 1, members, split - first);
  if (tid == 0) count[groups > 1 ? gi : 0] = 0;  // every member has arrived
  if (groups > 1) {
    publish(first);
    if (!arrive(count + groups, groups)) return;
    ordered_sum(0, group, groups, gi);
    if (tid == 0) count[groups] = 0;
  }
  finish();
}

template <int NT>
__global__ void __launch_bounds__(THREADS) int8_matmul_kernel(Args p) {
  quant_matmul<Int8Weights, NT>(p);
}

template <int NT>
__global__ void __launch_bounds__(THREADS) int4_matmul_kernel(Args p) {
  quant_matmul<Int4Weights, NT>(p);
}

template <class F, int NT>
int launch(const Args& p, int splits, cudaStream_t stream) {
  void (*kernel)(Args) =
      std::is_same<F, Int8Weights>::value ? int8_matmul_kernel<NT> : int4_matmul_kernel<NT>;
  const int smem = STAGES * stage_bytes<F>(8 * NT);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.rows + 8 * NT - 1) / (8 * NT), p.d_out / BN, splits);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <class F>
int dispatch(const Args& p, int splits, int row_tile, cudaStream_t stream) {
  switch (row_tile / 8) {
    case 1: return launch<F, 1>(p, splits, stream);
    case 2: return launch<F, 2>(p, splits, stream);
    case 3: return launch<F, 3>(p, splits, stream);
    case 4: return launch<F, 4>(p, splits, stream);
    case 5: return launch<F, 5>(p, splits, stream);
    case 6: return launch<F, 6>(p, splits, stream);
    case 7: return launch<F, 7>(p, splits, stream);
    case 8: return launch<F, 8>(p, splits, stream);
  }
  return cudaErrorInvalidValue;
}

// The plan over k_rows weight rows: splits x kc == k_rows, kc % 32 == 0,
// row_tile in 8..64 and % 8 == 0; a workspace and counters with splits > 1.
bool plan_ok(int rows, int k_rows, int d_out, int splits, int kc, int group, int row_tile,
             const void* ws, const void* counters) {
  return rows > 0 && d_out > 0 && d_out % BN == 0 && d_out / BN <= 65535 && splits > 0 &&
         splits <= 65535 && kc > 0 && kc % KS == 0 &&
         static_cast<long long>(kc) * splits == k_rows && row_tile >= 8 && row_tile <= 64 &&
         row_tile % 8 == 0 && group > 0 && (splits == 1 || (ws && counters));
}

}  // namespace

// K7.  x bf16 [rows, d_in]; w int8 [d_in, d_out]; scale f32 [d_out]; out
// [rows, d_out], f32 if out_f32 else bf16.  The plan over d_in weight rows
// (plan_ok); with splits > 1, ws f32 [splits, rows, d_out] and counters
// int32, one per (row tile, column tile) and sum group, all 0.
extern "C" int mmvc_int8_matmul(const void* x, const void* w, const void* scale, void* out,
                                void* ws, void* counters, int rows, int d_in, int d_out,
                                int splits, int kc, int group, int row_tile, int out_f32,
                                void* stream) {
  if (!plan_ok(rows, d_in, d_out, splits, kc, group, row_tile, ws, counters))
    return cudaErrorInvalidValue;
  const Args p{static_cast<const bf16*>(x), static_cast<const int8_t*>(w),
               static_cast<const float*>(scale), out, static_cast<float*>(ws),
               static_cast<int*>(counters), rows, d_in, d_out, kc, group, 0, out_f32};
  return dispatch<Int8Weights>(p, splits, row_tile, static_cast<cudaStream_t>(stream));
}

// K8.  x bf16 [rows, d_in]; w int8 [d_in / 2, d_out] half-split nibbles;
// scale f32 [d_in / qgroup, d_out]; out as K7's.  The plan over the d_in / 2
// packed rows (plan_ok); qgroup % 32 == 0 so that every stage lies in one
// scale group of each half, and (d_in / 2) % qgroup == 0.
extern "C" int mmvc_int4_matmul(const void* x, const void* w, const void* scale, void* out,
                                void* ws, void* counters, int rows, int d_in, int d_out,
                                int splits, int kc, int group, int row_tile, int qgroup,
                                int out_f32, void* stream) {
  if (d_in <= 0 || d_in % 2 || qgroup <= 0 || qgroup % KS || (d_in / 2) % qgroup ||
      !plan_ok(rows, d_in / 2, d_out, splits, kc, group, row_tile, ws, counters))
    return cudaErrorInvalidValue;
  const Args p{static_cast<const bf16*>(x), static_cast<const int8_t*>(w),
               static_cast<const float*>(scale), out, static_cast<float*>(ws),
               static_cast<int*>(counters), rows, d_in, d_out, kc, group, qgroup, out_f32};
  return dispatch<Int4Weights>(p, splits, row_tile, static_cast<cudaStream_t>(stream));
}
