// K1 · forward flash attention with an f32 online softmax (bf16 in, bf16 out).
//
// Replaces the Pallas kernel multimodalvc_tpu/ops/attention.py:
// flash_attention -> _flash_attention_impl (pallas_call at :328), body
// _flash_kernel (:61).  Same contract: q,k,v [B,H,T,D], D in {64, 128}; key
// window per batch row [kv_start, kv_len), optionally causal (col <= row);
// scores scaled after the q.k product; P rounded to bf16 before P.V; the
// output divided by max(l, 1e-30), so a row with no valid key gives exact
// zeros.
//
// What bounds it on the H100.  At the Whisper encoder shape [8,16,1536,64]
// with 1500 keys the work is 7.55e10 tensor-core operations over the allowed
// key pairs, 76.3 us at 989 TFLOP/s, against 99 MB of q/k/v/out (30 us at
// 3.35 TB/s): tensor-core issue bounds it.  At D=64 the exponentials (one
// MUFU op per score, 16 a clock per SM) need about as long again, so the
// special-function unit and the tensor cores have to run side by side.  At
// the AV-HuBERT [8,16,400,64] and LLaMA prefill shapes the bytes bound it.
//
// Design (Hopper, FlashAttention-3 structure).  A block is one consumer
// warpgroup, which owns 64 query rows of one (b, h), and one producer warp;
// up to three blocks share an SM.  The producer's elected thread brings Q
// once and the K/V tiles into a STAGES-deep ring by TMA
// (cp.async.bulk.tensor through 3-D tensor maps [B*H, T, D], so a tile past
// T is zero-filled and never reads the next head), with mbarrier expect-tx
// completion; the consumer releases a stage with one arrival per warp.
// Tiles land with the 128-byte swizzle, one 64-column (128-byte) box per
// half row at D=128.  S = Q.K^T is wgmma m64n64k16 with both operands
// K-major in shared memory; P, converted to bf16 pairs in registers, is the
// register A operand of O += P.V, wgmma m64nDk16 with V MN-major (the
// transposed B); S, P and the f32 O accumulator never leave the registers.
// The two products are software-pipelined: Q.K^T of tile j and P.V of tile
// j-1 are issued together, and the softmax of tile j runs while P.V of tile
// j-1 is on the tensor cores.  Each thread holds two rows of every 8-column
// block, so the row max needs two shuffles inside the quad.  The softmax
// works in the log2 domain: scale * log2(e) folded into one FMA before the
// ex2 instruction (ex2.approx.ftz written out in the source: the build has
// no fast-math).  The column and causal comparisons run only on tiles that
// straddle kv_start, kv_len or the diagonal, tiles wholly outside the
// window are never loaded, and a row whose keys are all masked so far keeps
// p = 0 (never exp(-inf - -inf)).  The output is staged through the warp's
// own Q rows and written with 16-byte stores.
#include <cuda.h>

#include "common.cuh"

using bf16 = __nv_bfloat16;

namespace {

// Keys per tile and K/V stages in the ring, for each head dim, from a sweep
// at the encoder and prefill shapes on the H100 (PERF.md §6): 64 keys a tile
// at both; 4 stages at D=64 (74 KB, three blocks an SM; 128 keys x 3 stages
// was ~2% slower at Whisper), 2 stages at D=128 (83 KB, two blocks an SM).
template <int D>
struct TileFor;
template <>
struct TileFor<64> {
  static constexpr int BK = 64, STAGES = 4;
};
template <>
struct TileFor<128> {
  static constexpr int BK = 64, STAGES = 2;
};

// 2^x on the special-function unit (inf -> 0, denormal results flushed)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait for the phase of `bar` with this parity to complete; a wait that
// outlasts ~2^34 clocks (seconds) is a fault, and traps rather than hangs
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  const long long t0 = clock64();
  uint32_t done;
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

// one box of a 3-D tensor map (coordinates innermost first) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | uint64_t(lbo >> 4) << 16 |
         uint64_t(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// registers written by an asynchronous wgmma are read only after its wait,
// and registers it reads stay untouched until then
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// wgmma m64nNk16, bf16 x bf16 -> f32.  Accumulator d: warp w of the
// warpgroup holds rows 16w + lane/4 (d[4j], d[4j+1]) and +8 (d[4j+2],
// d[4j+3]) of columns 8j + 2*(lane%4) + {0, 1}.  _ss: A and B from shared
// memory, K-major; `accumulate` 0 overwrites d.  _rs: A from registers, in
// the m16n8k16 A-fragment layout of the warp's 16 rows, B MN-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n128(d, a, b);
}

template <int D, int BK_, int STAGES_>
struct Tile {
  static constexpr int BQ = 64;           // query rows per block: one warpgroup
  static constexpr int BK = BK_;          // keys per tile
  static constexpr int STAGES = STAGES_;  // K/V tiles in flight
  static constexpr int THREADS = 128 + 32;  // the warpgroup and one producer warp
  static constexpr int BOXES = D / 64;             // 64-column (128-byte) boxes a row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one K or one V tile
  // 1024 bytes of slack: the swizzle pattern repeats every 1024 bytes, so
  // every tile starts on such a boundary
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES;
  // S = Q.K^T of a tile is one m64n64k16 product per k-step
  static_assert(BK == 64 && (D == 64 || D == 128), "tile shape");
};

// byte offset of 16-byte chunk c of row r in an R-row tile as TMA lands it:
// 64-column boxes one after another, 128-byte rows, chunks XOR-swizzled
template <int R>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

template <int D, int BK, int STAGES>
__global__ void __launch_bounds__(Tile<D, BK, STAGES>::THREADS)
flash_fwd(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ kv_lens,
          const int* __restrict__ kv_starts, bf16* __restrict__ out, int H, int Tq, int Tk,
          int causal, float scale_log2) {
  using T = Tile<D, BK, STAGES>;
  constexpr int NT = BK / 8, DT = D / 8;
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];  // Q, full[s], empty[s]
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (sq - raw);
  const uint32_t skv = sq + T::Q_BYTES;  // stage s: K at skv + 2s KV_BYTES, V right after
  const uint32_t bar_q = smem_addr(&bars[0]);
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_q + 8 * (1 + STAGES);

  const int b = blockIdx.z, h = blockIdx.y;
  // the causal tiles with the most keys first
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * T::BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int head = b * H + h;
  const int kv_len = min(kv_lens[b], Tk);
  const int kv_start = max(kv_starts[b], 0);

  // live key tiles of this query tile
  int hi = kv_len;
  if (causal) hi = min(hi, min(q0 + T::BQ, Tq));
  const int kb_begin = kv_start / BK;
  const int n_tiles = hi > kv_start ? (hi + BK - 1) / BK - kb_begin : 0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp: one thread issues every copy
    if (lane == 0) {
      mbar_expect_tx(bar_q, T::Q_BYTES);
      for (int x = 0; x < T::BOXES; ++x)
        tma_load(sq + x * T::BQ * 128, &tm_q, 64 * x, q0, head, bar_q);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES, k0 = (kb_begin + j) * BK;
        if (j >= STAGES) mbar_wait(bar_empty + 8 * s, (j / STAGES - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * T::KV_BYTES);
        const uint32_t sk = skv + s * 2 * T::KV_BYTES;
        for (int x = 0; x < T::BOXES; ++x) {
          tma_load(sk + x * BK * 128, &tm_k, 64 * x, k0, head, bar_full + 8 * s);
          tma_load(sk + T::KV_BYTES + x * BK * 128, &tm_v, 64 * x, k0, head, bar_full + 8 * s);
        }
      }
    }
    return;
  }

  const int w_lo = q0 + 16 * warp;       // this warp's first row in the sequence
  const int row0 = w_lo + (lane >> 2);  // this thread's rows: row0 and row0 + 8

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // S[64 x BK] = Q[64 x D] . K^T of tile j (issued, not waited); k-step kk
  // lies in box kk/4 at byte 32 (kk%4)
  auto qk = [&](float (&s)[BK / 2], int j) {
    const uint32_t sk = skv + (j % STAGES) * 2 * T::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, smem_desc(sq + (kk >> 2) * T::BQ * 128 + (kk & 3) * 32, 16, 1024),
                   smem_desc(sk + (kk >> 2) * BK * 128 + (kk & 3) * 32, 16, 1024), kk > 0);
    wgmma_commit();
  };
  // O[64 x D] += P[64 x BK] . V[BK x D] of tile j (issued, not waited); V is
  // MN-major, its two boxes (D=128) BK*128 bytes apart, 16 keys = 2048 bytes
  auto pv = [&](const uint32_t (&p)[BK / 16][4], int j) {
    const uint32_t sv = skv + (j % STAGES) * 2 * T::KV_BYTES + T::KV_BYTES;
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
      wgmma_rs<D>(o, p[t], smem_desc(sv + t * 2048, BK * 128, 1024));
    wgmma_commit();
  };
  // mask and online softmax of tile j's scores in the log2 domain: the new
  // running max, l rescaled and summed, s replaced by p = exp2(s*c - max*c)
  // (f32), and the factor O must take
  auto softmax = [&](float (&s)[BK / 2], float (&alpha)[2], int j) {
    const int k0 = (kb_begin + j) * BK;
    // masks only where the tile straddles the window or this warp's diagonal
    if (k0 < kv_start || k0 + BK > kv_len || (causal && k0 + BK - 1 > w_lo)) {
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * jn + 2 * (lane & 3) + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (col < kv_start || col >= kv_len || (causal && col > row)) s[4 * jn + e] = -INFINITY;
        }
      }
    }
    // rows row0 (i = 0) and row0 + 8 (i = 1); a quad shares a row
    float mx[2] = {m[0], m[1]}, base[2];
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * jn], s[4 * jn + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * jn + 2], s[4 * jn + 3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // no valid key so far: p = exp2(-inf) = 0 and nothing is rescaled
      const bool any = mx[i] != -INFINITY;
      base[i] = any ? mx[i] * scale_log2 : 0.f;
      alpha[i] = any ? exp2_ftz(fmaf(m[i], scale_log2, -base[i])) : 1.f;
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * jn + e] = exp2_ftz(fmaf(s[4 * jn + e], scale_log2, -base[e >> 1]));
        l[e >> 1] += s[4 * jn + e];  // this thread's columns; the quad is summed at the end
      }
    }
  };
  // p in bf16 pairs: 8-column blocks 2t and 2t+1 are the A fragment of k-step t
  auto pack = [&](const float (&s)[BK / 2], uint32_t (&p)[BK / 16][4]) {
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      p[jn >> 1][2 * (jn & 1)] = pack_bf16(s[4 * jn], s[4 * jn + 1]);
      p[jn >> 1][2 * (jn & 1) + 1] = pack_bf16(s[4 * jn + 2], s[4 * jn + 3]);
    }
  };
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int jd = 0; jd < DT; ++jd) {
      o[4 * jd] *= alpha[0];
      o[4 * jd + 1] *= alpha[0];
      o[4 * jd + 2] *= alpha[1];
      o[4 * jd + 3] *= alpha[1];
    }
  };
  auto ready = [&](int j) {
    mbar_wait(bar_full + 8 * (j % STAGES), (j / STAGES) & 1);
    __syncwarp();  // wgmma wants the warp converged
  };
  auto release = [&](int j) {  // this warp is done with tile j's stage
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * (j % STAGES));
  };

  mbar_wait(bar_q, 0);
  if (n_tiles > 0) {
    // software pipeline: Q.K^T of tile j and P.V of tile j-1 are in flight
    // together, and the softmax of tile j runs while P.V of tile j-1 does
    uint32_t p[BK / 16][4];
    float alpha[2];
    {
      float s[BK / 2];
      ready(0);
      wgmma_fence();
      qk(s, 0);
      wgmma_wait<0>();
      fence_regs(s);
      softmax(s, alpha, 0);  // O is still zero
      pack(s, p);
    }
    for (int j = 1; j < n_tiles; ++j) {
      float s[BK / 2];
      ready(j);
      wgmma_fence();
      qk(s, j);
      rescale(alpha);  // O to tile j-1's running max
      wgmma_fence();
      pv(p, j - 1);
      wgmma_wait<1>();  // Q.K^T of tile j is done
      fence_regs(s);
      softmax(s, alpha, j);
      wgmma_wait<0>();  // and P.V of tile j-1
      fence_regs(o);
      fence_regs(p);  // p stays untouched until that P.V has read it
      release(j - 1);
      pack(s, p);
    }
    rescale(alpha);
    wgmma_fence();
    pv(p, n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    release(n_tiles - 1);
  }

  // normalise, stage the warp's 16 rows in its own Q rows (the last wgmma
  // that read them has completed), store 16 bytes a lane
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
  const int r = 16 * warp + (lane >> 2);  // row in the tile
#pragma unroll
  for (int jd = 0; jd < DT; ++jd) {
    const uint32_t byte = 4 * (lane & 3);
    *reinterpret_cast<uint32_t*>(smem + swz<T::BQ>(r, jd) + byte) =
        pack_bf16(o[4 * jd] * inv[0], o[4 * jd + 1] * inv[0]);
    *reinterpret_cast<uint32_t*>(smem + swz<T::BQ>(r + 8, jd) + byte) =
        pack_bf16(o[4 * jd + 2] * inv[1], o[4 * jd + 3] * inv[1]);
  }
  __syncwarp();
  bf16* oh = out + size_t(head) * Tq * D;
#pragma unroll
  for (int it = 0; it < 16 * DT / 32; ++it) {
    const int i = lane + 32 * it, rr = i / DT, c = i % DT;
    if (w_lo + rr < Tq)
      *reinterpret_cast<uint4*>(oh + size_t(w_lo + rr) * D + c * 8) =
          *reinterpret_cast<const uint4*>(smem + swz<T::BQ>(16 * warp + rr, c));
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so the
// library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [B*H, T, D] bf16 as a 3-D tensor map with [1, rows, 64] boxes, 128-byte
// swizzle; reads past T are zero-filled
int tensor_map(CUtensorMap* map, const void* ptr, int heads, int T, int D, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(T), cuuint64_t(heads)};
  const cuuint64_t strides[2] = {cuuint64_t(D) * 2, cuuint64_t(T) * D * 2};
  const cuuint32_t box[3] = {64, cuuint32_t(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* kv_lens,
           const void* kv_starts, void* out, int B, int H, int Tq, int Tk, int causal,
           float scale, cudaStream_t stream) {
  constexpr int BK = TileFor<D>::BK, STAGES = TileFor<D>::STAGES;
  using T = Tile<D, BK, STAGES>;
  CUtensorMap tm_q, tm_k, tm_v;
  int e = tensor_map(&tm_q, q, B * H, Tq, D, T::BQ);
  if (e == 0) e = tensor_map(&tm_k, k, B * H, Tk, D, BK);
  if (e == 0) e = tensor_map(&tm_v, v, B * H, Tk, D, BK);
  if (e != 0) return e;
  cudaError_t ce = cudaFuncSetAttribute(flash_fwd<D, BK, STAGES>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (ce != cudaSuccess) return ce;
  dim3 grid((Tq + T::BQ - 1) / T::BQ, H, B);
  flash_fwd<D, BK, STAGES><<<grid, T::THREADS, T::SMEM, stream>>>(
      tm_q, tm_k, tm_v, static_cast<const int*>(kv_lens), static_cast<const int*>(kv_starts),
      static_cast<bf16*>(out), H, Tq, Tk, causal, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mmvc_flash_attention(const void* q, const void* k, const void* v,
                                    const void* kv_lens, const void* kv_starts, void* out,
                                    int B, int H, int Tq, int Tk, int D, int causal,
                                    float scale, void* stream) {
  // the running max is taken on the raw scores, which needs scale > 0 (the
  // wrapper ops/attention.py: flash_attention folds any other into q first,
  // fold_scale, so only a NaN scale reaches this refusal)
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || B > 65535 || H > 65535 || !(scale > 0.f))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(q, k, v, kv_lens, kv_starts, out, B, H, Tq, Tk, causal, scale, st);
  if (D == 128)
    return launch<128>(q, k, v, kv_lens, kv_starts, out, B, H, Tq, Tk, causal, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* mmvc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
