// K7 · int8_matmul and K8 · int4_matmul: weight-only quantized matmuls,
// y = bf16(x) @ dequant(W) with f32 accumulation (W8A16 and W4A16).
//
// Replace the Pallas kernels of multimodalvc_tpu/ops/int8_matmul.py:
//   K7 int8_matmul (pallas_call at :113, body _int8_matmul_kernel :26):
//      W int8 [d_in, d_out] with one f32 scale per output column.  Each W
//      tile becomes bf16 on chip (exact), the product accumulates in f32,
//      the f32 scale multiplies the f32 sum, then the cast to the output type.
//   K8 int4_matmul (pallas_call at :326, body _int4_matmul_kernel :209):
//      W packed two nibbles a byte, split half/half along d_in
//      (packed[r] = lo(w[r]) | w[r + d_in/2] << 4), one f32 scale per
//      (group of 128 rows, column).  Each weight is bf16(nibble) *
//      bf16(scale) rounded to bf16, as the TPU kernel multiplies in bf16;
//      no scale follows the product.
//
// Design for Hopper.  A block of 4 warps owns a 64-row x 64-column output
// tile and walks d_in in steps of 64 logical rows.  Each step loads the x
// tile (bf16, 16-byte loads) and the W tile (int8: 64 rows of 64 bytes;
// int4: 32 packed rows, whose low nibbles are logical rows k0.. and high
// nibbles rows d_in/2 + k0..) into registers, converts W to bf16 into
// shared memory, and multiplies on the tensor cores through WMMA (bf16 in,
// f32 accumulate, 16x16x16 fragments, a 32x32 tile per warp).  The global
// loads of step s+1 are issued before the products of step s, so they
// overlap.  The epilogue goes through shared memory (WMMA fragments have
// no documented element layout), applies the int8 column scale and stores
// bf16 or f32.
//
// What bounds it on the H100: at decode rows (40-240) it reads ~1 byte (int8)
// or ~0.5 byte (int4) of weight for every 2*rows flops, far below the ~295
// flops a byte where the tensor cores would bound it, so the weight bytes
// against 3.35 TB/s bound it (the 3B trunk plus the tied unembed: ~3.2 GB a
// step in int8).  The design reads each weight byte from device memory once
// for all rows of a 64-row tile; the row tiles of one column tile run as
// neighbouring blocks, so their re-reads of W mostly hit L2.  No TMA, no
// wgmma, no split-K: at 40 rows the trunk's 3072-wide outputs give only 48
// blocks, which leaves SMs idle; a split-K schedule is later work.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BM = 64;        // rows of x per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 64;        // logical d_in rows per step
constexpr int PK = BK / 2;    // int4: packed rows per step
constexpr int THREADS = 128;  // 4 warps, a 32 x 32 output tile each
// shared-memory pitches, padded by 16 bytes against bank conflicts; every
// 16-row fragment origin stays 32-byte aligned as WMMA requires
constexpr int LDX = BK + 8;  // bf16
constexpr int LDW = BN + 8;  // bf16
constexpr int LDC = BN + 4;  // f32, the epilogue tile
constexpr int SMEM_BYTES = (BM * LDX + BK * LDW) * 2;
static_assert(BM * LDC * 4 <= SMEM_BYTES, "the epilogue tile reuses the operand tiles");

// Logical d_in column of x that slot c8 (16-byte chunk 0..7) of step s
// reads.  int8: 64 consecutive columns.  int4: chunks 0-3 are the low-nibble
// rows k0.., chunks 4-7 the high-nibble rows half + k0...
template <bool INT4>
__device__ __forceinline__ int x_column(int s, int c8, int half) {
  if constexpr (!INT4) {
    return s * BK + c8 * 8;
  } else {
    const int k0 = s * PK;
    return c8 < 4 ? k0 + c8 * 8 : half + k0 + (c8 - 4) * 8;
  }
}

template <bool INT4>
__global__ void __launch_bounds__(THREADS)
quant_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, void* __restrict__ out, int rows, int d_in,
                    int d_out, int group, int out_f32) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [BM, LDX]
  bf16* ws = xs + BM * LDX;                   // [BK, LDW]
  float* cs = reinterpret_cast<float*>(smem);  // [BM, LDC], after the main loop

  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int half = d_in / 2;
  const int steps = d_in / BK;

  constexpr int XV = BM * BK / 8 / THREADS;         // 16-byte x loads a thread: 4
  constexpr int WV = (INT4 ? PK : BK) * BN / 16 / THREADS;  // 16-byte W loads: 1 or 2
  uint4 xr[XV], wr[WV];
  float4 sr[INT4 ? 8 : 1];  // int4: 16 low-group and 16 high-group scales

  auto load = [&](int s) {
#pragma unroll
    for (int it = 0; it < XV; ++it) {
      const int i = tid + it * THREADS, r = i >> 3, c8 = i & 7;
      xr[it] = make_uint4(0, 0, 0, 0);
      if (row0 + r < rows)
        xr[it] = *reinterpret_cast<const uint4*>(x + size_t(row0 + r) * d_in +
                                                 x_column<INT4>(s, c8, half));
    }
#pragma unroll
    for (int it = 0; it < WV; ++it) {
      const int i = tid + it * THREADS, r = i >> 2, c = (i & 3) * 16;
      const int wrow = (INT4 ? s * PK : s * BK) + r;
      wr[it] = *reinterpret_cast<const uint4*>(w + size_t(wrow) * d_out + col0 + c);
      if constexpr (INT4) {
        // a step's 32 packed rows lie in one group of each half
        const float* lo = scale + size_t(s * PK / group) * d_out + col0 + c;
        const float* hi = scale + size_t((half + s * PK) / group) * d_out + col0 + c;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sr[j] = *reinterpret_cast<const float4*>(lo + 4 * j);
          sr[4 + j] = *reinterpret_cast<const float4*>(hi + 4 * j);
        }
      }
    }
  };

  auto store = [&]() {
#pragma unroll
    for (int it = 0; it < XV; ++it) {
      const int i = tid + it * THREADS, r = i >> 3, c8 = i & 7;
      *reinterpret_cast<uint4*>(xs + r * LDX + c8 * 8) = xr[it];
    }
#pragma unroll
    for (int it = 0; it < WV; ++it) {
      const int i = tid + it * THREADS, r = i >> 2, c = (i & 3) * 16;
      const int8_t* b = reinterpret_cast<const int8_t*>(&wr[it]);
      __align__(16) bf16 lo[16];
      __align__(16) bf16 hi[16];
      if constexpr (!INT4) {
#pragma unroll
        for (int j = 0; j < 16; ++j) lo[j] = __float2bfloat16(float(b[j]));  // exact
      } else {
        const float* sl = reinterpret_cast<const float*>(&sr[0]);
        const float* sh = reinterpret_cast<const float*>(&sr[4]);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int v = b[j];
          const int nlo = ((v & 0xF) ^ 8) - 8, nhi = v >> 4;  // sign-extended nibbles
          // bf16(nibble) * bf16(scale): the f32 product is exact, one rounding
          lo[j] = __float2bfloat16(float(nlo) * __bfloat162float(__float2bfloat16(sl[j])));
          hi[j] = __float2bfloat16(float(nhi) * __bfloat162float(__float2bfloat16(sh[j])));
        }
        *reinterpret_cast<uint4*>(ws + (PK + r) * LDW + c) = *reinterpret_cast<uint4*>(hi);
        *reinterpret_cast<uint4*>(ws + (PK + r) * LDW + c + 8) =
            *reinterpret_cast<uint4*>(hi + 8);
      }
      *reinterpret_cast<uint4*>(ws + r * LDW + c) = *reinterpret_cast<uint4*>(lo);
      *reinterpret_cast<uint4*>(ws + r * LDW + c + 8) = *reinterpret_cast<uint4*>(lo + 8);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load(0);
  for (int s = 0; s < steps; ++s) {
    store();
    __syncthreads();
    if (s + 1 < steps) load(s + 1);  // in flight during the products below
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs + (wm + i * 16) * LDX + kk * 16, LDX);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], ws + kk * 16 * LDW + wn + j * 16, LDW);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bfr[j], acc[i][j]);
    }
    __syncthreads();  // every warp is done with the tiles before the next store
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm + i * 16) * LDC + wn + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    if (row0 + r >= rows) break;  // rows only grow with i
    float v = cs[r * LDC + c];
    if constexpr (!INT4) v *= scale[col0 + c];
    const size_t o = size_t(row0 + r) * d_out + col0 + c;
    if (out_f32)
      static_cast<float*>(out)[o] = v;
    else
      static_cast<bf16*>(out)[o] = __float2bfloat16(v);
  }
}

template <bool INT4>
int launch(const void* x, const void* w, const void* scale, void* out, int rows, int d_in,
           int d_out, int group, int out_f32, void* stream) {
  if (rows <= 0 || d_out <= 0 || d_out % BN || d_out / BN > 65535) return cudaErrorInvalidValue;
  if (INT4 ? (d_in <= 0 || (d_in / 2) % PK || group <= 0 || group % PK || (d_in / 2) % group)
           : (d_in <= 0 || d_in % BK))
    return cudaErrorInvalidValue;
  const dim3 grid((rows + BM - 1) / BM, d_out / BN);
  quant_matmul_kernel<INT4><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), out, rows, d_in, d_out, group, out_f32);
  return cudaGetLastError();
}

}  // namespace

// x bf16 [rows, d_in]; w int8 [d_in, d_out]; scale f32 [d_out];
// out [rows, d_out], f32 if out_f32 else bf16.
extern "C" int mmvc_int8_matmul(const void* x, const void* w, const void* scale, void* out,
                                int rows, int d_in, int d_out, int out_f32, void* stream) {
  return launch<false>(x, w, scale, out, rows, d_in, d_out, 0, out_f32, stream);
}

// x bf16 [rows, d_in]; w int8 [d_in/2, d_out] half-split nibbles;
// scale f32 [d_in/group, d_out]; out as above.
extern "C" int mmvc_int4_matmul(const void* x, const void* w, const void* scale, void* out,
                                int rows, int d_in, int d_out, int group, int out_f32,
                                void* stream) {
  return launch<true>(x, w, scale, out, rows, d_in, d_out, group, out_f32, stream);
}
