// K9 · the optimizer's two multi-tensor passes over every trainable leaf of a
// step: square_sums_many (each leaf's f32 sum of squares, their totals by
// split group, one finite flag) and adamw_many (the global-norm clip, Adam's
// moments and direction, the decayed weights, the step on the f32 master,
// and the module's copy in its own dtype), each one launch for all leaves.
//
// Replaces no TPU kernel: the JAX package runs optax's chain under XLA
// (clip_by_global_norm -> adam -> add_decayed_weights -> scale), which XLA
// fuses.  The port ran the same chain eagerly, leaf by leaf: ~36 PyTorch
// launches a leaf, ~17,000 a step of the NoLLM head's 485 leaves, so the
// host's launches set the layer's time (~200 ms a step) and not the card.
//
// What bounds it on the H100: bytes.  The update reads the gradient (bf16 or
// f32) and the f32 master, m and v, and writes m, v, the master and the
// module's bf16 copy: 28 B an element with a bf16 gradient, 3.47 GB for the
// NoLLM head's 123.96M trained elements, ~1.04 ms at 3.35 TB/s.  The
// square sums read the gradient once (0.25 GB, ~0.07 ms).  A handful of
// f32 operations an element is far below the card's compute rate.
//
// Design for Hopper:
// - One launch for all leaves.  The wrapper copies a table of the leaves
//   (pointers, lengths, dtypes, group) and each leaf's first work item to the
//   card once a call (gradients are new tensors every step); no parameter
//   space limit, no state between launches.
// - Work items are fixed-size chunks of CHUNK elements of one leaf, one a
//   block, so 485 leaves of 512 to 1.6M elements fill the 132 SMs evenly; a
//   block finds its leaf by a binary search of the first items.
// - 16-byte vector loads (four f32; four bf16 in 8 bytes) where every
//   operand of the leaf is aligned for them, a scalar tail past the last
//   whole vector, and a scalar path for a leaf that is not aligned.  Every
//   intermediate (the clipped gradient, the direction) stays in registers.
// - The arithmetic is the port's per-leaf chain on the card, bit for bit:
//   f32 throughout, no contraction (__fmul_rn / __fadd_rn / __fdiv_rn /
//   __fsqrt_rn), and PyTorch's rounding of each host constant: a Python
//   scalar multiplies as its f32 value, and a tensor divided by one is
//   multiplied by the f32 reciprocal (the wrapper computes both).
// - The square sums are deterministic: a block writes its chunk's sum, the
//   second launch (one block) folds each leaf's chunks in order, then the
//   groups' totals by a fixed tree.  No float atomics, so a step repeats.
#include <cuda_fp16.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;                  // elements a thread loads at once (16 B of f32)
constexpr long long CHUNK = 16384;      // elements a work item: THREADS * VEC * 16
constexpr int GROUPS = 4;               // square-sum totals (fsdp bit | tensor bit << 1)
constexpr int FOLD_THREADS = 512;       // the fold's one block

enum Dtype : int { kF32 = 0, kBF16 = 1, kF16 = 2, kNone = 3 };

// One leaf of the table, eight int64 words (ops/adamw.py: _table).
struct Leaf {
  const void* grad;
  float* master;  // null in the square sums' table, as mu, nu and copy
  float* mu;
  float* nu;
  void* copy;
  long long n;
  long long code;  // gradient dtype | copy dtype << 8 | group << 16
  long long spare;
};

// The update's constants, each as PyTorch rounds it for an f32 tensor.
struct Consts {
  float c1, b1, c2, b2;    // 1 - b1, b1, 1 - b2, b2
  float inv_bc1, inv_bc2;  // 1 / (1 - b1^count), 1 / (1 - b2^count)
  float eps, wd, step, scale, clip;  // step: -lr
  int flags;
  const float* norm;  // the global norm (CLIP), read on the card
};
constexpr int WD = 1, SCALE = 2, CLIP = 4;

// the leaf holding work item `item`: the last whose first item is <= item
// (an empty leaf shares its first item with the next one)
__device__ __forceinline__ int find_leaf(const long long* first, int count, long long item) {
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= item) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

// a 16-bit element from its bits and back
__device__ __forceinline__ float bits_f32(unsigned b, __nv_bfloat16*) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(b)));
}
__device__ __forceinline__ float bits_f32(unsigned b, __half*) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
}
__device__ __forceinline__ unsigned f32_bits(float x, __nv_bfloat16*) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ unsigned f32_bits(float x, __half*) {
  return __half_as_ushort(__float2half_rn(x));
}

// four consecutive elements as f32: one 16-byte load of f32, or 8 bytes of a
// 16-bit type (element 0 in the low half of the first word)
template <typename T>
__device__ __forceinline__ void load4(const T* p, float* out) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    T* tag = nullptr;
    out[0] = bits_f32(v.x & 0xffffu, tag), out[1] = bits_f32(v.x >> 16, tag);
    out[2] = bits_f32(v.y & 0xffffu, tag), out[3] = bits_f32(v.y >> 16, tag);
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float* x) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    T* tag = nullptr;
    *reinterpret_cast<uint2*>(p) =
        make_uint2(f32_bits(x[0], tag) | f32_bits(x[1], tag) << 16,
                   f32_bits(x[2], tag) | f32_bits(x[3], tag) << 16);
  }
}

// the block-wide sum of v in a fixed order; every thread returns it.  `s`
// is 32 floats of shared scratch.  Reached by all threads of the block.
__device__ __forceinline__ float block_sum(float v, float* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = mmvc::warp_sum(v);
  __syncthreads();  // s may still be read from the previous call
  if (lane == 0) s[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = mmvc::warp_sum(lane < int(blockDim.x >> 5) ? s[lane] : 0.f);
    if (lane == 0) s[0] = v;
  }
  __syncthreads();
  return s[0];
}

// ---- square sums ---------------------------------------------------------------

template <typename G>
__device__ __forceinline__ void squares(const G* g, long long lo, long long hi, float& sum,
                                        bool& bad) {
  float s[VEC] = {0.f, 0.f, 0.f, 0.f};
  long long tail = lo;
  if (aligned(g, VEC * sizeof(G))) {
    tail = lo + (hi - lo) / VEC * VEC;
    for (long long i = lo + threadIdx.x * VEC; i < tail; i += THREADS * VEC) {
      float x[VEC];
      load4(g + i, x);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        bad |= !isfinite(x[j]);
        s[j] = __fadd_rn(s[j], __fmul_rn(x[j], x[j]));
      }
    }
  }
  for (long long i = tail + threadIdx.x; i < hi; i += THREADS) {
    const float x = to_f32<G>(g[i]);
    bad |= !isfinite(x);
    s[0] = __fadd_rn(s[0], __fmul_rn(x, x));
  }
  sum = __fadd_rn(__fadd_rn(s[0], s[1]), __fadd_rn(s[2], s[3]));
}

__global__ void __launch_bounds__(THREADS)
    square_sums_kernel(const Leaf* leaves, const long long* first, int count, float* partial,
                       unsigned char* bad_out) {
  __shared__ float scratch[32];
  const long long item = blockIdx.x;
  const int l = find_leaf(first, count, item);
  const Leaf L = leaves[l];
  const long long lo = (item - first[l]) * CHUNK, hi = min(lo + CHUNK, L.n);
  float sum = 0.f;
  bool bad = false;
  switch (int(L.code & 0xff)) {
    case kF32: squares(static_cast<const float*>(L.grad), lo, hi, sum, bad); break;
    case kBF16: squares(static_cast<const __nv_bfloat16*>(L.grad), lo, hi, sum, bad); break;
    default: squares(static_cast<const __half*>(L.grad), lo, hi, sum, bad); break;
  }
  sum = block_sum(sum, scratch);
  const int any_bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    partial[item] = sum;
    bad_out[item] = any_bad ? 1 : 0;
  }
}

// one block: each leaf's chunks folded in order, the groups' totals, the flag
__global__ void __launch_bounds__(FOLD_THREADS)
    square_fold_kernel(const Leaf* leaves, const long long* first, int count,
                       const float* partial, const unsigned char* bad_in, float* sums,
                       float* totals, bool* finite) {
  __shared__ float scratch[32];
  float acc[GROUPS] = {0.f, 0.f, 0.f, 0.f};
  bool bad = false;
  for (int l = threadIdx.x; l < count; l += blockDim.x) {
    float s = 0.f;
    for (long long c = first[l]; c < first[l + 1]; ++c) {
      s = __fadd_rn(s, partial[c]);
      bad |= bad_in[c] != 0;
    }
    sums[l] = s;
    const int g = int(leaves[l].code >> 16) & (GROUPS - 1);
#pragma unroll
    for (int k = 0; k < GROUPS; ++k)
      if (k == g) acc[k] = __fadd_rn(acc[k], s);
  }
#pragma unroll
  for (int k = 0; k < GROUPS; ++k) {
    const float t = block_sum(acc[k], scratch);
    if (threadIdx.x == 0) totals[k] = t;
  }
  const int any_bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) *finite = !any_bad;
}

// ---- the update ----------------------------------------------------------------

// One element: the port's per-leaf chain (ops/adamw.py: adamw_many_plain)
// with each PyTorch kernel's rounding.
__device__ __forceinline__ void adamw_element(float g, float& p, float& m, float& v,
                                              const Consts& k, float norm) {
  if ((k.flags & CLIP) && !(norm < k.clip)) g = __fmul_rn(__fdiv_rn(g, norm), k.clip);
  m = __fadd_rn(__fmul_rn(k.c1, g), __fmul_rn(k.b1, m));
  v = __fadd_rn(__fmul_rn(k.c2, __fmul_rn(g, g)), __fmul_rn(k.b2, v));
  float u = __fdiv_rn(__fmul_rn(m, k.inv_bc1),
                      __fadd_rn(__fsqrt_rn(__fmul_rn(v, k.inv_bc2)), k.eps));
  if (k.flags & WD) u = __fadd_rn(u, __fmul_rn(k.wd, p));
  u = __fmul_rn(u, k.step);
  if (k.flags & SCALE) u = __fmul_rn(u, k.scale);
  p = __fadd_rn(p, u);
}

struct NoCopy {};  // the copy's type where the leaf has none

template <typename G, typename C>
__device__ __forceinline__ void adamw_range(const Leaf& L, long long lo, long long hi,
                                            const Consts& k, float norm) {
  constexpr bool kCopy = !std::is_same<C, NoCopy>::value;
  const G* g = static_cast<const G*>(L.grad);
  C* c = static_cast<C*>(L.copy);
  long long tail = lo;
  if (aligned(g, VEC * sizeof(G)) && aligned(L.master, 16) && aligned(L.mu, 16) &&
      aligned(L.nu, 16) && (!kCopy || aligned(c, VEC * sizeof(C)))) {
    tail = lo + (hi - lo) / VEC * VEC;
    for (long long i = lo + threadIdx.x * VEC; i < tail; i += THREADS * VEC) {
      float x[VEC], p[VEC], m[VEC], v[VEC];
      load4(g + i, x);
      load4(L.master + i, p);
      load4(L.mu + i, m);
      load4(L.nu + i, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) adamw_element(x[j], p[j], m[j], v[j], k, norm);
      store4(L.master + i, p);
      store4(L.mu + i, m);
      store4(L.nu + i, v);
      if constexpr (kCopy) store4(c + i, p);
    }
  }
  for (long long i = tail + threadIdx.x; i < hi; i += THREADS) {
    float p = L.master[i], m = L.mu[i], v = L.nu[i];
    adamw_element(to_f32<G>(g[i]), p, m, v, k, norm);
    L.master[i] = p;
    L.mu[i] = m;
    L.nu[i] = v;
    if constexpr (kCopy) c[i] = from_f32<C>(p);
  }
}

template <typename G>
__device__ __forceinline__ void adamw_copy(const Leaf& L, long long lo, long long hi,
                                           const Consts& k, float norm) {
  switch (int(L.code >> 8) & 0xff) {
    case kF32: adamw_range<G, float>(L, lo, hi, k, norm); break;
    case kBF16: adamw_range<G, __nv_bfloat16>(L, lo, hi, k, norm); break;
    case kF16: adamw_range<G, __half>(L, lo, hi, k, norm); break;
    default: adamw_range<G, NoCopy>(L, lo, hi, k, norm); break;
  }
}

__global__ void __launch_bounds__(THREADS)
    adamw_kernel(const Leaf* leaves, const long long* first, int count, const Consts k) {
  const long long item = blockIdx.x;
  const int l = find_leaf(first, count, item);
  const Leaf L = leaves[l];
  const long long lo = (item - first[l]) * CHUNK, hi = min(lo + CHUNK, L.n);
  const float norm = (k.flags & CLIP) ? *k.norm : 0.f;
  switch (int(L.code & 0xff)) {
    case kF32: adamw_copy<float>(L, lo, hi, k, norm); break;
    case kBF16: adamw_copy<__nv_bfloat16>(L, lo, hi, k, norm); break;
    default: adamw_copy<__half>(L, lo, hi, k, norm); break;
  }
}

bool table_ok(const void* table, int count, long long items) {
  return table && count > 0 && items > 0 && items <= INT_MAX;
}

}  // namespace

// Square sums of `count` gradients (table: count Leaf rows then count + 1
// first items, `items` in all, on the card): partial [items] f32 and bad
// [items] u8 scratch; sums [count] f32, totals [4] f32, finite (bool).  Two
// launches.
extern "C" int mmvc_square_sums_many(const void* table, int count, long long items,
                                     void* partial, void* bad, void* sums, void* totals,
                                     void* finite, void* stream) {
  if (!table_ok(table, count, items) || !partial || !bad || !sums || !totals || !finite)
    return cudaErrorInvalidValue;
  const Leaf* leaves = static_cast<const Leaf*>(table);
  const long long* first = reinterpret_cast<const long long*>(leaves + count);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  square_sums_kernel<<<unsigned(items), THREADS, 0, s>>>(
      leaves, first, count, static_cast<float*>(partial), static_cast<unsigned char*>(bad));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  square_fold_kernel<<<1, FOLD_THREADS, 0, s>>>(
      leaves, first, count, static_cast<const float*>(partial),
      static_cast<const unsigned char*>(bad), static_cast<float*>(sums),
      static_cast<float*>(totals), static_cast<bool*>(finite));
  return cudaGetLastError();
}

// One AdamW update of `count` leaves (the same table with master, mu, nu and
// copy): consts = 11 floats (c1, b1, c2, b2, inv_bc1, inv_bc2, eps, wd,
// step, scale, clip), flags (WD 1, SCALE 2, CLIP 4), norm: the global norm on
// the card (CLIP).  One launch.
extern "C" int mmvc_adamw_many(const void* table, int count, long long items,
                               const float* consts, int flags, const void* norm, void* stream) {
  if (!table_ok(table, count, items) || !consts || ((flags & CLIP) && !norm))
    return cudaErrorInvalidValue;
  const float* f = consts;
  const Consts k{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10], flags,
                 static_cast<const float*>(norm)};
  const Leaf* leaves = static_cast<const Leaf*>(table);
  adamw_kernel<<<unsigned(items), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      leaves, reinterpret_cast<const long long*>(leaves + count), count, k);
  return cudaGetLastError();
}
