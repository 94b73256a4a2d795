// Device helpers shared by the GWT-Adam kernels (gwt_adam_fused.cu: K1, f32
// or bf16 moments; gwt_adam_fused_q8.cu: K2, blocked-int8 moments;
// gwt_adam_tile.cu: K4 (f32 or bf16 moments) and K5), and the one-pass
// design of K1 and K2 (the second half of this file).  Every product and
// sum is written with an _rn intrinsic, so nvcc cannot contract them into
// FMAs that PyTorch's op-by-op arithmetic does not make; sqrt and division
// are IEEE (build without --use_fast_math).  The kernels then round exactly
// where their plain PyTorch versions (ref.py) round.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kChunk = kThreads * kPerThread;  // coefficients per block
constexpr float kInvSqrt2 = 0.7071067811865476f;

struct Coeffs {
  float b1, c1, b2, c2, eps;  // c1 = 1 - b1, c2 = 1 - b2
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// One A_l coefficient.  x holds its 2^LEVEL gradient values on entry and the
// unrounded G~ values on exit; m and v are updated.
template <int LEVEL>
__device__ __forceinline__ void dht_adam(float (&x)[1 << LEVEL], float& m,
                                         float& v, const Coeffs& c) {
  constexpr int B = 1 << LEVEL;
  float y[B];
  // forward, one level at a time: x becomes [A_l | D_l | ... | D_1]
#pragma unroll
  for (int w = B; w > 1; w >>= 1) {
#pragma unroll
    for (int i = 0; i < w / 2; ++i) {
      const float e = x[2 * i], o = x[2 * i + 1];
      y[i] = __fmul_rn(__fadd_rn(e, o), kInvSqrt2);
      y[w / 2 + i] = __fmul_rn(__fsub_rn(e, o), kInvSqrt2);
    }
#pragma unroll
    for (int i = 0; i < w; ++i) x[i] = y[i];
  }
  const float a = x[0];
  m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.c1, a));
  v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(__fmul_rn(c.c2, a), a));
  const float inv = __fdiv_rn(1.0f, __fadd_rn(__fsqrt_rn(v), c.eps));
  x[0] = __fmul_rn(m, inv);
#pragma unroll
  for (int i = 1; i < B; ++i) x[i] = __fmul_rn(x[i], inv);
  // inverse, coarsest band first
#pragma unroll
  for (int w = 2; w <= B; w <<= 1) {
#pragma unroll
    for (int i = 0; i < w / 2; ++i) {
      const float s = x[i], d = x[w / 2 + i];
      y[2 * i] = __fmul_rn(__fadd_rn(s, d), kInvSqrt2);
      y[2 * i + 1] = __fmul_rn(__fsub_rn(s, d), kInvSqrt2);
    }
#pragma unroll
    for (int i = 0; i < w; ++i) x[i] = y[i];
  }
}

// Sum of the rounded G~ squares of one coefficient.
template <typename T, int B>
__device__ __forceinline__ float sum_sq(const float (&x)[B], float acc) {
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const float r = round_to<T>(x[i]);
    acc = __fadd_rn(acc, __fmul_rn(r, r));
  }
  return acc;
}

// Sum over the block in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float acc) {
  __shared__ float warp_part[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = acc;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) total = __fadd_rn(total, warp_part[w]);
  }
  return total;
}

// A chunk's ||G~||^2 partial from its n rounded G~ coefficients of B values
// in shared memory: thread t adds coefficients t + 256k (k = 0..7), each
// one's B squares in order, then block_sum; the order of sum_sq in the
// two-pass kernels, which the plain version's chunk_ssq repeats.  Every
// thread calls it, after a barrier that makes the whole chunk visible; the
// result is valid in thread 0.
template <typename T, int B>
__device__ __forceinline__ float chunk_partial(const T* slot, int n) {
  float acc = 0.0f;
  for (int k = 0; k < kPerThread; ++k) {
    const int cc = threadIdx.x + k * kThreads;
    if (cc >= n) break;
#pragma unroll
    for (int e = 0; e < B; ++e) {
      const float r = to_f32(slot[cc * B + e]);
      acc = __fadd_rn(acc, __fmul_rn(r, r));
    }
  }
  return block_sum(acc);
}

// The limiter of one leaf, computed by one whole warp: the leaf's S
// partials summed in a fixed order (lane-strided from 0, then a fixed
// shuffle tree; ref.leaf_ssq repeats it), the correctly rounded root, the
// scale and the new norm (a zero-norm step keeps the limiter history).
// The results are valid in lane 0.  The partials are read through L2
// (__ldcg), because the one-pass kernels write them in the same launch.
__device__ __forceinline__ void leaf_limit(const float* part, long long S,
                                           float prev, float gamma,
                                           float& scale, float& out_norm) {
  const int lane = threadIdx.x & 31;
  float acc = 0.0f;
#pragma unroll 8
  for (long long i = lane; i < S; i += 32) acc = __fadd_rn(acc, __ldcg(part + i));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  const float norm = __fsqrt_rn(acc);
  const float safe_prev = prev > 0.0f ? prev : norm;
  const float limit = __fmul_rn(gamma, safe_prev);
  scale = norm > limit ? __fdiv_rn(limit, fmaxf(norm, 1e-30f)) : 1.0f;
  out_norm = norm > 0.0f ? __fmul_rn(norm, scale) : prev;
}

// The one-pass kernels' limiter scale of leaf `leaf`, the same in every
// block that asks: the first warp runs leaf_limit and, if `write_norm`,
// writes the leaf's new norm.  Call from every thread; it synchronises the
// block.
__device__ __forceinline__ float leaf_scale_at(const float* partials,
                                               const float* __restrict__ prev_norm,
                                               float* __restrict__ new_norm,
                                               float gamma, long long leaf,
                                               long long S, bool write_norm) {
  __shared__ float s_scale;
  if (threadIdx.x < 32) {
    float scale, out_norm;
    leaf_limit(partials + leaf * S, S, prev_norm[leaf], gamma, scale,
               out_norm);
    if (threadIdx.x == 0) {
      s_scale = scale;
      if (write_norm) new_norm[leaf] = out_norm;
    }
  }
  __syncthreads();
  const float scale = s_scale;
  __syncthreads();  // the next call overwrites s_scale
  return scale;
}

// One element's new parameter: p - step * T(G~ * T(scale)) [- wd * p], with
// G~ rounded to T, the gradient's type, first, the result computed in f32
// and rounded to P, the parameter's type.
template <typename T, typename P>
__device__ __forceinline__ P new_param(float p32, float x, float scale_t,
                                       float ss, float wd, int weight_decay) {
  const float gt = round_to<T>(x);
  const float limited = round_to<T>(__fmul_rn(gt, scale_t));
  float np = __fsub_rn(p32, __fmul_rn(ss, limited));
  if (weight_decay) np = __fsub_rn(np, __fmul_rn(wd, p32));
  return from_f32<P>(np);
}

// A type as a value, for the dtype dispatch below.
template <typename X>
struct Tag {
  using type = X;
};

// Calls f(Tag<T>{}, Tag<M>{}) for the gradient dtype code and the moment
// dtype code (each 0 = float32, 1 = bfloat16: the wrappers' _DTYPES).
template <typename F>
cudaError_t with_dtypes(int dtype, int mdtype, F f) {
  auto moments = [&](auto t) -> cudaError_t {
    if (mdtype == 0) return f(t, Tag<float>{});
    if (mdtype == 1) return f(t, Tag<__nv_bfloat16>{});
    return cudaErrorInvalidValue;
  };
  if (dtype == 0) return moments(Tag<float>{});
  if (dtype == 1) return moments(Tag<__nv_bfloat16>{});
  return cudaErrorInvalidValue;
}

// Calls f(Tag<T>{}, Tag<P>{}) for K1's and K2's dtype code of g (T) and p
// (P): 0 = both float32, 1 = both bfloat16, 2 = bfloat16 g with float32 p
// (the f32 LoRA adapters of a bf16 model, whose gradient the step casts to
// bf16: G~ and the limited step are rounded to bf16, as the JAX package's
// kernel rounds them to g's dtype, and p is read and written in f32).
template <typename F>
cudaError_t with_params(int dtype, F f) {
  if (dtype == 0) return f(Tag<float>{}, Tag<float>{});
  if (dtype == 1) return f(Tag<__nv_bfloat16>{}, Tag<__nv_bfloat16>{});
  if (dtype == 2) return f(Tag<__nv_bfloat16>{}, Tag<float>{});
  return cudaErrorInvalidValue;
}

// Calls f(std::integral_constant<int, LEVEL>) for level 1..4.
template <typename F>
cudaError_t with_level(int level, F f) {
  switch (level) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The one-pass design of K1 and K2: one cooperative launch over a group of
// buckets (one bucket or several) that reads every input once.
//
//  * The group: up to kGroupBuckets buckets that share the template codes
//    (T, P, the moments' format Mo, LEVEL) and the scalar hyperparameters
//    (Adam's coefficients, gamma, the limiter and weight-decay switches),
//    each with its own pointers, step-size and weight-decay scalars and
//    sizes, passed as one __grid_constant__ table (OnePassGroup).  The
//    buckets' chunks are numbered one after the other in table order
//    (OnePassBucket::first); a per-bucket launch is a group of one, with
//    a table of one (OnePassGroup's N; kTable: a library compiles one
//    size).
//  * The grid holds as many blocks of kThreads as are co-resident on the
//    card (occupancy x SM count, cached per kernel).  The group's chunks of
//    kChunk coefficients (leaf-major within a bucket, the two-pass
//    kernels' chunks) are dealt out in contiguous, balanced runs, which may
//    cross from one bucket into the next; a block finds a chunk's bucket
//    by scanning the table's first chunks, and keeps a slot of shared
//    memory for each chunk it owns.  A chunk never crosses a leaf, and a
//    leaf's norm sums its own chunk partials in a fixed order, so where a
//    chunk runs changes no bit: a group writes bitwise what its buckets'
//    own launches write.
//  * Phase A, for each chunk of the block: its moments are loaded into
//    registers (K1: 8-byte loads of m and v) and the next chunk's g is
//    staged into its slot by 16-byte cp.async (K2: with its codes and
//    scales, into a ring of two small shared entries, Mo::stage), one chunk
//    ahead of the compute.  Then each thread takes two adjacent
//    coefficients per round (4 rounds), reading its 2^(l+1) values with
//    16-byte shared loads, runs dht_adam, writes the new moments to device
//    memory at once, and writes G~ rounded to T back over the chunk's g.
//    The chunk's ||G~||^2 partial is then summed from shared memory in the
//    two-pass kernels' order (thread t takes coefficients t + 256k,
//    k = 0..7, each one's 2^l squares in order, then block_sum) into its
//    bucket's (L, S) partials.
//  * One grid barrier for the whole group
//    (cooperative_groups::this_grid().sync()).
//  * Phase B: each block computes the limiter scale of each leaf it holds
//    with leaf_scale_at (the fixed order of the two-pass scale pass;
//    the block owning chunk 0 of a leaf writes its new norm), then reads p
//    with 16-byte loads, up to 64 bytes a thread in flight, and writes p
//    from the G~ in shared memory.  Every written value is therefore
//    bitwise the two-pass kernels'.
//  * Without the limiter there is nothing to wait for: p is written in
//    phase A and there is no barrier.
//  * Capacity: a group takes this design only if its G~ fits the
//    co-resident shared memory at one block per SM,
//    ceil(sum of L*S / SMs) * kChunk * 2^l * sizeof(T) <= the opt-in shared
//    memory per block less the kernel's static shared memory and its ring
//    (K1: none; K2: 2 x 4416 bytes).  On an H100 that is 14 chunks of
//    16 KB per SM for K1 and 13 for K2 (bf16, level 2).  The caller
//    (kernel.py: one_pass_fits for a bucket, group_plan for a group)
//    decides before the launch; a bucket that does not fit alone takes the
//    two-pass kernels.
//  * Alignment: a leaf's base and a ragged last chunk need not be 16-byte
//    aligned (na * 2^l * sizeof(T) is only a multiple of 4).  The staging
//    copy of g then falls back to 4-byte cp.async (K2's codes and scales:
//    stage_bytes, plain copies for the unaligned ends), and every vector
//    load or store of device memory checks its address and the pair's
//    validity and otherwise takes scalar accesses.  Shared slots and ring
//    entries are 16-byte aligned.
//  * What the H100 showed while this was tuned (tools/fused_variants.py
//    times edited copies): staging all of a block's g at once, or two
//    chunks ahead, was slower than one chunk ahead; K2's codes loaded into
//    registers were slower than staged in shared memory; the rounds rolled
//    halved K2's code but ran 3-6% slower; a copy of the rounds
//    without validity branches, loading the next chunk's moments early,
//    issuing phase B's first loads before the barrier, and fewer of phase
//    B's loads in flight gained nothing.

constexpr int kRounds = kChunk / (2 * kThreads);  // 2 coefficients a thread
constexpr int kLookahead = 1;  // chunks staged ahead of the compute
constexpr int kMaxBlocksPerSM = 2048 / kThreads;
// buckets a one-pass launch takes (the table stays under the 4 KB of
// kernel parameters: K2's 16 records are 2688 bytes)
constexpr int kGroupBuckets = 16;

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The widest access (8 or 16 bytes) for N values of T.
template <typename T, int N>
struct Vec {
  static constexpr int kBytes = N * static_cast<int>(sizeof(T));
  static constexpr int kWidth = kBytes >= 16 ? 16 : kBytes;
  static constexpr int kPer = kWidth / static_cast<int>(sizeof(T));
  static_assert(kWidth == 8 || kWidth == 16, "two coefficients: 8+ bytes");
};

// N values of T at src (aligned to Vec::kWidth) as f32.
template <typename T, int N>
__device__ __forceinline__ void vload(const T* src, float (&x)[N]) {
  using V = Vec<T, N>;
#pragma unroll
  for (int q = 0; q < N / V::kPer; ++q) {
    T e[V::kPer];
    if constexpr (V::kWidth == 16) {
      const uint4 u = reinterpret_cast<const uint4*>(src)[q];
      memcpy(e, &u, 16);
    } else {
      const uint2 u = reinterpret_cast<const uint2*>(src)[q];
      memcpy(e, &u, 8);
    }
#pragma unroll
    for (int k = 0; k < V::kPer; ++k) x[q * V::kPer + k] = to_f32(e[k]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void vstore(T* dst, const T (&e)[N]) {
  using V = Vec<T, N>;
#pragma unroll
  for (int q = 0; q < N / V::kPer; ++q) {
    if constexpr (V::kWidth == 16) {
      uint4 u;
      memcpy(&u, e + q * V::kPer, 16);
      reinterpret_cast<uint4*>(dst)[q] = u;
    } else {
      uint2 u;
      memcpy(&u, e + q * V::kPer, 8);
      reinterpret_cast<uint2*>(dst)[q] = u;
    }
  }
}

// A thread's pair of coefficients in device memory: 2B values if the second
// coefficient exists (v1), else B; one vector access where the address
// allows it.
template <typename T, int B>
__device__ __forceinline__ void store_pair(T* dst, const T (&e)[2 * B],
                                           bool v1) {
  if (v1 && aligned(dst, Vec<T, 2 * B>::kWidth)) {
    vstore<T, 2 * B>(dst, e);
    return;
  }
#pragma unroll
  for (int i = 0; i < B; ++i) dst[i] = e[i];
  if (v1) {
#pragma unroll
    for (int i = B; i < 2 * B; ++i) dst[i] = e[i];
  }
}

// The first or second coefficient's B values of a pair.
template <int B>
__device__ __forceinline__ float (&coeff(float (&x)[2 * B], int h))[B] {
  return *reinterpret_cast<float(*)[B]>(x + h * B);
}

// Two f32 values at p (one 8-byte access where aligned and both exist).
__device__ __forceinline__ void load2(const float* p, float (&a)[2], bool v1) {
  if (v1 && aligned(p, 8)) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    a[0] = u.x;
    a[1] = u.y;
  } else {
    a[0] = p[0];
    if (v1) a[1] = p[1];
  }
}

// Two bf16 values at p as their 4 bytes, the first in the low half (one
// access where aligned and both exist; the second half 0 if absent).
__device__ __forceinline__ unsigned load_bits2(const __nv_bfloat16* p,
                                               bool v1) {
  if (v1 && aligned(p, 4)) return *reinterpret_cast<const unsigned*>(p);
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
  return h[0] | (v1 ? static_cast<unsigned>(h[1]) << 16 : 0u);
}

// load_bits2's pair widened to f32: exact, a bf16 is the high half of the
// f32 of the same value.
__device__ __forceinline__ void widen2(unsigned bits, float (&a)[2]) {
  a[0] = __uint_as_float(bits << 16);
  a[1] = __uint_as_float(bits & 0xffff0000u);
}

__device__ __forceinline__ void store2(float* p, const float (&a)[2], bool v1) {
  if (v1 && aligned(p, 8)) {
    *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
  } else {
    p[0] = a[0];
    if (v1) p[1] = a[1];
  }
}

// Two f32 values rounded to bf16, to nearest even, at p.
__device__ __forceinline__ void store2(__nv_bfloat16* p, const float (&a)[2],
                                       bool v1) {
  const __nv_bfloat16 e0 = from_f32<__nv_bfloat16>(a[0]);
  const __nv_bfloat16 e1 = from_f32<__nv_bfloat16>(a[1]);
  if (v1 && aligned(p, 4)) {
    __nv_bfloat162 u;
    u.x = e0;
    u.y = e1;
    *reinterpret_cast<__nv_bfloat162*>(p) = u;
  } else {
    p[0] = e0;
    if (v1) p[1] = e1;
  }
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Waits until at most n of the thread's cp.async groups are pending (n a
// constant after unrolling, 0..3).
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// The thread copies BYTES (a multiple of 4) from src (4-byte aligned) to the
// shared address dst (aligned as BYTES allows) with the widest cp.async
// src's alignment allows.
template <int BYTES>
__device__ __forceinline__ void copy_async(unsigned dst, const void* src) {
  static_assert(BYTES % 4 == 0, "whole 4-byte words");
  const unsigned char* s = static_cast<const unsigned char*>(src);
  if constexpr (BYTES % 16 == 0) {
    if (aligned(src, 16)) {
#pragma unroll
      for (int i = 0; i < BYTES; i += 16) cp_async16(dst + i, s + i);
      return;
    }
  }
  if constexpr (BYTES % 8 == 0) {
    if (aligned(src, 8)) {
#pragma unroll
      for (int i = 0; i < BYTES; i += 8) cp_async8(dst + i, s + i);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < BYTES; i += 4) cp_async4(dst + i, s + i);
}

// A thread's pair of coefficients (B values each; the second only if v1)
// from device memory to its place in a shared slot, by cp.async.
template <typename T, int B>
__device__ __forceinline__ void copy_pair_async(T* dst, const T* src,
                                                bool v1) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  constexpr int kOne = B * static_cast<int>(sizeof(T));
  if (v1) {
    copy_async<2 * kOne>(d, src);
  } else {
    copy_async<kOne>(d, src);
  }
}

// The block copies `bytes` (a multiple of 4) from src (4-byte aligned) to
// the 16-byte aligned shared dst: 16-byte copies where src is 16-byte
// aligned, 4-byte copies for the tail or an unaligned src.
__device__ __forceinline__ void stage_async(unsigned char* dst,
                                            const unsigned char* src,
                                            int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int done = 0;
  if (aligned(src, 16)) {
    const int n16 = bytes >> 4;
    for (int i = threadIdx.x; i < n16; i += kThreads)
      cp_async16(s + 16 * i, src + 16 * i);
    done = n16 << 4;
  }
  for (int i = (done >> 2) + threadIdx.x; i < (bytes >> 2); i += kThreads)
    cp_async4(s + 4 * i, src + 4 * i);
}

// The block copies `bytes` from src to dst + (src & 15), dst 16-byte
// aligned: the 16-byte aligned middle by 16-byte cp.async, the head and
// the tail by plain copies (visible after the next __syncthreads).  Any
// alignment of src and length.
__device__ __forceinline__ void stage_bytes(unsigned char* dst,
                                            const unsigned char* src,
                                            int bytes) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  unsigned char* d = dst + mis;
  const int head = mis == 0 ? 0 : (16 - mis < bytes ? 16 - mis : bytes);
  const int body = (bytes - head) & ~15;
  const int t = threadIdx.x;
  if (t < head) d[t] = src[t];  // head and tail are under 16 bytes
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(d + head));
  for (int q = t; q < (body >> 4); q += kThreads)
    cp_async16(s + 16 * q, src + head + 16 * q);
  if (t < bytes - head - body) d[head + body + t] = src[head + body + t];
}

// Where stage_bytes put the data it copied from src.
template <typename T>
__device__ __forceinline__ const T* staged(const unsigned char* dst,
                                           const void* src) {
  return reinterpret_cast<const T*>(
      dst + (reinterpret_cast<uintptr_t>(src) & 15));
}

// A thread's pair of coefficients' values of T, as stored (no conversion):
// one vector access where the address allows it.
template <typename T, int B>
__device__ __forceinline__ void load_pair_raw(const T* src, T (&e)[2 * B],
                                              bool v1) {
  using V = Vec<T, 2 * B>;
  if (v1 && aligned(src, V::kWidth)) {
#pragma unroll
    for (int q = 0; q < 2 * B / V::kPer; ++q) {
      if constexpr (V::kWidth == 16) {
        const uint4 u = reinterpret_cast<const uint4*>(src)[q];
        memcpy(e + q * V::kPer, &u, 16);
      } else {
        const uint2 u = reinterpret_cast<const uint2*>(src)[q];
        memcpy(e + q * V::kPer, &u, 8);
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < B; ++i) e[i] = src[i];
  if (v1) {
#pragma unroll
    for (int i = B; i < 2 * B; ++i) e[i] = src[i];
  }
}

// Moments stored as M (f32 or bf16), two coefficients a thread (the
// one-pass K1 and K4): one load of the pair's m and v each (8 bytes in f32,
// 4 in bf16) into registers ahead of the compute, and one store of the new
// ones, rounded to M (bf16: __float2bfloat16_rn, nearest even), to m_out,
// v_out (K1 passes m and v themselves: in place).  bf16 pairs wait as their
// loaded bytes and are widened to f32 only in update: widened at the load,
// the thread waited there for the load, before the block's wait for its
// chunk, and K1 and K4 with bf16 moments ran slower than with f32 on the
// H100.  The update and G~ use the unrounded f32 values; only what is
// stored is rounded, as the plain version (ref.py) and the JAX package's
// kernel do.
template <typename M>
struct FloatMoments {
  const M* m;
  const M* v;
  M* m_out;
  M* v_out;
  static constexpr int kRingBytes = 0;
  struct Chunk {
    const M *m, *v;
    M *mo, *vo;
  };
  static constexpr bool kF32 = std::is_same_v<M, float>;
  struct Regs {
    float m[2], v[2];
    unsigned m_bits, v_bits;  // bf16: the loaded pairs
  };
  __device__ __forceinline__ void stage(unsigned char*, long long, long long,
                                        long long, int) const {}
  __device__ __forceinline__ Chunk chunk(const unsigned char*, long long leaf,
                                         long long na, long long j0) const {
    const long long off = leaf * na + j0;
    return {m + off, v + off, m_out + off, v_out + off};
  }
  __device__ __forceinline__ void load(const Chunk& ck, int cl, bool v0,
                                       bool v1, Regs& r) const {
    if (!v0) return;
    if constexpr (kF32) {
      load2(ck.m + cl, r.m, v1);
      load2(ck.v + cl, r.v, v1);
    } else {
      r.m_bits = load_bits2(ck.m + cl, v1);
      r.v_bits = load_bits2(ck.v + cl, v1);
    }
  }
  template <int LEVEL>
  __device__ __forceinline__ void update(const Chunk& ck, int cl, int,
                                         bool v0, bool v1,
                                         float (&x)[2 << LEVEL], Regs& r,
                                         const Coeffs& c) const {
    constexpr int B = 1 << LEVEL;
    if (!v0) return;
    if constexpr (!kF32) {
      widen2(r.m_bits, r.m);
      widen2(r.v_bits, r.v);
    }
    dht_adam<LEVEL>(coeff<B>(x, 0), r.m[0], r.v[0], c);
    if (v1) dht_adam<LEVEL>(coeff<B>(x, 1), r.m[1], r.v[1], c);
    store2(ck.mo + cl, r.m, v1);
    store2(ck.vo + cl, r.v, v1);
  }
};

// Mo, the moments' format, provides
//   struct Chunk;  // a chunk's moment pointers (K2: its salts, its stage)
//   struct Regs;   // one pair's moments loaded ahead (K1)
//   static constexpr int kRingBytes;  // shared bytes a chunk stages (K2)
//   __device__ void stage(unsigned char* e, long long leaf, long long na,
//       long long j0, int n) const;
//   __device__ Chunk chunk(const unsigned char* e, long long leaf,
//       long long na, long long j0) const;
//   __device__ void load(const Chunk& ck, int cl, bool v0, bool v1,
//       Regs& r) const;
//   template <int LEVEL> __device__ void update(const Chunk& ck, int cl,
//       int n, bool v0, bool v1, float (&x)[2 << LEVEL], Regs& r,
//       const Coeffs& c) const;
// stage copies what chunk [j0, j0 + n) of a leaf needs into the ring entry
// e, together with the chunk's g (K2, K5: its codes and scales); chunk
// makes the chunk's state once, so a round's addresses are 32-bit offsets
// cl (chunk-local coefficient index) from its bases; load reads the
// moments of coefficients cl (if v0) and cl + 1 (if v1) into registers
// before the block waits for the chunk (K1, K4); update runs dht_adam on
// each and writes the new moments to the outputs (K1, K2: the inputs, in
// place; K4, K5: their own buffers).  All 32 lanes of a warp call update
// together (K2's and K5's absmax is a warp shuffle).  FloatMoments here
// and Q8Moments (gwt_adam_q8.cuh) serve the one-pass kernel below and the
// staged kernels of gwt_adam_tile.cu alike.
// One bucket of a one-pass group.
template <typename T, typename P, class Mo>
struct OnePassBucket {
  const T* g;
  P* p;
  float* partials;  // (L, S)
  const float* prev_norm;
  float* new_norm;
  const float* step_size;
  const float* wd_coef;
  long long na;     // coefficients per leaf
  long long S;      // chunks per leaf
  long long first;  // the bucket's first chunk in the group
  Mo mo;            // its moments
};

// A one-pass launch's table: the shared scalars, then room for N buckets.
// A launch of one bucket takes N = 1 and the kernel without the bucket
// scan: its fields are constant operands, and its parameters as small as
// one bucket's.  Through the 16-bucket table (2,688 bytes of parameters
// for K2) K2's per-bucket launch at llama-60m's buckets ran 6% slower than
// the earlier kernel of one bucket with the scan, 2-3% without it (H100
// 80GB HBM3, 700 W; tools/fused_variants.py --parent).
template <typename T, typename P, class Mo, int N>
struct OnePassGroup {
  int n;            // buckets
  int slots;        // G~ slots per block (the ring of Mo's stages follows)
  long long total;  // chunks of the group
  Coeffs c;
  float gamma;
  int use_limiter, weight_decay;
  OnePassBucket<T, P, Mo> b[N];
};

// Appends an (L, na) bucket to the group a; cudaErrorInvalidValue for a
// full table or an empty bucket.
template <typename T, typename P, class Mo, int N>
cudaError_t add_bucket(OnePassGroup<T, P, Mo, N>& a, const T* g, P* p,
                       const Mo& mo, float* partials, const float* prev_norm,
                       float* new_norm, const float* step_size,
                       const float* wd_coef, long long L, long long na) {
  if (a.n >= N || L < 1 || na < 1) return cudaErrorInvalidValue;
  const long long S = (na + kChunk - 1) / kChunk;
  a.b[a.n] = {g, p, partials, prev_norm, new_norm, step_size, wd_coef,
              na, S, a.total, mo};
  a.total += L * S;
  ++a.n;
  return cudaSuccess;
}

template <typename T, typename P, int LEVEL, class Mo, int N>
__global__ void __launch_bounds__(kThreads)
one_pass(const __grid_constant__ OnePassGroup<T, P, Mo, N> a) {
  using Bucket = OnePassBucket<T, P, Mo>;
  constexpr int B = 1 << LEVEL;
  constexpr int kSlot = kChunk * B * static_cast<int>(sizeof(T));
  // rounds whose p phase B loads before it computes any: up to 64 bytes
  // a thread in flight
  constexpr int kPairBytes = 2 * B * static_cast<int>(sizeof(P));
  constexpr int kDepth = 64 / kPairBytes >= kRounds ? kRounds
                         : 64 / kPairBytes >= 1     ? 64 / kPairBytes
                                                    : 1;
  extern __shared__ __align__(16) unsigned char slots[];
  const long long grid = gridDim.x, b = blockIdx.x;
  const long long per = a.total / grid, extra = a.total % grid;
  const long long first = b * per + (b < extra ? b : extra);
  const int count = static_cast<int>(per + (b < extra ? 1 : 0));
  const int t = threadIdx.x;
  // chunk i of the run: its bucket k, its leaf, its index s in the leaf and
  // its coefficient count n
  struct Where {
    int k, n;
    long long leaf, s;
  };
  auto where = [&](int i) {
    const long long ch = first + i;
    Where w;
    w.k = 0;
    if constexpr (N > 1)
      while (w.k + 1 < a.n && ch >= a.b[w.k + 1].first) ++w.k;
    const Bucket& e = a.b[w.k];
    const long long local = ch - e.first;
    w.leaf = local / e.S;
    w.s = local % e.S;
    const long long left = e.na - w.s * kChunk;
    w.n = static_cast<int>(left < kChunk ? left : kChunk);
    return w;
  };
  // chunk i's g into slot i and Mo's stage into ring entry i % kRing,
  // kLookahead chunks ahead of the compute; every thread commits one group
  // per chunk (empty past the last), so chunk i's copies are done when at
  // most kLookahead groups are pending
  constexpr int kRing = kLookahead + 1;
  unsigned char* ring = slots + a.slots * kSlot;
  auto entry = [&](int i) { return ring + (i % kRing) * Mo::kRingBytes; };
  auto stage = [&](int i) {
    if (i < count) {
      const Where w = where(i);
      const Bucket& e = a.b[w.k];
      const long long j0 = w.s * kChunk;
      stage_async(slots + i * kSlot,
                  reinterpret_cast<const unsigned char*>(
                      e.g + (w.leaf * e.na + j0) * B),
                  w.n * B * static_cast<int>(sizeof(T)));
      if constexpr (Mo::kRingBytes > 0)
        e.mo.stage(entry(i), w.leaf, e.na, j0, w.n);
    }
    cp_async_commit();
  };
  for (int i = 0; i < kLookahead; ++i) stage(i);
  // the step size and weight-decay coefficient of bucket kss: the run's
  // first bucket's loaded now, while the first chunk stages, not after
  // the grid barrier; a later bucket's when its first chunk comes
  int kss = -1;
  float ss = 0.0f, wd = 0.0f;
  auto scalars = [&](int k) {
    if (k != kss) {
      ss = *a.b[k].step_size;
      wd = *a.b[k].wd_coef;
      kss = k;
    }
  };
  if (count > 0) scalars(where(0).k);
  // phase A
  for (int i = 0; i < count; ++i) {
    const Where w = where(i);
    const Bucket& e = a.b[w.k];
    const long long leaf = w.leaf, s = w.s;
    const int n = w.n;
    const long long j0 = s * kChunk;
    T* gt = reinterpret_cast<T*>(slots + i * kSlot);
    P* pc = e.p + (leaf * e.na + j0) * B;  // the chunk's p
    if (!a.use_limiter) {
      scalars(w.k);
      if (s == 0 && t == 0) e.new_norm[leaf] = e.prev_norm[leaf];
    }
    const typename Mo::Chunk ck = e.mo.chunk(entry(i), leaf, e.na, j0);
    typename Mo::Regs regs[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int cl = 2 * (t + r * kThreads);
      e.mo.load(ck, cl, cl < n, cl + 1 < n, regs[r]);
    }
    stage(i + kLookahead);
    cp_async_wait<kLookahead>();
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int cl = 2 * (t + r * kThreads);
      const bool v0 = cl < n, v1 = cl + 1 < n;
      float x[2 * B];
      vload<T, 2 * B>(gt + cl * B, x);  // past the leaf's end: unused
      e.mo.template update<LEVEL>(ck, cl, n, v0, v1, x, regs[r], a.c);
      if (!v0) continue;
      T el[2 * B];
#pragma unroll
      for (int k = 0; k < 2 * B; ++k) el[k] = from_f32<T>(x[k]);
      if (a.use_limiter) {
        vstore<T, 2 * B>(gt + cl * B, el);
      } else {
        P pe[2 * B];
        load_pair_raw<P, B>(pc + cl * B, pe, v1);
#pragma unroll
        for (int k = 0; k < 2 * B; ++k)
          pe[k] = new_param<T, P>(to_f32(pe[k]), x[k], round_to<T>(1.0f),
                                  ss, wd, a.weight_decay);
        store_pair<P, B>(pc + cl * B, pe, v1);
      }
    }
    if (a.use_limiter) {
      __syncthreads();
      const float total = chunk_partial<T, B>(gt, n);
      if (t == 0) e.partials[leaf * e.S + s] = total;
    } else {
      __syncthreads();  // the next stage overwrites this chunk's ring entry
    }
  }
  if (!a.use_limiter) return;
  cooperative_groups::this_grid().sync();
  // phase B: p for kDepth rounds in flight, then their writes.  cur: the
  // group's index of the chunk 0 of the leaf whose scale is scale_t
  long long cur = -1;
  float scale_t = 1.0f;
  for (int i = 0; i < count; ++i) {
    const Where w = where(i);
    const Bucket& e = a.b[w.k];
    const long long leaf = w.leaf, s = w.s;
    const int n = w.n;
    const T* gt = reinterpret_cast<const T*>(slots + i * kSlot);
    P* pc = e.p + (leaf * e.na + s * kChunk) * B;
    scalars(w.k);
#pragma unroll
    for (int r0 = 0; r0 < kRounds; r0 += kDepth) {
      P pe[kDepth][2 * B];
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        const int cl = 2 * (t + (r0 + d) * kThreads);
        if (cl < n) load_pair_raw<P, B>(pc + cl * B, pe[d], cl + 1 < n);
      }
      const long long key = e.first + leaf * e.S;
      if (r0 == 0 && key != cur) {
        // runs are contiguous, so chunk 0 of a leaf starts its run here
        scale_t = round_to<T>(leaf_scale_at(e.partials, e.prev_norm,
                                            e.new_norm, a.gamma, leaf, e.S,
                                            s == 0));
        cur = key;
      }
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        const int cl = 2 * (t + (r0 + d) * kThreads);
        if (cl >= n) continue;
        float x[2 * B];
        vload<T, 2 * B>(gt + cl * B, x);
#pragma unroll
        for (int k = 0; k < 2 * B; ++k)
          pe[d][k] = new_param<T, P>(to_f32(pe[d][k]), x[k], scale_t, ss,
                                     wd, a.weight_decay);
        store_pair<P, B>(pc + cl * B, pe[d], cl + 1 < n);
      }
    }
  }
}

// A one-pass launch: the kernel and the card (cached per kernel and
// device), then this bucket's blocks per SM, slots per block, dynamic
// shared memory and grid.
struct OnePassPlan {
  int regs, local_bytes, static_smem, max_dyn_smem, sms;
  int blocks_per_sm, slots, smem, grid;
};

// The card and kernel half of the plan; sets the kernel's dynamic shared
// memory limit to all it may have, once.
inline cudaError_t one_pass_info(const void* kern, OnePassPlan* out) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int>, OnePassPlan> cache;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(kern, dev);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  OnePassPlan p{};
  int optin;
  cudaFuncAttributes fa;
  if ((err = cudaDeviceGetAttribute(&p.sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess ||
      (err = cudaFuncGetAttributes(&fa, kern)) != cudaSuccess)
    return err;
  p.regs = fa.numRegs;
  p.local_bytes = static_cast<int>(fa.localSizeBytes);
  p.static_smem = static_cast<int>(fa.sharedSizeBytes);
  p.max_dyn_smem = optin - p.static_smem;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.max_dyn_smem);
  if (err != cudaSuccess) return err;
  cache[key] = p;
  *out = p;
  return cudaSuccess;
}

// The most blocks per SM (up to kMaxBlocksPerSM) whose slots and ring fit
// and are co-resident; cudaErrorInvalidConfiguration if even one block per
// SM cannot hold ceil(total / SMs) slots.  max_dyn_smem becomes the shared
// memory a block has for slots: the kernel's limit less the ring.
inline cudaError_t plan_one_pass(const void* kern, long long slot,
                                 long long ring, long long total,
                                 OnePassPlan* out) {
  if (total <= 0) return cudaErrorInvalidValue;
  cudaError_t err = one_pass_info(kern, out);
  if (err != cudaSuccess) return err;
  out->max_dyn_smem -= static_cast<int>(ring);  // what the slots may have
  static std::mutex mu;
  static std::map<std::tuple<const void*, long long>, int> occupancy;
  for (int bps = kMaxBlocksPerSM; bps >= 1; --bps) {
    const long long width = static_cast<long long>(bps) * out->sms;
    const long long slots = (total + width - 1) / width;
    const long long smem = slots * slot + ring;
    if (smem - ring > out->max_dyn_smem) break;  // fewer blocks: more slots
    int occ;
    {
      std::lock_guard<std::mutex> lock(mu);
      const auto key = std::make_tuple(kern, smem);
      const auto it = occupancy.find(key);
      if (it != occupancy.end()) {
        occ = it->second;
      } else {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occ, kern, kThreads, static_cast<size_t>(smem));
        if (err != cudaSuccess) return err;
        occupancy[key] = occ;
      }
    }
    if (occ >= bps) {
      out->blocks_per_sm = bps;
      out->slots = static_cast<int>(slots);
      out->smem = static_cast<int>(smem);
      out->grid = static_cast<int>((total + slots - 1) / slots);
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidConfiguration;
}

template <typename T, typename P, int LEVEL, class Mo, int N>
const void* one_pass_kernel() {
  return reinterpret_cast<const void*>(&one_pass<T, P, LEVEL, Mo, N>);
}

// The table size of the one-pass kernels a library instantiates: one
// bucket, or kGroupBuckets where its source is built with
// -DGWT_ADAM_GROUPED (kernels/build.py: the *_group libraries).  Each
// library compiles one size, so nvcc builds the two at once.
#ifdef GWT_ADAM_GROUPED
constexpr int kTable = kGroupBuckets;
#else
constexpr int kTable = 1;
#endif

template <typename T, int LEVEL>
constexpr long long one_pass_slot() {
  return static_cast<long long>(kChunk) * (1 << LEVEL) *
         static_cast<long long>(sizeof(T));
}

template <class Mo>
constexpr long long one_pass_ring() {
  return static_cast<long long>(kLookahead + 1) * Mo::kRingBytes;
}

template <int LEVEL, typename T, typename P, class Mo, int N>
cudaError_t launch_one_pass(OnePassGroup<T, P, Mo, N>& a,
                            cudaStream_t stream) {
  const void* kern = one_pass_kernel<T, P, LEVEL, Mo, N>();
  OnePassPlan plan;
  cudaError_t err = plan_one_pass(kern, one_pass_slot<T, LEVEL>(),
                                  one_pass_ring<Mo>(), a.total, &plan);
  if (err != cudaSuccess) return err;
  a.slots = plan.slots;
  void* params[] = {&a};
  return cudaLaunchCooperativeKernel(kern, dim3(plan.grid), dim3(kThreads),
                                     params, plan.smem, stream);
}

// A group's table with its shared scalars and no bucket yet.
template <typename T, typename P, class Mo, int N>
OnePassGroup<T, P, Mo, N> one_pass_group(const Coeffs& c, float gamma,
                                         int use_limiter, int weight_decay) {
  OnePassGroup<T, P, Mo, N> a{};
  a.c = c;
  a.gamma = gamma;
  a.use_limiter = use_limiter;
  a.weight_decay = weight_decay;
  return a;
}

// The chunks of the group of n (L, na) buckets whose sizes are
// sizes[2k], sizes[2k + 1]; 0 for an empty bucket or more than
// kGroupBuckets of them.
inline long long group_chunks(const long long* sizes, int n) {
  if (n < 1 || n > kGroupBuckets) return 0;
  long long total = 0;
  for (int k = 0; k < n; ++k) {
    if (sizes[2 * k] < 1 || sizes[2 * k + 1] < 1) return 0;
    total += sizes[2 * k] * ((sizes[2 * k + 1] + kChunk - 1) / kChunk);
  }
  return total;
}

// Fills out[0..8] with the plan's fields, in OnePassPlan's order.
inline cudaError_t export_plan(const void* kern, long long slot,
                               long long ring, long long total, int* out) {
  OnePassPlan p;
  const cudaError_t err = plan_one_pass(kern, slot, ring, total, &p);
  if (err != cudaSuccess) return err;
  const int fields[] = {p.regs, p.local_bytes, p.static_smem, p.max_dyn_smem,
                        p.sms, p.blocks_per_sm, p.slots, p.smem, p.grid};
  for (int i = 0; i < 9; ++i) out[i] = fields[i];
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The two-pass design of K1 and K2, for buckets whose G~ does not fit on
// chip.  Three launches with the limiter, one without:
//
//  * The norm pass (in each kernel's source) writes one ||G~||^2 partial
//    per (leaf, chunk of kChunk coefficients) and nothing else.
//  * The scale pass: one warp per leaf runs leaf_limit over the leaf's S
//    partials and writes the leaf's scale, rounded to T, and its new norm,
//    so each partial is read once (a leaf of qwen2.5-3b's (2, 73728,
//    11008) has 99,072), and the write pass reads one float a leaf.
//  * The write pass (write_pass below): a persistent grid of co-resident
//    blocks that streams the bucket.  The bucket is cut into pieces of
//    WritePlan::kPiece coefficients (whole rounds of two coefficients a
//    thread; a piece never crosses a leaf or a chunk), dealt out in
//    contiguous, balanced runs in the chunks' order.  The next piece's g
//    and p, and for K2 its codes and scales (Mo::stage), are copied into a
//    ring of two shared entries by 16-byte cp.async while the current piece
//    computes; K1's moments are loaded into registers ahead of the wait, as
//    in the one-pass kernel.  A round reads a thread's two coefficients of
//    g and p from shared memory, runs Mo::update (dht_adam, the moments'
//    store), and writes p by new_param with the leaf's scale in one 16-byte
//    store where the address allows it.  The arithmetic is the one-pass
//    kernel's, so every output is bitwise what it was.  Without the
//    limiter the scale is T(1) and the write pass copies prev_norm to
//    new_norm.
//  * The piece: four rounds (2048 coefficients, a whole chunk) where a
//    round's g is at most 4 KB (bf16 at level 2), fewer where it is larger,
//    so that a ring entry (g and p) stays at most 32 KB and at least three
//    blocks of K1 fit an SM at bf16 level 2.

constexpr int kScaleWarps = 8;  // leaves per scale-pass block

template <typename T>
__global__ void __launch_bounds__(kScaleWarps * 32)
scale_pass(const float* __restrict__ partials,
           const float* __restrict__ prev_norm, float* __restrict__ new_norm,
           float* __restrict__ scale, long long L, long long S, float gamma) {
  const long long leaf = static_cast<long long>(blockIdx.x) * kScaleWarps +
                         (threadIdx.x >> 5);
  if (leaf >= L) return;  // whole warps
  float sc, out_norm;
  leaf_limit(partials + leaf * S, S, prev_norm[leaf], gamma, sc, out_norm);
  if ((threadIdx.x & 31) == 0) {
    scale[leaf] = round_to<T>(sc);
    new_norm[leaf] = out_norm;
  }
}

template <typename T, typename P>
struct WriteArgs {
  const T* g;
  P* p;
  const float* scale;  // (L,) rounded to T; null without the limiter
  const float* prev_norm;
  float* new_norm;  // written here only without the limiter
  const float* step_size;
  const float* wd_coef;
  long long na;      // coefficients per leaf
  long long pieces;  // pieces per leaf
  long long total;   // L * pieces
  Coeffs c;
  int weight_decay;
};

template <typename T, typename P, int LEVEL, class Mo>
struct WritePlan {
  // a pair's g and p bytes
  static constexpr int kPairBytes =
      2 * (1 << LEVEL) * static_cast<int>(sizeof(T) + sizeof(P));
  static constexpr int kPieceRounds =
      kPairBytes * kThreads * kRounds <= 32768 ? kRounds
      : kPairBytes * kThreads * 2 <= 32768     ? 2
                                               : 1;
  static constexpr int kPiece = kPieceRounds * 2 * kThreads;  // coefficients
  static constexpr int kSlot = kPiece * (1 << LEVEL) * static_cast<int>(sizeof(T));
  static constexpr int kSlotP = kPiece * (1 << LEVEL) * static_cast<int>(sizeof(P));
  static constexpr int kEntry = kSlot + kSlotP + Mo::kRingBytes;  // g, p, Mo's
  static constexpr int kSmem = 2 * kEntry;
  static_assert(kChunk % kPiece == 0, "a piece never crosses a chunk");
  static_assert(kEntry % 16 == 0, "ring entries stay 16-byte aligned");
};

template <typename T, typename P, int LEVEL, class Mo>
__global__ void __launch_bounds__(kThreads)
write_pass(const WriteArgs<T, P> a, const Mo mo) {
  using W = WritePlan<T, P, LEVEL, Mo>;
  constexpr int B = 1 << LEVEL;
  extern __shared__ __align__(16) unsigned char ring[];
  const long long grid = gridDim.x, b = blockIdx.x;
  const long long per = a.total / grid, extra = a.total % grid;
  const long long first = b * per + (b < extra ? b : extra);
  const int count = static_cast<int>(per + (b < extra ? 1 : 0));
  const int t = threadIdx.x;
  // piece i of the run: its leaf, its first coefficient j0, its count n
  auto where = [&](int i, long long& leaf, long long& j0, int& n) {
    const long long pc = first + i;
    leaf = pc / a.pieces;
    j0 = (pc % a.pieces) * W::kPiece;
    const long long left = a.na - j0;
    n = static_cast<int>(left < W::kPiece ? left : W::kPiece);
  };
  auto entry = [&](int i) { return ring + (i & 1) * W::kEntry; };
  // every thread commits one group per piece (empty past the last), so
  // piece i's copies are done when at most one group is pending
  auto stage = [&](int i) {
    if (i < count) {
      long long leaf, j0;
      int n;
      where(i, leaf, j0, n);
      const long long off = (leaf * a.na + j0) * B;
      unsigned char* e = entry(i);
      stage_async(e, reinterpret_cast<const unsigned char*>(a.g + off),
                  n * B * static_cast<int>(sizeof(T)));
      stage_async(e + W::kSlot, reinterpret_cast<const unsigned char*>(a.p + off),
                  n * B * static_cast<int>(sizeof(P)));
      if constexpr (Mo::kRingBytes > 0)
        mo.stage(e + W::kSlot + W::kSlotP, leaf, a.na, j0, n);
    }
    cp_async_commit();
  };
  stage(0);
  const float ss = *a.step_size, wd = *a.wd_coef;
  for (int i = 0; i < count; ++i) {
    long long leaf, j0;
    int n;
    where(i, leaf, j0, n);
    const unsigned char* e = entry(i);
    const T* gs = reinterpret_cast<const T*>(e);
    const P* ps = reinterpret_cast<const P*>(e + W::kSlot);
    P* pc = a.p + (leaf * a.na + j0) * B;
    float scale_t;
    if (a.scale) {
      scale_t = a.scale[leaf];
    } else {
      scale_t = round_to<T>(1.0f);
      if (j0 == 0 && t == 0) a.new_norm[leaf] = a.prev_norm[leaf];
    }
    const typename Mo::Chunk ck =
        mo.chunk(e + W::kSlot + W::kSlotP, leaf, a.na, j0);
    typename Mo::Regs regs[W::kPieceRounds];
#pragma unroll
    for (int r = 0; r < W::kPieceRounds; ++r) {
      const int cl = 2 * (t + r * kThreads);
      mo.load(ck, cl, cl < n, cl + 1 < n, regs[r]);
    }
    stage(i + 1);
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int r = 0; r < W::kPieceRounds; ++r) {
      const int cl = 2 * (t + r * kThreads);
      const bool v0 = cl < n, v1 = cl + 1 < n;
      float x[2 * B];
      vload<T, 2 * B>(gs + cl * B, x);  // past the leaf's end: unused
      mo.template update<LEVEL>(ck, cl, n, v0, v1, x, regs[r], a.c);
      if (!v0) continue;
      P pe[2 * B];
      load_pair_raw<P, B>(ps + cl * B, pe, v1);
#pragma unroll
      for (int k = 0; k < 2 * B; ++k)
        pe[k] = new_param<T, P>(to_f32(pe[k]), x[k], scale_t, ss, wd,
                                a.weight_decay);
      store_pair<P, B>(pc + cl * B, pe, v1);
    }
    __syncthreads();  // the next stage overwrites this piece's entry
  }
}

// The write pass's grid: co-resident blocks x SMs (cached per kernel and
// device), at most one block a piece.
template <typename T, typename P, int LEVEL, class Mo>
cudaError_t write_grid(long long total, int* grid) {
  static std::mutex mu;
  static std::map<int, int> width;  // device -> blocks
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  auto it = width.find(dev);
  if (it == width.end()) {
    const void* kern =
        reinterpret_cast<const void*>(&write_pass<T, P, LEVEL, Mo>);
    int sms, occ;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
             WritePlan<T, P, LEVEL, Mo>::kSmem)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &occ, kern, kThreads, WritePlan<T, P, LEVEL, Mo>::kSmem)) !=
            cudaSuccess)
      return err;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    it = width.emplace(dev, occ * sms).first;
  }
  *grid = static_cast<int>(total < it->second ? total : it->second);
  return cudaSuccess;
}

// The scale pass (with the limiter: partials -> scale, new_norm) and the
// write pass of a two-pass launch, after the norm pass.
template <typename T, typename P, int LEVEL, class Mo>
cudaError_t launch_scale_and_write(const T* g, P* p, const Mo& mo,
                                   const float* partials, float* scale,
                                   const float* prev_norm, float* new_norm,
                                   const float* step_size,
                                   const float* wd_coef, long long L,
                                   long long na, Coeffs c, float gamma,
                                   int use_limiter, int weight_decay,
                                   cudaStream_t stream) {
  using W = WritePlan<T, P, LEVEL, Mo>;
  if (use_limiter) {
    const long long S = (na + kChunk - 1) / kChunk;
    const unsigned blocks = static_cast<unsigned>((L + kScaleWarps - 1) / kScaleWarps);
    scale_pass<T><<<blocks, kScaleWarps * 32, 0, stream>>>(
        partials, prev_norm, new_norm, scale, L, S, gamma);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long pieces = (na + W::kPiece - 1) / W::kPiece;
  const WriteArgs<T, P> a{g, p, use_limiter ? scale : nullptr, prev_norm,
                          new_norm, step_size, wd_coef, na, pieces,
                          L * pieces, c, weight_decay};
  int grid;
  const cudaError_t err = write_grid<T, P, LEVEL, Mo>(a.total, &grid);
  if (err != cudaSuccess) return err;
  if (grid == 0) return cudaSuccess;  // an empty bucket
  write_pass<T, P, LEVEL, Mo><<<grid, kThreads, W::kSmem, stream>>>(a, mo);
  return cudaGetLastError();
}

}  // namespace
