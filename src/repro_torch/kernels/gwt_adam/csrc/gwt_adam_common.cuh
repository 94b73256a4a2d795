// Device helpers shared by the fused-write GWT-Adam kernels
// (gwt_adam_fused.cu: f32 moments; gwt_adam_fused_q8.cu: blocked-int8
// moments).  Every product and sum is written with an _rn intrinsic, so
// nvcc cannot contract them into FMAs that PyTorch's op-by-op arithmetic
// does not make; sqrt and division are IEEE (build without
// --use_fast_math).  The kernels then round exactly where their plain
// PyTorch versions (ref.py) round.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// The limiter scale of this block's leaf (blockIdx.y), the same in every
// block of the leaf: the first warp sums the leaf's S partials in a fixed
// order (lane-strided, then a fixed shuffle tree).  Block 0 writes the
// leaf's new norm.  Call from every thread; it synchronises the block.
__device__ __forceinline__ float leaf_scale(const float* __restrict__ partials,
                                            const float* __restrict__ prev_norm,
                                            float* __restrict__ new_norm,
                                            float gamma, int use_limiter) {
  __shared__ float s_scale;
  const long long leaf = blockIdx.y;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float prev = prev_norm[leaf];
    float scale = 1.0f, out_norm = prev;
    if (use_limiter) {
      const int S = gridDim.x;
      const float* part = partials + leaf * S;
      float acc = 0.0f;
      for (int i = lane; i < S; i += 32) acc = __fadd_rn(acc, part[i]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
      const float norm = __fsqrt_rn(acc);
      const float safe_prev = prev > 0.0f ? prev : norm;
      const float limit = __fmul_rn(gamma, safe_prev);
      scale = norm > limit ? __fdiv_rn(limit, fmaxf(norm, 1e-30f)) : 1.0f;
      // a zero-norm step keeps the limiter history
      out_norm = norm > 0.0f ? __fmul_rn(norm, scale) : prev;
    }
    if (lane == 0) {
      s_scale = scale;
      if (blockIdx.x == 0) new_norm[leaf] = out_norm;
    }
  }
  __syncthreads();
  return s_scale;
}

// p <- p - step * T(G~ * T(scale)) [- wd * p] for one coefficient's B
// elements; G~ is rounded to T first.
template <typename T, int B>
__device__ __forceinline__ void write_params(T* __restrict__ pj,
                                             const float (&x)[B],
                                             float scale_t, float ss,
                                             float wd, int weight_decay) {
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const float gt = round_to<T>(x[i]);
    const float limited = round_to<T>(__fmul_rn(gt, scale_t));
    const float p32 = to_f32(pj[i]);
    float np = __fsub_rn(p32, __fmul_rn(ss, limited));
    if (weight_decay) np = __fsub_rn(np, __fmul_rn(wd, p32));
    pj[i] = from_f32<T>(np);
  }
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

}  // namespace
