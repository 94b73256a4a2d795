// Fused-write GWT-Adam update for one (L, N) bucket of same-shaped leaves:
// level-l Haar DWT along rows -> Adam on the A_l band (m, v in place) ->
// A~ = m/(sqrt(v)+eps), details scaled by the same 1/(sqrt(v)+eps) ->
// inverse DWT -> G~ rounded to the parameter type -> per-leaf ||G~|| ->
// norm-growth limiter -> p <- p - step*s*G~ - wd*p, written in place.
//
// Replaces the TPU kernel gwt_adam_tile_fused (body _body_fused) of
// src/repro/kernels/gwt_adam/kernel.py.
//
// Bound on an H100: the update does O(30) f32 operations per gradient
// element, so memory bounds it.  It must read g and p (2 + 2 bytes in bf16),
// read and write m and v (4 + 4 bytes each, once per 2^l gradient elements)
// and write p (2 bytes): 10 bytes per gradient element at level 2.  LLaMA-60M
// has 25.3 M such elements, so about 253 MB per step over three launches.
//
// Design:
//  * At level l, approximation coefficient j of a row depends only on the
//    2^l gradient values [j*2^l, (j+1)*2^l).  Rows are contiguous and have
//    n = na*2^l elements, so coefficient c of a leaf covers elements
//    [c*2^l, (c+1)*2^l) of the flat leaf.  One thread takes one coefficient:
//    it holds its 2^l values in registers and runs the forward butterfly,
//    Adam on one m and one v, the detail scaling and the inverse with no
//    shared memory.  Widths whose band is not a power of two (1376 -> 344)
//    need nothing special; the last block masks the ragged end.
//  * CUDA blocks run in no order, so the per-leaf norm is two launches.  The
//    norm pass writes one f32 partial per (leaf, block of coefficients) and
//    nothing else.  The write pass sums its leaf's partials in a fixed order
//    (lane-strided, then a fixed shuffle tree), applies the limiter,
//    recomputes the tile and writes p, m, v.  No float atomics: the result is
//    identical from run to run.  Recomputing costs one more read of g, m and
//    v (4 bytes per element in bf16), 14 bytes per element in all against
//    the 10-byte bound; it is cheaper than a round trip of G~ through memory.
//  * Rounding follows the plain PyTorch version (ref.py) point for point:
//    G~ is rounded to the parameter type before the norm and the write,
//    limited = G~ * T(scale) is rounded to T, new p is computed in f32.  Every
//    product and sum is written with an _rn intrinsic, so nvcc cannot
//    contract them into FMAs that PyTorch's op-by-op arithmetic does not
//    make, and sqrt and division are IEEE (build without --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// grid (S, L): block s of leaf l takes coefficients [s*kChunk, (s+1)*kChunk).
template <typename T, int LEVEL>
__global__ void __launch_bounds__(kThreads)
norm_pass(const T* __restrict__ g, const float* __restrict__ m,
          const float* __restrict__ v, float* __restrict__ partials,
          long long na, Coeffs c) {
  constexpr int B = 1 << LEVEL;
  const long long leaf = blockIdx.y;
  const T* gl = g + leaf * na * B;
  const float* ml = m + leaf * na;
  const float* vl = v + leaf * na;
  const long long base = (long long)blockIdx.x * kChunk + threadIdx.x;
  float acc = 0.0f;
  for (int k = 0; k < kPerThread; ++k) {
    const long long j = base + (long long)k * kThreads;
    if (j >= na) break;
    float x[B];
#pragma unroll
    for (int i = 0; i < B; ++i) x[i] = to_f32(gl[j * B + i]);
    float mj = ml[j], vj = vl[j];
    dht_adam<LEVEL>(x, mj, vj, c);
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const float r = round_to<T>(x[i]);
      acc = __fadd_rn(acc, __fmul_rn(r, r));
    }
  }
  const float total = block_sum(acc);
  if (threadIdx.x == 0) partials[leaf * gridDim.x + blockIdx.x] = total;
}

template <typename T, int LEVEL>
__global__ void __launch_bounds__(kThreads)
write_pass(const T* __restrict__ g, T* __restrict__ p, float* __restrict__ m,
           float* __restrict__ v, const float* __restrict__ prev_norm,
           float* __restrict__ new_norm, const float* __restrict__ partials,
           const float* __restrict__ step_size,
           const float* __restrict__ wd_coef, long long na, Coeffs c,
           float gamma, int use_limiter, int weight_decay) {
  constexpr int B = 1 << LEVEL;
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
  const float scale_t = round_to<T>(s_scale);
  const float ss = *step_size;
  const float wd = *wd_coef;
  const T* gl = g + leaf * na * B;
  T* pl = p + leaf * na * B;
  float* ml = m + leaf * na;
  float* vl = v + leaf * na;
  const long long base = (long long)blockIdx.x * kChunk + threadIdx.x;
  for (int k = 0; k < kPerThread; ++k) {
    const long long j = base + (long long)k * kThreads;
    if (j >= na) break;
    float x[B];
#pragma unroll
    for (int i = 0; i < B; ++i) x[i] = to_f32(gl[j * B + i]);
    float mj = ml[j], vj = vl[j];
    dht_adam<LEVEL>(x, mj, vj, c);
    ml[j] = mj;
    vl[j] = vj;
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const float gt = round_to<T>(x[i]);
      const float limited = round_to<T>(__fmul_rn(gt, scale_t));
      const float p32 = to_f32(pl[j * B + i]);
      float np = __fsub_rn(p32, __fmul_rn(ss, limited));
      if (weight_decay) np = __fsub_rn(np, __fmul_rn(wd, p32));
      pl[j * B + i] = from_f32<T>(np);
    }
  }
}

template <typename T, int LEVEL>
cudaError_t launch(const void* g, void* p, float* m, float* v,
                   const float* prev_norm, float* new_norm, float* partials,
                   const float* step_size, const float* wd_coef, long long L,
                   long long na, Coeffs c, float gamma, int use_limiter,
                   int weight_decay, cudaStream_t stream) {
  const long long S = (na + kChunk - 1) / kChunk;
  const dim3 grid((unsigned)S, (unsigned)L);
  if (use_limiter) {
    norm_pass<T, LEVEL><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(g), m, v, partials, na, c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  write_pass<T, LEVEL><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<T*>(p), m, v, prev_norm, new_norm,
      partials, step_size, wd_coef, na, c, gamma, use_limiter, weight_decay);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_level(int level, const void* g, void* p, float* m, float* v,
                         const float* prev_norm, float* new_norm,
                         float* partials, const float* step_size,
                         const float* wd_coef, long long L, long long na,
                         Coeffs c, float gamma, int use_limiter,
                         int weight_decay, cudaStream_t stream) {
  switch (level) {
    case 1:
      return launch<T, 1>(g, p, m, v, prev_norm, new_norm, partials, step_size,
                          wd_coef, L, na, c, gamma, use_limiter, weight_decay,
                          stream);
    case 2:
      return launch<T, 2>(g, p, m, v, prev_norm, new_norm, partials, step_size,
                          wd_coef, L, na, c, gamma, use_limiter, weight_decay,
                          stream);
    case 3:
      return launch<T, 3>(g, p, m, v, prev_norm, new_norm, partials, step_size,
                          wd_coef, L, na, c, gamma, use_limiter, weight_decay,
                          stream);
    case 4:
      return launch<T, 4>(g, p, m, v, prev_norm, new_norm, partials, step_size,
                          wd_coef, L, na, c, gamma, use_limiter, weight_decay,
                          stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Coefficients per block: the wrapper sizes the partials buffer (L, S) with
// S = ceil(na / chunk).
int gwt_adam_fused_chunk() { return kChunk; }

// dtype: 0 = float32, 1 = bfloat16 (g and p share it); m, v f32 (L, na);
// prev_norm, new_norm f32 (L,); partials f32 (L, S); step_size and wd_coef
// point to f32 scalars on the device.  p, m, v are updated in place.
int gwt_adam_fused(int dtype, int level, const void* g, void* p, float* m,
                   float* v, const float* prev_norm, float* new_norm,
                   float* partials, const float* step_size,
                   const float* wd_coef, long long L, long long na,
                   float gamma, float b1, float c1, float b2, float c2,
                   float eps, int use_limiter, int weight_decay,
                   void* stream) {
  const Coeffs c{b1, c1, b2, c2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_level<float>(level, g, p, m, v, prev_norm, new_norm,
                               partials, step_size, wd_coef, L, na, c, gamma,
                               use_limiter, weight_decay, s);
  if (dtype == 1)
    return launch_level<__nv_bfloat16>(level, g, p, m, v, prev_norm, new_norm,
                                       partials, step_size, wd_coef, L, na, c,
                                       gamma, use_limiter, weight_decay, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
