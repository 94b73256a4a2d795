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

#include "gwt_adam_common.cuh"

namespace {

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
    acc = sum_sq<T, B>(x, acc);
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
  const float scale_t = round_to<T>(
      leaf_scale(partials, prev_norm, new_norm, gamma, use_limiter));
  const float ss = *step_size;
  const float wd = *wd_coef;
  const long long leaf = blockIdx.y;
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
    write_params<T, B>(pl + j * B, x, scale_t, ss, wd, weight_decay);
  }
}

template <typename T>
cudaError_t launch(int level, const void* g, void* p, float* m, float* v,
                   const float* prev_norm, float* new_norm, float* partials,
                   const float* step_size, const float* wd_coef, long long L,
                   long long na, Coeffs c, float gamma, int use_limiter,
                   int weight_decay, cudaStream_t stream) {
  const long long S = (na + kChunk - 1) / kChunk;
  const dim3 grid((unsigned)S, (unsigned)L);
  return with_level(level, [&](auto lv) {
    constexpr int LEVEL = decltype(lv)::value;
    if (use_limiter) {
      norm_pass<T, LEVEL><<<grid, kThreads, 0, stream>>>(
          static_cast<const T*>(g), m, v, partials, na, c);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    write_pass<T, LEVEL><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(g), static_cast<T*>(p), m, v, prev_norm,
        new_norm, partials, step_size, wd_coef, na, c, gamma, use_limiter,
        weight_decay);
    return cudaGetLastError();
  });
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
    return launch<float>(level, g, p, m, v, prev_norm, new_norm, partials,
                         step_size, wd_coef, L, na, c, gamma, use_limiter,
                         weight_decay, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(level, g, p, m, v, prev_norm, new_norm,
                                 partials, step_size, wd_coef, L, na, c,
                                 gamma, use_limiter, weight_decay, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
