// Fused-write GWT-Adam update (K1) for one (L, N) bucket of same-shaped
// leaves: level-l Haar DWT along rows -> Adam on the A_l band (m, v in
// place) -> A~ = m/(sqrt(v)+eps), details scaled by the same
// 1/(sqrt(v)+eps) -> inverse DWT -> G~ rounded to the parameter type ->
// per-leaf ||G~|| -> norm-growth limiter -> p <- p - step*s*G~ - wd*p,
// written in place.
//
// Replaces the TPU kernel gwt_adam_tile_fused (body _body_fused) of
// src/repro/kernels/gwt_adam/kernel.py (pallas_call at line 404).
//
// Bound on an H100: the update does O(30) f32 operations per gradient
// element, so memory bounds it.  It must read g and p (2 + 2 bytes in bf16),
// read and write m and v (4 + 4 bytes each, once per 2^l gradient elements)
// and write p (2 bytes): 10 bytes per gradient element at level 2.  LLaMA-60M
// has 25.3 M such elements, so about 253 MB per step over three launches.
//
// Two designs, chosen per bucket by the caller before the launch
// (kernel.py: one_pass_fits):
//
//  * One pass (gwt_adam_fused_one_pass; the design is described in
//    gwt_adam_common.cuh): one cooperative launch that reads g, m, v and p
//    once and writes m, v and p once, 10 bytes per element at level 2, with
//    16-byte loads, g staged into shared memory by cp.async, and the rounded
//    G~ held in shared memory across one grid barrier while the per-leaf
//    norms are summed.  It carries the main path: llama-60m's three bf16
//    buckets need 8, 11 and 6 chunks of 16 KB per SM, within the 227 KB a
//    block may hold.  Capacity rule: ceil(L*S / SMs) * 2048 * 2^l *
//    sizeof(T) <= the shared memory one block may have, S = ceil(na/2048).
//  * Two passes (gwt_adam_fused; below), for the buckets whose G~ does not
//    fit on chip (f32 parameters of (2, 4096, 1376) need 45 MB; larger
//    models).  CUDA blocks run in no order, so the per-leaf norm takes two
//    launches: the norm pass writes one f32 partial per (leaf, chunk of
//    2048 coefficients) and nothing else; the write pass sums its leaf's
//    partials in a fixed order (leaf_scale), applies the limiter,
//    recomputes the tile and writes p, m, v.  Recomputing costs one more
//    read of g, m and v: 14 bytes per element against the 10-byte bound.
//
// Both designs put one A_l coefficient's chain in one thread: at level l,
// approximation coefficient j of a row depends only on the 2^l gradient
// values [j*2^l, (j+1)*2^l); rows are contiguous and have n = na*2^l
// elements, so coefficient c of a leaf covers elements [c*2^l, (c+1)*2^l)
// of the flat leaf, and widths whose band is not a power of two (1376 ->
// 344) need nothing special.  Both write the same (L, S) partials in the
// same order, so every written value is bitwise the same in both; no float
// atomics, so the result is identical from run to run.  Rounding follows
// the plain PyTorch version (ref.py) point for point: G~ is rounded to the
// parameter type before the norm and the write, limited = G~ * T(scale) is
// rounded to T, new p is computed in f32.  Every product and sum is written
// with an _rn intrinsic, so nvcc cannot contract them into FMAs that
// PyTorch's op-by-op arithmetic does not make, and sqrt and division are
// IEEE (build without --use_fast_math).

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

template <typename T>
cudaError_t launch_one(int level, const OnePassArgs<T>& a, float* m,
                       float* v, cudaStream_t stream) {
  return with_level(level, [&](auto lv) {
    return launch_one_pass<T, decltype(lv)::value>(
        a, F32Moments{m, v, m, v}, stream);
  });
}

template <typename T>
cudaError_t plan_one(int level, long long total, int* out) {
  return with_level(level, [&](auto lv) {
    constexpr int LEVEL = decltype(lv)::value;
    return export_plan(one_pass_kernel<T, LEVEL, F32Moments>(),
                       one_pass_slot<T, LEVEL>(), one_pass_ring<F32Moments>(), total,
                       out);
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

// The one-pass design, same arguments.  The caller has checked that the
// bucket fits (one_pass_fits); otherwise the plan fails with
// cudaErrorInvalidConfiguration before anything is launched.  A refused
// cooperative launch returns its error.
int gwt_adam_fused_one_pass(int dtype, int level, const void* g, void* p,
                            float* m, float* v, const float* prev_norm,
                            float* new_norm, float* partials,
                            const float* step_size, const float* wd_coef,
                            long long L, long long na, float gamma, float b1,
                            float c1, float b2, float c2, float eps,
                            int use_limiter, int weight_decay, void* stream) {
  const Coeffs c{b1, c1, b2, c2, eps};
  const long long S = (na + kChunk - 1) / kChunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const OnePassArgs<float> a{static_cast<const float*>(g),
                               static_cast<float*>(p), partials, prev_norm,
                               new_norm, step_size, wd_coef, na, S, L * S, 0, c,
                               gamma, use_limiter, weight_decay};
    return launch_one<float>(level, a, m, v, s);
  }
  if (dtype == 1) {
    const OnePassArgs<__nv_bfloat16> a{
        static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(p),
        partials, prev_norm, new_norm, step_size, wd_coef, na, S, L * S, 0, c,
        gamma, use_limiter, weight_decay};
    return launch_one<__nv_bfloat16>(level, a, m, v, s);
  }
  return cudaErrorInvalidValue;
}

// The one-pass plan of an (L, na) bucket: out[0..8] = registers per
// thread, local (spill) bytes, static shared bytes, the most dynamic shared
// bytes a block may have, SMs, blocks per SM, slots per block, dynamic
// shared bytes per block, grid.
int gwt_adam_fused_one_pass_plan(int dtype, int level, long long L,
                                 long long na, int* out) {
  const long long total = L * ((na + kChunk - 1) / kChunk);
  if (dtype == 0) return plan_one<float>(level, total, out);
  if (dtype == 1) return plan_one<__nv_bfloat16>(level, total, out);
  return cudaErrorInvalidValue;
}

}  // extern "C"
