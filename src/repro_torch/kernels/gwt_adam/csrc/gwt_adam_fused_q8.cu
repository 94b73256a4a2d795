// Fused-write GWT-Adam update over blocked-int8 moments, for one (L, N)
// bucket of same-shaped leaves: dequantize m and v (q * scale of the
// coefficient's 64-element block) -> level-l Haar DWT along rows -> Adam on
// the A_l band -> A~ = m/(sqrt(v)+eps), details scaled by the same
// 1/(sqrt(v)+eps) -> inverse DWT -> G~ rounded to the parameter type ->
// per-leaf ||G~|| -> norm-growth limiter -> p <- p - step*s*G~ - wd*p, and
// the new m and v requantized with stochastic rounding; p, codes and scales
// are written in place.
//
// Replaces the TPU kernel gwt_adam_tile_fused_q8 (body _body_fused_q8) of
// src/repro/kernels/gwt_adam/kernel.py.
//
// Bound on an H100: as for the f32 kernel, O(30) f32 operations per
// gradient element against a handful of bytes, so memory bounds it.  It must
// read g (2 bytes in bf16), read and write p (2 + 2), read and write the
// int8 codes of m and v (1 byte each way per moment, once per 2^l gradient
// elements) and their f32 scales (one per 64 codes): 7.06 bytes per gradient
// element at level 2, against 10 for f32 moments.
//
// Design: the f32 kernel's (gwt_adam_fused.cu), with the moment format
// changed.
//  * One thread per A_l coefficient over the leaf's flat coefficient index
//    j (coefficient j covers gradient elements [j*2^l, (j+1)*2^l)); a norm
//    pass writes one partial per (leaf, block of coefficients), the write
//    pass sums its leaf's partials in a fixed order and recomputes.
//  * A quantization block is 64 consecutive flat coefficients of one leaf,
//    numbered from 0 at every leaf, so it needs no row arithmetic where it
//    straddles rows (n>>l = 344).  A CUDA block takes 2048 coefficients in
//    8 rounds of 256, so each round holds 4 whole quantization blocks, each
//    on two warps.  The absmax is a max (exact, order-free) by a warp
//    shuffle tree and one exchange between the two warps through shared
//    memory.  A leaf whose coefficient count is not a multiple of 64 ends in
//    a partial block: the absent coefficients count as 0, which leaves the
//    absmax of the present ones.
//  * Stochastic rounding: u = uniform01(salt, j), the murmur3 hash of
//    optim/codec.py in native uint32 arithmetic; the bits depend only on
//    (salt, j), so the write pass rounds as the plain version does.  The
//    salts (one per leaf and moment) are computed on the device by the codec
//    module and passed in.
//  * In place: every thread of a quantization block reads its scale before
//    the block's first barrier, and the one thread that writes the new scale
//    does so after it.  CUDA blocks own disjoint quantization blocks.
//  * Rounding: the helpers of gwt_adam_common.cuh (_rn intrinsics, IEEE
//    sqrt and division); scale = absmax * f32(1/127), inv = 1/scale by
//    __fdiv_rn, y = x*inv, q = floor(y) + (u < y - floor(y)) clipped to
//    +-127 — term for term the codec's blocked_quant.

#include "gwt_adam_common.cuh"

namespace {

constexpr int kQBlock = 64;  // coefficients per quantization block
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);
constexpr unsigned kM1 = 0x85EBCA6Bu, kM2 = 0xC2B2AE35u, kGold = 0x9E3779B9u;

__device__ __forceinline__ unsigned fmix(unsigned h) {
  h ^= h >> 16;
  h *= kM1;
  h ^= h >> 13;
  h *= kM2;
  h ^= h >> 16;
  return h;
}

// 24 exact bits in [0, 1)
__device__ __forceinline__ float uniform01(unsigned salt, unsigned idx) {
  const unsigned bits = fmix(salt ^ (idx * kGold));
  return __fmul_rn(static_cast<float>(bits >> 8), 1.0f / 16777216.0f);
}

__device__ __forceinline__ float dequant(const signed char* __restrict__ q,
                                         const float* __restrict__ s,
                                         long long j) {
  return __fmul_rn(static_cast<float>(q[j]), s[j / kQBlock]);
}

__device__ __forceinline__ float quant_scale(float absmax) {
  return __fmul_rn(absmax, kInv127);
}

__device__ __forceinline__ signed char quant(float x, float scale,
                                             unsigned salt, unsigned idx) {
  const float inv = scale > 0.0f ? __fdiv_rn(1.0f, scale) : 0.0f;
  const float y = __fmul_rn(x, inv);
  const float lo = floorf(y);
  float q = uniform01(salt, idx) < __fsub_rn(y, lo) ? __fadd_rn(lo, 1.0f)
                                                    : lo;
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<signed char>(static_cast<int>(q));
}

// Absmax of |a| over the 64 threads (two warps) of each quantization block
// of the current round, for two values at once.  Synchronises the block.
__device__ __forceinline__ void pair_absmax(float& am, float& av) {
  __shared__ float s_am[kThreads / 32], s_av[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, off));
    av = fmaxf(av, __shfl_xor_sync(0xffffffffu, av, off));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_am[warp] = am;
    s_av[warp] = av;
  }
  __syncthreads();
  const int first = warp & ~1;
  am = fmaxf(s_am[first], s_am[first + 1]);
  av = fmaxf(s_av[first], s_av[first + 1]);
  __syncthreads();  // the next round overwrites s_am, s_av
}

// grid (S, L): block s of leaf l takes coefficients [s*kChunk, (s+1)*kChunk).
template <typename T, int LEVEL>
__global__ void __launch_bounds__(kThreads)
norm_pass(const T* __restrict__ g, const signed char* __restrict__ qm,
          const float* __restrict__ sm, const signed char* __restrict__ qv,
          const float* __restrict__ sv, float* __restrict__ partials,
          long long na, long long nb, Coeffs c) {
  constexpr int B = 1 << LEVEL;
  const long long leaf = blockIdx.y;
  const T* gl = g + leaf * na * B;
  const signed char* qml = qm + leaf * na;
  const signed char* qvl = qv + leaf * na;
  const float* sml = sm + leaf * nb;
  const float* svl = sv + leaf * nb;
  const long long base = (long long)blockIdx.x * kChunk + threadIdx.x;
  float acc = 0.0f;
  for (int k = 0; k < kPerThread; ++k) {
    const long long j = base + (long long)k * kThreads;
    if (j >= na) break;
    float x[B];
#pragma unroll
    for (int i = 0; i < B; ++i) x[i] = to_f32(gl[j * B + i]);
    float mj = dequant(qml, sml, j), vj = dequant(qvl, svl, j);
    dht_adam<LEVEL>(x, mj, vj, c);
    acc = sum_sq<T, B>(x, acc);
  }
  const float total = block_sum(acc);
  if (threadIdx.x == 0) partials[leaf * gridDim.x + blockIdx.x] = total;
}

template <typename T, int LEVEL>
__global__ void __launch_bounds__(kThreads)
write_pass(const T* __restrict__ g, T* __restrict__ p,
           signed char* __restrict__ qm, float* __restrict__ sm,
           signed char* __restrict__ qv, float* __restrict__ sv,
           const unsigned* __restrict__ salt_m,
           const unsigned* __restrict__ salt_v,
           const float* __restrict__ prev_norm, float* __restrict__ new_norm,
           const float* __restrict__ partials,
           const float* __restrict__ step_size,
           const float* __restrict__ wd_coef, long long na, long long nb,
           Coeffs c, float gamma, int use_limiter, int weight_decay) {
  constexpr int B = 1 << LEVEL;
  const float scale_t = round_to<T>(
      leaf_scale(partials, prev_norm, new_norm, gamma, use_limiter));
  const float ss = *step_size;
  const float wd = *wd_coef;
  const long long leaf = blockIdx.y;
  const unsigned salt_ml = salt_m[leaf], salt_vl = salt_v[leaf];
  const T* gl = g + leaf * na * B;
  T* pl = p + leaf * na * B;
  signed char* qml = qm + leaf * na;
  signed char* qvl = qv + leaf * na;
  float* sml = sm + leaf * nb;
  float* svl = sv + leaf * nb;
  for (int k = 0; k < kPerThread; ++k) {
    // the round's start is the same for every thread: the barriers inside
    // pair_absmax are reached by the whole block or by none of it
    const long long j0 = (long long)blockIdx.x * kChunk + (long long)k * kThreads;
    if (j0 >= na) break;
    const long long j = j0 + threadIdx.x;
    const bool valid = j < na;
    float x[B];
    float mj = 0.0f, vj = 0.0f;
#pragma unroll
    for (int i = 0; i < B; ++i) x[i] = valid ? to_f32(gl[j * B + i]) : 0.0f;
    if (valid) {
      mj = dequant(qml, sml, j);
      vj = dequant(qvl, svl, j);
    }
    dht_adam<LEVEL>(x, mj, vj, c);
    if (valid) write_params<T, B>(pl + j * B, x, scale_t, ss, wd, weight_decay);
    float am = valid ? fabsf(mj) : 0.0f, av = valid ? fabsf(vj) : 0.0f;
    pair_absmax(am, av);
    const float scm = quant_scale(am), scv = quant_scale(av);
    if (valid) {
      qml[j] = quant(mj, scm, salt_ml, static_cast<unsigned>(j));
      qvl[j] = quant(vj, scv, salt_vl, static_cast<unsigned>(j));
      if (j % kQBlock == 0) {
        sml[j / kQBlock] = scm;
        svl[j / kQBlock] = scv;
      }
    }
  }
}

template <typename T>
cudaError_t launch(int level, const void* g, void* p, signed char* qm,
                   float* sm, signed char* qv, float* sv,
                   const unsigned* salt_m, const unsigned* salt_v,
                   const float* prev_norm, float* new_norm, float* partials,
                   const float* step_size, const float* wd_coef, long long L,
                   long long na, Coeffs c, float gamma, int use_limiter,
                   int weight_decay, cudaStream_t stream) {
  const long long S = (na + kChunk - 1) / kChunk;
  const long long nb = (na + kQBlock - 1) / kQBlock;
  const dim3 grid((unsigned)S, (unsigned)L);
  return with_level(level, [&](auto lv) {
    constexpr int LEVEL = decltype(lv)::value;
    if (use_limiter) {
      norm_pass<T, LEVEL><<<grid, kThreads, 0, stream>>>(
          static_cast<const T*>(g), qm, sm, qv, sv, partials, na, nb, c);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    write_pass<T, LEVEL><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(g), static_cast<T*>(p), qm, sm, qv, sv, salt_m,
        salt_v, prev_norm, new_norm, partials, step_size, wd_coef, na, nb, c,
        gamma, use_limiter, weight_decay);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// Coefficients per CUDA block (the partials buffer is (L, ceil(na/chunk)))
// and per quantization block (the scales are (L, ceil(na/qblock))).
int gwt_adam_fused_q8_chunk() { return kChunk; }
int gwt_adam_fused_q8_qblock() { return kQBlock; }

// dtype: 0 = float32, 1 = bfloat16 (g and p share it); qm, qv int8 (L, na);
// sm, sv f32 (L, nb); salt_m, salt_v uint32 (L,); prev_norm, new_norm f32
// (L,); partials f32 (L, S); step_size and wd_coef point to f32 scalars on
// the device.  p, qm, sm, qv, sv are updated in place.
int gwt_adam_fused_q8(int dtype, int level, const void* g, void* p,
                      signed char* qm, float* sm, signed char* qv, float* sv,
                      const unsigned* salt_m, const unsigned* salt_v,
                      const float* prev_norm, float* new_norm,
                      float* partials, const float* step_size,
                      const float* wd_coef, long long L, long long na,
                      float gamma, float b1, float c1, float b2, float c2,
                      float eps, int use_limiter, int weight_decay,
                      void* stream) {
  const Coeffs c{b1, c1, b2, c2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(level, g, p, qm, sm, qv, sv, salt_m, salt_v,
                         prev_norm, new_norm, partials, step_size, wd_coef, L,
                         na, c, gamma, use_limiter, weight_decay, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(level, g, p, qm, sm, qv, sv, salt_m, salt_v,
                                 prev_norm, new_norm, partials, step_size,
                                 wd_coef, L, na, c, gamma, use_limiter,
                                 weight_decay, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
