// Device helpers of the blocked-int8 GWT-Adam kernels
// (gwt_adam_fused_q8.cu: K2, the fused write; gwt_adam_tile.cu: K5, the
// staged update): dequantization, the codec's murmur3 rounding hash in
// native uint32, stochastic requantization and the absmax of a
// 64-coefficient quantization block held by two warps (the two-pass K2 and
// K5) or by one (the one-pass K2).  Include after
// gwt_adam_common.cuh.  Rounding as there: _rn intrinsics, IEEE division.

#pragma once

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

// 1/scale of a quantization block (0 for an all-zero block).
__device__ __forceinline__ float quant_inv(float scale) {
  return scale > 0.0f ? __fdiv_rn(1.0f, scale) : 0.0f;
}

// x's code, given its block's 1/scale.
__device__ __forceinline__ signed char quant_with(float x, float inv,
                                                  unsigned salt,
                                                  unsigned idx) {
  const float y = __fmul_rn(x, inv);
  const float lo = floorf(y);
  float q = uniform01(salt, idx) < __fsub_rn(y, lo) ? __fadd_rn(lo, 1.0f)
                                                    : lo;
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<signed char>(static_cast<int>(q));
}

__device__ __forceinline__ signed char quant(float x, float scale,
                                             unsigned salt, unsigned idx) {
  return quant_with(x, quant_inv(scale), salt, idx);
}

// Absmax over one warp, for two values at once: the one-pass K2 puts a
// whole quantization block on one warp (32 lanes x 2 coefficients), so no
// shared memory and no barrier.  A max is exact and order-free, so it
// equals pair_absmax's.
__device__ __forceinline__ void warp_absmax(float& am, float& av) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, off));
    av = fmaxf(av, __shfl_xor_sync(0xffffffffu, av, off));
  }
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

}  // namespace
