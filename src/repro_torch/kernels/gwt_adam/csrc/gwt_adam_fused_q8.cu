// Fused-write GWT-Adam update over blocked-int8 moments (K2), for one
// (L, N) bucket of same-shaped leaves: dequantize m and v (q * scale of the
// coefficient's 64-element block) -> level-l Haar DWT along rows -> Adam on
// the A_l band -> A~ = m/(sqrt(v)+eps), details scaled by the same
// 1/(sqrt(v)+eps) -> inverse DWT -> G~ rounded to the parameter type ->
// per-leaf ||G~|| -> norm-growth limiter -> p <- p - step*s*G~ - wd*p, and
// the new m and v requantized with stochastic rounding; p, codes and scales
// are written in place.
//
// Replaces the TPU kernel gwt_adam_tile_fused_q8 (body _body_fused_q8) of
// src/repro/kernels/gwt_adam/kernel.py (pallas_call at line 554).
//
// Bound on an H100: as for K1, O(30) f32 operations per gradient element
// against a handful of bytes, so memory bounds it.  It must read g (2 bytes
// in bf16), read and write p (2 + 2), read and write the int8 codes of m
// and v (1 byte each way per moment, once per 2^l gradient elements) and
// their f32 scales (one per 64 codes): 7.06 bytes per gradient element at
// level 2, against 10 for f32 moments.
//
// Two designs, as for K1 (gwt_adam_fused.cu), chosen per bucket by the
// caller before the launch (kernel.py: one_pass_fits, the same capacity
// rule: ceil(L*S / SMs) * 2048 * 2^l * sizeof(T) bytes of G~ per SM):
//
//  * One pass (gwt_adam_fused_q8_one_pass; gwt_adam_common.cuh describes
//    the design): one cooperative launch reading every input once, 7.06
//    bytes per element at level 2.  A thread takes two adjacent
//    coefficients, so a warp holds exactly one 64-coefficient quantization
//    block (32 lanes x 2): the absmax is warp shuffles only (warp_absmax),
//    with no shared-memory exchange and no block barrier, and 1/scale is
//    one __fdiv_rn per block and moment (quant_inv), the same bits as the
//    two-pass kernel's division per coefficient.  The codes are 2-byte
//    loads and stores, the scales one per warp.
//  * Two passes (gwt_adam_fused_q8; below), for buckets whose G~ does not
//    fit on chip: a norm pass writes one partial per (leaf, chunk of 2048
//    coefficients), the write pass sums its leaf's partials in a fixed
//    order and recomputes, about 9.6 bytes per element.  A chunk is 8
//    rounds of 256 threads, one coefficient each, so each round holds 4
//    whole quantization blocks, each on two warps: the absmax is a warp
//    shuffle tree and one exchange between the two warps through shared
//    memory (pair_absmax, two barriers a round).
//
// Common to both:
//  * One A_l coefficient's chain per thread over the leaf's flat
//    coefficient index j (coefficient j covers gradient elements
//    [j*2^l, (j+1)*2^l)).  A quantization block is 64 consecutive flat
//    coefficients of one leaf, numbered from 0 at every leaf, so it needs
//    no row arithmetic where it straddles rows (n>>l = 344).  A leaf whose
//    coefficient count is not a multiple of 64 ends in a partial block: the
//    absent coefficients count as 0, which leaves the absmax of the present
//    ones.  Chunks are 2048 coefficients, so a CUDA block owns whole
//    quantization blocks.
//  * Stochastic rounding: u = uniform01(salt, j), the murmur3 hash of
//    optim/codec.py in native uint32 arithmetic; the bits depend only on
//    (salt, j), so both designs round as the plain version does.  The salts
//    (one per leaf and moment) are computed on the device by the codec
//    module and passed in.
//  * In place: every lane of a quantization block reads its scale before
//    the absmax (the one-pass kernel copies a chunk's codes and scales into
//    shared memory before it writes any), and the one lane that writes the
//    new scale does so after.
//  * Rounding: the helpers of gwt_adam_common.cuh (_rn intrinsics, IEEE
//    sqrt and division); scale = absmax * f32(1/127), inv = 1/scale by
//    __fdiv_rn, y = x*inv, q = floor(y) + (u < y - floor(y)) clipped to
//    +-127 -- term for term the codec's blocked_quant.  Both designs write
//    the same (L, S) partials in the same order, so p, codes, scales and
//    the new norms are bitwise equal between them.

#include "gwt_adam_common.cuh"
#include "gwt_adam_q8.cuh"

namespace {

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

template <typename T>
cudaError_t launch_one(int level, const OnePassArgs<T>& a,
                       const Q8Moments& mo, cudaStream_t stream) {
  return with_level(level, [&](auto lv) {
    return launch_one_pass<T, decltype(lv)::value>(a, mo, stream);
  });
}

template <typename T>
cudaError_t plan_one(int level, long long total, int* out) {
  return with_level(level, [&](auto lv) {
    constexpr int LEVEL = decltype(lv)::value;
    return export_plan(one_pass_kernel<T, LEVEL, Q8Moments>(),
                       one_pass_slot<T, LEVEL>(), one_pass_ring<Q8Moments>(), total,
                       out);
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

// The one-pass design, same arguments.  The caller has checked that the
// bucket fits (one_pass_fits); otherwise the plan fails with
// cudaErrorInvalidConfiguration before anything is launched.  A refused
// cooperative launch returns its error.
int gwt_adam_fused_q8_one_pass(int dtype, int level, const void* g, void* p,
                               signed char* qm, float* sm, signed char* qv,
                               float* sv, const unsigned* salt_m,
                               const unsigned* salt_v,
                               const float* prev_norm, float* new_norm,
                               float* partials, const float* step_size,
                               const float* wd_coef, long long L,
                               long long na, float gamma, float b1, float c1,
                               float b2, float c2, float eps,
                               int use_limiter, int weight_decay,
                               void* stream) {
  const Coeffs c{b1, c1, b2, c2, eps};
  const long long S = (na + kChunk - 1) / kChunk;
  const Q8Moments mo{qm, sm, qv, sv, salt_m, salt_v, qm, sm, qv, sv,
                     (na + kQBlock - 1) / kQBlock};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const OnePassArgs<float> a{static_cast<const float*>(g),
                               static_cast<float*>(p), partials, prev_norm,
                               new_norm, step_size, wd_coef, na, S, L * S, 0, c,
                               gamma, use_limiter, weight_decay};
    return launch_one<float>(level, a, mo, s);
  }
  if (dtype == 1) {
    const OnePassArgs<__nv_bfloat16> a{
        static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(p),
        partials, prev_norm, new_norm, step_size, wd_coef, na, S, L * S, 0, c,
        gamma, use_limiter, weight_decay};
    return launch_one<__nv_bfloat16>(level, a, mo, s);
  }
  return cudaErrorInvalidValue;
}

// The one-pass plan of an (L, na) bucket, as gwt_adam_fused_one_pass_plan.
int gwt_adam_fused_q8_one_pass_plan(int dtype, int level, long long L,
                                    long long na, int* out) {
  const long long total = L * ((na + kChunk - 1) / kChunk);
  if (dtype == 0) return plan_one<float>(level, total, out);
  if (dtype == 1) return plan_one<__nv_bfloat16>(level, total, out);
  return cudaErrorInvalidValue;
}

}  // extern "C"
