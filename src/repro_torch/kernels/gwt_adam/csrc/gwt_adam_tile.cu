// Staged GWT-Adam update for one (L, N) stack of same-shaped leaves, in one
// launch: level-l Haar DWT along rows -> Adam on the A_l band ->
// A~ = m/(sqrt(v)+eps), details scaled by the same 1/(sqrt(v)+eps) ->
// inverse DWT -> G~ written in the gradient's type, new m and v written to
// their own outputs, and one partial ||G~||^2 of the rounded G~ per
// (leaf, CUDA block).  The limiter, the step and the parameter write stay
// with the caller.  Two variants:
//
//  * gwt_adam_tile (K4) over f32 moments.  Replaces the TPU kernel
//    gwt_adam_tile (body _body, core _dht_adam_core) of
//    src/repro/kernels/gwt_adam/kernel.py.
//  * gwt_adam_tile_q8 (K5) over blocked-int8 moments: dequantize -> K4's
//    chain -> stochastic requantization of the new m and v.  Replaces
//    gwt_adam_tile_q8 (body _body_q8) of the same file.
//
// Bound on an H100: O(30) f32 operations per gradient element against a
// few bytes, so memory bounds both.  K4 must read g (2 bytes in bf16),
// write G~ (2), and read and write m and v (4 bytes each way per moment,
// once per 2^l gradient elements): 8 bytes per gradient element at level
// 2.  K5 moves the moments as int8 codes plus one f32 scale per 64 codes:
// about 5.06 bytes per element at level 2.
//
// Design (K1's and K2's, gwt_adam_fused.cu and gwt_adam_fused_q8.cu, without
// the limiter and the write):
//  * One thread per A_l coefficient j of a leaf's flat coefficient index;
//    coefficient j covers gradient elements [j*2^l, (j+1)*2^l) of the flat
//    leaf, because rows are contiguous, so no row index and no shared
//    memory are needed for the transform.  A CUDA block takes 2048
//    coefficients in 8 rounds of 256 threads; the last block masks the
//    ragged end.
//  * Nothing waits on another block: without the limiter there is no
//    per-leaf sum to wait for, so one launch does it all.  Each block sums
//    its threads' squares in a fixed order (per thread in order, a shuffle
//    tree per warp, the warps in order) and writes one partial; the caller
//    sums the (L, S) partials if it wants ||G~||^2.  No float atomics: the
//    result is identical from run to run.
//  * K5: a quantization block is 64 consecutive flat coefficients of one
//    leaf, so each round holds 4 whole quantization blocks, each on two
//    warps; absmax by shuffles and one shared-memory exchange; the rounding
//    bits u = uniform01(salt, j) come from the codec's murmur3 hash in
//    native uint32, with the salts (one per leaf and moment) computed on
//    the device by the engine.  The outputs are separate buffers, so no
//    thread reads a scale that another has already replaced.
//  * Rounding follows the plain PyTorch versions (ref.py) point for point:
//    G~ is rounded to the gradient type before it is squared; every product
//    and sum is an _rn intrinsic, so nvcc contracts nothing into FMAs that
//    PyTorch's op-by-op arithmetic does not make; sqrt and division are
//    IEEE (build without --use_fast_math).

#include "gwt_adam_common.cuh"
#include "gwt_adam_q8.cuh"

namespace {

// Writes coefficient j's 2^LEVEL values of G~, rounded to T, and adds their
// squares to acc.
template <typename T, int B>
__device__ __forceinline__ float store_tilde(T* __restrict__ gj,
                                             const float (&x)[B],
                                             float acc) {
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const T r = from_f32<T>(x[i]);
    gj[i] = r;
    const float rf = to_f32(r);
    acc = __fadd_rn(acc, __fmul_rn(rf, rf));
  }
  return acc;
}

// grid (S, L): block s of leaf l takes coefficients [s*kChunk, (s+1)*kChunk).
template <typename T, int LEVEL>
__global__ void __launch_bounds__(kThreads)
tile(const T* __restrict__ g, const float* __restrict__ m,
     const float* __restrict__ v, T* __restrict__ gt,
     float* __restrict__ m_out, float* __restrict__ v_out,
     float* __restrict__ partials, long long na, Coeffs c) {
  constexpr int B = 1 << LEVEL;
  const long long leaf = blockIdx.y;
  const T* gl = g + leaf * na * B;
  T* gtl = gt + leaf * na * B;
  const long long off = leaf * na;
  const long long base = (long long)blockIdx.x * kChunk + threadIdx.x;
  float acc = 0.0f;
  for (int k = 0; k < kPerThread; ++k) {
    const long long j = base + (long long)k * kThreads;
    if (j >= na) break;
    float x[B];
#pragma unroll
    for (int i = 0; i < B; ++i) x[i] = to_f32(gl[j * B + i]);
    float mj = m[off + j], vj = v[off + j];
    dht_adam<LEVEL>(x, mj, vj, c);
    m_out[off + j] = mj;
    v_out[off + j] = vj;
    acc = store_tilde<T, B>(gtl + j * B, x, acc);
  }
  const float total = block_sum(acc);
  if (threadIdx.x == 0) partials[leaf * gridDim.x + blockIdx.x] = total;
}

template <typename T, int LEVEL>
__global__ void __launch_bounds__(kThreads)
tile_q8(const T* __restrict__ g, const signed char* __restrict__ qm,
        const float* __restrict__ sm, const signed char* __restrict__ qv,
        const float* __restrict__ sv, const unsigned* __restrict__ salt_m,
        const unsigned* __restrict__ salt_v, T* __restrict__ gt,
        signed char* __restrict__ qm_out, float* __restrict__ sm_out,
        signed char* __restrict__ qv_out, float* __restrict__ sv_out,
        float* __restrict__ partials, long long na, long long nb, Coeffs c) {
  constexpr int B = 1 << LEVEL;
  const long long leaf = blockIdx.y;
  const unsigned salt_ml = salt_m[leaf], salt_vl = salt_v[leaf];
  const T* gl = g + leaf * na * B;
  T* gtl = gt + leaf * na * B;
  const long long off = leaf * na, soff = leaf * nb;
  float acc = 0.0f;
  for (int k = 0; k < kPerThread; ++k) {
    // the round's start is the same for every thread: the barriers inside
    // pair_absmax are reached by the whole block or by none of it
    const long long j0 =
        (long long)blockIdx.x * kChunk + (long long)k * kThreads;
    if (j0 >= na) break;
    const long long j = j0 + threadIdx.x;
    const bool valid = j < na;
    float x[B];
    float mj = 0.0f, vj = 0.0f;
#pragma unroll
    for (int i = 0; i < B; ++i) x[i] = valid ? to_f32(gl[j * B + i]) : 0.0f;
    if (valid) {
      mj = dequant(qm + off, sm + soff, j);
      vj = dequant(qv + off, sv + soff, j);
    }
    dht_adam<LEVEL>(x, mj, vj, c);
    if (valid) acc = store_tilde<T, B>(gtl + j * B, x, acc);
    float am = valid ? fabsf(mj) : 0.0f, av = valid ? fabsf(vj) : 0.0f;
    pair_absmax(am, av);
    const float scm = quant_scale(am), scv = quant_scale(av);
    if (valid) {
      qm_out[off + j] = quant(mj, scm, salt_ml, static_cast<unsigned>(j));
      qv_out[off + j] = quant(vj, scv, salt_vl, static_cast<unsigned>(j));
      if (j % kQBlock == 0) {
        sm_out[soff + j / kQBlock] = scm;
        sv_out[soff + j / kQBlock] = scv;
      }
    }
  }
  const float total = block_sum(acc);
  if (threadIdx.x == 0) partials[leaf * gridDim.x + blockIdx.x] = total;
}

template <typename T>
cudaError_t launch(int level, const void* g, const float* m, const float* v,
                   void* gt, float* m_out, float* v_out, float* partials,
                   long long L, long long na, Coeffs c, cudaStream_t stream) {
  const dim3 grid((unsigned)((na + kChunk - 1) / kChunk), (unsigned)L);
  return with_level(level, [&](auto lv) {
    constexpr int LEVEL = decltype(lv)::value;
    tile<T, LEVEL><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(g), m, v, static_cast<T*>(gt), m_out, v_out,
        partials, na, c);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t launch_q8(int level, const void* g, const signed char* qm,
                      const float* sm, const signed char* qv, const float* sv,
                      const unsigned* salt_m, const unsigned* salt_v,
                      void* gt, signed char* qm_out, float* sm_out,
                      signed char* qv_out, float* sv_out, float* partials,
                      long long L, long long na, Coeffs c,
                      cudaStream_t stream) {
  const long long nb = (na + kQBlock - 1) / kQBlock;
  const dim3 grid((unsigned)((na + kChunk - 1) / kChunk), (unsigned)L);
  return with_level(level, [&](auto lv) {
    constexpr int LEVEL = decltype(lv)::value;
    tile_q8<T, LEVEL><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(g), qm, sm, qv, sv, salt_m, salt_v,
        static_cast<T*>(gt), qm_out, sm_out, qv_out, sv_out, partials, na,
        nb, c);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// Coefficients per CUDA block (the partials are (L, ceil(na/chunk))) and
// per quantization block (the scales are (L, ceil(na/qblock))).
int gwt_adam_tile_chunk() { return kChunk; }
int gwt_adam_tile_qblock() { return kQBlock; }

// dtype: 0 = float32, 1 = bfloat16 (g and gt share it); m, v, m_out, v_out
// f32 (L, na); partials f32 (L, S).  The outputs must not overlap the
// inputs.
int gwt_adam_tile(int dtype, int level, const void* g, const float* m,
                  const float* v, void* gt, float* m_out, float* v_out,
                  float* partials, long long L, long long na, float b1,
                  float c1, float b2, float c2, float eps, void* stream) {
  const Coeffs c{b1, c1, b2, c2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(level, g, m, v, gt, m_out, v_out, partials, L, na,
                         c, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(level, g, m, v, gt, m_out, v_out, partials,
                                 L, na, c, s);
  return cudaErrorInvalidValue;
}

// As gwt_adam_tile over blocked-int8 moments: qm, qv (and qm_out, qv_out)
// int8 (L, na); sm, sv (and sm_out, sv_out) f32 (L, nb); salt_m, salt_v
// uint32 (L,).
int gwt_adam_tile_q8(int dtype, int level, const void* g,
                     const signed char* qm, const float* sm,
                     const signed char* qv, const float* sv,
                     const unsigned* salt_m, const unsigned* salt_v,
                     void* gt, signed char* qm_out, float* sm_out,
                     signed char* qv_out, float* sv_out, float* partials,
                     long long L, long long na, float b1, float c1, float b2,
                     float c2, float eps, void* stream) {
  const Coeffs c{b1, c1, b2, c2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_q8<float>(level, g, qm, sm, qv, sv, salt_m, salt_v, gt,
                            qm_out, sm_out, qv_out, sv_out, partials, L, na,
                            c, s);
  if (dtype == 1)
    return launch_q8<__nv_bfloat16>(level, g, qm, sm, qv, sv, salt_m, salt_v,
                                    gt, qm_out, sm_out, qv_out, sv_out,
                                    partials, L, na, c, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
