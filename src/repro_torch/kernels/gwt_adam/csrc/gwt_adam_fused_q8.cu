// Fused-write GWT-Adam update over blocked-int8 moments (K2), for one
// (L, N) bucket of same-shaped leaves: dequantize m and v (q * scale of the
// coefficient's 64-element block) -> level-l Haar DWT along rows -> Adam on
// the A_l band -> A~ = m/(sqrt(v)+eps), details scaled by the same
// 1/(sqrt(v)+eps) -> inverse DWT -> G~ rounded to the gradient type ->
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
//  * Two passes (gwt_adam_fused_q8; gwt_adam_common.cuh describes the
//    design), for buckets whose G~ does not fit on chip: a norm pass
//    (below) writes one partial per (leaf, chunk of 2048 coefficients), the
//    scale pass sums each leaf's partials once in a fixed order, and the
//    write pass streams the bucket through a persistent grid and
//    recomputes, about 9.6 bytes per element.  Its rounds are the one-pass
//    kernel's (Q8Moments: a warp is one quantization block, the codes and
//    scales staged into shared memory with g and p).
//
// This source builds two libraries, as gwt_adam_fused.cu does:
// gwt_adam_fused_q8 (per bucket) and, with -DGWT_ADAM_GROUPED,
// gwt_adam_fused_q8_group (grouped).
//
// Grouped (gwt_adam_fused_q8_group): the one-pass design over up to
// kGroupBuckets buckets in one cooperative launch, each bucket what
// gwt_adam_tile_fused_q8 computes for it alone, bitwise.  At adapter
// sizes a launch is bound by its latency, not by the 7.06 bytes an
// element: llama-60m's four LoRA adapter buckets took 0.0155-0.0162 ms a
// launch against a bound of 0.0021 ms for all four (H100 80GB HBM3,
// 700 W); one launch over the step's buckets pays the latency once.
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
//  * In place: a chunk's (the write pass: a piece's) codes and scales are
//    copied into shared memory before any of them is written.
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

template <typename T, typename P>
cudaError_t launch(int level, const void* g, void* p, const Q8Moments& mo,
                   const float* prev_norm, float* new_norm, float* partials,
                   float* scale, const float* step_size,
                   const float* wd_coef, long long L, long long na, Coeffs c,
                   float gamma, int use_limiter, int weight_decay,
                   cudaStream_t stream) {
  const long long S = (na + kChunk - 1) / kChunk;
  const dim3 grid((unsigned)S, (unsigned)L);
  return with_level(level, [&](auto lv) {
    constexpr int LEVEL = decltype(lv)::value;
    if (use_limiter) {
      norm_pass<T, LEVEL><<<grid, kThreads, 0, stream>>>(
          static_cast<const T*>(g), mo.qm, mo.sm, mo.qv, mo.sv, partials, na,
          mo.nb, c);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    return launch_scale_and_write<T, P, LEVEL>(
        static_cast<const T*>(g), static_cast<P*>(p), mo, partials, scale,
        prev_norm, new_norm, step_size, wd_coef, L, na, c, gamma,
        use_limiter, weight_decay, stream);
  });
}

template <class Group>
cudaError_t launch_one(int level, Group& a, cudaStream_t stream) {
  return with_level(level, [&](auto lv) {
    return launch_one_pass<decltype(lv)::value>(a, stream);
  });
}

// The plan of this library's one-pass kernel (a table of kTable buckets).
template <typename T, typename P>
cudaError_t plan_one(int level, long long total, int* out) {
  return with_level(level, [&](auto lv) {
    constexpr int LEVEL = decltype(lv)::value;
    return export_plan(
        one_pass_kernel<T, P, LEVEL, Q8Moments, kTable>(),
        one_pass_slot<T, LEVEL>(), one_pass_ring<Q8Moments>(), total, out);
  });
}

// int64 fields of a bucket's record in a grouped launch's table
constexpr int kRecord = 16;

}  // namespace

extern "C" {

// Coefficients per CUDA block (the partials buffer is (L, ceil(na/chunk)))
// and per quantization block (the scales are (L, ceil(na/qblock))).
int gwt_adam_fused_q8_chunk() { return kChunk; }
int gwt_adam_fused_q8_qblock() { return kQBlock; }

#ifndef GWT_ADAM_GROUPED

// The two-pass design.  dtype: 0 = float32 g and p, 1 = bfloat16 g and p,
// 2 = bfloat16 g with float32 p (with_params); qm, qv int8 (L, na); sm, sv f32 (L, nb); salt_m, salt_v uint32
// (L,); prev_norm, new_norm f32 (L,); partials f32 (L, S) and scale f32
// (L,), scratch the caller allocates; step_size and wd_coef point to f32
// scalars on the device.  p, qm, sm, qv, sv are updated in place.
int gwt_adam_fused_q8(int dtype, int level, const void* g, void* p,
                      signed char* qm, float* sm, signed char* qv, float* sv,
                      const unsigned* salt_m, const unsigned* salt_v,
                      const float* prev_norm, float* new_norm,
                      float* partials, float* scale, const float* step_size,
                      const float* wd_coef, long long L, long long na,
                      float gamma, float b1, float c1, float b2, float c2,
                      float eps, int use_limiter, int weight_decay,
                      void* stream) {
  const Coeffs c{b1, c1, b2, c2, eps};
  const Q8Moments mo{qm, sm, qv, sv, salt_m, salt_v, qm, sm, qv, sv,
                     (na + kQBlock - 1) / kQBlock};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_params(dtype, [&](auto t, auto pt) {
    return launch<typename decltype(t)::type, typename decltype(pt)::type>(
        level, g, p, mo, prev_norm, new_norm, partials, scale, step_size,
        wd_coef, L, na, c, gamma, use_limiter, weight_decay, s);
  });
}

// The one-pass design, the same arguments but the scale: a group of one
// bucket (gwt_adam_fused_q8_group).  The caller has checked that the
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
  const Q8Moments mo{qm, sm, qv, sv, salt_m, salt_v, qm, sm, qv, sv,
                     (na + kQBlock - 1) / kQBlock};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_params(dtype, [&](auto t, auto pt) {
    using T = typename decltype(t)::type;
    using P = typename decltype(pt)::type;
    auto a = one_pass_group<T, P, Q8Moments, kTable>(c, gamma, use_limiter,
                                                     weight_decay);
    const cudaError_t err = add_bucket(
        a, static_cast<const T*>(g), static_cast<P*>(p), mo, partials,
        prev_norm, new_norm, step_size, wd_coef, L, na);
    if (err != cudaSuccess) return err;
    return launch_one(level, a, s);
  });
}

// The one-pass plan of an (L, na) bucket, as gwt_adam_fused_one_pass_plan.
int gwt_adam_fused_q8_one_pass_plan(int dtype, int level, long long L,
                                    long long na, int* out) {
  const long long total = L * ((na + kChunk - 1) / kChunk);
  return with_params(dtype, [&](auto t, auto pt) {
    return plan_one<typename decltype(t)::type, typename decltype(pt)::type>(
        level, total, out);
  });
}

#else  // GWT_ADAM_GROUPED

// The one-pass design over a group of n buckets (1..gwt_adam_fused_q8_
// group_buckets()) that share the codes and the scalars, in one
// cooperative launch through the table of kGroupBuckets (a group of one
// too).  table: n records of kRecord int64 fields, bucket
// k's at table + k * kRecord: g, p, qm, sm, qv, sv, salt_m, salt_v,
// prev_norm, new_norm, partials, step_size, wd_coef (device addresses), L,
// na and its first chunk in the group (cudaErrorInvalidValue otherwise).
// Each bucket's p, codes and scales are updated in place, as by its own
// gwt_adam_fused_q8_one_pass, bitwise.
int gwt_adam_fused_q8_group(int dtype, int level, const long long* table,
                            int n, float gamma, float b1, float c1, float b2,
                            float c2, float eps, int use_limiter,
                            int weight_decay, void* stream) {
  if (n < 1 || n > kGroupBuckets) return cudaErrorInvalidValue;
  const Coeffs c{b1, c1, b2, c2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_params(dtype, [&](auto t, auto pt) {
    using T = typename decltype(t)::type;
    using P = typename decltype(pt)::type;
    auto a = one_pass_group<T, P, Q8Moments, kTable>(c, gamma, use_limiter,
                                                     weight_decay);
    for (int k = 0; k < n; ++k) {
      const long long* r = table + k * kRecord;
      auto at = [&](int f) { return reinterpret_cast<void*>(r[f]); };
      signed char* qm = static_cast<signed char*>(at(2));
      float* sm = static_cast<float*>(at(3));
      signed char* qv = static_cast<signed char*>(at(4));
      float* sv = static_cast<float*>(at(5));
      const Q8Moments mo{
          qm, sm, qv, sv, static_cast<const unsigned*>(at(6)),
          static_cast<const unsigned*>(at(7)), qm, sm, qv, sv,
          (r[14] + kQBlock - 1) / kQBlock};
      if (r[15] != a.total) return cudaErrorInvalidValue;
      const cudaError_t err = add_bucket(
          a, static_cast<const T*>(at(0)), static_cast<P*>(at(1)), mo,
          static_cast<float*>(at(10)), static_cast<const float*>(at(8)),
          static_cast<float*>(at(9)), static_cast<const float*>(at(11)),
          static_cast<const float*>(at(12)), r[13], r[14]);
      if (err != cudaSuccess) return err;
    }
    return launch_one(level, a, s);
  });
}

// Buckets a grouped launch takes.
int gwt_adam_fused_q8_group_buckets() { return kGroupBuckets; }

// The one-pass plan of a group of n (L, na) buckets, as
// gwt_adam_fused_group_plan's.
int gwt_adam_fused_q8_group_plan(int dtype, int level,
                                 const long long* sizes, int n, int* out) {
  const long long total = group_chunks(sizes, n);
  if (total == 0) return cudaErrorInvalidValue;
  return with_params(dtype, [&](auto t, auto pt) {
    return plan_one<typename decltype(t)::type, typename decltype(pt)::type>(
        level, total, out);
  });
}

#endif  // GWT_ADAM_GROUPED

}  // extern "C"
