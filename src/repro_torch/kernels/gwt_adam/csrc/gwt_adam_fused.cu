// Fused-write GWT-Adam update (K1) for one (L, N) bucket of same-shaped
// leaves: level-l Haar DWT along rows -> Adam on the A_l band (m, v in
// place, f32 or bf16: read as f32, written back rounded to nearest even
// into their own dtype) -> A~ = m/(sqrt(v)+eps), details scaled by the same
// 1/(sqrt(v)+eps) -> inverse DWT -> G~ rounded to the gradient type ->
// per-leaf ||G~|| -> norm-growth limiter -> p <- p - step*s*G~ - wd*p,
// written in place.
//
// Replaces the TPU kernel gwt_adam_tile_fused (body _body_fused) of
// src/repro/kernels/gwt_adam/kernel.py (pallas_call at line 404).
//
// Bound on an H100: the update does O(30) f32 operations per gradient
// element, so memory bounds it.  It must read g and p (2 + 2 bytes in bf16),
// read and write m and v (4 + 4 bytes each in f32, 2 + 2 in bf16, once per
// 2^l gradient elements) and write p (2 bytes): 10 bytes per gradient
// element at level 2 with f32 moments, 8 with bf16 moments.  LLaMA-60M has
// 25.3 M such elements, so about 253 MB per step over three launches (f32
// moments).
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
//  * Two passes (gwt_adam_fused; gwt_adam_common.cuh describes the
//    design), for the buckets whose G~ does not fit on chip (f32
//    parameters of (2, 4096, 1376) need 45 MB; qwen2.5-3b's four large
//    buckets).  CUDA blocks run in no order, so the per-leaf norm takes
//    separate launches: the norm pass (below) writes one f32 partial per
//    (leaf, chunk of 2048 coefficients) and nothing else; the scale pass
//    sums each leaf's partials once, in a fixed order, and applies the
//    limiter; the write pass streams the bucket through a persistent grid,
//    recomputes the tile and writes p, m, v.  Recomputing costs one more
//    read of g, m and v: 14 bytes per element against the 10-byte bound.
//
// This source builds two libraries (kernels/build.py): gwt_adam_fused, the
// per-bucket entries, and, with -DGWT_ADAM_GROUPED, gwt_adam_fused_group,
// the grouped ones; each compiles one table size (kTable), and the two
// compile at once.
//
// Grouped (gwt_adam_fused_group): the one-pass design over up to
// kGroupBuckets buckets in one cooperative launch, each bucket what
// gwt_adam_tile_fused computes for it alone, bitwise.  At a LoRA
// fine-tune's adapter buckets a launch is bound by its latency, not by
// the 10 bytes an element (8 with bf16 moments, 14 with f32 p under a
// bf16 g): llama-60m's four adapter buckets took 0.0137-0.0145 ms a
// launch against a bound of 0.0026 ms for all four (H100 80GB HBM3,
// 700 W).  One launch over the step's buckets pays the latency once; the
// chunks of all of them share the grid.
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
// gradient type T before the norm and the write, limited = G~ * T(scale) is
// rounded to T, new p is computed in f32 and rounded to the parameter type
// P (T itself, or f32 under a bf16 gradient: a LoRA adapter's).  Every
// product and sum is written with an _rn intrinsic, so nvcc cannot contract
// them into FMAs that PyTorch's op-by-op arithmetic does not make, and sqrt
// and division are IEEE (build without --use_fast_math).

#include "gwt_adam_common.cuh"

namespace {

// grid (S, L): block s of leaf l takes coefficients [s*kChunk, (s+1)*kChunk).
template <typename T, typename M, int LEVEL>
__global__ void __launch_bounds__(kThreads)
norm_pass(const T* __restrict__ g, const M* __restrict__ m,
          const M* __restrict__ v, float* __restrict__ partials,
          long long na, Coeffs c) {
  constexpr int B = 1 << LEVEL;
  const long long leaf = blockIdx.y;
  const T* gl = g + leaf * na * B;
  const M* ml = m + leaf * na;
  const M* vl = v + leaf * na;
  const long long base = (long long)blockIdx.x * kChunk + threadIdx.x;
  float acc = 0.0f;
  for (int k = 0; k < kPerThread; ++k) {
    const long long j = base + (long long)k * kThreads;
    if (j >= na) break;
    float x[B];
#pragma unroll
    for (int i = 0; i < B; ++i) x[i] = to_f32(gl[j * B + i]);
    float mj = to_f32(ml[j]), vj = to_f32(vl[j]);
    dht_adam<LEVEL>(x, mj, vj, c);
    acc = sum_sq<T, B>(x, acc);
  }
  const float total = block_sum(acc);
  if (threadIdx.x == 0) partials[leaf * gridDim.x + blockIdx.x] = total;
}

template <typename T, typename P, typename M>
cudaError_t launch(int level, const void* g, void* p, void* m, void* v,
                   const float* prev_norm, float* new_norm, float* partials,
                   float* scale, const float* step_size,
                   const float* wd_coef, long long L, long long na, Coeffs c,
                   float gamma, int use_limiter, int weight_decay,
                   cudaStream_t stream) {
  const long long S = (na + kChunk - 1) / kChunk;
  const dim3 grid((unsigned)S, (unsigned)L);
  M* mm = static_cast<M*>(m);
  M* vv = static_cast<M*>(v);
  return with_level(level, [&](auto lv) {
    constexpr int LEVEL = decltype(lv)::value;
    if (use_limiter) {
      norm_pass<T, M, LEVEL><<<grid, kThreads, 0, stream>>>(
          static_cast<const T*>(g), mm, vv, partials, na, c);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    return launch_scale_and_write<T, P, LEVEL>(
        static_cast<const T*>(g), static_cast<P*>(p),
        FloatMoments<M>{mm, vv, mm, vv}, partials, scale, prev_norm,
        new_norm, step_size, wd_coef, L, na, c, gamma, use_limiter,
        weight_decay, stream);
  });
}

template <class Group>
cudaError_t launch_one(int level, Group& a, cudaStream_t stream) {
  return with_level(level, [&](auto lv) {
    return launch_one_pass<decltype(lv)::value>(a, stream);
  });
}

// The plan of this library's one-pass kernel (a table of kTable buckets).
template <typename T, typename P, typename M>
cudaError_t plan_one(int level, long long total, int* out) {
  return with_level(level, [&](auto lv) {
    constexpr int LEVEL = decltype(lv)::value;
    using Mo = FloatMoments<M>;
    return export_plan(one_pass_kernel<T, P, LEVEL, Mo, kTable>(),
                       one_pass_slot<T, LEVEL>(), one_pass_ring<Mo>(), total,
                       out);
  });
}

// Calls f(Tag<T>{}, Tag<P>{}, Tag<M>{}) for K1's dtype codes.
template <typename F>
cudaError_t with_fused_dtypes(int dtype, int mdtype, F f) {
  return with_params(dtype, [&](auto t, auto pt) -> cudaError_t {
    if (mdtype == 0) return f(t, pt, Tag<float>{});
    if (mdtype == 1) return f(t, pt, Tag<__nv_bfloat16>{});
    return cudaErrorInvalidValue;
  });
}

// int64 fields of a bucket's record in a grouped launch's table
constexpr int kRecord = 12;

}  // namespace

extern "C" {

// Coefficients per block: the wrapper sizes the partials buffer (L, S) with
// S = ceil(na / chunk).
int gwt_adam_fused_chunk() { return kChunk; }

#ifndef GWT_ADAM_GROUPED

// The two-pass design.  dtype: 0 = float32 g and p, 1 = bfloat16 g and p,
// 2 = bfloat16 g with float32 p (with_params); mdtype, 0 = float32 or
// 1 = bfloat16, for m and v (L, na); prev_norm, new_norm f32
// (L,); partials f32 (L, S) and scale f32 (L,), scratch the caller
// allocates; step_size and wd_coef point to f32 scalars on the device.  p,
// m, v are updated in place.
int gwt_adam_fused(int dtype, int mdtype, int level, const void* g, void* p,
                   void* m, void* v, const float* prev_norm, float* new_norm,
                   float* partials, float* scale, const float* step_size,
                   const float* wd_coef, long long L, long long na,
                   float gamma, float b1, float c1, float b2, float c2,
                   float eps, int use_limiter, int weight_decay,
                   void* stream) {
  const Coeffs c{b1, c1, b2, c2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_fused_dtypes(dtype, mdtype, [&](auto t, auto pt, auto mt) {
    using T = typename decltype(t)::type;
    using P = typename decltype(pt)::type;
    using M = typename decltype(mt)::type;
    return launch<T, P, M>(level, g, p, m, v, prev_norm, new_norm, partials,
                        scale, step_size, wd_coef, L, na, c, gamma,
                        use_limiter, weight_decay, s);
  });
}

// The one-pass design, the same arguments but the scale: a group of one
// bucket (gwt_adam_fused_group).  The caller has checked that the bucket
// fits (one_pass_fits); otherwise the plan fails with
// cudaErrorInvalidConfiguration before anything is launched.  A refused
// cooperative launch returns its error.
int gwt_adam_fused_one_pass(int dtype, int mdtype, int level, const void* g,
                            void* p, void* m, void* v,
                            const float* prev_norm, float* new_norm,
                            float* partials, const float* step_size,
                            const float* wd_coef, long long L, long long na,
                            float gamma, float b1, float c1, float b2,
                            float c2, float eps, int use_limiter,
                            int weight_decay, void* stream) {
  const Coeffs c{b1, c1, b2, c2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_fused_dtypes(dtype, mdtype, [&](auto t, auto pt, auto mt) {
    using T = typename decltype(t)::type;
    using P = typename decltype(pt)::type;
    using M = typename decltype(mt)::type;
    using Mo = FloatMoments<M>;
    auto a = one_pass_group<T, P, Mo, kTable>(c, gamma, use_limiter,
                                              weight_decay);
    M* mm = static_cast<M*>(m);
    M* vv = static_cast<M*>(v);
    const cudaError_t err = add_bucket(
        a, static_cast<const T*>(g), static_cast<P*>(p), Mo{mm, vv, mm, vv},
        partials, prev_norm, new_norm, step_size, wd_coef, L, na);
    if (err != cudaSuccess) return err;
    return launch_one(level, a, s);
  });
}

// The one-pass plan of an (L, na) bucket: out[0..8] = registers per
// thread, local (spill) bytes, static shared bytes, the most dynamic shared
// bytes a block may have, SMs, blocks per SM, slots per block, dynamic
// shared bytes per block, grid.
int gwt_adam_fused_one_pass_plan(int dtype, int mdtype, int level,
                                 long long L, long long na, int* out) {
  const long long total = L * ((na + kChunk - 1) / kChunk);
  return with_fused_dtypes(dtype, mdtype, [&](auto t, auto pt, auto mt) {
    return plan_one<typename decltype(t)::type, typename decltype(pt)::type,
                    typename decltype(mt)::type>(level, total, out);
  });
}

#else  // GWT_ADAM_GROUPED

// The one-pass design over a group of n buckets (1..gwt_adam_fused_group_
// buckets()) that share the codes and the scalars, in one cooperative
// launch through the table of kGroupBuckets (a group of one too).  table:
// n records of kRecord int64 fields, bucket k's at table + k * kRecord: g, p, m, v, prev_norm, new_norm, partials (its (L,
// S) chunk partials), step_size, wd_coef (device addresses), L, na and its
// first chunk in the group (the chunks of the buckets before it;
// cudaErrorInvalidValue otherwise).  Each bucket's p, m, v are updated in
// place, as by its own gwt_adam_fused_one_pass, bitwise.  The caller has
// checked that the group fits (kernel.py: group_plan).
int gwt_adam_fused_group(int dtype, int mdtype, int level,
                         const long long* table, int n, float gamma,
                         float b1, float c1, float b2, float c2, float eps,
                         int use_limiter, int weight_decay, void* stream) {
  if (n < 1 || n > kGroupBuckets) return cudaErrorInvalidValue;
  const Coeffs c{b1, c1, b2, c2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_fused_dtypes(dtype, mdtype, [&](auto t, auto pt, auto mt) {
    using T = typename decltype(t)::type;
    using P = typename decltype(pt)::type;
    using M = typename decltype(mt)::type;
    using Mo = FloatMoments<M>;
    auto a = one_pass_group<T, P, Mo, kTable>(c, gamma, use_limiter,
                                              weight_decay);
    for (int k = 0; k < n; ++k) {
      const long long* r = table + k * kRecord;
      auto at = [&](int f) { return reinterpret_cast<void*>(r[f]); };
      M* mm = static_cast<M*>(at(2));
      M* vv = static_cast<M*>(at(3));
      if (r[11] != a.total) return cudaErrorInvalidValue;
      const cudaError_t err = add_bucket(
          a, static_cast<const T*>(at(0)), static_cast<P*>(at(1)),
          Mo{mm, vv, mm, vv}, static_cast<float*>(at(6)),
          static_cast<const float*>(at(4)), static_cast<float*>(at(5)),
          static_cast<const float*>(at(7)), static_cast<const float*>(at(8)),
          r[9], r[10]);
      if (err != cudaSuccess) return err;
    }
    return launch_one(level, a, s);
  });
}

// Buckets a grouped launch takes.
int gwt_adam_fused_group_buckets() { return kGroupBuckets; }

// The one-pass plan of a group of n (L, na) buckets, sizes = L0, na0, L1,
// na1, ...: out[0..8] as gwt_adam_fused_one_pass_plan's.
int gwt_adam_fused_group_plan(int dtype, int mdtype, int level,
                              const long long* sizes, int n, int* out) {
  const long long total = group_chunks(sizes, n);
  if (total == 0) return cudaErrorInvalidValue;
  return with_fused_dtypes(dtype, mdtype, [&](auto t, auto pt, auto mt) {
    return plan_one<typename decltype(t)::type, typename decltype(pt)::type,
                    typename decltype(mt)::type>(level, total, out);
  });
}

#endif  // GWT_ADAM_GROUPED

}  // extern "C"
