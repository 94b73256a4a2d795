// Multi-level Haar DWT along the last axis of an (m, n) array, forward and
// inverse, as three entry points over one templated butterfly:
//
//  * haar_dwt_fwd    (m, n) -> (A_l, D_l, ..., D_1), every band in the input
//                    type, f32 arithmetic.  Replaces the TPU kernel
//                    haar_dwt_fwd of src/repro/kernels/haar_dwt/kernel.py.
//  * haar_dwt_fwd_q  the same from f32, A_l in f32 and D_l..D_1 narrowed to
//                    the wire type (bf16, f16 or float8_e4m3fn) at the
//                    write.  Replaces haar_dwt_fwd_q there: the detail bands
//                    of the compressed data-parallel reduction.
//  * haar_dwt_inv    (A_l, [D_l..D_1]) -> (m, n), f32 arithmetic, output in
//                    A's type.  Replaces haar_dwt_inv there (the same
//                    function as the reduction's reconstruction).
//
// Bound on an H100: a butterfly is 2 f32 operations per input element and
// level, so memory bounds all three.  At level 2 each must move, per element
// of the (m, n) array: forward from f32 to f32 A and wire details,
// 4 + 1 + 0.75 * detail bytes (6.5 B with bf16 details, 5.75 B with fp8);
// forward in bf16, 2 + 2 = 4 B; inverse in f32, 4 + 4 = 8 B.
//
// Design:
//  * Coefficient j of row i of A_l depends only on the 2^l input values
//    [j*2^l, (j+1)*2^l) of that row, and rows are contiguous with
//    n = na*2^l, so flat coefficient t = i*na + j covers the flat input
//    elements [t*2^l, (t+1)*2^l), and the 2^(l-k) coefficients of band D_k
//    that it produces are flat elements [t*2^(l-k), (t+1)*2^(l-k)) of D_k.
//    One thread takes one coefficient: one contiguous chunk in, one
//    contiguous chunk per band out, all in registers, no shared memory, no
//    row index.  Neighbouring threads touch neighbouring chunks, so every
//    warp access is coalesced; a chunk of 8 or 16 bytes moves as one vector
//    load when the base pointer allows it.
//  * Rounding follows the plain PyTorch version (ref.py) and the TPU kernel
//    point for point: (even +- odd) is an add, then a multiply by
//    f32(1/sqrt 2), each an _rn intrinsic so that nvcc contracts nothing into
//    an FMA.  Bands are cast once, at the write: __float2bfloat16_rn,
//    __float2half_rn, and for fp8 __nv_cvt_float_to_fp8 with __NV_NOSAT, so a
//    value whose magnitude rounds past 448 (and +-inf) becomes NaN with its
//    sign (0x7f / 0xff) as in the JAX package, not a saturated +-448.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevel = 6;
constexpr float kInvSqrt2 = 0.7071067811865476f;

// storage types by code: 0 f32, 1 bf16, 2 f16, 3 float8_e4m3fn
struct Fp8 {
  __nv_fp8_storage_t bits;
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
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ Fp8 from_f32<Fp8>(float x) {
  return Fp8{__nv_cvt_float_to_fp8(x, __NV_NOSAT, __NV_E4M3)};
}

// COUNT values of T at src (a thread's chunk) into registers; one or more
// 16-byte or one 8-byte load when `vec` (the chunk is aligned), else one
// load per value.
template <typename T, int COUNT>
__device__ __forceinline__ void load_chunk(T (&dst)[COUNT],
                                           const T* __restrict__ src,
                                           bool vec) {
  constexpr int kBytes = COUNT * (int)sizeof(T);
  if constexpr (kBytes % 16 == 0) {
    if (vec) {
      const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i) {
        const uint4 u = s[i];
        memcpy(reinterpret_cast<char*>(dst) + 16 * i, &u, 16);
      }
      return;
    }
  } else if constexpr (kBytes == 8) {
    if (vec) {
      const uint2 u = *reinterpret_cast<const uint2*>(src);
      memcpy(dst, &u, 8);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < COUNT; ++i) dst[i] = src[i];
}

// COUNT values to dst (outputs are allocated by the wrapper, so aligned to
// their chunk size, which is a power of two).
template <typename T, int COUNT>
__device__ __forceinline__ void store_chunk(T* __restrict__ dst,
                                            const T (&src)[COUNT]) {
  constexpr int kBytes = COUNT * (int)sizeof(T);
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      uint4 u;
      memcpy(&u, reinterpret_cast<const char*>(src) + 16 * i, 16);
      reinterpret_cast<uint4*>(dst)[i] = u;
    }
  } else if constexpr (kBytes == 8) {
    uint2 u;
    memcpy(&u, src, 8);
    *reinterpret_cast<uint2*>(dst) = u;
  } else if constexpr (kBytes == 4) {
    uint32_t u;
    memcpy(&u, src, 4);
    *reinterpret_cast<uint32_t*>(dst) = u;
  } else {
#pragma unroll
    for (int i = 0; i < COUNT; ++i) dst[i] = src[i];
  }
}

struct Bands {
  void* d[kMaxLevel];  // d[k-1] is band D_k
};

// Forward: thread t reads input chunk t, writes A_l[t] and chunk t of every
// D_k, k = 1..LEVEL.
template <typename TIn, typename TA, typename TD, int LEVEL, int K>
__device__ __forceinline__ void fwd_levels(float (&x)[1 << LEVEL],
                                           const Bands& bands, long long t) {
  if constexpr (K <= LEVEL) {
    constexpr int kHalf = 1 << (LEVEL - K);  // values of D_K per thread
    TD d[kHalf];
#pragma unroll
    for (int q = 0; q < kHalf; ++q) {
      const float e = x[2 * q], o = x[2 * q + 1];
      x[q] = __fmul_rn(__fadd_rn(e, o), kInvSqrt2);
      d[q] = from_f32<TD>(__fmul_rn(__fsub_rn(e, o), kInvSqrt2));
    }
    store_chunk<TD, kHalf>(static_cast<TD*>(bands.d[K - 1]) + t * kHalf, d);
    fwd_levels<TIn, TA, TD, LEVEL, K + 1>(x, bands, t);
  }
}

template <typename TIn, typename TA, typename TD, int LEVEL>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const TIn* __restrict__ g, TA* __restrict__ a, Bands bands,
           long long count, bool vec) {
  constexpr int kB = 1 << LEVEL;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= count) return;
  TIn in[kB];
  load_chunk<TIn, kB>(in, g + t * kB, vec);
  float x[kB];
#pragma unroll
  for (int i = 0; i < kB; ++i) x[i] = to_f32(in[i]);
  fwd_levels<TIn, TA, TD, LEVEL, 1>(x, bands, t);
  a[t] = from_f32<TA>(x[0]);
}

// Inverse: thread t reads A_l[t] and chunk t of every D_k (D_l first),
// writes output chunk t.
template <typename T, int LEVEL, int K>
__device__ __forceinline__ void inv_levels(float (&x)[1 << LEVEL],
                                           const Bands& bands, long long t,
                                           bool vec) {
  if constexpr (K >= 1) {
    constexpr int kW = 1 << (LEVEL - K);  // values of D_K per thread
    T draw[kW];
    load_chunk<T, kW>(draw, static_cast<const T*>(bands.d[K - 1]) + t * kW,
                      vec);
#pragma unroll
    for (int q = kW - 1; q >= 0; --q) {
      const float s = x[q], d = to_f32(draw[q]);
      x[2 * q + 1] = __fmul_rn(__fsub_rn(s, d), kInvSqrt2);
      x[2 * q] = __fmul_rn(__fadd_rn(s, d), kInvSqrt2);
    }
    inv_levels<T, LEVEL, K - 1>(x, bands, t, vec);
  }
}

template <typename T, int LEVEL>
__global__ void __launch_bounds__(kThreads)
inv_kernel(const T* __restrict__ a, Bands bands, T* __restrict__ out,
           long long count, bool vec) {
  constexpr int kB = 1 << LEVEL;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= count) return;
  float x[kB];
  x[0] = to_f32(a[t]);
  inv_levels<T, LEVEL, LEVEL>(x, bands, t, vec);
  T o[kB];
#pragma unroll
  for (int i = 0; i < kB; ++i) o[i] = from_f32<T>(x[i]);
  store_chunk<T, kB>(out + t * kB, o);
}

template <int LEVEL = 1, typename F>
cudaError_t with_level(int level, F&& f) {
  if constexpr (LEVEL <= kMaxLevel) {
    if (level == LEVEL) return f(std::integral_constant<int, LEVEL>{});
    return with_level<LEVEL + 1>(level, f);
  } else {
    return cudaErrorInvalidValue;
  }
}

Bands bands_of(void* const* d, int level) {
  Bands b{};
  // the caller passes [D_l, ..., D_1]; the kernels index by k
  for (int k = 1; k <= level; ++k) b.d[k - 1] = d[level - k];
  return b;
}

unsigned blocks(long long count) {
  return (unsigned)((count + kThreads - 1) / kThreads);
}

template <typename TIn, typename TA, typename TD>
cudaError_t launch_fwd(int level, const void* g, void* a, void* const* d,
                       long long count, int vec, cudaStream_t s) {
  const Bands b = bands_of(d, level);
  return with_level(level, [&](auto lv) {
    fwd_kernel<TIn, TA, TD, decltype(lv)::value>
        <<<blocks(count), kThreads, 0, s>>>(static_cast<const TIn*>(g),
                                            static_cast<TA*>(a), b, count,
                                            vec != 0);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t launch_inv(int level, const void* a, void* const* d, void* out,
                       long long count, int vec, cudaStream_t s) {
  const Bands b = bands_of(d, level);
  return with_level(level, [&](auto lv) {
    inv_kernel<T, decltype(lv)::value><<<blocks(count), kThreads, 0, s>>>(
        static_cast<const T*>(a), b, static_cast<T*>(out), count, vec != 0);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

int haar_dwt_max_level() { return kMaxLevel; }

// Forward: g (count * 2^level values of type `dtype`), A_l (count values),
// d = [D_l, ..., D_1] (band D_k holds count * 2^(level-k) values).
// dtype 0 = f32, 1 = bf16; every band in that type.  `vec`: g is 16-byte
// aligned.
int haar_dwt_fwd(int dtype, int level, const void* g, void* a,
                 void* const* d, long long count, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float, float, float>(level, g, a, d, count, vec, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
        level, g, a, d, count, vec, s);
  return cudaErrorInvalidValue;
}

// Forward from f32 with A_l in f32 and the details in the wire type
// `detail_dtype`: 1 = bf16, 2 = f16, 3 = float8_e4m3fn.
int haar_dwt_fwd_q(int detail_dtype, int level, const void* g, void* a,
                   void* const* d, long long count, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (detail_dtype == 1)
    return launch_fwd<float, float, __nv_bfloat16>(level, g, a, d, count, vec,
                                                   s);
  if (detail_dtype == 2)
    return launch_fwd<float, float, __half>(level, g, a, d, count, vec, s);
  if (detail_dtype == 3)
    return launch_fwd<float, float, Fp8>(level, g, a, d, count, vec, s);
  return cudaErrorInvalidValue;
}

// Inverse: A_l (count values), d = [D_l, ..., D_1], out (count * 2^level
// values), all of type `dtype` (0 = f32, 1 = bf16).  `vec`: every input is
// 16-byte aligned.
int haar_dwt_inv(int dtype, int level, const void* a, void* const* d,
                 void* out, long long count, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_inv<float>(level, a, d, out, count, vec, s);
  if (dtype == 1)
    return launch_inv<__nv_bfloat16>(level, a, d, out, count, vec, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
