// Multi-level Haar DWT along the last axis of (m, n) arrays, forward and
// inverse:
//
//  * haar_dwt_fwd_group  a group of up to kGroupLeaves leaves (m_i, n_i) ->
//                        (A_l, D_l, ..., D_1) each, f32 arithmetic, in one
//                        launch.  Every band in the input type (f32 or bf16)
//                        replaces the TPU kernel haar_dwt_fwd
//                        (src/repro/kernels/haar_dwt/kernel.py:93, "K6");
//                        f32 in, A_l in f32 and D_l..D_1 narrowed to the
//                        wire type (bf16, f16 or float8_e4m3fn) at the write
//                        replaces haar_dwt_fwd_q (:124, "K3"), the detail
//                        bands of the compressed data-parallel reduction,
//                        whose step splits all its leaves in one launch.
//  * haar_dwt_inv        (A_l, [D_l..D_1]) -> (m, n), f32 arithmetic, output
//                        in A's type, one leaf a launch.  Replaces
//                        haar_dwt_inv (:144, "K7"; the reduction's
//                        reconstruction).
//
// Bound on an H100: a butterfly is 2 f32 operations per input element and
// level, so memory bounds all of them.  At level 2 each must move, per
// element of the (m, n) array: K3 from f32 to f32 A and wire details,
// 4 + 1 + 0.75 * detail bytes (6.5 B with bf16 details, 5.75 B with fp8);
// K6 in bf16, 2 + 2 = 4 B; K7 in f32, 4 + 4 = 8 B.
//
// Layout: coefficient j of row i of A_l depends only on the 2^l input
// values [j*2^l, (j+1)*2^l) of that row, and rows are contiguous with
// n = na*2^l, so flat coefficient t = i*na + j covers the flat input
// elements [t*2^l, (t+1)*2^l), and the 2^(l-k) coefficients of band D_k
// that it produces are flat elements [t*2^(l-k), (t+1)*2^(l-k)) of D_k.
// A run of consecutive coefficients is one contiguous range of the input
// and one contiguous range of every band; no row index is needed.
//
// The forward design answers four costs of a launch per leaf with one
// coefficient a thread:
//  1. A launch costs about 5 us however small the leaf: one launch takes a
//     whole group, its leaf table (pointers, coefficient count, input
//     alignment, first tile) in the kernel parameters, so a step pays that
//     floor once, not once per leaf.
//  2. Bytes in flight: a tile is kTileBytes of one leaf's input (kT
//     coefficients) and arrives as one bulk asynchronous copy
//     (cp.async.bulk, completion on an mbarrier) into a ring of kStages
//     shared-memory stages; one thread issues the loads, and the next
//     tiles' loads stay in flight while a tile is computed.
//  3. Narrow stores: a tile's A_l and each of its detail bands are staged
//     in shared memory and written with one bulk copy each
//     (cp.async.bulk.global.shared::cta), whatever the band's type.
//  4. One-shot blocks: about one wave of blocks (occupancy from the card,
//     in haar_dwt_fwd_plan) walks all tiles of all leaves of the group, so
//     the small leaves ride in the same wave as the large ones and one
//     tile's latency overlaps the next tiles' copies.
// Where a bulk copy does not apply (a leaf whose input is not 16-byte
// aligned, a leaf's last partial tile) the block takes the tile straight
// from and to device memory: each thread kC consecutive coefficients, one
// chunk of kC * 2^l input values loaded before its arithmetic, with vector
// loads where the input is aligned and one load per value where it is not.
// kBulkCopies = false sends every tile that way: the register-direct
// variant, which tools/haar_variants.py times against the bulk copies.
// On the DP group it is the slower on an H100 (PERF.md has the times),
// probably because a warp's 16-byte accesses there lie a chunk apart, so
// each instruction covers a fraction of every line it touches, where a
// bulk copy moves whole lines.
//
// Rounding follows the plain PyTorch version (ref.py) and the TPU kernel
// point for point: (even +- odd) is an add, then a multiply by
// f32(1/sqrt 2), each an _rn intrinsic so that nvcc contracts nothing into
// an FMA.  Bands are cast once, at the write: __float2bfloat16_rn,
// __float2half_rn, and for fp8 the codes of __nv_cvt_float_to_fp8 with
// __NV_NOSAT, so a value whose magnitude rounds past 448 (and +-inf)
// becomes NaN with its sign (0x7f / 0xff) as in the JAX package, not a
// saturated +-448 (from_f32<Fp8>: the hardware's conversion and the NaN
// rule, since the software non-saturating conversion cost K3 a tenth of
// its time with fp8 details).

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

// the grouped forward: leaves per launch, input bytes per tile, stages of
// the shared-memory ring, and the bytes before the ring that hold its
// mbarriers
constexpr int kGroupLeaves = 32;
constexpr int kTileBytes = 16384;
constexpr int kStages = 2;
constexpr int kBarBytes = 128;
constexpr bool kBulkCopies = true;
static_assert(kStages >= 2 && 8 * kStages <= kBarBytes, "ring of stages");

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
// float8_e4m3fn: the hardware's conversion (cvt.rn.satfinite) rounds to
// nearest even and clamps a finite magnitude past 448 to 448; where the
// magnitude rounds past 448 (above 464, the tie, which rounds to the even
// 448), and for +-inf and NaN, the code is NaN with the sign instead, as
// __NV_NOSAT and the JAX package give.  At or below 464 clamping changes
// nothing, so every code equals the non-saturating conversion's.
template <>
__device__ __forceinline__ Fp8 from_f32<Fp8>(float x) {
  const __nv_fp8_storage_t b =
      __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
  return Fp8{fabsf(x) <= 464.0f
                 ? b
                 : (__nv_fp8_storage_t)(__float_as_uint(x) >> 31 ? 0xff
                                                                  : 0x7f)};
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

// ---------------------------------------------------------------------------
// Forward, grouped

// One leaf of a group, as the wrapper fills it (kernel.py's _Leaf).
struct FwdLeaf {
  const void* g;       // the (m, n) input, count * 2^l values
  void* a;             // A_l, count values
  void* d[kMaxLevel];  // D_l, ..., D_1; D_k holds count * 2^(l-k) values
  long long count;     // coefficients of A_l
  int first_tile;      // the leaf's first tile in the group
  int vec;             // g is 16-byte aligned
};

static_assert(sizeof(FwdLeaf) == 80, "kernel.py's LEAF");

// the counts first: every block reads them before its first tile
struct FwdGroup {
  int n_leaves;
  int n_tiles;
  FwdLeaf leaf[kGroupLeaves];
};

template <typename TIn, typename TA, typename TD, int LEVEL>
struct Fwd {
  static constexpr int kB = 1 << LEVEL;
  // coefficients per tile
  static constexpr int kT = kTileBytes / (kB * (int)sizeof(TIn));
  // coefficients per thread chunk on the direct path: 16 input values
  static constexpr int kC = kB >= 16 ? 1 : 16 / kB;
  // a tile's bands: A_l, then D_l (kT values), ..., D_1 (kT << (l-1))
  static constexpr int kOutBytes =
      kT * (int)sizeof(TA) + kT * (kB - 1) * (int)sizeof(TD);
  static constexpr int kStageBytes = kTileBytes + kOutBytes;
  static constexpr int kSmem =
      kBulkCopies ? kBarBytes + kStages * kStageBytes : 0;
  static_assert(kT % 16 == 0 && kT % kC == 0, "tile of whole chunks");
};

// One chunk of C consecutive coefficients c..c+C-1; x holds their
// N = C << LEVEL input values in f32.  Level K replaces x[0, N >> K) by the
// pair sums and writes the pair differences, the chunk's N >> K values of
// D_K, to d[LEVEL - K] at c * 2^(LEVEL - K).  After the last level x[0, C)
// is the chunk's A_l.
template <typename TD, int LEVEL, int C, int K>
__device__ __forceinline__ void fwd_levels(float (&x)[C << LEVEL],
                                           void* const (&d)[kMaxLevel],
                                           long long c) {
  if constexpr (K <= LEVEL) {
    constexpr int kHalf = (C << LEVEL) >> K;  // values of D_K in the chunk
    TD out[kHalf];
#pragma unroll
    for (int q = 0; q < kHalf; ++q) {
      const float e = x[2 * q], o = x[2 * q + 1];
      x[q] = __fmul_rn(__fadd_rn(e, o), kInvSqrt2);
      out[q] = from_f32<TD>(__fmul_rn(__fsub_rn(e, o), kInvSqrt2));
    }
    store_chunk<TD, kHalf>(
        static_cast<TD*>(d[LEVEL - K]) + c * (kHalf / C), out);
    fwd_levels<TD, LEVEL, C, K + 1>(x, d, c);
  }
}

// Coefficients c..c+C-1 (c a multiple of C): input from g, A_l to a, the
// details to d; g, a and d in device or shared memory.
template <typename TIn, typename TA, typename TD, int LEVEL, int C>
__device__ __forceinline__ void fwd_chunk(const TIn* __restrict__ g,
                                          bool vec, TA* __restrict__ a,
                                          void* const (&d)[kMaxLevel],
                                          long long c) {
  constexpr int kN = C << LEVEL;
  TIn in[kN];
  load_chunk<TIn, kN>(in, g + (c << LEVEL), vec);
  float x[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) x[i] = to_f32(in[i]);
  fwd_levels<TD, LEVEL, C, 1>(x, d, c);
  TA av[C];
#pragma unroll
  for (int i = 0; i < C; ++i) av[i] = from_f32<TA>(x[i]);
  store_chunk<TA, C>(a + c, av);
}

// Coefficients [c0, c1) of leaf L (c0 a multiple of kC) straight from and to
// device memory: chunks of kC coefficients a thread, then the leaf's last
// coefficients one at a time.
template <typename TIn, typename TA, typename TD, int LEVEL>
__device__ void fwd_direct(const FwdLeaf& L, long long c0, long long c1) {
  constexpr int kC = Fwd<TIn, TA, TD, LEVEL>::kC;
  const TIn* g = static_cast<const TIn*>(L.g);
  TA* a = static_cast<TA*>(L.a);
  const bool vec = L.vec != 0;
  const long long whole = (c1 - c0) / kC;
  for (long long q = threadIdx.x; q < whole; q += kThreads)
    fwd_chunk<TIn, TA, TD, LEVEL, kC>(g, vec, a, L.d, c0 + q * kC);
  for (long long c = c0 + whole * kC + threadIdx.x; c < c1; c += kThreads)
    fwd_chunk<TIn, TA, TD, LEVEL, 1>(g, vec, a, L.d, c);
}

// A tile from its shared-memory stage `in` to its bands staged at `out`
// (A_l, then D_l, ..., D_1), one coefficient a thread per round.
template <typename TIn, typename TA, typename TD, int LEVEL>
__device__ __forceinline__ void fwd_staged(const unsigned char* in,
                                           unsigned char* out) {
  constexpr int kT = Fwd<TIn, TA, TD, LEVEL>::kT;
  void* d[kMaxLevel] = {};
  unsigned char* p = out + kT * (int)sizeof(TA);
#pragma unroll
  for (int i = 0; i < LEVEL; ++i) {
    d[i] = p;
    p += (kT << i) * (int)sizeof(TD);
  }
#pragma unroll
  for (int r = 0; r < (kT + kThreads - 1) / kThreads; ++r) {
    const int c = threadIdx.x + r * kThreads;
    if (kT % kThreads == 0 || c < kT)
      fwd_chunk<TIn, TA, TD, LEVEL, 1>(reinterpret_cast<const TIn*>(in),
                                       true, reinterpret_cast<TA*>(out), d,
                                       c);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// `bytes` from device memory at src to shared memory at dst, both 16-byte
// aligned; completes `bytes` transactions on the mbarrier at bar.
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, unsigned src,
                                           unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

// Waits until at most N of the thread's bulk store groups still read
// shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

template <typename P>
__device__ __forceinline__ bool bulk_tile(const FwdLeaf& L, int tile) {
  return L.vec && (long long)(tile - L.first_tile + 1) * P::kT <= L.count;
}

// Block b takes tiles b, b + gridDim.x, ... of the group.  Whole tiles of
// aligned leaves go through the ring: thread 0 keeps the loads of this
// block's next kStages such tiles in flight and writes each tile's bands
// from shared memory after its one barrier.  Other tiles go straight
// (fwd_direct).
template <typename TIn, typename TA, typename TD, int LEVEL>
__global__ void __launch_bounds__(kThreads)
fwd_group_kernel(const __grid_constant__ FwdGroup grp) {
  using P = Fwd<TIn, TA, TD, LEVEL>;
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned bars = smem_addr(smem);  // kStages mbarriers of 8 bytes
  unsigned char* const ring = smem + kBarBytes;
  // thread 0: the next tile to look at and how many loads it has issued
  int p_tile = blockIdx.x, p_leaf = 0, issued = 0;
  auto issue_next = [&]() {
    for (; p_tile < grp.n_tiles; p_tile += gridDim.x) {
      while (p_leaf + 1 < grp.n_leaves &&
             p_tile >= grp.leaf[p_leaf + 1].first_tile)
        ++p_leaf;
      const FwdLeaf& L = grp.leaf[p_leaf];
      if (bulk_tile<P>(L, p_tile)) {
        const int s = issued % kStages;
        const long long c0 = (long long)(p_tile - L.first_tile) * P::kT;
        mbar_expect_tx(bars + 8 * s, kTileBytes);
        bulk_load(smem_addr(ring + s * P::kStageBytes),
                  static_cast<const TIn*>(L.g) + (c0 << LEVEL), kTileBytes,
                  bars + 8 * s);
        ++issued;
        p_tile += gridDim.x;
        return;
      }
    }
  };
  if constexpr (kBulkCopies) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int s = 0; s < kStages; ++s) issue_next();
    }
    __syncthreads();  // the mbarriers are initialised
  }
  int leaf = 0, k = 0;  // k: this block's tiles through the ring so far
  for (int tile = blockIdx.x; tile < grp.n_tiles; tile += gridDim.x) {
    while (leaf + 1 < grp.n_leaves && tile >= grp.leaf[leaf + 1].first_tile)
      ++leaf;
    const FwdLeaf& L = grp.leaf[leaf];
    const long long c0 = (long long)(tile - L.first_tile) * P::kT;
    if (kBulkCopies && bulk_tile<P>(L, tile)) {
      const int s = k % kStages;
      unsigned char* const in = ring + s * P::kStageBytes;
      unsigned char* const out = in + kTileBytes;
      mbar_wait(bars + 8 * s, (k / kStages) & 1);
      // stage s's bands were last stored kStages tiles ago: the barrier
      // after that tile's wait below freed them
      fwd_staged<TIn, TA, TD, LEVEL>(in, out);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      // the next tile's stage: its bands' stores (tile k + 1 - kStages)
      // have read shared memory
      if (threadIdx.x == 0) bulk_wait_read<kStages - 2>();
      __syncthreads();
      if (threadIdx.x == 0) {
        const unsigned o = smem_addr(out);
        bulk_store(static_cast<TA*>(L.a) + c0, o, P::kT * (int)sizeof(TA));
        unsigned off = P::kT * (int)sizeof(TA);
#pragma unroll
        for (int i = 0; i < LEVEL; ++i) {  // D_(LEVEL - i)
          const unsigned bytes = (P::kT << i) * (int)sizeof(TD);
          bulk_store(static_cast<TD*>(L.d[i]) + (c0 << i), o + off, bytes);
          off += bytes;
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        issue_next();  // into stage s, which every thread has read
      }
      ++k;
    } else {
      const long long end = c0 + P::kT;
      fwd_direct<TIn, TA, TD, LEVEL>(L, c0, end < L.count ? end : L.count);
    }
  }
  // the last bands' stores have read shared memory (their writes complete
  // before the kernel does)
  if constexpr (kBulkCopies) {
    if (threadIdx.x == 0) bulk_wait_read<0>();
  }
}

// ---------------------------------------------------------------------------
// Inverse

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

// ---------------------------------------------------------------------------
// Host side

template <int LEVEL = 1, typename F>
cudaError_t with_level(int level, F&& f) {
  if constexpr (LEVEL <= kMaxLevel) {
    if (level == LEVEL) return f(std::integral_constant<int, LEVEL>{});
    return with_level<LEVEL + 1>(level, f);
  } else {
    return cudaErrorInvalidValue;
  }
}

template <typename T>
struct Type {
  using type = T;
};

// f(Type<TIn>, Type<TA>, Type<TD>) for the forward's dtype codes: every band
// in the input type (f32 or bf16), or f32 in and A_l with the details in
// bf16, f16 or float8_e4m3fn.
template <typename F>
cudaError_t with_fwd_types(int in, int a, int d, F&& f) {
  if (in == 0 && a == 0 && d == 0)
    return f(Type<float>{}, Type<float>{}, Type<float>{});
  if (in == 1 && a == 1 && d == 1)
    return f(Type<__nv_bfloat16>{}, Type<__nv_bfloat16>{},
             Type<__nv_bfloat16>{});
  if (in == 0 && a == 0 && d == 1)
    return f(Type<float>{}, Type<float>{}, Type<__nv_bfloat16>{});
  if (in == 0 && a == 0 && d == 2)
    return f(Type<float>{}, Type<float>{}, Type<__half>{});
  if (in == 0 && a == 0 && d == 3)
    return f(Type<float>{}, Type<float>{}, Type<Fp8>{});
  return cudaErrorInvalidValue;
}

// Once per kernel: its dynamic shared memory may pass 48 KB.
template <typename TIn, typename TA, typename TD, int LEVEL>
cudaError_t fwd_prepare() {
  static const cudaError_t err = cudaFuncSetAttribute(
      fwd_group_kernel<TIn, TA, TD, LEVEL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      Fwd<TIn, TA, TD, LEVEL>::kSmem);
  return err;
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

// The grouped forward's plan for dtype codes (in, a, d) at `level`, into
// out[5]: coefficients per tile, leaves per launch, co-resident blocks per
// SM, the card's SMs, dynamic shared bytes per block.
int haar_dwt_fwd_plan(int in_dtype, int a_dtype, int d_dtype, int level,
                      int* out) {
  return with_fwd_types(in_dtype, a_dtype, d_dtype, [&](auto ti, auto ta,
                                                        auto td) {
    using TIn = typename decltype(ti)::type;
    using TA = typename decltype(ta)::type;
    using TD = typename decltype(td)::type;
    return with_level(level, [&](auto lv) {
      constexpr int L = decltype(lv)::value;
      using P = Fwd<TIn, TA, TD, L>;
      cudaError_t err = fwd_prepare<TIn, TA, TD, L>();
      int dev = 0, sms = 0, per_sm = 0;
      if (err != cudaSuccess ||
          (err = cudaGetDevice(&dev)) != cudaSuccess ||
          (err = cudaDeviceGetAttribute(
               &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, fwd_group_kernel<TIn, TA, TD, L>, kThreads,
               P::kSmem)) != cudaSuccess)
        return err;
      out[0] = P::kT;
      out[1] = kGroupLeaves;
      out[2] = per_sm;
      out[3] = sms;
      out[4] = P::kSmem;
      return cudaSuccess;
    });
  });
}

// The grouped forward over n_leaves (1..kGroupLeaves) FwdLeaf entries at
// `leaves` (first tiles from 0, in order), on `grid` blocks.  Dtype codes
// as haar_dwt_fwd_plan: 0 = f32, 1 = bf16, 2 = f16, 3 = float8_e4m3fn.
int haar_dwt_fwd_group(int in_dtype, int a_dtype, int d_dtype, int level,
                       const void* leaves, int n_leaves, int grid,
                       void* stream) {
  if (n_leaves < 1 || n_leaves > kGroupLeaves || grid < 1)
    return cudaErrorInvalidValue;
  FwdGroup grp{};
  memcpy(grp.leaf, leaves, n_leaves * sizeof(FwdLeaf));
  grp.n_leaves = n_leaves;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_fwd_types(in_dtype, a_dtype, d_dtype, [&](auto ti, auto ta,
                                                        auto td) {
    using TIn = typename decltype(ti)::type;
    using TA = typename decltype(ta)::type;
    using TD = typename decltype(td)::type;
    return with_level(level, [&](auto lv) {
      constexpr int L = decltype(lv)::value;
      using P = Fwd<TIn, TA, TD, L>;
      const FwdLeaf& last = grp.leaf[n_leaves - 1];
      grp.n_tiles =
          last.first_tile + static_cast<int>((last.count + P::kT - 1) / P::kT);
      const cudaError_t err = fwd_prepare<TIn, TA, TD, L>();
      if (err != cudaSuccess) return err;
      fwd_group_kernel<TIn, TA, TD, L><<<grid, kThreads, P::kSmem, s>>>(grp);
      return cudaGetLastError();
    });
  });
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
