// Staged GWT-Adam update for one (L, N) stack of same-shaped leaves, in one
// launch: level-l Haar DWT along rows -> Adam on the A_l band ->
// A~ = m/(sqrt(v)+eps), details scaled by the same 1/(sqrt(v)+eps) ->
// inverse DWT -> G~ written in the gradient's type, new m and v written to
// their own outputs, and one partial ||G~||^2 of the rounded G~ per
// (leaf, chunk of 2048 coefficients).  The limiter, the step and the
// parameter write stay with the caller.  Two variants:
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
// about 5.06 bytes per element at level 2.  At the staged path's leaves
// ((8,512,512): 16.8 MB, 256 chunks for 132 SMs) the launch is about two
// blocks per SM in one wave, so what bounds it is the bytes each SM keeps
// in flight and the latency of the chunk's first loads, not the
// arithmetic.
//
// Design (K1's and K2's one-pass phase A, gwt_adam_common.cuh, with the
// same moment policies, F32Moments and Q8Moments, writing to separate
// outputs; without the grid barrier, the limiter and the write: nothing
// waits on another block, so a plain launch of grid (S, L), one block per
// chunk):
//  * A thread takes two adjacent coefficients per round, 4 rounds of 512
//    coefficients a chunk; coefficient j of the flat leaf covers gradient
//    elements [j*2^l, (j+1)*2^l), because rows are contiguous.
//  * Every load of the chunk is issued before the first round's
//    arithmetic: each thread copies its own pairs' g into the chunk's slot
//    of dynamic shared memory by cp.async (16-byte copies where the
//    address allows; one commit group per round, waited for round by
//    round: a thread reads only what it copied, so no barrier); K4 loads
//    its pairs' m and v into registers (8-byte loads); K5's block stages
//    the chunk's codes and scales by 16-byte cp.async with round 0
//    (stage_bytes, as the one-pass K2 does), then one barrier before the
//    rounds.  At level 2 in bf16 that is 128 bytes a thread in flight
//    (K4).  K5 stages its codes and scales because, loaded into registers
//    as 2-byte and broadcast 4-byte loads, they held K5 far from a copy of
//    the same bytes on the H100; staged, they move 16 bytes a copy.
//  * G~ is written to device memory from registers (16-byte stores where
//    aligned) and rounded to T over the pair's g in the slot; after one
//    barrier the chunk's partial is summed from the slot in the two-pass
//    kernels' order (chunk_partial: thread t takes coefficients t + 256k,
//    k = 0..7, each one's 2^l squares in order, then block_sum), the order
//    of the plain version's chunk_ssq.  No float atomics: identical from
//    run to run.  The slot is 2048 * 2^l * sizeof(T) bytes (16 KB at level
//    2 in bf16, up to 128 KB at level 4 in f32; the kernel's dynamic
//    shared memory limit is raised above 48 KB).
//  * K5: a warp holds exactly one 64-coefficient quantization block per
//    round (32 lanes x 2), so the absmax is warp shuffles and there is no
//    block barrier in the rounds (Q8Moments::update); 1/scale is one
//    __fdiv_rn per block and moment.  The rounding bits
//    u = uniform01(salt, j) come from the codec's murmur3 hash in native
//    uint32, j the leaf-flat coefficient index; the salts (one per leaf and
//    moment) are computed on the device by the engine.  A leaf whose
//    coefficient count is not a multiple of 64 ends in a partial block,
//    whose absent coefficients count as 0 in the absmax.
//  * Alignment: a leaf's base is at l*na*2^l elements and its codes at
//    l*na bytes, so with na odd the vector accesses of leaves after the
//    first are misaligned: every copy and access checks its address and
//    takes 8-, 4-, 2-byte or scalar accesses there (the staged codes sit
//    at their source's offset within 16 bytes).
//  * Rounding follows the plain PyTorch versions (ref.py) point for point:
//    G~ is rounded to the gradient type before it is squared; every product
//    and sum is an _rn intrinsic, so nvcc contracts nothing into FMAs that
//    PyTorch's op-by-op arithmetic does not make; sqrt and division are
//    IEEE (build without --use_fast_math).

#include "gwt_adam_common.cuh"
#include "gwt_adam_q8.cuh"

namespace {

// Dynamic shared memory of one block: a slot for the chunk's g (then its
// rounded G~) and Mo's staging entry (K5: the chunk's codes and scales).
template <typename T, int LEVEL, class Mo>
constexpr int tile_smem() {
  return kChunk * (1 << LEVEL) * static_cast<int>(sizeof(T)) + Mo::kRingBytes;
}

// grid (S, L): block s of leaf l takes coefficients [s*kChunk, (s+1)*kChunk)
// of the leaf, with Mo the moments' policy (F32Moments: K4; Q8Moments: K5).
template <typename T, int LEVEL, class Mo>
__global__ void __launch_bounds__(kThreads)
tile(const T* __restrict__ g, T* __restrict__ gt, float* __restrict__ partials,
     long long na, Coeffs c, Mo mo) {
  constexpr int B = 1 << LEVEL;
  extern __shared__ __align__(16) unsigned char smem[];
  T* slot = reinterpret_cast<T*>(smem);
  unsigned char* entry = smem + kChunk * B * static_cast<int>(sizeof(T));
  const long long leaf = blockIdx.y, s = blockIdx.x, j0 = s * kChunk;
  const long long left = na - j0;
  const int n = static_cast<int>(left < kChunk ? left : kChunk);
  const int t = threadIdx.x;
  const T* gc = g + (leaf * na + j0) * B;
  T* gtc = gt + (leaf * na + j0) * B;
  // every load of the chunk in flight before any arithmetic, by cp.async,
  // one group per round: Mo's staging (K5: the codes and scales, by the
  // whole block) with round 0, then the thread's own pairs of g into the
  // slot; K4's moments go to registers
  if constexpr (Mo::kRingBytes > 0) mo.stage(entry, leaf, na, j0, n);
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int cl = 2 * (t + r * kThreads);
    if (cl < n) copy_pair_async<T, B>(slot + cl * B, gc + cl * B, cl + 1 < n);
    cp_async_commit();
  }
  const typename Mo::Chunk ck = mo.chunk(entry, leaf, na, j0);
  typename Mo::Regs regs[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int cl = 2 * (t + r * kThreads);
    mo.load(ck, cl, cl < n, cl + 1 < n, regs[r]);
  }
  if constexpr (Mo::kRingBytes > 0) {
    // the staging was copied by other threads: wait for it, then one
    // barrier before the rounds (none inside them)
    cp_async_wait_n(kRounds - 1);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int cl = 2 * (t + r * kThreads);
    const bool v0 = cl < n, v1 = cl + 1 < n;
    cp_async_wait_n(kRounds - 1 - r);  // this round's pairs have landed
    float x[2 * B];
    vload<T, 2 * B>(slot + cl * B, x);  // past the chunk's end: unused
    mo.template update<LEVEL>(ck, cl, n, v0, v1, x, regs[r], c);
    if (!v0) continue;
    T e[2 * B];
#pragma unroll
    for (int k = 0; k < 2 * B; ++k) e[k] = from_f32<T>(x[k]);
    store_pair<T, B>(gtc + cl * B, e, v1);
    vstore<T, 2 * B>(slot + cl * B, e);
  }
  __syncthreads();
  const float total = chunk_partial<T, B>(slot, n);
  if (t == 0) partials[leaf * gridDim.x + s] = total;
}

template <typename T, class Mo>
cudaError_t launch(int level, const void* g, void* gt, float* partials,
                   long long L, long long na, Coeffs c, const Mo& mo,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)((na + kChunk - 1) / kChunk), (unsigned)L);
  return with_level(level, [&](auto lv) {
    constexpr int LEVEL = decltype(lv)::value;
    constexpr int kSmem = tile_smem<T, LEVEL, Mo>();
    const auto kern = tile<T, LEVEL, Mo>;
    if (kSmem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          reinterpret_cast<const void*>(kern),
          cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
      if (err != cudaSuccess) return err;
    }
    kern<<<grid, kThreads, kSmem, stream>>>(static_cast<const T*>(g),
                                            static_cast<T*>(gt), partials, na,
                                            c, mo);
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
  const F32Moments mo{m, v, m_out, v_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(level, g, gt, partials, L, na, c, mo, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(level, g, gt, partials, L, na, c, mo, s);
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
  const Q8Moments mo{qm,     sm,     qv,     sv,     salt_m, salt_v,
                     qm_out, sm_out, qv_out, sv_out,
                     (na + kQBlock - 1) / kQBlock};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(level, g, gt, partials, L, na, c, mo, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(level, g, gt, partials, L, na, c, mo, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
