// Device helpers of the blocked-int8 GWT-Adam kernels
// (gwt_adam_fused_q8.cu: K2, the fused write; gwt_adam_tile.cu: K5, the
// staged update): dequantization, the codec's murmur3 rounding hash in
// native uint32, stochastic requantization and the absmax of a
// 64-coefficient quantization block held by one warp (Q8Moments, the
// moment policy of K2's designs and K5).
// Include after gwt_adam_common.cuh.  Rounding as there: _rn intrinsics,
// IEEE division.

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

// Absmax over one warp, for two values at once: K2 and K5 put a whole
// quantization block on one warp (32 lanes x 2 coefficients), so no shared
// memory and no barrier.
__device__ __forceinline__ void warp_absmax(float& am, float& av) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, off));
    av = fmaxf(av, __shfl_xor_sync(0xffffffffu, av, off));
  }
}

// A thread's pair of codes (coefficients cl, cl + 1; the second only if
// v1), one 2-byte store where the address allows it.
__device__ __forceinline__ void store_codes(signed char* q,
                                            const signed char (&e)[2],
                                            bool v1) {
  if (v1 && aligned(q, 2)) {
    *reinterpret_cast<char2*>(q) = make_char2(e[0], e[1]);
  } else {
    q[0] = e[0];
    if (v1) q[1] = e[1];
  }
}

// Blocked-int8 moments, two coefficients a thread (K2 and K5):
// a warp is one quantization block per round.  A chunk's codes and scales
// are staged into shared memory with its g; the new ones go to qm_out,
// sm_out, qv_out, sv_out (K2 passes the inputs themselves: in place).
struct Q8Moments {
  const signed char* qm;
  const float* sm;
  const signed char* qv;
  const float* sv;
  const unsigned* salt_m;
  const unsigned* salt_v;
  signed char* qm_out;
  float* sm_out;
  signed char* qv_out;
  float* sv_out;
  long long nb;  // scales per leaf
  // a chunk's codes of m and v, then its scales of m and v, each staged at
  // its source's offset within 16 bytes (stage_bytes)
  static constexpr int kCodeBytes = kChunk + 16;
  static constexpr int kScaleBytes = kChunk / kQBlock * 4 + 16;
  static constexpr int kRingBytes = 2 * kCodeBytes + 2 * kScaleBytes;
  static_assert(kRingBytes % 16 == 0, "ring entries stay 16-byte aligned");
  struct Chunk {
    const signed char *cm, *cv;  // staged codes
    const float *sm, *sv;        // staged scales
    signed char *qm, *qv;        // where the chunk's new codes go
    float *om, *ov;              // and its new scales
    unsigned salt_m, salt_v, j0;
  };
  struct Regs {};
  __device__ __forceinline__ void stage(unsigned char* e, long long leaf,
                                        long long na, long long j0,
                                        int n) const {
    const long long q0 = leaf * nb + j0 / kQBlock;
    const int nq = (n + kQBlock - 1) / kQBlock;
    stage_bytes(e, reinterpret_cast<const unsigned char*>(qm + leaf * na + j0),
                n);
    stage_bytes(e + kCodeBytes,
                reinterpret_cast<const unsigned char*>(qv + leaf * na + j0),
                n);
    stage_bytes(e + 2 * kCodeBytes,
                reinterpret_cast<const unsigned char*>(sm + q0), 4 * nq);
    stage_bytes(e + 2 * kCodeBytes + kScaleBytes,
                reinterpret_cast<const unsigned char*>(sv + q0), 4 * nq);
  }
  __device__ __forceinline__ Chunk chunk(const unsigned char* e,
                                         long long leaf, long long na,
                                         long long j0) const {
    const long long off = leaf * na + j0, q0 = leaf * nb + j0 / kQBlock;
    return {staged<signed char>(e, qm + off),
            staged<signed char>(e + kCodeBytes, qv + off),
            staged<float>(e + 2 * kCodeBytes, sm + q0),
            staged<float>(e + 2 * kCodeBytes + kScaleBytes, sv + q0),
            qm_out + off, qv_out + off, sm_out + q0, sv_out + q0,
            salt_m[leaf], salt_v[leaf], static_cast<unsigned>(j0)};
  }
  __device__ __forceinline__ void load(const Chunk&, int, bool, bool,
                                       Regs&) const {}
  template <int LEVEL>
  __device__ __forceinline__ void update(const Chunk& ck, int cl, int n,
                                         bool v0, bool v1,
                                         float (&x)[2 << LEVEL], Regs&,
                                         const Coeffs& c) const {
    static_assert(kQBlock == 64 && kChunk % kQBlock == 0,
                  "a warp of two-coefficient lanes is one quantization block");
    constexpr int B = 1 << LEVEL;
    const int lane = threadIdx.x & 31;
    const int cw = cl - 2 * lane;  // the quantization block's first
    const int qi = cw / kQBlock;
    float scm = 0.0f, scv = 0.0f;
    if (cw < n) {
      scm = ck.sm[qi];
      scv = ck.sv[qi];
    }
    float m2[2] = {0.0f, 0.0f}, v2[2] = {0.0f, 0.0f};
    if (v0) {
      m2[0] = __fmul_rn(static_cast<float>(ck.cm[cl]), scm);
      v2[0] = __fmul_rn(static_cast<float>(ck.cv[cl]), scv);
      dht_adam<LEVEL>(coeff<B>(x, 0), m2[0], v2[0], c);
      if (v1) {
        m2[1] = __fmul_rn(static_cast<float>(ck.cm[cl + 1]), scm);
        v2[1] = __fmul_rn(static_cast<float>(ck.cv[cl + 1]), scv);
        dht_adam<LEVEL>(coeff<B>(x, 1), m2[1], v2[1], c);
      }
    }
    float am = fmaxf(v0 ? fabsf(m2[0]) : 0.0f, v1 ? fabsf(m2[1]) : 0.0f);
    float av = fmaxf(v0 ? fabsf(v2[0]) : 0.0f, v1 ? fabsf(v2[1]) : 0.0f);
    warp_absmax(am, av);
    const float nsm = quant_scale(am), nsv = quant_scale(av);
    const float im = quant_inv(nsm), iv = quant_inv(nsv);
    if (v0) {
      // the codec's rounding index: the leaf-flat coefficient index, uint32
      const unsigned j = ck.j0 + static_cast<unsigned>(cl);
      signed char cm[2], cv[2];
      cm[0] = quant_with(m2[0], im, ck.salt_m, j);
      cv[0] = quant_with(v2[0], iv, ck.salt_v, j);
      if (v1) {
        cm[1] = quant_with(m2[1], im, ck.salt_m, j + 1u);
        cv[1] = quant_with(v2[1], iv, ck.salt_v, j + 1u);
      }
      store_codes(ck.qm + cl, cm, v1);
      store_codes(ck.qv + cl, cv, v1);
    }
    if (lane == 0 && cw < n) {
      ck.om[qi] = nsm;
      ck.ov[qi] = nsv;
    }
  }
};

}  // namespace
