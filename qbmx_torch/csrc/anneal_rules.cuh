// The update rules of the anneal kernels, each on fields already summed, and
// a chain's per-sweep uniforms.  sa_metropolis.cu (K1), sa_heatbath.cu (K2),
// pt_heatbath.cu (K3) and anneal_wide.cu (K4) form their fields differently
// but take every decision through these, so the float operations of a
// decision are the same in all four and in the plain versions
// (qbmx_torch/samplers/sa_torch.py, gibbs.py, tempering.py), whose
// association order they copy.
//
// Build without --use_fast_math: the thresholds need IEEE logf/expf and
// division, and expf must overflow to inf where torch.exp does.

#pragma once

#include <cstdint>

#include "philox.cuh"

namespace qbmx {

// One chain's uniforms for one sweep: from the host (stride R) or drawn
// from its Philox stream four variables at a time, at counter (r, y_base |
// variable/4, t, seed_hi); pt_heatbath.cu puts a rung in y_base.
struct SweepUniforms {
  const float* ut;  // host: &uniforms[t, p, 0, r]; null in Philox mode
  int R;
  uint2 key;
  uint32_t r, t, seed_hi;
  uint32_t y_base = 0;
  int cached = -1;
  uint4 bits;

  __device__ __forceinline__ float operator()(int i) {
    if (ut != nullptr) return ut[(size_t)i * R];
    if ((i >> 2) != cached) {
      cached = i >> 2;
      bits = philox4x32_10(make_uint4(r, y_base | (uint32_t)cached, t, seed_hi), key);
    }
    return uniform_of(word(bits, i & 3));
  }
};

// Metropolis: flip iff (1 - 2 s) * field < -logf(u) / beta.  The threshold
// depends on the uniform and beta alone, so a kernel may compute it ahead of
// the state-dependent comparison.
__device__ __forceinline__ float metropolis_threshold(float u, float beta) {
  return -logf(u) / beta;
}

__device__ __forceinline__ bool metropolis_accept(float field, float s, float thr) {
  return (1.0f - 2.0f * s) * field < thr;
}

__device__ __forceinline__ float metropolis_rule(float field, float s, float beta, float u) {
  return metropolis_accept(field, s, metropolis_threshold(u, beta)) ? 1.0f - s : s;
}

// Heat-bath, width 1: 1 iff field < (logf(1 - u) - logf(u)) / beta.
__device__ __forceinline__ float heatbath_threshold(float u, float beta) {
  return (logf(1.0f - u) - logf(u)) / beta;
}

__device__ __forceinline__ float heatbath_rule(float field, float beta, float u) {
  return field < heatbath_threshold(u, beta) ? 1.0f : 0.0f;
}

// The trailing single of a pair or quad sweep: u < sigmoid(-beta f), i.e.
// u * (1 + expf(beta f)) < 1 (inf-safe: an overflow keeps it 0).
__device__ __forceinline__ float single_rule(float field, float beta, float u) {
  const float w = expf(beta * field);
  return u * (1.0f + w) < 1.0f ? 1.0f : 0.0f;
}

// Variables (i, i+1) from their exact 4-state conditional: f1, f2 are their
// full fields (partner included), c = J[i][i+1], s1, s2 their states.
__device__ __forceinline__ void pair_rule(float f1, float f2, float c, float s1, float s2,
                                          float beta, float u, float& o1, float& o2) {
  const float f1p = f1 - c * s2;  // fields excluding the partner
  const float f2p = f2 - c * s1;
  const float e01 = -beta * f2p;
  const float e10 = -beta * f1p;
  const float e11 = -beta * (f1p + f2p + c);
  const float m = fmaxf(fmaxf(e01, e10), fmaxf(e11, 0.0f));
  const float w00 = expf(-m);
  const float w01 = expf(e01 - m);
  const float w10 = expf(e10 - m);
  const float w11 = expf(e11 - m);
  const float Z = w00 + w01 + w10 + w11;
  const float t = u * Z;
  const float cum2 = w00 + w01;
  const float cum3 = cum2 + w10;
  o1 = t >= cum2 ? 1.0f : 0.0f;
  o2 = ((t >= w00 && t < cum2) || t >= cum3) ? 1.0f : 0.0f;
}

// Variables i..i+3 from their exact 16-state conditional: f their full
// fields, c[a][b] = J[i+a][i+b] for a < b, s their states.  State index
// idx = b0*8 + b1*4 + b2*2 + b3 (bit 3-a is variable i+a); coupling pairs in
// lexicographic order (0,1),(0,2),(0,3),(1,2),(1,3),(2,3).
__device__ __forceinline__ void quad_rule(const float f[4], const float c[4][4],
                                          const float s[4], float beta, float u,
                                          float o[4]) {
  float fp[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float fa = f[a];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (b != a) fa = fa - c[a < b ? a : b][a < b ? b : a] * s[b];
    fp[a] = fa;
  }
  float es[16];
  es[0] = 0.0f;
#pragma unroll
  for (int idx = 1; idx < 16; ++idx) {
    float acc = 0.0f;
    bool first = true;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      if ((idx >> (3 - a)) & 1) {
        acc = first ? fp[a] : acc + fp[a];
        first = false;
      }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = a + 1; b < 4; ++b)
        if (((idx >> (3 - a)) & 1) && ((idx >> (3 - b)) & 1)) acc = acc + c[a][b];
    es[idx] = -beta * acc;
  }
  float m = es[1];
#pragma unroll
  for (int idx = 2; idx < 16; ++idx) m = fmaxf(m, es[idx]);
  m = fmaxf(m, 0.0f);
  float cums[16];
  float cum = expf(es[0] - m);
  cums[0] = cum;
#pragma unroll
  for (int idx = 1; idx < 16; ++idx) {
    cum = cum + expf(es[idx] - m);
    cums[idx] = cum;
  }
  const float t = u * cums[15];
  int sel = 0;
#pragma unroll
  for (int idx = 0; idx < 15; ++idx) sel += t >= cums[idx] ? 1 : 0;
#pragma unroll
  for (int a = 0; a < 4; ++a) o[a] = (float)((sel >> (3 - a)) & 1);
}

// quad_rule spread over 16 lanes: every lane of a chain of 16 or 32 lanes
// (sa_heatbath.cu: a warp or half a warp) calls it with the same values;
// lane l forms the energy and weight of joint state idx = l % 16 alone, by
// quad_rule's operations for that state; the maximum is taken by a
// butterfly within the 16 lanes (fmaxf is exact, so its order does not
// matter); lane l sums the weights of states 0..idx in quad_rule's order,
// and a ballot of its 16 lanes counts the running sums that t reaches.  A
// chain of 32 lanes does the same in both halves.  So every lane returns
// quad_rule's o, bit for bit, at a sixteenth of its expf and energy
// arithmetic.
__device__ __forceinline__ void quad_rule_warp(const float f[4], const float c[4][4],
                                               const float s[4], float beta, float u,
                                               float o[4]) {
  const unsigned full = 0xFFFFFFFFu;
  const int idx = threadIdx.x & 15;
  const int half = threadIdx.x & 16;  // the first lane of this 16 in the warp
  float fp[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float fa = f[a];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (b != a) fa = fa - c[a < b ? a : b][a < b ? b : a] * s[b];
    fp[a] = fa;
  }
  float acc = 0.0f;
  bool first = true;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    if ((idx >> (3 - a)) & 1) {
      acc = first ? fp[a] : acc + fp[a];
      first = false;
    }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = a + 1; b < 4; ++b)
      if (((idx >> (3 - a)) & 1) && ((idx >> (3 - b)) & 1)) acc = acc + c[a][b];
  const float es = idx == 0 ? 0.0f : -beta * acc;
  float m = es;  // the maximum of es[0..15], es[0] = 0: quad_rule's m
#pragma unroll
  for (int d = 1; d < 16; d <<= 1) m = fmaxf(m, __shfl_xor_sync(full, m, d));
  m = fmaxf(m, 0.0f);
  const float w = expf(es - m);
  float cum = __shfl_sync(full, w, 0, 16);  // this lane's running sum, to state idx
#pragma unroll
  for (int k = 1; k < 16; ++k) {
    const float wk = __shfl_sync(full, w, k, 16);
    if (k <= idx) cum = cum + wk;
  }
  const float t = u * __shfl_sync(full, cum, 15, 16);
  // sel counts the running sums 0..14 that t reaches
  const int sel = __popc((__ballot_sync(full, idx < 15 && t >= cum) >> half) & 0x7FFFu);
#pragma unroll
  for (int a = 0; a < 4; ++a) o[a] = (float)((sel >> (3 - a)) & 1);
}

}  // namespace qbmx
