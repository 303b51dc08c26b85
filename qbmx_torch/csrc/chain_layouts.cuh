// What K1 (sa_metropolis.cu) and K2 (sa_heatbath.cu) share for their chain
// layouts (samplers/kernel_call.py::chain_layout): J_g's staging in shared
// memory, a chain's initial bits, the THREAD layout's dot product and the
// GROUP and LANES layouts' ballot words.  K3 (pt_heatbath.cuh) takes the
// staging, the dot product and the ballot words for its layouts with a rung
// for a chain (a rung a thread, GROUP, a rung a warp).

#pragma once

#include <cstdint>

#include "philox.cuh"

namespace qbmx {

// THREAD layout up to this width keeps J_g in registers: the compiler
// hoists its n² loads out of the sweep loop (126 registers at n = 8).  Past
// it that would cap the blocks a SM (147 registers at n = 9, spills from
// n = 14), so a wider THREAD instance rereads J_g's rows from shared memory
// every sweep, 16 bytes a load, in rows padded to a multiple of 4 floats.
constexpr int kThreadRegN = 8;

// The row stride (floats) of J_g in shared memory in the THREAD layout.
__host__ __device__ constexpr int thread_stride(int n) {
  return n <= kThreadRegN ? n : (n + 3) / 4 * 4;
}

// J_g (n x n, row-major in global memory) into shared memory, rows `stride`
// floats apart (the pad zeroed).
__device__ __forceinline__ void stage_J(float* Js, const float* J, int g, int n,
                                        int stride) {
  const int nn = n * n;
  if (stride == n) {
    for (int k = threadIdx.x; k < nn; k += blockDim.x) Js[k] = J[(size_t)g * nn + k];
  } else {
    for (int k = threadIdx.x; k < n * stride; k += blockDim.x) {
      const int i = k / stride, j = k % stride;
      Js[k] = j < n ? J[(size_t)g * nn + i * n + j] : 0.0f;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ bool init_bit(const float* init01, size_t p, int R, int r, int n,
                                         int i, uint2 key, uint32_t seed_hi) {
  if (init01 != nullptr) return init01[(p * R + r) * n + i] != 0.0f;
  const uint4 bits =
      philox4x32_10(make_uint4((uint32_t)r, (uint32_t)(i >> 2), kInitTag, seed_hi), key);
  return (word(bits, i & 3) & 1u) != 0u;
}

// THREAD layout: sum_{j=0..N-1} J_ij s_j, serially in j (i is a constant
// once the caller's loops are unrolled); J_g staged at thread_stride(N).
template <int N>
__device__ __forceinline__ float thread_dot(const float* Js, const float (&s)[N], int i) {
  float acc = 0.0f;
  if constexpr (N <= kThreadRegN) {
#pragma unroll
    for (int j = 0; j < N; ++j) acc += Js[i * N + j] * s[j];
  } else {
    const float4* row = reinterpret_cast<const float4*>(Js + i * thread_stride(N));
#pragma unroll
    for (int q = 0; 4 * q < N; ++q) {
      const float4 v = row[q];
      acc += v.x * s[4 * q];
      if (4 * q + 1 < N) acc += v.y * s[4 * q + 1];
      if (4 * q + 2 < N) acc += v.z * s[4 * q + 2];
      if (4 * q + 3 < N) acc += v.w * s[4 * q + 3];
    }
  }
  return acc;
}

// THREAD layout, at the top of each sweep: past kThreadRegN, a compiler
// barrier, so that J_g's loads stay in the sweep and out of the registers.
template <int N>
__device__ __forceinline__ void thread_sweep_fence() {
  if constexpr (N > kThreadRegN) asm volatile("" ::: "memory");
}

// GROUP and LANES: the L bits of this lane's chain in a warp-wide ballot
// (the lanes of a chain are L consecutive lanes of the warp).
template <int L>
__device__ __forceinline__ uint32_t chain_bits(uint32_t ballot) {
  if constexpr (L == 32) return ballot;
  else return (ballot >> (threadIdx.x % 32 / L * L)) & ((1u << L) - 1u);
}

}  // namespace qbmx
