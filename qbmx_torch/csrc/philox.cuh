// Philox4x32-10 (Salmon et al., SC'11), the counter-based generator every
// kernel of qbmx_torch draws its random numbers from.  Each kernel keys it
// by (seed low word, stream id) and chooses its own counter layout; the
// host-side copy that writes the same draws out is
// qbmx_torch/samplers/sa_torch.py::philox4x32_10.
//
// A uniform is (word >> 8) * 2^-24 in [0, 1); an initial bit is the low bit
// of a word.

#pragma once

#include <cstdint>

namespace qbmx {

constexpr uint32_t kInitTag = 0xFFFFFFFFu;  // sweep slot of the initial bits

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += W0;
    k.y += W1;
  }
  return c;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float uniform_of(uint32_t w) {
  return (float)(w >> 8) * (1.0f / 16777216.0f);
}

}  // namespace qbmx
