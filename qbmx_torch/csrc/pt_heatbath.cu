// Parallel tempering (replica exchange) with heat-bath sweeps over a dense
// batch of QUBOs, for NVIDIA Hopper (sm_90a).
//
// Replaces the parallel-tempering mode of the TPU kernel of qbmx:
//   qbmx/samplers/sa_pallas.py _sa_kernel with M > 0 (entry
//   pt_sample_batch_pallas), which packs a ladder's M rungs as M pack slots
//   and exchanges them with sublane rolls.  That layout is not carried over.
//
// Semantics (those of qbmx_torch/samplers/tempering.py, the plain version):
// read r of problem b is a ladder of M rungs at fixed inverse temperatures
// betas[b, m].  Per sweep t, every rung m does one single-variable
// heat-bath sweep at its beta (variable i becomes 1 iff
// field_i < (logf(1-u) - logf(u))/beta); then the links (m, m+1) with
// m % 2 == t % 2 swap states iff dbeta[b, m]*(E[m] - E[m+1]) < -logf(u_swap).
// The target rung M-1 is written out.  Each rung's energy is tracked
// incrementally (E += ds*field, as the TPU kernel does); the plain version
// recomputes it, so a near-tie exchange may go the other way in a few
// chains.
//
// What bounds it on this card: a ladder is one sequential chain of M*n
// sub-steps a sweep (each an n-term dot product with J_b in shared memory)
// plus M/2 exchange tests, and its exchanges couple the rungs.  The design
// keeps a whole ladder in one thread -- (b, r), r fastest, J_b staged once
// per block -- so the exchange is a swap inside the thread's own state
// array (bounded by the template parameter CAP >= M*n) and needs no
// shuffles or barriers.  The cost is M times K1's work per thread; a warp
// per ladder with shuffled energies is later work.
//
// Random numbers: with null variate pointers a ladder draws from a
// Philox4x32-10 stream (philox.cuh) keyed by (seed, problem b), so its
// draws do not depend on its batch-mates; the rung rides in the counter.
// Variable draws: counter (read, (m << 8) | variable/4, sweep), sweep slot
// 2^32-1 for the initial bits.  Swap draws: counter (read,
// ((m / 4) << 8) | 0xFF, sweep), word m % 4.  With non-null pointers
// init01 (B*M,R,n), uniforms (S,B*M,n,R) and swap_u (S,B*M,R), slot b*M+m,
// come from the host.
//
// Build without --use_fast_math: the thresholds need IEEE logf and division
// to agree with the plain version.

#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

using qbmx::kInitTag;
using qbmx::philox4x32_10;
using qbmx::uniform_of;
using qbmx::word;

constexpr int kThreads = 128;
constexpr int kMaxRungs = 64;
// Largest n whose J_b (4·n² bytes) fits one block's 232,448 bytes of shared
// memory.
constexpr int kMaxN = 241;
constexpr uint32_t kSwapTag = 0xFFu;  // variable-block slot of the swap draws

__device__ __forceinline__ float dot(const float* Ji, const float* s, int n) {
  float acc = 0.0f;
  for (int j = 0; j < n; ++j) acc += Ji[j] * s[j];
  return acc;
}

template <int CAP>
__global__ void __launch_bounds__(kThreads)
pt_heatbath_kernel(const float* __restrict__ J, const float* __restrict__ h,
                   const float* __restrict__ betas, const float* __restrict__ dbeta,
                   const float* __restrict__ init01, const float* __restrict__ uniforms,
                   const float* __restrict__ swap_u, float* __restrict__ out, int B, int M,
                   int R, int n, int S, uint32_t seed_lo, uint32_t seed_hi) {
  extern __shared__ float Js[];  // J_b, n*n row-major
  const int b = blockIdx.y;
  const int nn = n * n;
  for (int k = threadIdx.x; k < nn; k += blockDim.x) Js[k] = J[(size_t)b * nn + k];
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const uint2 key = make_uint2(seed_lo, (uint32_t)b);
  const bool host = uniforms != nullptr;
  const float* hp = h + (size_t)b * n;
  const size_t BM = (size_t)B * M;
  const size_t slot0 = (size_t)b * M;  // slot of rung 0

  float s[CAP];  // rung m's state at s[m*n .. m*n+n)
  float E[kMaxRungs];
  for (int m = 0; m < M; ++m) {
    float* sm = s + m * n;
    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    for (int i = 0; i < n; ++i) {
      if (host) {
        sm[i] = init01[((slot0 + m) * R + r) * n + i];
      } else {
        if ((i & 3) == 0)
          bits = philox4x32_10(
              make_uint4((uint32_t)r, ((uint32_t)m << 8) | (uint32_t)(i >> 2), kInitTag, seed_hi),
              key);
        sm[i] = (float)(word(bits, i & 3) & 1u);
      }
    }
    float e = 0.0f;  // h.s + s.J.s / 2
    for (int i = 0; i < n; ++i) e += sm[i] * (hp[i] + 0.5f * dot(Js + i * n, sm, n));
    E[m] = e;
  }

  for (int t = 0; t < S; ++t) {
    for (int m = 0; m < M; ++m) {
      float* sm = s + m * n;
      const float beta = betas[slot0 + m];
      const float* ut = host ? uniforms + ((t * BM + slot0 + m) * n) * R + r : nullptr;
      float e = E[m];
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      for (int i = 0; i < n; ++i) {
        float u;
        if (host) {
          u = ut[(size_t)i * R];
        } else {
          if ((i & 3) == 0)
            bits = philox4x32_10(make_uint4((uint32_t)r, ((uint32_t)m << 8) | (uint32_t)(i >> 2),
                                            (uint32_t)t, seed_hi),
                                 key);
          u = uniform_of(word(bits, i & 3));
        }
        const float thr = (logf(1.0f - u) - logf(u)) / beta;
        const float f = hp[i] + dot(Js + i * n, sm, n);
        const float v = f < thr ? 1.0f : 0.0f;
        e += (v - sm[i]) * f;  // incremental energy of the accepted update
        sm[i] = v;
      }
      E[m] = e;
    }
    for (int m = t & 1; m < M - 1; m += 2) {
      float usw;
      if (host) {
        usw = swap_u[(t * BM + slot0 + m) * R + r];
      } else {
        const uint4 w = philox4x32_10(
            make_uint4((uint32_t)r, ((uint32_t)(m >> 2) << 8) | kSwapTag, (uint32_t)t, seed_hi),
            key);
        usw = uniform_of(word(w, m & 3));
      }
      if (dbeta[slot0 + m] * (E[m] - E[m + 1]) < -logf(usw)) {
        float* lo = s + m * n;
        float* hi = lo + n;
        for (int i = 0; i < n; ++i) {
          const float x = lo[i];
          lo[i] = hi[i];
          hi[i] = x;
        }
        const float x = E[m];
        E[m] = E[m + 1];
        E[m + 1] = x;
      }
    }
  }

  const float* target = s + (M - 1) * n;
  float* op = out + ((size_t)b * R + r) * n;
  for (int i = 0; i < n; ++i) op[i] = target[i];
}

template <int CAP>
cudaError_t launch(const float* J, const float* h, const float* betas, const float* dbeta,
                   const float* init01, const float* uniforms, const float* swap_u,
                   float* out, int B, int M, int R, int n, int S, unsigned long long seed,
                   cudaStream_t stream) {
  const size_t smem = (size_t)n * n * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pt_heatbath_kernel<CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)((R + kThreads - 1) / kThreads), (unsigned)B);
  pt_heatbath_kernel<CAP><<<grid, kThreads, smem, stream>>>(
      J, h, betas, dbeta, init01, uniforms, swap_u, out, B, M, R, n, S,
      (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32));
  return cudaGetLastError();
}

}  // namespace

// Bounds of the kernel: n (J_b and a rung), the rungs of a ladder, and the
// state of a whole ladder (M*n floats per thread).
extern "C" int qbmx_pt_heatbath_max_n() { return kMaxN; }
extern "C" int qbmx_pt_heatbath_max_rungs() { return kMaxRungs; }
extern "C" int qbmx_pt_heatbath_max_state() { return 2048; }

// Returns the cudaError_t of the launch (0 = success).  init01, uniforms and
// swap_u are all null (Philox mode) or all set (host-variate mode).
extern "C" int qbmx_pt_heatbath(const float* J, const float* h, const float* betas,
                                const float* dbeta, const float* init01,
                                const float* uniforms, const float* swap_u, float* out,
                                int B, int M, int R, int n, int S, unsigned long long seed,
                                void* stream) {
  const bool some = init01 != nullptr || uniforms != nullptr || swap_u != nullptr;
  const bool all = init01 != nullptr && uniforms != nullptr && swap_u != nullptr;
  if (B <= 0 || M <= 0 || R <= 0 || n <= 0 || S <= 0 || B > 65535 || n > kMaxN ||
      M > kMaxRungs || M * n > 2048 || some != all)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M * n <= 64)
    return (int)launch<64>(J, h, betas, dbeta, init01, uniforms, swap_u, out, B, M, R, n, S, seed, st);
  if (M * n <= 512)
    return (int)launch<512>(J, h, betas, dbeta, init01, uniforms, swap_u, out, B, M, R, n, S, seed, st);
  return (int)launch<2048>(J, h, betas, dbeta, init01, uniforms, swap_u, out, B, M, R, n, S, seed, st);
}
