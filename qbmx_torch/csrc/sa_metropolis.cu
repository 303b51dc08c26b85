// Annealed single-flip Metropolis over the structured shared-coupling form,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the Metropolis mode of both TPU kernels of qbmx:
//   * qbmx/samplers/sa_lane.py   _lane_kernel (entry lane_sample_groups,
//     rule="metropolis") -- G groups x B problems with per-group couplings;
//   * qbmx/samplers/sa_pallas.py _sa_kernel   (entry sa_sample_batch_pallas,
//     rule="metropolis") -- a dense batch, here G = B groups of one problem.
// The TPU layouts (packed interleave, Kronecker lane fold, block-sweep rank
// updates) are not carried over.
//
// Semantics (identical to qbmx_torch/samplers/sa_torch.py, the plain
// version): problem p = g*B + b has couplings J_g (symmetric, zero diagonal)
// and linear terms h[p]; its schedule is beta_t = hot[p]*expf(logr[p]*t*inv_span);
// each sweep visits variables 0..n-1 and flips variable i iff
// (1 - 2 s_i) * (h_i + sum_j J_ij s_j) < -logf(u) / beta_t.
//
// What bounds it on this card: each chain is a sequential dependency chain of
// n*S sub-steps (every flip decision needs the state left by the previous
// one), each costing an n-term dot product whose J_g row is read from shared
// memory.  The design runs the chains in parallel instead: one thread per
// chain (g, b, r), r fastest, so a warp reads the same J_g[i, j] (a shared-
// memory broadcast) and the host-variate reads u[t, g, b, i, r] coalesce.
// J_g is staged once per block in shared memory; the chain state lives in a
// per-thread array bounded by the template parameter NMAX.
//
// Random numbers: with null variate pointers every chain draws from a
// Philox4x32-10 stream (philox.cuh) keyed by (seed, problem id) with the
// counter over (read, variable/4, sweep), so a problem's samples do not
// depend on its batch-mates.  Uniforms are (bits >> 8) * 2^-24; the initial
// state takes the low bit.  With non-null pointers the initial state init01 (G,B,R,n)
// and the uniforms (S,G,B,n,R) come from the host.
//
// Build without --use_fast_math: the thresholds need IEEE logf/expf and
// division to agree with the plain version.

#include <cstdint>
#include <cuda_runtime.h>

#include "anneal_rules.cuh"

namespace {

using qbmx::kInitTag;
using qbmx::metropolis_rule;
using qbmx::philox4x32_10;
using qbmx::SweepUniforms;
using qbmx::word;

constexpr int kThreads = 128;
// Largest n whose J_g (4·n² bytes) fits one block's 232,448 bytes of shared
// memory; the wrappers send wider problems to anneal_wide.cu (K4).
constexpr int kMaxN = 241;

template <int NMAX>
__global__ void __launch_bounds__(kThreads)
sa_metropolis_kernel(const float* __restrict__ J, const float* __restrict__ h,
                     const float* __restrict__ hot, const float* __restrict__ logr,
                     const float* __restrict__ init01,
                     const float* __restrict__ uniforms, float* __restrict__ out,
                     int G, int B, int R, int n, int S, float inv_span,
                     uint32_t seed_lo, uint32_t seed_hi) {
  extern __shared__ float Js[];  // J_g, n*n row-major
  const int g = blockIdx.y;
  const int nn = n * n;
  for (int k = threadIdx.x; k < nn; k += blockDim.x) Js[k] = J[(size_t)g * nn + k];
  __syncthreads();

  const long long chain = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (chain >= (long long)B * R) return;
  const int b = (int)(chain / R);
  const int r = (int)(chain % R);
  const size_t p = (size_t)g * B + b;  // problem id
  const uint2 key = make_uint2(seed_lo, (uint32_t)p);
  const bool host = uniforms != nullptr;

  float s[NMAX];
  const float* hp = h + p * n;
  uint4 bits = make_uint4(0u, 0u, 0u, 0u);
  for (int i = 0; i < n; ++i) {
    if (host) {
      s[i] = init01[(p * R + r) * n + i];
    } else {
      if ((i & 3) == 0)
        bits = philox4x32_10(make_uint4((uint32_t)r, (uint32_t)(i >> 2), kInitTag, seed_hi), key);
      s[i] = (float)(word(bits, i & 3) & 1u);
    }
  }

  const float hot_p = hot[p], logr_p = logr[p];
  const size_t u_sweep = (size_t)G * B * n * R;  // uniforms per sweep
  for (int t = 0; t < S; ++t) {
    const float beta = hot_p * expf(logr_p * ((float)t * inv_span));
    SweepUniforms u{host ? uniforms + (size_t)t * u_sweep + p * n * R + r : nullptr, R, key,
                    (uint32_t)r, (uint32_t)t, seed_hi};
    for (int i = 0; i < n; ++i) {
      const float* Ji = Js + i * n;
      float acc = 0.0f;
      for (int j = 0; j < n; ++j) acc += Ji[j] * s[j];
      s[i] = metropolis_rule(hp[i] + acc, s[i], beta, u(i));
    }
  }

  float* op = out + (p * R + r) * n;
  for (int i = 0; i < n; ++i) op[i] = s[i];
}

template <int NMAX>
cudaError_t launch(const float* J, const float* h, const float* hot, const float* logr,
                   const float* init01, const float* uniforms, float* out, int G, int B,
                   int R, int n, int S, float inv_span, unsigned long long seed,
                   cudaStream_t stream) {
  const size_t smem = (size_t)n * n * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sa_metropolis_kernel<NMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long chains = (long long)B * R;
  const dim3 grid((unsigned)((chains + kThreads - 1) / kThreads), (unsigned)G);
  sa_metropolis_kernel<NMAX><<<grid, kThreads, smem, stream>>>(
      J, h, hot, logr, init01, uniforms, out, G, B, R, n, S, inv_span,
      (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32));
  return cudaGetLastError();
}

}  // namespace

// Largest n the kernel takes: J_g must fit one block's shared memory.
extern "C" int qbmx_sa_metropolis_max_n() { return kMaxN; }

// Returns the cudaError_t of the launch (0 = success).  init01/uniforms are
// both null (Philox mode) or both set (host-variate mode).
extern "C" int qbmx_sa_metropolis(const float* J, const float* h, const float* hot,
                                  const float* logr, const float* init01,
                                  const float* uniforms, float* out, int G, int B, int R,
                                  int n, int S, float inv_span, unsigned long long seed,
                                  void* stream) {
  if (G <= 0 || B <= 0 || R <= 0 || n <= 0 || S <= 0 || G > 65535 ||
      (init01 == nullptr) != (uniforms == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 8)
    return (int)launch<8>(J, h, hot, logr, init01, uniforms, out, G, B, R, n, S, inv_span, seed, st);
  if (n <= 64)
    return (int)launch<64>(J, h, hot, logr, init01, uniforms, out, G, B, R, n, S, inv_span, seed, st);
  if (n <= kMaxN)
    return (int)launch<256>(J, h, hot, logr, init01, uniforms, out, G, B, R, n, S, inv_span, seed, st);
  return (int)cudaErrorInvalidValue;
}
