// Annealed heat-bath ("BMS") sampling over the structured shared-coupling
// form, for NVIDIA Hopper (sm_90a), with single, pair and quad updates.
//
// Replaces the heat-bath mode of both TPU kernels of qbmx:
//   * qbmx/samplers/sa_lane.py   _lane_kernel (entry lane_sample_groups,
//     rule="heatbath", pair False or True) -- G groups x B problems;
//   * qbmx/samplers/sa_pallas.py _sa_kernel   (entry gibbs_sample_batch_pallas,
//     single, pair or quad updates) -- a dense batch, here G = B groups of
//     one problem.
// The TPU layouts and the packed kernel's demotion of quad to pair at some
// pack sizes are not carried over: every width runs as asked.
//
// Semantics (identical to qbmx_torch/samplers/gibbs.py, the plain version,
// whose float operations copy qbmx.samplers.gibbs in the same association
// order): problem p = g*B + b has couplings J_g (symmetric, zero diagonal)
// and linear terms h[p]; its warm-up schedule is
// beta_t = hot[p]*expf(logr[p]*t*inv_span).  Per sweep, with u[i] the
// sweep's uniform for variable i:
//   * WIDTH 1: variable i becomes 1 iff field_i < (logf(1-u[i]) - logf(u[i]))/beta;
//   * WIDTH 2: pairs (2q, 2q+1) from their exact 4-state conditional with
//     u[2q]; a trailing odd variable is 1 iff u*(1 + expf(beta*field)) < 1
//     (inf-safe: an overflow keeps it 0);
//   * WIDTH 4: quads 4q..4q+3 from their exact 16-state conditional with
//     u[4q], then a remainder pair and/or a trailing single as above.
//
// What bounds it on this card: as for sa_metropolis.cu, each chain is a
// strictly sequential chain of sub-steps, each an n-term dot product per
// updated variable read from J_g in shared memory, plus 4 (pair) or 16
// (quad) expf.  Wider updates shorten the chain (n, n/2, n/4 sub-steps a
// sweep) at more arithmetic per sub-step.  The design is K1's: one thread
// per chain (g, b, r), r fastest, so a warp reads the same J_g[i, j] (a
// shared-memory broadcast) and the host-variate reads u[t, g, b, i, r]
// coalesce; the state lives in a per-thread array bounded by NMAX.
//
// Random numbers: the streams of sa_metropolis.cu (philox.cuh), keyed by
// (seed, problem id) with the counter over (read, variable/4, sweep), so
// qbmx_torch/samplers/sa_torch.py::philox_variates writes out this kernel's
// draws too.  A pair or quad reads the uniform of its first variable.
//
// Build without --use_fast_math: the thresholds need IEEE logf/expf and
// division to agree with the plain version, and expf must overflow to inf
// where torch.exp does.

#include <cstdint>
#include <cuda_runtime.h>

#include "anneal_rules.cuh"

namespace {

using qbmx::heatbath_rule;
using qbmx::kInitTag;
using qbmx::pair_rule;
using qbmx::philox4x32_10;
using qbmx::quad_rule;
using qbmx::single_rule;
using qbmx::SweepUniforms;
using qbmx::word;

constexpr int kThreads = 128;
// Largest n whose J_g (4·n² bytes) fits one block's 232,448 bytes of shared
// memory; the wrappers send wider problems to anneal_wide.cu (K4).
constexpr int kMaxN = 241;

__device__ __forceinline__ float field(const float* Js, const float* hp, const float* s,
                                       int n, int i) {
  const float* Ji = Js + i * n;
  float acc = 0.0f;
  for (int j = 0; j < n; ++j) acc += Ji[j] * s[j];
  return hp[i] + acc;
}

__device__ __forceinline__ void single_update(float* s, const float* Js, const float* hp,
                                              int n, int i, float beta, float u) {
  s[i] = single_rule(field(Js, hp, s, n, i), beta, u);
}

__device__ __forceinline__ void pair_update(float* s, const float* Js, const float* hp,
                                            int n, int i, float beta, float u) {
  pair_rule(field(Js, hp, s, n, i), field(Js, hp, s, n, i + 1), Js[i * n + i + 1], s[i],
            s[i + 1], beta, u, s[i], s[i + 1]);
}

__device__ __forceinline__ void quad_update(float* s, const float* Js, const float* hp,
                                            int n, int i, float beta, float u) {
  float f[4], c[4][4], sv[4], o[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    f[a] = field(Js, hp, s, n, i + a);
    sv[a] = s[i + a];
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = a + 1; b < 4; ++b) c[a][b] = Js[(i + a) * n + i + b];
  quad_rule(f, c, sv, beta, u, o);
#pragma unroll
  for (int a = 0; a < 4; ++a) s[i + a] = o[a];
}

template <int NMAX, int WIDTH>
__global__ void __launch_bounds__(kThreads)
sa_heatbath_kernel(const float* __restrict__ J, const float* __restrict__ h,
                   const float* __restrict__ hot, const float* __restrict__ logr,
                   const float* __restrict__ init01, const float* __restrict__ uniforms,
                   float* __restrict__ out, int G, int B, int R, int n, int S,
                   float inv_span, uint32_t seed_lo, uint32_t seed_hi) {
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
    if (WIDTH == 1) {
      for (int i = 0; i < n; ++i) s[i] = heatbath_rule(field(Js, hp, s, n, i), beta, u(i));
    } else {
      int i = 0;
      if (WIDTH == 4)
        for (; i + 4 <= n; i += 4) quad_update(s, Js, hp, n, i, beta, u(i));
      for (; i + 2 <= n; i += 2) pair_update(s, Js, hp, n, i, beta, u(i));
      if (i < n) single_update(s, Js, hp, n, i, beta, u(i));
    }
  }

  float* op = out + (p * R + r) * n;
  for (int i = 0; i < n; ++i) op[i] = s[i];
}

template <int NMAX, int WIDTH>
cudaError_t launch(const float* J, const float* h, const float* hot, const float* logr,
                   const float* init01, const float* uniforms, float* out, int G, int B,
                   int R, int n, int S, float inv_span, unsigned long long seed,
                   cudaStream_t stream) {
  const size_t smem = (size_t)n * n * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(sa_heatbath_kernel<NMAX, WIDTH>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long chains = (long long)B * R;
  const dim3 grid((unsigned)((chains + kThreads - 1) / kThreads), (unsigned)G);
  sa_heatbath_kernel<NMAX, WIDTH><<<grid, kThreads, smem, stream>>>(
      J, h, hot, logr, init01, uniforms, out, G, B, R, n, S, inv_span,
      (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32));
  return cudaGetLastError();
}

template <int WIDTH>
cudaError_t dispatch(const float* J, const float* h, const float* hot, const float* logr,
                     const float* init01, const float* uniforms, float* out, int G, int B,
                     int R, int n, int S, float inv_span, unsigned long long seed,
                     cudaStream_t st) {
  if (n <= 8)
    return launch<8, WIDTH>(J, h, hot, logr, init01, uniforms, out, G, B, R, n, S, inv_span, seed, st);
  if (n <= 64)
    return launch<64, WIDTH>(J, h, hot, logr, init01, uniforms, out, G, B, R, n, S, inv_span, seed, st);
  return launch<256, WIDTH>(J, h, hot, logr, init01, uniforms, out, G, B, R, n, S, inv_span, seed, st);
}

}  // namespace

// Largest n the kernel takes: J_g must fit one block's shared memory.
extern "C" int qbmx_sa_heatbath_max_n() { return kMaxN; }

// Returns the cudaError_t of the launch (0 = success).  init01/uniforms are
// both null (Philox mode) or both set (host-variate mode); width is 1, 2 or 4.
extern "C" int qbmx_sa_heatbath(const float* J, const float* h, const float* hot,
                                const float* logr, const float* init01,
                                const float* uniforms, float* out, int G, int B, int R,
                                int n, int S, float inv_span, unsigned long long seed,
                                int width, void* stream) {
  if (G <= 0 || B <= 0 || R <= 0 || n <= 0 || n > kMaxN || S <= 0 || G > 65535 ||
      (init01 == nullptr) != (uniforms == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 1:
      return (int)dispatch<1>(J, h, hot, logr, init01, uniforms, out, G, B, R, n, S, inv_span, seed, st);
    case 2:
      return (int)dispatch<2>(J, h, hot, logr, init01, uniforms, out, G, B, R, n, S, inv_span, seed, st);
    case 4:
      return (int)dispatch<4>(J, h, hot, logr, init01, uniforms, out, G, B, R, n, S, inv_span, seed, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
