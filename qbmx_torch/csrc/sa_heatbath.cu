// Annealed heat-bath ("BMS") sampling over the structured shared-coupling
// form, for NVIDIA Hopper (sm_90a), with single, pair and quad updates (K2).
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
// Every decision goes through anneal_rules.cuh.
//
// What bounds it on this card: each chain is a strictly sequential chain of
// n, n/2 or n/4 updates a sweep; J_g sits whole in one block's shared
// memory (n <= 241).  The CDQBM default call has only 600 chains, 6 SMs'
// worth at a thread a chain; a field recomputed for each decision costs n
// FMAs; a state array indexed at run time lives in local memory.  Two
// layouts, chosen on the host by the rule K1 uses
// (samplers/kernel_call.py::chain_layout):
//   * THREAD (n <= 8, many chains: the flagship's 120,000): one thread a
//     chain, r fastest, so a warp reads the same J_g[i][j] (a broadcast).
//     n and the width are template parameters and every loop is unrolled,
//     so the state, h and the fields live in registers.  A field is the
//     serial dot product acc = sum_{j=0..n-1} J_ij s_j, then h_i + acc.
//   * LANES (otherwise: few chains, or n > 8): a chain spread over a warp,
//     so that a decision's latency, not a dot product, sets an update's
//     cost, and a launch of few chains occupies many SMs.  Lane l owns
//     variables i = 32*k + l (slot k < K): their fields, h and uniforms
//     stay in its registers; the chain's state is a word a slot, the same
//     in every lane.  Per sweep every lane first draws its variables'
//     uniforms (Philox, and for WIDTH 1 the threshold's logf and division:
//     off the chain of decisions).  An update of variables i..i+M-1
//     (M = 1, 2, 4; a pair or quad never straddles two slots) shuffles
//     their fields and the first one's uniform from their owner lanes to
//     every lane; every lane takes the same decision from the same values
//     (pair_rule; quad_rule_warp, which spreads the 16 joint states over
//     the lanes and returns quad_rule's verdict bit for bit; couplings
//     among them are shared-memory broadcasts) and adds d_a * J_{i+a, j}
//     to the fields it owns (incremental fields: one FMA a changed variable
//     and owned field).
// Fields of the LANES layout: recomputed from the state at sweep 0 and
// every kRefreshPeriod sweeps (each field summed serially j = 0..n-1, then
// h_i + acc, the THREAD order), and between refreshes updated by
// f_j = fmaf(d, J_ij, f_j) -- f_j +/- J_ij rounded once -- in the order of
// the decisions (a pair or quad: its rows in increasing order).  So a field
// rounds at most kRefreshPeriod*n times more than a recomputed one;
// chip_smoke.py holds the final fields of the CDQBM default call to
// samplers/wide_cuda.py::field_drift_bound.
//
// Random numbers: the streams of sa_metropolis.cu (philox.cuh), keyed by
// (seed, problem id) with the counter over (read, variable/4, sweep), so
// qbmx_torch/samplers/sa_torch.py::philox_variates writes out this kernel's
// draws too.  A pair or quad reads the uniform of its first variable.
// Optional outputs, null on the main path: flips, the number of variables
// changed (for the bound of PERF.md); fields_out (G,B,R,n), the LANES
// layout's final fields (for chip_smoke.py's drift check).
//
// Build without --use_fast_math: the thresholds need IEEE logf/expf and
// division to agree with the plain version, and expf must overflow to inf
// where torch.exp does.

#include <cstdint>
#include <cuda_runtime.h>

#include "anneal_rules.cuh"

namespace {

using qbmx::heatbath_rule;
using qbmx::heatbath_threshold;
using qbmx::kInitTag;
using qbmx::pair_rule;
using qbmx::philox4x32_10;
using qbmx::quad_rule;
using qbmx::quad_rule_warp;
using qbmx::single_rule;
using qbmx::SweepUniforms;
using qbmx::word;

constexpr int kThreads = 128;
// Largest n whose J_g (4·n² bytes) fits one block's 232,448 bytes of shared
// memory; the wrappers send wider problems to anneal_wide.cu (K4).
constexpr int kMaxN = 241;
constexpr int kThreadMaxN = 8;  // widest THREAD layout (fully unrolled)
constexpr int kChains = kThreads / 32;  // chains a block of the LANES layout
// LANES layout: a refresh costs a lane K·n FMAs, about one sweep's worth of
// its incremental updates, so refreshing every 16th sweep adds at most ~6%
// while a field's extra rounding stays under 16·n adds of +/- J_ij (K1's
// period; samplers/gibbs_cuda.py::REFRESH_PERIOD).
constexpr int kRefreshPeriod = 16;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ void stage_J(float* Js, const float* J, int g, int n) {
  const int nn = n * n;
  for (int k = threadIdx.x; k < nn; k += blockDim.x) Js[k] = J[(size_t)g * nn + k];
  __syncthreads();
}

__device__ __forceinline__ bool init_bit(const float* init01, size_t p, int R, int r, int n,
                                         int i, uint2 key, uint32_t seed_hi) {
  if (init01 != nullptr) return init01[(p * R + r) * n + i] != 0.0f;
  const uint4 bits =
      philox4x32_10(make_uint4((uint32_t)r, (uint32_t)(i >> 2), kInitTag, seed_hi), key);
  return (word(bits, i & 3) & 1u) != 0u;
}

// THREAD layout: the field of variable i on the state s, the serial dot
// product then h_i (i is a constant once the caller's loops are unrolled).
template <int N>
__device__ __forceinline__ float thread_field(const float* Js, const float (&hv)[N],
                                              const float (&s)[N], int i) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) acc += Js[i * N + j] * s[j];
  return hv[i] + acc;
}

// THREAD layout: one chain per thread, width N = n.
template <int N, int WIDTH>
__global__ void __launch_bounds__(kThreads)
sa_heatbath_thread_kernel(const float* __restrict__ J, const float* __restrict__ h,
                          const float* __restrict__ hot, const float* __restrict__ logr,
                          const float* __restrict__ init01, const float* __restrict__ uniforms,
                          float* __restrict__ out, unsigned long long* __restrict__ flips, int G,
                          int B, int R, int S, float inv_span, uint32_t seed_lo,
                          uint32_t seed_hi) {
  extern __shared__ float Js[];  // J_g, N*N row-major
  const int g = blockIdx.y;
  stage_J(Js, J, g, N);

  const long long chain = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (chain >= (long long)B * R) return;
  const int b = (int)(chain / R);
  const int r = (int)(chain % R);
  const size_t p = (size_t)g * B + b;  // problem id
  const uint2 key = make_uint2(seed_lo, (uint32_t)p);
  const bool host = uniforms != nullptr;

  float s[N], hv[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = init_bit(init01, p, R, r, N, i, key, seed_hi) ? 1.0f : 0.0f;
    hv[i] = h[p * N + i];
  }

  const float hot_p = hot[p], logr_p = logr[p];
  const size_t u_sweep = (size_t)G * B * N * R;  // uniforms per sweep
  unsigned long long nflip = 0;
  for (int t = 0; t < S; ++t) {
    const float beta = hot_p * expf(logr_p * ((float)t * inv_span));
    SweepUniforms u{host ? uniforms + (size_t)t * u_sweep + p * N * R + r : nullptr, R, key,
                    (uint32_t)r, (uint32_t)t, seed_hi};
    if constexpr (WIDTH == 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float o = heatbath_rule(thread_field<N>(Js, hv, s, i), beta, u(i));
        nflip += o != s[i];
        s[i] = o;
      }
    } else {
      constexpr int P0 = WIDTH == 4 ? N / 4 * 4 : 0;  // first variable after the quads
#pragma unroll
      for (int i = 0; i < P0; i += 4) {
        float f[4], c[4][4], sv[4], o[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          f[a] = thread_field<N>(Js, hv, s, i + a);
          sv[a] = s[i + a];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = a + 1; bb < 4; ++bb) c[a][bb] = Js[(i + a) * N + i + bb];
        quad_rule(f, c, sv, beta, u(i), o);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          nflip += o[a] != s[i + a];
          s[i + a] = o[a];
        }
      }
#pragma unroll
      for (int i = P0; i + 2 <= N; i += 2) {
        float o1, o2;
        pair_rule(thread_field<N>(Js, hv, s, i), thread_field<N>(Js, hv, s, i + 1),
                  Js[i * N + i + 1], s[i], s[i + 1], beta, u(i), o1, o2);
        nflip += (o1 != s[i]) + (o2 != s[i + 1]);
        s[i] = o1;
        s[i + 1] = o2;
      }
      if constexpr ((N - P0) % 2 == 1) {
        const float o = single_rule(thread_field<N>(Js, hv, s, N - 1), beta, u(N - 1));
        nflip += o != s[N - 1];
        s[N - 1] = o;
      }
    }
  }

  float* op = out + (p * R + r) * N;
#pragma unroll
  for (int i = 0; i < N; ++i) op[i] = s[i];
  if (flips != nullptr && nflip != 0) atomicAdd(flips, nflip);
}

// LANES layout: variables i..i+M-1 of slot k (i = 32*k + l, owned by lanes
// l..l+M-1): the decision, taken alike in every lane of the chain from the
// owners' fields and the first one's v (threshold or uniform), and its
// changes applied to the state words w and to every field the lane owns.
// k is a constant once the caller's slot loop is unrolled, so f, v and w
// stay in registers.
template <int M, int WIDTH, int K>
__device__ __forceinline__ void unit(float (&f)[K], const float (&v)[K], uint32_t (&w)[K],
                                     const float* Js, int n, int k, int l, int lane, float beta,
                                     unsigned long long& nflip) {
  const int i = 32 * k + l;
  float fa[M], sa[M], o[M];
#pragma unroll
  for (int a = 0; a < M; ++a) {
    fa[a] = __shfl_sync(kFull, f[k], l + a);
    sa[a] = (float)((w[k] >> (l + a)) & 1u);
  }
  const float va = __shfl_sync(kFull, v[k], l);
  if constexpr (M == 4) {
    float c[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = a + 1; b < 4; ++b) c[a][b] = Js[(i + a) * n + i + b];
    quad_rule_warp(fa, c, sa, beta, va, lane, o);  // a joint state a lane
  } else if constexpr (M == 2) {
    pair_rule(fa[0], fa[1], Js[i * n + i + 1], sa[0], sa[1], beta, va, o[0], o[1]);
  } else if constexpr (WIDTH == 1) {
    o[0] = fa[0] < va ? 1.0f : 0.0f;  // heatbath_rule on the threshold drawn ahead
  } else {
    o[0] = single_rule(fa[0], beta, va);  // the trailing single of a pair or quad sweep
  }
  uint32_t changed = 0;  // bit a: variable i + a changed
#pragma unroll
  for (int a = 0; a < M; ++a) changed |= (uint32_t)(o[a] != sa[a]) << a;
  w[k] ^= changed << l;
  nflip += __popc(changed);
#pragma unroll
  for (int a = 0; a < M; ++a) {
    const float d = o[a] - sa[a];
    const float* Ji = Js + (i + a) * n;
#pragma unroll
    for (int k2 = 0; k2 < K; ++k2) {
      const int j = 32 * k2 + lane;
      if (j < n) f[k2] = fmaf(d, Ji[j], f[k2]);
    }
  }
}

// LANES layout: a warp a chain, K slots a lane (32*K >= n).
template <int K, int WIDTH>
__global__ void __launch_bounds__(kThreads)
sa_heatbath_lanes_kernel(const float* __restrict__ J, const float* __restrict__ h,
                         const float* __restrict__ hot, const float* __restrict__ logr,
                         const float* __restrict__ init01, const float* __restrict__ uniforms,
                         float* __restrict__ out, float* __restrict__ fields_out,
                         unsigned long long* __restrict__ flips, int G, int B, int R, int n,
                         int S, float inv_span, uint32_t seed_lo, uint32_t seed_hi) {
  extern __shared__ float Js[];  // J_g, n*n row-major
  const int g = blockIdx.y;
  stage_J(Js, J, g, n);

  const int c = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long chains = (long long)B * R;
  const long long chain = (long long)blockIdx.x * kChains + c;
  const bool active = chain < chains;
  // spare chains of the last block repeat the group's last chain, so that
  // every lane of the warp takes part in the shuffles and ballots; they
  // write nothing
  const long long ch = active ? chain : chains - 1;
  const int b = (int)(ch / R);
  const int r = (int)(ch % R);
  const size_t p = (size_t)g * B + b;  // problem id
  const uint2 key = make_uint2(seed_lo, (uint32_t)p);
  const bool host = uniforms != nullptr;

  // f, hv: the field and h of variable 32*k + lane; v: its threshold (WIDTH
  // 1) or uniform (WIDTH 2, 4) this sweep; w[k] bit l: the state of
  // variable 32*k + l, the same in every lane
  float f[K], hv[K], v[K];
  uint32_t w[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = 32 * k + lane;
    hv[k] = i < n ? h[p * n + i] : 0.0f;
    f[k] = 0.0f;
    w[k] = __ballot_sync(kFull, i < n && init_bit(init01, p, R, r, n, i, key, seed_hi));
  }

  unsigned long long nflip = 0;
  const float hot_p = hot[p], logr_p = logr[p];
  const size_t u_sweep = (size_t)G * B * n * R;  // uniforms per sweep
  for (int t = 0; t < S; ++t) {
    if (t % kRefreshPeriod == 0) {
      float acc[K];
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = 0.0f;
#pragma unroll
      for (int kj = 0; kj < K; ++kj) {
#pragma unroll 1  // unrolled 32 times, the kernels take ~2x as long to build
        for (int l = 0; l < 32; ++l) {
          const int j = 32 * kj + l;
          if (j >= n) break;
          const bool on = (w[kj] >> l) & 1u;
#pragma unroll
          for (int k = 0; k < K; ++k) {  // row j of the symmetric J_g: lanes read adjacent words
            const int i = 32 * k + lane;
            if (i < n) acc[k] += on ? Js[j * n + i] : 0.0f;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) f[k] = hv[k] + acc[k];
    }

    const float beta = hot_p * expf(logr_p * ((float)t * inv_span));
    SweepUniforms u{host ? uniforms + (size_t)t * u_sweep + p * n * R + r : nullptr, R, key,
                    (uint32_t)r, (uint32_t)t, seed_hi};
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = 32 * k + lane;
      const float uu = i < n ? u(i) : 0.5f;
      v[k] = WIDTH == 1 ? heatbath_threshold(uu, beta) : uu;
    }

    // the sweep's units in order: a pair or quad never straddles two slots
    // (32 is a multiple of 4), so slot k's are quads, then pairs, then a
    // single -- the last two only in the slot that holds the remainder
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int lo = 32 * k;
      if (lo >= n) break;
      const int top = min(n - lo, 32);  // variables of slot k
      int l = 0;
      if constexpr (WIDTH == 4)
        for (; l + 4 <= top; l += 4) unit<4, WIDTH>(f, v, w, Js, n, k, l, lane, beta, nflip);
      if constexpr (WIDTH >= 2)
        for (; l + 2 <= top; l += 2) unit<2, WIDTH>(f, v, w, Js, n, k, l, lane, beta, nflip);
      for (; l < top; ++l) unit<1, WIDTH>(f, v, w, Js, n, k, l, lane, beta, nflip);
    }
  }

  if (active) {
    const size_t row = (p * R + r) * n;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = 32 * k + lane;
      if (i < n) {
        out[row + i] = (float)((w[k] >> lane) & 1u);
        if (fields_out != nullptr) fields_out[row + i] = f[k];
      }
    }
    if (flips != nullptr && lane == 0 && nflip != 0) atomicAdd(flips, nflip);
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
  const float *J, *h, *hot, *logr, *init01, *uniforms;
  float *out, *fields_out;
  unsigned long long* flips;
  int G, B, R, n, S;
  float inv_span;
  uint32_t seed_lo, seed_hi;
};

template <int N, int WIDTH>
cudaError_t launch_thread(const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)N * N * sizeof(float);
  const cudaError_t e = set_smem(sa_heatbath_thread_kernel<N, WIDTH>, smem);
  if (e != cudaSuccess) return e;
  const long long chains = (long long)a.B * a.R;
  const dim3 grid((unsigned)((chains + kThreads - 1) / kThreads), (unsigned)a.G);
  sa_heatbath_thread_kernel<N, WIDTH><<<grid, kThreads, smem, stream>>>(
      a.J, a.h, a.hot, a.logr, a.init01, a.uniforms, a.out, a.flips, a.G, a.B, a.R, a.S,
      a.inv_span, a.seed_lo, a.seed_hi);
  return cudaGetLastError();
}

template <int K, int WIDTH>
cudaError_t launch_lanes(const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)a.n * a.n * sizeof(float);
  const cudaError_t e = set_smem(sa_heatbath_lanes_kernel<K, WIDTH>, smem);
  if (e != cudaSuccess) return e;
  const long long chains = (long long)a.B * a.R;
  const dim3 grid((unsigned)((chains + kChains - 1) / kChains), (unsigned)a.G);
  sa_heatbath_lanes_kernel<K, WIDTH><<<grid, kThreads, smem, stream>>>(
      a.J, a.h, a.hot, a.logr, a.init01, a.uniforms, a.out, a.fields_out, a.flips, a.G, a.B,
      a.R, a.n, a.S, a.inv_span, a.seed_lo, a.seed_hi);
  return cudaGetLastError();
}

// The slot bound K of the LANES layout: ceil(n/32) rounded up to a power of
// 2 (8 slots cover kMaxN).
template <int WIDTH>
cudaError_t dispatch_lanes(const Args& a, cudaStream_t st) {
  const int k = (a.n + 31) / 32;
  if (k <= 1) return launch_lanes<1, WIDTH>(a, st);
  if (k <= 2) return launch_lanes<2, WIDTH>(a, st);
  if (k <= 4) return launch_lanes<4, WIDTH>(a, st);
  return launch_lanes<8, WIDTH>(a, st);
}

template <int WIDTH>
cudaError_t dispatch_thread(const Args& a, cudaStream_t st) {
  switch (a.n) {
    case 1: return launch_thread<1, WIDTH>(a, st);
    case 2: return launch_thread<2, WIDTH>(a, st);
    case 3: return launch_thread<3, WIDTH>(a, st);
    case 4: return launch_thread<4, WIDTH>(a, st);
    case 5: return launch_thread<5, WIDTH>(a, st);
    case 6: return launch_thread<6, WIDTH>(a, st);
    case 7: return launch_thread<7, WIDTH>(a, st);
    case 8: return launch_thread<8, WIDTH>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int WIDTH>
cudaError_t dispatch(const Args& a, int lanes, cudaStream_t st) {
  switch (lanes) {
    case 1:  // the THREAD layout keeps no fields
      return a.n <= kThreadMaxN && a.fields_out == nullptr ? dispatch_thread<WIDTH>(a, st)
                                                           : cudaErrorInvalidValue;
    case 32: return dispatch_lanes<WIDTH>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Largest n the kernel takes: J_g must fit one block's shared memory.
extern "C" int qbmx_sa_heatbath_max_n() { return kMaxN; }

// Returns the cudaError_t of the launch (0 = success).  init01/uniforms are
// both null (Philox mode) or both set (host-variate mode); width is 1, 2 or
// 4; lanes is 1 for the THREAD layout (n <= 8) or 32 for the LANES layout;
// fields_out (LANES only) and flips may be null.
extern "C" int qbmx_sa_heatbath(const float* J, const float* h, const float* hot,
                                const float* logr, const float* init01,
                                const float* uniforms, float* out, float* fields_out,
                                unsigned long long* flips, int G, int B, int R, int n, int S,
                                float inv_span, unsigned long long seed, int width, int lanes,
                                void* stream) {
  if (G <= 0 || B <= 0 || R <= 0 || n <= 0 || n > kMaxN || S <= 0 || G > 65535 ||
      (init01 == nullptr) != (uniforms == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{J, h, hot, logr, init01, uniforms, out, fields_out, flips, G, B, R, n, S,
               inv_span, (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 1: return (int)dispatch<1>(a, lanes, st);
    case 2: return (int)dispatch<2>(a, lanes, st);
    case 4: return (int)dispatch<4>(a, lanes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
