// K2's kernels and their dispatch, included by its three sources (one an
// update width: sa_heatbath.cu, sa_heatbath_pair.cu, sa_heatbath_quad.cu).
//
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
// FMAs; a state array indexed at run time lives in local memory.  Three
// layouts, chosen on the host by the rule K1 uses, from measured boundaries
// (samplers/kernel_call.py::chain_layout):
//   * THREAD (n <= kThreadMaxN, many chains: the flagship's 120,000, the
//     search's 400,000 at n = 9): one thread a chain, r fastest, so a warp
//     reads the same J_g[i][j] (a broadcast).  n and the width are template
//     parameters and every loop is unrolled, so the state, h and the fields
//     live in registers.  A field is the serial dot product
//     acc = sum_{j=0..n-1} J_ij s_j, then h_i + acc.
//   * GROUP(L) and LANES (L = 32): a chain spread over L lanes of a warp
//     (L in {4, 8, 16, 32}; 32/L chains a warp; quad only at L >= 16), so
//     that a decision's latency, not a dot product, sets an update's cost,
//     and a launch of few chains occupies many SMs; a smaller L wastes
//     fewer lanes on a narrow chain.  Lane l of a chain owns variables
//     i = L*k + l (slot k < K): their fields, h and uniforms stay in its
//     registers; the chain's state is a word a slot (its L bits), the same
//     in every lane of the chain.  Per sweep every lane first draws its
//     variables' uniforms (Philox, and for WIDTH 1 the threshold's logf and
//     division: off the chain of decisions).  An update of variables
//     i..i+M-1 (M = 1, 2, 4; a pair or quad never straddles two slots)
//     shuffles their fields and the first one's uniform from their owner
//     lanes to the chain's lanes (shuffles of width L); every lane takes
//     the same decision from the same values (pair_rule; quad_rule_warp,
//     which spreads the 16 joint states over 16 lanes and returns
//     quad_rule's verdict bit for bit; couplings among them are
//     shared-memory broadcasts) and adds d_a * J_{i+a, j} to the fields it
//     owns (incremental fields: one FMA a changed variable and owned field).
// Fields of GROUP and LANES: recomputed from the state at sweep 0 and
// every kRefreshPeriod sweeps (each field summed serially j = 0..n-1, then
// h_i + acc, the THREAD order), and between refreshes updated by
// f_j = fmaf(d, J_ij, f_j) -- f_j +/- J_ij rounded once -- in the order of
// the decisions (a pair or quad: its rows in increasing order).  So a field
// rounds at most kRefreshPeriod*n times more than a recomputed one;
// chip_smoke.py holds the final fields of the CDQBM default call to
// samplers/wide_cuda.py::field_drift_bound.  Every L performs the same
// float operations on every field in the same order: GROUP(L) gives
// LANES's samples and fields bit for bit under the same draws.
//
// Random numbers: the streams of sa_metropolis.cu (philox.cuh), keyed by
// (seed, problem id) with the counter over (read, variable/4, sweep), so
// qbmx_torch/samplers/sa_torch.py::philox_variates writes out this kernel's
// draws too.  A pair or quad reads the uniform of its first variable.
// Optional outputs, null on the main path: flips, the number of variables
// changed (for the bound of PERF.md); fields_out (G,B,R,n), the final
// fields of GROUP and LANES (for chip_smoke.py's drift check).
//
// Build without --use_fast_math: the thresholds need IEEE logf/expf and
// division to agree with the plain version, and expf must overflow to inf
// where torch.exp does.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "anneal_rules.cuh"
#include "chain_layouts.cuh"

namespace qbmx::heatbath {

// A launch's arguments, as qbmx_sa_heatbath (sa_heatbath.cu) received them.
struct Args {
  const float *J, *h, *hot, *logr, *init01, *uniforms;
  float *out, *fields_out;
  unsigned long long* flips;
  int G, B, R, n, S;
  float inv_span;
  uint32_t seed_lo, seed_hi;
};

// K2 at one update width, each in its own source so that nvcc builds the
// three at once: width 1 in sa_heatbath.cu, 2 in sa_heatbath_pair.cu, 4 in
// sa_heatbath_quad.cu.
cudaError_t launch_width1(const Args& a, int lanes, cudaStream_t st);
cudaError_t launch_width2(const Args& a, int lanes, cudaStream_t st);
cudaError_t launch_width4(const Args& a, int lanes, cudaStream_t st);

}  // namespace qbmx::heatbath

namespace {

using qbmx::heatbath_rule;
using qbmx::heatbath_threshold;
using qbmx::chain_bits;
using qbmx::init_bit;
using qbmx::kInitTag;
using qbmx::pair_rule;
using qbmx::philox4x32_10;
using qbmx::stage_J;
using qbmx::thread_dot;
using qbmx::thread_stride;
using qbmx::thread_sweep_fence;
using qbmx::quad_rule;
using qbmx::quad_rule_warp;
using qbmx::single_rule;
using qbmx::SweepUniforms;
using qbmx::word;

constexpr int kThreads = 128;
// Largest n whose J_g (4·n² bytes) fits one block's 232,448 bytes of shared
// memory; the wrappers send wider problems to anneal_wide.cu (K4).
constexpr int kMaxN = 241;
// Widest THREAD layout: one template instance a width 1..kThreadMaxN
// (samplers/kernel_call.py::THREAD_MAX_N); a build for measurements may
// widen it (-DQBMX_THREAD_MAX_N=48, cli/compare_kernels.py --parts layouts).
#ifndef QBMX_THREAD_MAX_N
#define QBMX_THREAD_MAX_N 32
#endif
constexpr int kThreadMaxN = QBMX_THREAD_MAX_N;
// GROUP and LANES: a refresh costs a lane K·n FMAs, about one sweep's worth of
// its incremental updates, so refreshing every 16th sweep adds at most ~6%
// while a field's extra rounding stays under 16·n adds of +/- J_ij (K1's
// period; samplers/gibbs_cuda.py::REFRESH_PERIOD).
constexpr int kRefreshPeriod = 16;
constexpr unsigned kFull = 0xFFFFFFFFu;

// THREAD layout: the field of variable i on the state s, the serial dot
// product then h_i (i is a constant once the caller's loops are unrolled).
template <int N>
__device__ __forceinline__ float thread_field(const float* Js, const float (&hv)[N],
                                              const float (&s)[N], int i) {
  return hv[i] + thread_dot<N>(Js, s, i);
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
  extern __shared__ float Js[];  // J_g, N rows thread_stride(N) floats apart
  const int g = blockIdx.y;
  stage_J(Js, J, g, N, thread_stride(N));

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
  constexpr int NS = thread_stride(N);  // J_g's row stride
  for (int t = 0; t < S; ++t) {
    thread_sweep_fence<N>();
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
          for (int bb = a + 1; bb < 4; ++bb) c[a][bb] = Js[(i + a) * NS + i + bb];
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
                  Js[i * NS + i + 1], s[i], s[i + 1], beta, u(i), o1, o2);
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

// GROUP and LANES: variables i..i+M-1 of slot k (i = L*k + l, owned by
// lanes l..l+M-1 of the chain): the decision, taken alike in every lane of
// the chain from the owners' fields and the first one's v (threshold or
// uniform), and its changes applied to the state words w and to every
// field the lane owns.  k is a constant once the caller's slot loop is
// unrolled, so f, v and w stay in registers.
template <int M, int WIDTH, int K, int L>
__device__ __forceinline__ void unit(float (&f)[K], const float (&v)[K], uint32_t (&w)[K],
                                     const float* Js, int n, int k, int l, int lane, float beta,
                                     unsigned long long& nflip) {
  static_assert(M < 4 || L >= 16, "quad_rule_warp needs 16 lanes a chain");
  const int i = L * k + l;
  float fa[M], sa[M], o[M];
#pragma unroll
  for (int a = 0; a < M; ++a) {
    fa[a] = __shfl_sync(kFull, f[k], l + a, L);
    sa[a] = (float)((w[k] >> (l + a)) & 1u);
  }
  const float va = __shfl_sync(kFull, v[k], l, L);
  if constexpr (M == 4) {
    float c[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = a + 1; b < 4; ++b) c[a][b] = Js[(i + a) * n + i + b];
    quad_rule_warp(fa, c, sa, beta, va, o);  // a joint state a lane
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
      const int j = L * k2 + lane;
      if (j < n) f[k2] = fmaf(d, Ji[j], f[k2]);
    }
  }
}

// GROUP(L) and LANES (L = 32): a chain on L consecutive lanes, K slots a
// lane (L*K >= n), 128/L chains a block.
template <int K, int WIDTH, int L>
__global__ void __launch_bounds__(kThreads)
sa_heatbath_lanes_kernel(const float* __restrict__ J, const float* __restrict__ h,
                         const float* __restrict__ hot, const float* __restrict__ logr,
                         const float* __restrict__ init01, const float* __restrict__ uniforms,
                         float* __restrict__ out, float* __restrict__ fields_out,
                         unsigned long long* __restrict__ flips, int G, int B, int R, int n,
                         int S, float inv_span, uint32_t seed_lo, uint32_t seed_hi) {
  static_assert(K <= 8 && L >= 4 && L <= 32 && (L & (L - 1)) == 0, "slots, lanes");
  constexpr int kChains = kThreads / L;  // chains a block
  extern __shared__ float Js[];  // J_g, n*n row-major
  const int g = blockIdx.y;
  stage_J(Js, J, g, n, n);

  const int c = threadIdx.x / L, lane = threadIdx.x % L;  // lane: within the chain
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

  // f, hv: the field and h of variable L*k + lane; v: its threshold (WIDTH
  // 1) or uniform (WIDTH 2, 4) this sweep; w[k] bit l: the state of
  // variable L*k + l, the same in every lane of the chain
  float f[K], hv[K], v[K];
  uint32_t w[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = L * k + lane;
    hv[k] = i < n ? h[p * n + i] : 0.0f;
    f[k] = 0.0f;
    w[k] = chain_bits<L>(
        __ballot_sync(kFull, i < n && init_bit(init01, p, R, r, n, i, key, seed_hi)));
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
#pragma unroll 1  // unrolled L times, the kernels take ~2x as long to build
        for (int l = 0; l < L; ++l) {
          const int j = L * kj + l;
          if (j >= n) break;
          const bool on = (w[kj] >> l) & 1u;
#pragma unroll
          for (int k = 0; k < K; ++k) {  // row j of the symmetric J_g: lanes read adjacent words
            const int i = L * k + lane;
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
      const int i = L * k + lane;
      const float uu = i < n ? u(i) : 0.5f;
      v[k] = WIDTH == 1 ? heatbath_threshold(uu, beta) : uu;
    }

    // the sweep's units in order: a pair or quad never straddles two slots
    // (L is a multiple of 4), so slot k's are quads, then pairs, then a
    // single -- the last two only in the slot that holds the remainder
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int lo = L * k;
      if (lo >= n) break;
      const int top = min(n - lo, L);  // variables of slot k
      int l = 0;
      if constexpr (WIDTH == 4)
        for (; l + 4 <= top; l += 4) unit<4, WIDTH, K, L>(f, v, w, Js, n, k, l, lane, beta, nflip);
      if constexpr (WIDTH >= 2)
        for (; l + 2 <= top; l += 2) unit<2, WIDTH, K, L>(f, v, w, Js, n, k, l, lane, beta, nflip);
      for (; l < top; ++l) unit<1, WIDTH, K, L>(f, v, w, Js, n, k, l, lane, beta, nflip);
    }
  }

  if (active) {
    const size_t row = (p * R + r) * n;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = L * k + lane;
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

using qbmx::heatbath::Args;

template <int N, int WIDTH>
cudaError_t launch_thread(const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)N * thread_stride(N) * sizeof(float);
  const cudaError_t e = set_smem(sa_heatbath_thread_kernel<N, WIDTH>, smem);
  if (e != cudaSuccess) return e;
  const long long chains = (long long)a.B * a.R;
  const dim3 grid((unsigned)((chains + kThreads - 1) / kThreads), (unsigned)a.G);
  sa_heatbath_thread_kernel<N, WIDTH><<<grid, kThreads, smem, stream>>>(
      a.J, a.h, a.hot, a.logr, a.init01, a.uniforms, a.out, a.flips, a.G, a.B, a.R, a.S,
      a.inv_span, a.seed_lo, a.seed_hi);
  return cudaGetLastError();
}

template <int K, int WIDTH, int L>
cudaError_t launch_lanes(const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)a.n * a.n * sizeof(float);
  const cudaError_t e = set_smem(sa_heatbath_lanes_kernel<K, WIDTH, L>, smem);
  if (e != cudaSuccess) return e;
  constexpr int kChains = kThreads / L;
  const long long chains = (long long)a.B * a.R;
  const dim3 grid((unsigned)((chains + kChains - 1) / kChains), (unsigned)a.G);
  sa_heatbath_lanes_kernel<K, WIDTH, L><<<grid, kThreads, smem, stream>>>(
      a.J, a.h, a.hot, a.logr, a.init01, a.uniforms, a.out, a.fields_out, a.flips, a.G, a.B,
      a.R, a.n, a.S, a.inv_span, a.seed_lo, a.seed_hi);
  return cudaGetLastError();
}

// The slot bound K of GROUP(L) and LANES: ceil(n/L) rounded up to a power
// of 2, at most 8 (at L = 32 that covers kMaxN; at 16 slots the fields,
// thresholds and h outgrow the registers); wider n at that L is refused
// (samplers/kernel_call.py::max_n), and so is quad below 16 lanes.
template <int WIDTH, int L>
cudaError_t dispatch_lanes(const Args& a, cudaStream_t st) {
  if constexpr (WIDTH == 4 && L < 16) {
    return cudaErrorInvalidValue;
  } else {
    const int k = (a.n + L - 1) / L;
    if (k <= 1) return launch_lanes<1, WIDTH, L>(a, st);
    if (k <= 2) return launch_lanes<2, WIDTH, L>(a, st);
    if (k <= 4) return launch_lanes<4, WIDTH, L>(a, st);
    if (k <= 8) return launch_lanes<8, WIDTH, L>(a, st);
    return cudaErrorInvalidValue;
  }
}

// THREAD: the instance of width n, for n <= N.
template <int N, int WIDTH>
cudaError_t dispatch_thread(const Args& a, cudaStream_t st) {
  if (a.n == N) return launch_thread<N, WIDTH>(a, st);
  if constexpr (N > 1) return dispatch_thread<N - 1, WIDTH>(a, st);
  return cudaErrorInvalidValue;
}

template <int WIDTH>
cudaError_t dispatch(const Args& a, int lanes, cudaStream_t st) {
  switch (lanes) {
    case 1:  // the THREAD layout keeps no fields
      return a.n <= kThreadMaxN && a.fields_out == nullptr
                 ? dispatch_thread<kThreadMaxN, WIDTH>(a, st)
                 : cudaErrorInvalidValue;
    case 4: return dispatch_lanes<WIDTH, 4>(a, st);
    case 8: return dispatch_lanes<WIDTH, 8>(a, st);
    case 16: return dispatch_lanes<WIDTH, 16>(a, st);
    case 32: return dispatch_lanes<WIDTH, 32>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

