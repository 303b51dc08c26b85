// Annealed single-flip Metropolis over the structured shared-coupling form,
// for NVIDIA Hopper (sm_90a) (K1).
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
// What bounds it on this card: each chain is a strictly sequential chain of
// n*S decisions.  J_g sits whole in one block's shared memory (n <= 241).
// Three layouts, chosen on the host (samplers/kernel_call.py::chain_layout,
// the rule K2 shares, from measured boundaries):
//   * THREAD (n <= kThreadMaxN, many chains: the flagship's 120,000, the
//     search's 400,000 at n = 9): one thread per chain, r fastest, so a
//     warp reads the same J_g[i][j] (a broadcast).  The width is a template
//     parameter and every loop is unrolled, so the state, h and the fields
//     live in registers.  A field is the serial dot product
//     acc = sum_{j=0..n-1} J_ij s_j, then h_i + acc: n FMAs a decision, the
//     fewest instructions a chain of any layout, so it wins wherever the
//     chains fill the card's issue slots; it rounds as the earlier
//     one-layout kernel did.
//   * GROUP(L) and LANES (L = 32): a chain spread over L lanes of a warp
//     (L in {4, 8, 16, 32}; 32/L chains a warp), so that a decision's
//     latency, not a dot product, sets a variable's cost, and a launch of
//     few chains occupies many SMs; a smaller L wastes fewer lanes on a
//     narrow chain (n = 41 keeps 8 lanes busy at 6 slots, 32 lanes at 2).
//     Lane l of a chain owns variables i = L*k + l (slot k < K, K a
//     template bound): their fields, thresholds and state bits stay in its
//     registers.  Per sweep every lane first computes its variables'
//     thresholds (Philox, logf, division: off the chain of decisions).
//     Variable i's owner then compares, shuffles the change d in
//     {-1, 0, +1} to the chain's lanes (a shuffle of width L), and every
//     lane adds d * J_ij to the fields it owns (incremental fields: one FMA
//     per owned field, no branch, no dot product).
// Fields of GROUP and LANES: recomputed from the state at sweep 0 and
// every kRefreshPeriod sweeps (the full state gathered by ballots, the
// chain's L bits cut from the warp's word; each field summed serially
// j = 0..n-1, then h_i + acc, the THREAD order), and between refreshes
// updated by f_j = fmaf(d, J_ij, f_j), which is f_j +/- J_ij rounded once,
// in the order of the decisions.  So a field rounds at most
// kRefreshPeriod*n times more than a recomputed one, and every L performs
// the same float operations on every field in the same order: GROUP(L)
// gives LANES's samples and fields bit for bit under the same draws.
// Random numbers: with null variate pointers every chain draws from a
// Philox4x32-10 stream (philox.cuh) keyed by (seed, problem id) with the
// counter over (read, variable/4, sweep), so a problem's samples do not
// depend on its batch-mates.  Uniforms are (bits >> 8) * 2^-24; the initial
// state takes the low bit.  With non-null pointers the initial state init01 (G,B,R,n)
// and the uniforms (S,G,B,n,R) come from the host.  A non-null `flips`
// receives the number of flips the launch made (for the bound of PERF.md),
// a non-null `fields_out` (G,B,R,n; GROUP and LANES only) the final fields.
//
// Build without --use_fast_math: the thresholds need IEEE logf/expf and
// division to agree with the plain version.

#include <cstdint>
#include <cuda_runtime.h>

#include "anneal_rules.cuh"
#include "chain_layouts.cuh"

namespace {

using qbmx::chain_bits;
using qbmx::init_bit;
using qbmx::kInitTag;
using qbmx::metropolis_accept;
using qbmx::metropolis_rule;
using qbmx::metropolis_threshold;
using qbmx::philox4x32_10;
using qbmx::stage_J;
using qbmx::thread_dot;
using qbmx::thread_stride;
using qbmx::thread_sweep_fence;
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
// GROUP and LANES: a refresh costs a lane K·n FMAs, about one sweep's worth
// of its incremental updates, so refreshing every 16th sweep adds at most
// ~6% while a field's extra rounding stays under 16·n adds of +/- J_ij.
constexpr int kRefreshPeriod = 16;
constexpr unsigned kFull = 0xFFFFFFFFu;

// THREAD layout: one chain per thread, width N = n.
template <int N>
__global__ void __launch_bounds__(kThreads)
sa_metropolis_thread_kernel(const float* __restrict__ J, const float* __restrict__ h,
                 const float* __restrict__ hot, const float* __restrict__ logr,
                 const float* __restrict__ init01, const float* __restrict__ uniforms,
                 float* __restrict__ out, unsigned long long* __restrict__ flips, int G,
                 int B, int R, int S, float inv_span, uint32_t seed_lo, uint32_t seed_hi) {
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
  for (int t = 0; t < S; ++t) {
    thread_sweep_fence<N>();
    const float beta = hot_p * expf(logr_p * ((float)t * inv_span));
    SweepUniforms u{host ? uniforms + (size_t)t * u_sweep + p * N * R + r : nullptr, R, key,
                    (uint32_t)r, (uint32_t)t, seed_hi};
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float o = metropolis_rule(hv[i] + thread_dot<N>(Js, s, i), s[i], beta, u(i));
      nflip += o != s[i];
      s[i] = o;
    }
  }

  float* op = out + (p * R + r) * N;
#pragma unroll
  for (int i = 0; i < N; ++i) op[i] = s[i];
  if (flips != nullptr) atomicAdd(flips, nflip);
}

// GROUP and LANES: variable i = L*k + l of the chain.  Every lane weighs
// its own slot-k variable, the owner's verdict counts, and every lane adds
// d * J_ij to the fields it owns.  k is a constant once the caller's slot
// loop is unrolled, so f, thr and the state bits stay in registers.
template <int K, int L>
__device__ __forceinline__ void decide(float (&f)[K], const float (&thr)[K], uint32_t& mine,
                                       unsigned long long& nflip, const float* Js, int n, int k,
                                       int l, int lane) {
  const float s = (float)((mine >> k) & 1u);
  const float d_own = metropolis_accept(f[k], s, thr[k]) ? 1.0f - 2.0f * s : 0.0f;
  const float d = __shfl_sync(kFull, d_own, l, L);
  if (lane == l && d != 0.0f) {
    mine ^= 1u << k;
    ++nflip;
  }
  const float* Ji = Js + (L * k + l) * n;
#pragma unroll
  for (int k2 = 0; k2 < K; ++k2) {
    const int j = L * k2 + lane;
    if (j < n) f[k2] = fmaf(d, Ji[j], f[k2]);
  }
}

// GROUP(L) and LANES (L = 32): a chain on L consecutive lanes, K slots a
// lane (L*K >= n), 128/L chains a block.
template <int K, int L>
__global__ void __launch_bounds__(kThreads)
sa_metropolis_lanes_kernel(const float* __restrict__ J, const float* __restrict__ h,
                const float* __restrict__ hot, const float* __restrict__ logr,
                const float* __restrict__ init01, const float* __restrict__ uniforms,
                float* __restrict__ out, float* __restrict__ fields_out,
                unsigned long long* __restrict__ flips, int G, int B, int R, int n, int S,
                float inv_span, uint32_t seed_lo, uint32_t seed_hi) {
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

  float f[K], thr[K], hv[K];
  uint32_t mine = 0;  // bit k: the state of variable L*k + lane
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = L * k + lane;
    hv[k] = 0.0f;
    f[k] = 0.0f;
    if (i < n) {
      hv[k] = h[p * n + i];
      if (init_bit(init01, p, R, r, n, i, key, seed_hi)) mine |= 1u << k;
    }
  }

  const float hot_p = hot[p], logr_p = logr[p];
  const size_t u_sweep = (size_t)G * B * n * R;  // uniforms per sweep
  unsigned long long nflip = 0;
  for (int t = 0; t < S; ++t) {
    if (t % kRefreshPeriod == 0) {
      uint32_t words[K];  // bit l of words[k]: the state of variable L*k + l
#pragma unroll
      for (int k = 0; k < K; ++k) words[k] = chain_bits<L>(__ballot_sync(kFull, (mine >> k) & 1u));
      float acc[K];
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = 0.0f;
#pragma unroll
      for (int kj = 0; kj < K; ++kj) {
#pragma unroll 1  // as GROUP's decision loop (a refresh is a 16th of the sweeps)
        for (int l = 0; l < L; ++l) {
          const int j = L * kj + l;
          if (j >= n) break;
          const bool on = (words[kj] >> l) & 1u;
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
      thr[k] = i < n ? metropolis_threshold(u(i), beta) : 0.0f;
    }

#pragma unroll
    for (int k = 0; k < K; ++k) {
      if constexpr (L == 32) {  // a warp a chain: nvcc's own unrolling, the fastest at few chains
        for (int l = 0; l < L; ++l) {
          if (L * k + l >= n) break;
          decide<K, L>(f, thr, mine, nflip, Js, n, k, l, lane);
        }
      } else {
        // GROUP: unrolled, K x L copies of the K field updates outgrow the
        // instruction cache (8 lanes a chain then ran slower than a warp at n = 41)
#pragma unroll 1
        for (int l = 0; l < L; ++l) {
          if (L * k + l >= n) break;
          decide<K, L>(f, thr, mine, nflip, Js, n, k, l, lane);
        }
      }
    }
  }

  if (active) {
    const size_t row = (p * R + r) * n;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = L * k + lane;
      if (i < n) {
        out[row + i] = (float)((mine >> k) & 1u);
        if (fields_out != nullptr) fields_out[row + i] = f[k];
      }
    }
    if (flips != nullptr && nflip != 0) atomicAdd(flips, nflip);
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

template <int N>
cudaError_t launch_thread(const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)N * thread_stride(N) * sizeof(float);
  const cudaError_t e = set_smem(sa_metropolis_thread_kernel<N>, smem);
  if (e != cudaSuccess) return e;
  const long long chains = (long long)a.B * a.R;
  const dim3 grid((unsigned)((chains + kThreads - 1) / kThreads), (unsigned)a.G);
  sa_metropolis_thread_kernel<N><<<grid, kThreads, smem, stream>>>(
      a.J, a.h, a.hot, a.logr, a.init01, a.uniforms, a.out, a.flips, a.G, a.B, a.R, a.S,
      a.inv_span, a.seed_lo, a.seed_hi);
  return cudaGetLastError();
}

template <int K, int L>
cudaError_t launch_lanes(const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)a.n * a.n * sizeof(float);
  const cudaError_t e = set_smem(sa_metropolis_lanes_kernel<K, L>, smem);
  if (e != cudaSuccess) return e;
  constexpr int kChains = kThreads / L;
  const long long chains = (long long)a.B * a.R;
  const dim3 grid((unsigned)((chains + kChains - 1) / kChains), (unsigned)a.G);
  sa_metropolis_lanes_kernel<K, L><<<grid, kThreads, smem, stream>>>(
      a.J, a.h, a.hot, a.logr, a.init01, a.uniforms, a.out, a.fields_out, a.flips, a.G, a.B,
      a.R, a.n, a.S, a.inv_span, a.seed_lo, a.seed_hi);
  return cudaGetLastError();
}

// The slot bound K of GROUP(L) and LANES: ceil(n/L) rounded up to a power
// of 2, at most 8 (at L = 32 that covers kMaxN; at 16 slots the fields,
// thresholds and h outgrow the registers); wider n at that L is refused
// (samplers/kernel_call.py::max_n).
template <int L>
cudaError_t dispatch_lanes(const Args& a, cudaStream_t st) {
  const int k = (a.n + L - 1) / L;
  if (k <= 1) return launch_lanes<1, L>(a, st);
  if (k <= 2) return launch_lanes<2, L>(a, st);
  if (k <= 4) return launch_lanes<4, L>(a, st);
  if (k <= 8) return launch_lanes<8, L>(a, st);
  return cudaErrorInvalidValue;
}

// THREAD: the instance of width n, for n <= N.
template <int N>
cudaError_t dispatch_thread(const Args& a, cudaStream_t st) {
  if (a.n == N) return launch_thread<N>(a, st);
  if constexpr (N > 1) return dispatch_thread<N - 1>(a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Largest n the kernel takes: J_g must fit one block's shared memory.
extern "C" int qbmx_sa_metropolis_max_n() { return kMaxN; }

// Widest n of the THREAD layout in this build.
extern "C" int qbmx_sa_metropolis_thread_max_n() { return kThreadMaxN; }

// Returns the cudaError_t of the launch (0 = success).  init01/uniforms are
// both null (Philox mode) or both set (host-variate mode); lanes is 1 for
// the THREAD layout (n <= kThreadMaxN), 4, 8 or 16 for GROUP, 32 for LANES;
// fields_out (GROUP and LANES only) and flips may be null.
extern "C" int qbmx_sa_metropolis(const float* J, const float* h, const float* hot,
                                  const float* logr, const float* init01,
                                  const float* uniforms, float* out, float* fields_out,
                                  unsigned long long* flips, int G, int B, int R, int n,
                                  int S, float inv_span, unsigned long long seed, int lanes,
                                  void* stream) {
  if (G <= 0 || B <= 0 || R <= 0 || n <= 0 || n > kMaxN || S <= 0 || G > 65535 ||
      (init01 == nullptr) != (uniforms == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{J, h, hot, logr, init01, uniforms, out, fields_out, flips, G, B, R, n, S,
               inv_span, (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1:  // the THREAD layout keeps no fields
      return (int)(n <= kThreadMaxN && fields_out == nullptr ? dispatch_thread<kThreadMaxN>(a, st)
                                                             : cudaErrorInvalidValue);
    case 4: return (int)dispatch_lanes<4>(a, st);
    case 8: return (int)dispatch_lanes<8>(a, st);
    case 16: return (int)dispatch_lanes<16>(a, st);
    case 32: return (int)dispatch_lanes<32>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
