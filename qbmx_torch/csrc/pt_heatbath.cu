// Parallel tempering (replica exchange) with heat-bath sweeps over a dense
// batch of QUBOs, for NVIDIA Hopper (sm_90a) (K3).
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
// The target rung M-1 is written out.  Each state's energy is tracked
// incrementally (E += ds*field, with the field that decided, as the TPU
// kernel does); the plain version recomputes it, so a near-tie exchange may
// go the other way in a few chains.
//
// Temperatures, not states, are exchanged: a thread (or warp) keeps one
// state for the whole run, with its energy, and the index rho of the rung
// it sits at; a swap of link (m, m+1) exchanges the rho of the two states
// sitting there.  A state at rung rho draws exactly the numbers the plain
// version gives rung rho (Philox counter and host-variate slot b*M + rho,
// beta[rho]), so the trajectories are the plain version's, and no state
// moves.  The target is whichever state sits at rung M-1 at the end.
//
// What bounds it on this card: every rung is a sequential chain of n
// decisions a sweep, each a field (a dot product, or an incremental
// update), a threshold (two logf and a division, about half a decision's
// instructions) and a draw, and the exchanges couple a ladder's rungs once
// a sweep.  A whole ladder in one thread would keep its M*n states and M
// energies in run-time indexed arrays, so in local memory, bounded by what
// a thread can hold, and an exchange would copy n floats.  Two layouts,
// chosen on the host (samplers/pt_cuda.py::pt_layout):
//   * RUNG (n <= 8, M <= 32: the flagship's n = 6, M = 8): a rung a
//     thread.  A ladder's M rungs sit on M adjacent lanes of one warp
//     (floor(32/M) ladders a warp, 4 warps a block of one problem); n is a
//     template parameter and the loops are unrolled, so the state, h and
//     fields live in registers.  An exchange is a few warp instructions:
//     the energies by rung (a shuffle through inv, the lane holding each
//     rung), each link's test on the lane of its lower rung, a ballot of
//     the verdicts, and rho and inv updated from it.
//   * WARP (n > 8 or M > 32, n <= 241): a rung a warp, on K1's LANES scheme
//     (sa_metropolis.cu): lane l owns variables 32*k + l, with their
//     fields in registers, incremental between refreshes every
//     kRefreshPeriod sweeps, and the state a word a slot in every lane.  A
//     ladder is a block, J_b in its shared memory with the energies by rung
//     of the last two sweeps; a warp carries RPW = 1 or 2 rungs in turn
//     (M <= 32, M <= 64).  After its sweep each state writes its energy at
//     its rung's slot; one barrier; then each state reads its partner's
//     (the energy slots alternate between two sweeps, so one barrier a
//     sweep orders every write before the reads and every read before the
//     next write to its slot), and the two states of a link take the same
//     decision from the same values.
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

#include "anneal_rules.cuh"

namespace {

using qbmx::heatbath_threshold;
using qbmx::kInitTag;
using qbmx::philox4x32_10;
using qbmx::SweepUniforms;
using qbmx::uniform_of;
using qbmx::word;

constexpr int kThreads = 128;  // RUNG layout: 4 warps a block
constexpr int kRungWarps = kThreads / 32;
constexpr int kRungMaxN = 8, kRungMaxM = 32;  // the RUNG layout's bounds
constexpr int kMaxRungs = 64;                 // WARP layout: 32 warps of 2 rungs
// Largest n whose J_b (4·n² bytes) fits one block's shared memory.
constexpr int kMaxN = 241;
constexpr size_t kSmemMax = 232448;  // a block's shared memory on Hopper
constexpr uint32_t kSwapTag = 0xFFu;  // variable-block slot of the swap draws
// WARP layout: K1's refresh period (sa_metropolis.cu): a refresh costs a
// lane K·n FMAs, about one sweep of incremental updates.
constexpr int kRefreshPeriod = 16;
constexpr unsigned kFull = 0xFFFFFFFFu;

enum Layout { kRung = 0, kWarp = 1 };

__host__ __device__ inline size_t smem_bytes(int layout, int n, int M) {
  // J_b, then (WARP) the energies by rung of two sweeps
  return 4 * ((size_t)n * n + (layout == kWarp ? 2 * (size_t)M : 0));
}

__device__ __forceinline__ void stage_J(float* Js, const float* J, int b, int n) {
  const int nn = n * n;
  for (int k = threadIdx.x; k < nn; k += blockDim.x) Js[k] = J[(size_t)b * nn + k];
  __syncthreads();
}

// The initial bit of variable i of the state that starts at rung m (slot
// slot0 + m): from the host, or the low bit of its Philox word.
__device__ __forceinline__ bool init_bit(const float* init01, size_t slot, int m, int R, int r,
                                         int n, int i, uint2 key, uint32_t seed_hi) {
  if (init01 != nullptr) return init01[(slot * R + r) * n + i] != 0.0f;
  const uint4 bits = philox4x32_10(
      make_uint4((uint32_t)r, ((uint32_t)m << 8) | (uint32_t)(i >> 2), kInitTag, seed_hi), key);
  return (word(bits, i & 3) & 1u) != 0u;
}

// RUNG layout: sum_j J_ij s_j, serially (i is a constant once the caller's
// loops are unrolled).
template <int N>
__device__ __forceinline__ float rung_dot(const float* Js, const float (&s)[N], int i) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) acc += Js[i * N + j] * s[j];
  return acc;
}

// Rung m's uniform for the swap of link (m, m+1) at sweep t.
__device__ __forceinline__ float swap_uniform(const float* swap_u, size_t BM, size_t slot0,
                                              int m, int R, int r, int t, uint2 key,
                                              uint32_t seed_hi) {
  if (swap_u != nullptr) return swap_u[((size_t)t * BM + slot0 + m) * R + r];
  const uint4 w = philox4x32_10(
      make_uint4((uint32_t)r, ((uint32_t)(m >> 2) << 8) | kSwapTag, (uint32_t)t, seed_hi), key);
  return uniform_of(word(w, m & 3));
}

// RUNG layout: a rung a thread, width N = n.
template <int N>
__global__ void __launch_bounds__(kThreads)
pt_heatbath_rung_kernel(const float* __restrict__ J, const float* __restrict__ h,
                        const float* __restrict__ betas, const float* __restrict__ dbeta,
                        const float* __restrict__ init01, const float* __restrict__ uniforms,
                        const float* __restrict__ swap_u, float* __restrict__ out, int B, int M,
                        int R, int S, uint32_t seed_lo, uint32_t seed_hi) {
  extern __shared__ float Js[];  // J_b, N*N row-major
  const int b = blockIdx.y;
  stage_J(Js, J, b, N);

  const int lane = threadIdx.x % 32;
  const int L = 32 / M;  // ladders a warp
  const int q = lane / M, pos = lane % M;  // the lane's ladder in the warp, and position
  const int base = q * M;                  // lane of the ladder's position 0
  const int r0 = (blockIdx.x * kRungWarps + threadIdx.x / 32) * L + q;
  // lanes past the warp's last ladder, and ladders past R, shadow a valid
  // read so that every lane takes part in the shuffles; they write nothing
  const bool active = q < L && r0 < R;
  const int r = min(r0, R - 1);
  const uint2 key = make_uint2(seed_lo, (uint32_t)b);
  const bool host = uniforms != nullptr;
  const size_t BM = (size_t)B * M;
  const size_t slot0 = (size_t)b * M;  // slot of rung 0
  // position pos's constants: its rung's beta and the gap to the next
  const float beta_pos = betas[slot0 + pos], dbeta_pos = dbeta[slot0 + pos];

  float s[N], hv[N];
#pragma unroll
  for (int i = 0; i < N; ++i) hv[i] = h[(size_t)b * N + i];
  int rho = pos;  // the rung this lane's state sits at
  int inv = pos;  // position of the lane whose state sits at rung pos
#pragma unroll
  for (int i = 0; i < N; ++i)
    s[i] = init_bit(init01, slot0 + rho, rho, R, r, N, i, key, seed_hi) ? 1.0f : 0.0f;
  float e = 0.0f;  // h.s + s.J.s / 2
#pragma unroll
  for (int i = 0; i < N; ++i) e += s[i] * (hv[i] + 0.5f * rung_dot<N>(Js, s, i));

  for (int t = 0; t < S; ++t) {
    const float beta = __shfl_sync(kFull, beta_pos, base + rho);
    SweepUniforms u{host ? uniforms + ((size_t)t * BM + slot0 + rho) * N * R + r : nullptr, R,
                    key, (uint32_t)r, (uint32_t)t, seed_hi, (uint32_t)rho << 8};
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float thr = heatbath_threshold(u(i), beta);
      const float f = hv[i] + rung_dot<N>(Js, s, i);
      const float v = f < thr ? 1.0f : 0.0f;
      e += (v - s[i]) * f;  // incremental energy of the accepted update
      s[i] = v;
    }
    if (M > 1) {
      const float e_rung = __shfl_sync(kFull, e, base + inv);  // the energy at rung pos
      const float e_next = __shfl_down_sync(kFull, e_rung, 1);  // ... at rung pos + 1
      bool swap = false;
      if (q < L && pos < M - 1 && (pos & 1) == (t & 1)) {
        const float usw = swap_uniform(swap_u, BM, slot0, pos, R, r, t, key, seed_hi);
        swap = dbeta_pos * (e_rung - e_next) < -logf(usw);
      }
      const uint32_t swaps = __ballot_sync(kFull, swap);  // bit base + m: link (m, m+1)
      const int inv_next = __shfl_down_sync(kFull, inv, 1);
      const int inv_prev = __shfl_up_sync(kFull, inv, 1);
      if ((swaps >> lane) & 1u)
        inv = inv_next;
      else if (pos > 0 && ((swaps >> (lane - 1)) & 1u))
        inv = inv_prev;
      const int at = (base + rho) & 31;  // a shadow lane's may wrap: it writes nothing
      if (rho < M - 1 && ((swaps >> at) & 1u))
        ++rho;
      else if (rho > 0 && ((swaps >> ((at + 31) & 31)) & 1u))
        --rho;
    }
  }

  if (active && rho == M - 1) {
    float* op = out + ((size_t)b * R + r) * N;
#pragma unroll
    for (int i = 0; i < N; ++i) op[i] = s[i];
  }
}

// WARP layout: one state's sweep at inverse temperature beta -- its
// variables' thresholds drawn by their owner lanes, then the decisions in
// order, each taken alike in every lane, with the incremental energy e and
// fields f (k is a constant once the slot loops are unrolled).
template <int K>
__device__ __forceinline__ void warp_sweep(float (&f)[K], uint32_t (&w)[K], float& e,
                                           const float* Js, int n, int lane, float beta,
                                           SweepUniforms& u) {
  float thr[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = 32 * k + lane;
    thr[k] = i < n ? heatbath_threshold(u(i), beta) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll 1  // unrolled 32 times, the kernels take ~4x as long to build
    for (int l = 0; l < 32; ++l) {
      const int i = 32 * k + l;
      if (i >= n) break;
      const float fi = __shfl_sync(kFull, f[k], l);
      const float th = __shfl_sync(kFull, thr[k], l);
      const float si = (float)((w[k] >> l) & 1u);
      const float d = (fi < th ? 1.0f : 0.0f) - si;
      e += d * fi;  // (v - s_i) * field, as the RUNG layout and the TPU kernel
      if (d != 0.0f) w[k] ^= 1u << l;
      const float* Ji = Js + i * n;
#pragma unroll
      for (int k2 = 0; k2 < K; ++k2) {
        const int j = 32 * k2 + lane;
        if (j < n) f[k2] = fmaf(d, Ji[j], f[k2]);
      }
    }
  }
}

// WARP layout: the fields f = h + J·s recomputed from the state words (each
// summed serially j = 0..n-1, then h_i); `energy` also returns the state's
// energy h.s + s.J.s/2, the same in every lane.
template <int K>
__device__ __forceinline__ float warp_refresh(float (&f)[K], const uint32_t (&w)[K],
                                              const float (&hv)[K], const float* Js, int n,
                                              int lane) {
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0f;
#pragma unroll
  for (int kj = 0; kj < K; ++kj) {
#pragma unroll 1  // unrolled 32 times, the kernels take ~4x as long to build
    for (int l = 0; l < 32; ++l) {
      const int j = 32 * kj + l;
      if (j >= n) break;
      const bool on = (w[kj] >> l) & 1u;
#pragma unroll
      for (int k = 0; k < K; ++k) {  // row j of the symmetric J_b: lanes read adjacent words
        const int i = 32 * k + lane;
        if (i < n) acc[k] += on ? Js[j * n + i] : 0.0f;
      }
    }
  }
  float e = 0.0f;  // this lane's share of h.s + s.J.s/2, then the warp's sum
#pragma unroll
  for (int k = 0; k < K; ++k) {
    f[k] = hv[k] + acc[k];
    if ((w[k] >> lane) & 1u) e += hv[k] + 0.5f * acc[k];
  }
  // a butterfly: every lane adds the same two partial sums at every level
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) e += __shfl_xor_sync(kFull, e, d);
  return e;
}

// WARP layout: a ladder a block of ceil(M/RPW) warps, warp c carrying the
// states that start at rungs c and c + warps (RPW of them); K slots a lane.
template <int K, int RPW>
__global__ void __launch_bounds__(1024)
pt_heatbath_warp_kernel(const float* __restrict__ J, const float* __restrict__ h,
                        const float* __restrict__ betas, const float* __restrict__ dbeta,
                        const float* __restrict__ init01, const float* __restrict__ uniforms,
                        const float* __restrict__ swap_u, float* __restrict__ out, int B, int M,
                        int R, int n, int S, uint32_t seed_lo, uint32_t seed_hi) {
  extern __shared__ float smem[];
  float* Js = smem;            // J_b, n*n row-major
  float* energy = smem + n * n;  // [sweep parity][rung]: the energy of the state there
  const int b = blockIdx.y, r = blockIdx.x;
  stage_J(Js, J, b, n);

  const int c = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const uint2 key = make_uint2(seed_lo, (uint32_t)b);
  const bool host = uniforms != nullptr;
  const size_t BM = (size_t)B * M;
  const size_t slot0 = (size_t)b * M;

  float hv[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = 32 * k + lane;
    hv[k] = i < n ? h[(size_t)b * n + i] : 0.0f;
  }
  float f[RPW][K], e[RPW];
  uint32_t w[RPW][K];
  int rho[RPW];
#pragma unroll
  for (int a = 0; a < RPW; ++a) {
    rho[a] = c + a * warps;  // >= M: no state (the last warp of an odd M at RPW 2)
    e[a] = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = 32 * k + lane;
      w[a][k] = __ballot_sync(kFull, rho[a] < M && i < n &&
                                         init_bit(init01, slot0 + rho[a], rho[a], R, r, n, i,
                                                  key, seed_hi));
      f[a][k] = 0.0f;
    }
  }

  for (int t = 0; t < S; ++t) {
#pragma unroll
    for (int a = 0; a < RPW; ++a) {
      if (rho[a] >= M) continue;  // the same in the whole warp
      if (t % kRefreshPeriod == 0) {
        const float e0 = warp_refresh<K>(f[a], w[a], hv, Js, n, lane);
        if (t == 0) e[a] = e0;  // afterwards the energy stays incremental
      }
      SweepUniforms u{host ? uniforms + ((size_t)t * BM + slot0 + rho[a]) * n * R + r : nullptr,
                      R, key, (uint32_t)r, (uint32_t)t, seed_hi, (uint32_t)rho[a] << 8};
      warp_sweep<K>(f[a], w[a], e[a], Js, n, lane, betas[slot0 + rho[a]], u);
    }
    if (M == 1) continue;
    float* et = energy + (t & 1) * M;
#pragma unroll
    for (int a = 0; a < RPW; ++a)
      if (rho[a] < M && lane == 0) et[rho[a]] = e[a];
    __syncthreads();
#pragma unroll
    for (int a = 0; a < RPW; ++a) {
      const int m = rho[a];
      if (m >= M) continue;
      // the link of this sweep's parity that holds rung m, if any
      const int lo = (m & 1) == (t & 1) ? m : m - 1;
      if (lo < 0 || lo + 1 >= M) continue;
      const float usw = swap_uniform(swap_u, BM, slot0, lo, R, r, t, key, seed_hi);
      if (dbeta[slot0 + lo] * (et[lo] - et[lo + 1]) < -logf(usw)) rho[a] = m == lo ? lo + 1 : lo;
    }
  }

#pragma unroll
  for (int a = 0; a < RPW; ++a) {
    if (rho[a] != M - 1) continue;
    float* op = out + ((size_t)b * R + r) * n;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = 32 * k + lane;
      if (i < n) op[i] = (float)((w[a][k] >> lane) & 1u);
    }
  }
}

struct Args {
  const float *J, *h, *betas, *dbeta, *init01, *uniforms, *swap_u;
  float* out;
  int B, M, R, n, S;
  uint32_t seed_lo, seed_hi;
};

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int N>
cudaError_t launch_rung(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(kRung, N, a.M);
  const int per_block = kRungWarps * (32 / a.M);  // ladders a block
  const dim3 grid((unsigned)((a.R + per_block - 1) / per_block), (unsigned)a.B);
  pt_heatbath_rung_kernel<N><<<grid, kThreads, smem, stream>>>(
      a.J, a.h, a.betas, a.dbeta, a.init01, a.uniforms, a.swap_u, a.out, a.B, a.M, a.R, a.S,
      a.seed_lo, a.seed_hi);
  return cudaGetLastError();
}

template <int K, int RPW>
cudaError_t launch_warp(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(kWarp, a.n, a.M);
  const cudaError_t e = set_smem(pt_heatbath_warp_kernel<K, RPW>, smem);
  if (e != cudaSuccess) return e;
  const int warps = (a.M + RPW - 1) / RPW;
  const dim3 grid((unsigned)a.R, (unsigned)a.B);
  pt_heatbath_warp_kernel<K, RPW><<<grid, 32 * warps, smem, stream>>>(
      a.J, a.h, a.betas, a.dbeta, a.init01, a.uniforms, a.swap_u, a.out, a.B, a.M, a.R, a.n,
      a.S, a.seed_lo, a.seed_hi);
  return cudaGetLastError();
}

cudaError_t dispatch_rung(const Args& a, cudaStream_t st) {
  switch (a.n) {
    case 1: return launch_rung<1>(a, st);
    case 2: return launch_rung<2>(a, st);
    case 3: return launch_rung<3>(a, st);
    case 4: return launch_rung<4>(a, st);
    case 5: return launch_rung<5>(a, st);
    case 6: return launch_rung<6>(a, st);
    case 7: return launch_rung<7>(a, st);
    case 8: return launch_rung<8>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// RPW = 1 up to 32 rungs, else 2; the slot bound K is ceil(n/32) rounded up
// to a power of 2 (8 slots cover kMaxN).
template <int RPW>
cudaError_t dispatch_warp_k(const Args& a, cudaStream_t st) {
  const int k = (a.n + 31) / 32;
  if (k <= 1) return launch_warp<1, RPW>(a, st);
  if (k <= 2) return launch_warp<2, RPW>(a, st);
  if (k <= 4) return launch_warp<4, RPW>(a, st);
  return launch_warp<8, RPW>(a, st);
}

}  // namespace

// Bounds of the kernel: n (J_b in shared memory) and the rungs of a ladder;
// and the shared memory of a block in each layout (0 RUNG, 1 WARP), which
// must not exceed 232,448 bytes -- so the WARP layout takes M <= 15 at
// n = 241 (J_b and the 2·M exchanged energies).
extern "C" int qbmx_pt_heatbath_max_n() { return kMaxN; }
extern "C" int qbmx_pt_heatbath_max_rungs() { return kMaxRungs; }
extern "C" unsigned long long qbmx_pt_heatbath_smem(int layout, int n, int M) {
  return (unsigned long long)smem_bytes(layout, n, M);
}

// Returns the cudaError_t of the launch (0 = success).  init01, uniforms and
// swap_u are all null (Philox mode) or all set (host-variate mode); layout
// is 0 (RUNG: n <= 8, M <= 32) or 1 (WARP), the host's choice.
extern "C" int qbmx_pt_heatbath(const float* J, const float* h, const float* betas,
                                const float* dbeta, const float* init01,
                                const float* uniforms, const float* swap_u, float* out,
                                int B, int M, int R, int n, int S, unsigned long long seed,
                                int layout, void* stream) {
  const bool some = init01 != nullptr || uniforms != nullptr || swap_u != nullptr;
  const bool all = init01 != nullptr && uniforms != nullptr && swap_u != nullptr;
  if (B <= 0 || M <= 0 || R <= 0 || n <= 0 || S <= 0 || B > 65535 || n > kMaxN ||
      M > kMaxRungs || some != all || (layout != kRung && layout != kWarp) ||
      smem_bytes(layout, n, M) > kSmemMax ||
      (layout == kRung && (n > kRungMaxN || M > kRungMaxM)))
    return (int)cudaErrorInvalidValue;
  const Args a{J, h, betas, dbeta, init01, uniforms, swap_u, out, B, M, R, n, S,
               (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout == kRung) return (int)dispatch_rung(a, st);
  return (int)(M <= 32 ? dispatch_warp_k<1>(a, st) : dispatch_warp_k<2>(a, st));
}
