// K3's kernels, included by its two sources (pt_heatbath.cu: the entry, a
// rung on L lanes and a rung a warp; pt_heatbath_rung.cu: a rung a thread),
// so that nvcc builds the two at once.
//
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
// Temperatures, not states, are exchanged: a thread (or a group of lanes)
// keeps one state for the whole run, with its energy, and the index rho of
// the rung it sits at; a swap of link (m, m+1) exchanges the rho of the two
// states sitting there.  A state at rung rho draws exactly the numbers the
// plain version gives rung rho (Philox counter and host-variate slot
// b*M + rho, beta[rho]), so the trajectories are the plain version's, and
// no state moves.  The target is whichever state sits at rung M-1 at the end.
//
// What bounds it on this card: every rung is a sequential chain of n
// decisions a sweep, each a field (a dot product, or an incremental
// update), a threshold (two logf and a division, about half a decision's
// instructions) and a draw, and the exchanges couple a ladder's rungs once
// a sweep.  A whole ladder in one thread would keep its M*n states and M
// energies in run-time indexed arrays, so in local memory, and an exchange
// would copy n floats.  Three layouts, chosen on the host from the card's
// measurements (samplers/pt_cuda.py::pt_layout), K1's and K2's
// (chain_layouts.cuh) with a rung for a chain:
//   * RUNG (n <= 32, M <= 32; the flagship's n = 6, the flat h8 call's
//     n = 9, M = 8): a rung a thread.  A ladder's M rungs sit on M adjacent
//     lanes of one warp (floor(32/M) ladders a warp, 4 warps a block of one
//     problem); n is a template parameter and the loops are unrolled, so
//     the state and h live in registers.  A field is the serial dot product
//     h_i + sum_j J_ij s_j, recomputed for every decision; up to n = 8
//     J_b's n² values stay in registers, past it its rows are reread from
//     shared memory as float4 every sweep (thread_dot, thread_sweep_fence).
//     An exchange is a few warp instructions: the energies by rung (a
//     shuffle through inv, the lane holding each rung), each link's test on
//     the lane of its lower rung, a ballot of the verdicts, and rho and inv
//     updated from it (ladder_exchange).
//   * GROUP(L) (L in {4, 8, 16}) and WARP (L = 32): a rung on L consecutive
//     lanes (K1's GROUP and LANES scheme): lane l owns variables L*k + l
//     (slot k < K), with their fields in registers, incremental between
//     refreshes every kRefreshPeriod sweeps, and the state a word a slot
//     (the rung's L bits of a ballot) in every lane of the rung; a
//     decision's latency, not a dot product, sets a variable's cost, so a
//     call of few rungs occupies many SMs.  Where M*L <= 32 a ladder sits in
//     one warp on M adjacent groups of L lanes and exchanges by shuffles,
//     RUNG's ladder_exchange at a stride of L lanes (floor(32/(M*L))
//     ladders a warp, 4 warps a block).  Otherwise a ladder is a block of
//     ceil(M*L/32) warps (WARP: ceil(M/RPW) warps carrying RPW = 1 or 2
//     rungs in turn, M <= 32, M <= 64) with J_b in its shared memory beside
//     the energies by rung of the last two sweeps: after its sweep each
//     state writes its energy at its rung's slot; one barrier; then each
//     state reads its partner's (the slots alternate between two sweeps, so
//     one barrier a sweep orders every write before the reads and every
//     read before the next write to its slot), and the two states of a
//     link take the same decision from the same values.  Every L does the
//     same float operations on every field and energy in the same order
//     (the initial energy is summed serially over i, not by a butterfly),
//     so GROUP(L) gives WARP's samples bit for bit under the same draws.
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

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "anneal_rules.cuh"
#include "chain_layouts.cuh"

namespace qbmx::pt {

// A launch's arguments, as qbmx_pt_heatbath (pt_heatbath.cu) received them.
struct Args {
  const float *J, *h, *betas, *dbeta, *init01, *uniforms, *swap_u;
  float* out;
  int B, M, R, n, S;
  uint32_t seed_lo, seed_hi;
};

// RUNG's launches, in pt_heatbath_rung.cu (n <= kRungMaxN, M <= 32).
cudaError_t launch_rung(const Args& a, cudaStream_t st);

constexpr int kThreads = 128;  // RUNG, and GROUP with a ladder in a warp: 4 warps a block
constexpr int kBlockWarps = kThreads / 32;
constexpr int kRungMaxN = 32, kRungMaxM = 32;  // RUNG's bounds: n unrolled, a ladder in a warp
constexpr int kMaxSlots = 8;  // GROUP's and WARP's slot bound K: 8 lanes cover n = 64, a warp 241
constexpr int kMaxRungs = 64;  // WARP layout: 32 warps of 2 rungs
// Largest n whose J_b (4·n² bytes) fits one block's shared memory.
constexpr int kMaxN = 241;
constexpr size_t kSmemMax = 232448;  // a block's shared memory on Hopper

// A block's shared memory at `lanes` lanes a rung (1: RUNG; 4, 8, 16:
// GROUP; 32: WARP): J_b (RUNG: rows thread_stride(n) floats apart), and
// where a ladder spans warps the energies by rung of two sweeps.
__host__ __device__ inline size_t smem_bytes(int lanes, int n, int M) {
  if (lanes == 1) return 4 * (size_t)n * thread_stride(n);
  return 4 * ((size_t)n * n + (M * lanes > 32 ? 2 * (size_t)M : 0));
}

}  // namespace qbmx::pt

namespace {

using qbmx::chain_bits;
using qbmx::heatbath_threshold;
using qbmx::kInitTag;
using qbmx::philox4x32_10;
using qbmx::stage_J;
using qbmx::SweepUniforms;
using qbmx::thread_dot;
using qbmx::thread_stride;
using qbmx::thread_sweep_fence;
using qbmx::uniform_of;
using qbmx::word;
using namespace qbmx::pt;

constexpr uint32_t kSwapTag = 0xFFu;  // variable-block slot of the swap draws
// GROUP and WARP: K1's refresh period (sa_metropolis.cu): a refresh costs a
// lane K·n adds, about one sweep of incremental updates.
constexpr int kRefreshPeriod = 16;
constexpr unsigned kFull = 0xFFFFFFFFu;

// The initial bit of variable i of the state that starts at rung m (slot
// slot0 + m): from the host, or the low bit of its Philox word.
__device__ __forceinline__ bool rung_init_bit(const float* init01, size_t slot, int m, int R,
                                              int r, int n, int i, uint2 key, uint32_t seed_hi) {
  if (init01 != nullptr) return init01[(slot * R + r) * n + i] != 0.0f;
  const uint4 bits = philox4x32_10(
      make_uint4((uint32_t)r, ((uint32_t)m << 8) | (uint32_t)(i >> 2), kInitTag, seed_hi), key);
  return (word(bits, i & 3) & 1u) != 0u;
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

// A ladder on M adjacent groups of L lanes of one warp (RUNG: L = 1): the
// exchanges of sweep t.  The group at position pos of the warp's ladder q
// (its first group: base) holds a state of energy e sitting at rung rho;
// inv is the position of the group whose state sits at rung pos.  Groups
// past the warp's ladders (q >= ladders) shadow one so that every lane
// takes part in the shuffles and the ballot; their verdicts are false.
template <int L>
__device__ __forceinline__ void ladder_exchange(float e, int& rho, int& inv, int M, int ladders,
                                                int q, int pos, int base, int t, float dbeta_pos,
                                                const float* swap_u, size_t BM, size_t slot0,
                                                int R, int r, uint2 key, uint32_t seed_hi) {
  const int lane = threadIdx.x % 32, sub = lane % L;
  const float e_rung = __shfl_sync(kFull, e, (base + inv) * L + sub);  // the energy at rung pos
  const float e_next = __shfl_down_sync(kFull, e_rung, L);  // ... at rung pos + 1
  bool swap = false;
  if (q < ladders && pos < M - 1 && (pos & 1) == (t & 1)) {
    const float usw = swap_uniform(swap_u, BM, slot0, pos, R, r, t, key, seed_hi);
    swap = dbeta_pos * (e_rung - e_next) < -logf(usw);
  }
  const uint32_t swaps = __ballot_sync(kFull, swap);  // the lanes of link (m, m+1)'s lower group
  const int inv_next = __shfl_down_sync(kFull, inv, L);
  const int inv_prev = __shfl_up_sync(kFull, inv, L);
  if ((swaps >> lane) & 1u)
    inv = inv_next;
  else if (pos > 0 && ((swaps >> (lane - L)) & 1u))
    inv = inv_prev;
  const int at = ((base + rho) * L + sub) & 31;  // a shadow group's may wrap: it writes nothing
  if (rho < M - 1 && ((swaps >> at) & 1u))
    ++rho;
  else if (rho > 0 && ((swaps >> ((at + 32 - L) & 31)) & 1u))
    --rho;
}

// RUNG layout: a rung a thread, width N = n.
template <int N>
__global__ void __launch_bounds__(kThreads)
pt_heatbath_rung_kernel(const float* __restrict__ J, const float* __restrict__ h,
                        const float* __restrict__ betas, const float* __restrict__ dbeta,
                        const float* __restrict__ init01, const float* __restrict__ uniforms,
                        const float* __restrict__ swap_u, float* __restrict__ out, int B, int M,
                        int R, int S, uint32_t seed_lo, uint32_t seed_hi) {
  extern __shared__ float Js[];  // J_b, N rows thread_stride(N) floats apart
  const int b = blockIdx.y;
  stage_J(Js, J, b, N, thread_stride(N));

  const int lane = threadIdx.x % 32;
  const int L = 32 / M;  // ladders a warp
  const int q = lane / M, pos = lane % M;  // the lane's ladder in the warp, and position
  const int base = q * M;                  // lane of the ladder's position 0
  const int r0 = (blockIdx.x * kBlockWarps + threadIdx.x / 32) * L + q;
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
    s[i] = rung_init_bit(init01, slot0 + rho, rho, R, r, N, i, key, seed_hi) ? 1.0f : 0.0f;
  float e = 0.0f;  // h.s + s.J.s / 2
#pragma unroll
  for (int i = 0; i < N; ++i) e += s[i] * (hv[i] + 0.5f * thread_dot<N>(Js, s, i));

  for (int t = 0; t < S; ++t) {
    thread_sweep_fence<N>();
    const float beta = __shfl_sync(kFull, beta_pos, base + rho);
    SweepUniforms u{host ? uniforms + ((size_t)t * BM + slot0 + rho) * N * R + r : nullptr, R,
                    key, (uint32_t)r, (uint32_t)t, seed_hi, (uint32_t)rho << 8};
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float thr = heatbath_threshold(u(i), beta);
      const float f = hv[i] + thread_dot<N>(Js, s, i);
      const float v = f < thr ? 1.0f : 0.0f;
      e += (v - s[i]) * f;  // incremental energy of the accepted update
      s[i] = v;
    }
    if (M > 1)
      ladder_exchange<1>(e, rho, inv, M, L, q, pos, base, t, dbeta_pos, swap_u, BM, slot0, R, r,
                         key, seed_hi);
  }

  if (active && rho == M - 1) {
    float* op = out + ((size_t)b * R + r) * N;
#pragma unroll
    for (int i = 0; i < N; ++i) op[i] = s[i];
  }
}

// GROUP and WARP: one state's sweep at inverse temperature beta on L lanes
// (sub: the lane within them) -- its variables' thresholds drawn by their
// owner lanes, then the decisions in order, each taken alike in every lane
// of the rung, with the incremental energy e and fields f (k is a constant
// once the slot loops are unrolled).
template <int K, int L>
__device__ __forceinline__ void group_sweep(float (&f)[K], uint32_t (&w)[K], float& e,
                                            const float* Js, int n, int sub, float beta,
                                            SweepUniforms& u) {
  float thr[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = L * k + sub;
    thr[k] = i < n ? heatbath_threshold(u(i), beta) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll 1  // unrolled L times, the kernels take ~4x as long to build
    for (int l = 0; l < L; ++l) {
      const int i = L * k + l;
      if (i >= n) break;
      const float fi = __shfl_sync(kFull, f[k], l, L);
      const float th = __shfl_sync(kFull, thr[k], l, L);
      const float si = (float)((w[k] >> l) & 1u);
      const float d = (fi < th ? 1.0f : 0.0f) - si;
      e += d * fi;  // (v - s_i) * field, as the RUNG layout and the TPU kernel
      if (d != 0.0f) w[k] ^= 1u << l;
      const float* Ji = Js + i * n;
#pragma unroll
      for (int k2 = 0; k2 < K; ++k2) {
        const int j = L * k2 + sub;
        if (j < n) f[k2] = fmaf(d, Ji[j], f[k2]);
      }
    }
  }
}

// GROUP and WARP: the fields f = h + J·s recomputed from the state words
// (each summed serially j = 0..n-1, then h_i).  With `energy` (the same in
// every lane of the warp) it also returns the state's energy
// h.s + s.J.s/2, summed serially i = 0..n-1 in every lane of the rung, so
// that every L (and RUNG) starts from the same value.
template <int K, int L>
__device__ __forceinline__ float group_refresh(float (&f)[K], const uint32_t (&w)[K],
                                               const float (&hv)[K], const float* Js, int n,
                                               int sub, bool energy) {
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0f;
#pragma unroll
  for (int kj = 0; kj < K; ++kj) {
#pragma unroll 1  // unrolled L times, the kernels take ~4x as long to build
    for (int l = 0; l < L; ++l) {
      const int j = L * kj + l;
      if (j >= n) break;
      const bool on = (w[kj] >> l) & 1u;
#pragma unroll
      for (int k = 0; k < K; ++k) {  // row j of the symmetric J_b: lanes read adjacent words
        const int i = L * k + sub;
        if (i < n) acc[k] += on ? Js[j * n + i] : 0.0f;
      }
    }
  }
  float term[K];  // s_i (h_i + acc_i / 2) of this lane's variables
#pragma unroll
  for (int k = 0; k < K; ++k) {
    f[k] = hv[k] + acc[k];
    term[k] = ((w[k] >> sub) & 1u) ? hv[k] + 0.5f * acc[k] : 0.0f;
  }
  float e = 0.0f;
  if (energy) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll 1
      for (int l = 0; l < L; ++l) {
        if (L * k + l >= n) break;
        e += __shfl_sync(kFull, term[k], l, L);
      }
    }
  }
  return e;
}

// GROUP layout: a rung on L consecutive lanes, K slots a lane (L*K >= n).
// Where M*L <= 32 (`span` false) a ladder sits on M adjacent groups of one
// warp, floor(32/(M*L)) ladders a warp, 4 warps a block, and exchanges by
// shuffles; otherwise a ladder is a block of ceil(M*L/32) warps, group c
// carrying the state that starts at rung c, exchanging through the
// energies in shared memory (groups c >= M shadow rung M-1 and write
// nothing).
template <int K, int L>
__global__ void __launch_bounds__(1024)
pt_heatbath_group_kernel(const float* __restrict__ J, const float* __restrict__ h,
                         const float* __restrict__ betas, const float* __restrict__ dbeta,
                         const float* __restrict__ init01, const float* __restrict__ uniforms,
                         const float* __restrict__ swap_u, float* __restrict__ out, int B, int M,
                         int R, int n, int S, uint32_t seed_lo, uint32_t seed_hi) {
  static_assert(K <= kMaxSlots && L >= 4 && L <= 16 && (L & (L - 1)) == 0, "slots, lanes");
  extern __shared__ float smem[];
  float* Js = smem;              // J_b, n*n row-major
  float* energy = smem + n * n;  // spanning ladders: [sweep parity][rung]
  const int b = blockIdx.y;
  stage_J(Js, J, b, n, n);

  const bool span = M * L > 32;  // the same in the whole launch
  const int sub = threadIdx.x % L;
  int ladders = 0, q = 0, pos, base = 0, r;
  bool live, active;
  if (span) {
    pos = threadIdx.x / L;  // the rung the group's state starts at
    live = pos < M;
    active = live;
    pos = min(pos, M - 1);
    r = blockIdx.x;
  } else {
    const int gw = threadIdx.x % 32 / L;  // the group in the warp
    ladders = 32 / (M * L);
    q = gw / M;
    pos = gw % M;
    base = q * M;
    const int r0 = (blockIdx.x * kBlockWarps + threadIdx.x / 32) * ladders + q;
    live = true;  // shadows take part in the shuffles, and write nothing
    active = q < ladders && r0 < R;
    r = min(r0, R - 1);
  }
  const uint2 key = make_uint2(seed_lo, (uint32_t)b);
  const bool host = uniforms != nullptr;
  const size_t BM = (size_t)B * M;
  const size_t slot0 = (size_t)b * M;
  const float dbeta_pos = dbeta[slot0 + pos];

  float hv[K], f[K];
  uint32_t w[K];  // bit l of w[k]: the state of variable L*k + l
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = L * k + sub;
    hv[k] = i < n ? h[(size_t)b * n + i] : 0.0f;
    f[k] = 0.0f;
    w[k] = chain_bits<L>(__ballot_sync(
        kFull, i < n && rung_init_bit(init01, slot0 + pos, pos, R, r, n, i, key, seed_hi)));
  }
  int rho = pos, inv = pos;
  float e = 0.0f;

  for (int t = 0; t < S; ++t) {
    if (t % kRefreshPeriod == 0) {
      const float e0 = group_refresh<K, L>(f, w, hv, Js, n, sub, t == 0);
      if (t == 0) e = e0;  // afterwards the energy stays incremental
    }
    SweepUniforms u{host ? uniforms + ((size_t)t * BM + slot0 + rho) * n * R + r : nullptr, R,
                    key, (uint32_t)r, (uint32_t)t, seed_hi, (uint32_t)rho << 8};
    group_sweep<K, L>(f, w, e, Js, n, sub, betas[slot0 + rho], u);
    if (M == 1) continue;
    if (!span) {
      ladder_exchange<L>(e, rho, inv, M, ladders, q, pos, base, t, dbeta_pos, swap_u, BM, slot0,
                         R, r, key, seed_hi);
      continue;
    }
    float* et = energy + (t & 1) * M;
    if (live && sub == 0) et[rho] = e;
    __syncthreads();
    if (live) {
      const int m = rho;
      // the link of this sweep's parity that holds rung m, if any
      const int lo = (m & 1) == (t & 1) ? m : m - 1;
      if (lo >= 0 && lo + 1 < M) {
        const float usw = swap_uniform(swap_u, BM, slot0, lo, R, r, t, key, seed_hi);
        if (dbeta[slot0 + lo] * (et[lo] - et[lo + 1]) < -logf(usw)) rho = m == lo ? lo + 1 : lo;
      }
    }
  }

  if (active && rho == M - 1) {
    float* op = out + ((size_t)b * R + r) * n;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = L * k + sub;
      if (i < n) op[i] = (float)((w[k] >> sub) & 1u);
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
