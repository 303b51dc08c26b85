// Parallel tempering (replica exchange) with heat-bath sweeps over the
// structured shared-coupling form, for couplings that do not fit one
// block's shared memory, for NVIDIA Hopper (sm_90a) (K5).
//
// Replaces, where pt_heatbath.cu (K3) cannot hold J_b whole in shared
// memory (n > 241, or M >= 16 at n = 241), the parallel-tempering mode of
// the TPU kernel of qbmx:
//   qbmx/samplers/sa_pallas.py _sa_kernel with M > 0 (entry
//   pt_sample_batch_pallas), which takes such shapes only at one problem
//   per pack (n up to ~415 at M = 8), qbmx running its XLA tempering beyond.
//
// Semantics: those of K3 and of the plain version
// (qbmx_torch/samplers/tempering.py) on the densified batch: problem p =
// g*B + b has couplings J_g and linear terms h[g, b]; read r is a ladder of
// M rungs at the fixed inverse temperatures betas[p, m]; per sweep t every
// rung does one single-variable heat-bath sweep at its beta (variable i
// becomes 1 iff field_i < (logf(1-u) - logf(u))/beta), then the links
// (m, m+1) with m % 2 == t % 2 swap iff dbeta[p, m]*(E[m] - E[m+1]) <
// -logf(u_swap).  The target rung M-1 is written out.
//
// What bounds it on this card.  At the CDQBM probabilistic-pooling PT call
// (G=2 groups of B=20 problems, M=8, R=100, n=717, S=1000: 32,000 rungs,
// 2.3e10 decisions) J_g is 2.06 MB, nine times a block's shared memory.
// Densified, the 40 problems' couplings would be 82 MB, past the 50 MB L2;
// on the structured form the blocks of a group stream the same J_g, which
// stays in L2.  Each rung is a sequential chain of n·S decisions, so the
// design is K4's (anneal_wide.cu), with the tile machinery it shares
// (anneal_tiles.cuh):
//   * a rung is a warp, with its state (a byte a variable) and its n
//     incremental fields f = h + J·s in shared memory, refreshed every
//     kRefreshPeriod-th sweep; J_g streams through shared memory in 8-row
//     tiles double-buffered with cp.async; the tile's fields sit in
//     registers; 32 thresholds are drawn by the warp's lanes at once;
//   * a block holds L whole ladders of one group, L·M <= 32 warps, L chosen
//     on the host (samplers/pt_wide_cuda.py::pt_wide_geometry) within
//     shared memory, so a ladder's exchanges need only the block's barrier.
//     At the CDQBM (a) call: L = 4, 1,000 blocks of 32 warps, one block an
//     SM (161,536 bytes), about eight waves.
//
// Temperatures, not states, are exchanged, as in K3: a warp keeps its
// state and fields for the whole run and carries rho, the rung it sits at;
// it draws that rung's numbers (Philox counter and host slot p*M + rho) at
// betas[p, rho], so the trajectories are the plain version's, and no state
// moves.  After each sweep every state's energy is recomputed from its
// fields, E = sum_i s_i (h_i + f_i) / 2 (lane l sums variables i = l mod 32
// in increasing order, then a butterfly), so it carries only the fields'
// drift and one sum's rounding and never accumulates: no incremental energy
// to drift over 1000 sweeps.  Each state writes its energy at its rung's
// slot (two slots a rung, alternating by sweep, so one barrier a sweep
// orders the writes before the reads and the reads before the next write
// there); then the two states of a link read both energies and take the
// same verdict from the same values.  The plain version recomputes E from
// the state in float32 in another order, so a near-tie exchange may go the
// other way in a few chains (chip_smoke.py bounds them).
//
// Random numbers: Philox4x32-10 (philox.cuh) keyed by (seed, problem p).
// Variable draws at counter (read, (m << 10) | variable/4, sweep), initial
// bits at sweep slot 2^32-1; swap draws at (read, ((m / 4) << 10) | 0x3FF,
// sweep), word m % 4 -- K3's layout with 10 bits for the variable block (n
// <= 4096) where K3 has 8 (n <= 1024):
// qbmx_torch/samplers/sa_torch.py::pt_philox_variates(..., var_shift=10)
// writes them out.  With non-null pointers init01 (G*B*M,R,n), uniforms
// (S,G*B*M,n,R) and swap_u (S,G*B*M,R), slot p*M+m, come from the host.
// Optional outputs, null on the main path, each at the slot p*M + rho of
// the rung a state ends at: states_out (G*B*M,R,n) every rung's state,
// fields_out (G*B*M,R,n) its fields, energy_out (G*B*M,R) its energy; and
// flips, the variables changed (for chip_smoke.py's drift check and bound).
//
// Build without --use_fast_math (anneal_rules.cuh).

#include <climits>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "anneal_tiles.cuh"

namespace {

using qbmx::kInitTag;
using qbmx::kLanes;
using qbmx::kRows;
using qbmx::Layout;
using qbmx::layout_of;
using qbmx::load_tile;
using qbmx::philox4x32_10;
using qbmx::sweep_tiles;
using qbmx::SweepUniforms;
using qbmx::uniform_of;
using qbmx::word;

constexpr int kMaxChains = 32;       // rungs a block, a warp each: 1024 threads
constexpr size_t kSmemMax = 232448;  // a block's shared memory on Hopper
constexpr int kRefreshPeriod = 64;   // K4's: the wrappers' field_drift_bound assumes it
constexpr int kHeatBath = 1;         // anneal_tiles.cuh's rule 1: single-variable heat-bath
constexpr int kVarShift = 10;        // Philox counter y = (rung << 10) | variable/4
constexpr uint32_t kSwapTag = (1u << kVarShift) - 1;  // variable-block slot of the swap draws
constexpr unsigned kFull = 0xFFFFFFFFu;

// A block of `chains` warps at width n: K4's layout, then the energies by
// rung of two sweeps.
__host__ __device__ inline size_t smem_bytes(int n, int chains) {
  return layout_of(n).bytes(chains) + 4 * (size_t)2 * chains;
}

// Rung m's uniform for the swap of link (m, m+1) at sweep t.
__device__ __forceinline__ float swap_uniform(const float* swap_u, size_t GBM, size_t slot0,
                                              int m, int R, int r, int t, uint2 key,
                                              uint32_t seed_hi) {
  if (swap_u != nullptr) return swap_u[((size_t)t * GBM + slot0 + m) * R + r];
  const uint4 w = philox4x32_10(
      make_uint4((uint32_t)r, ((uint32_t)(m >> 2) << kVarShift) | kSwapTag, (uint32_t)t,
                 seed_hi),
      key);
  return uniform_of(word(w, m & 3));
}

__global__ void __launch_bounds__(kMaxChains * kLanes)
pt_wide_kernel(const float* __restrict__ J, const float* __restrict__ h,
               const float* __restrict__ betas, const float* __restrict__ dbeta,
               const float* __restrict__ init01, const float* __restrict__ uniforms,
               const float* __restrict__ swap_u, float* __restrict__ out,
               float* __restrict__ states_out, float* __restrict__ fields_out,
               float* __restrict__ energy_out, unsigned long long* __restrict__ flips, int G,
               int B, int M, int R, int n, int S, uint32_t seed_lo, uint32_t seed_hi,
               int ladders_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = ladders_per_block * M;  // warps a block
  const Layout L = layout_of(n);
  float* tiles = reinterpret_cast<float*>(smem);
  float* field_rows = tiles + 2 * kRows * L.jrow;
  uint32_t* state = reinterpret_cast<uint32_t*>(field_rows + (size_t)C * L.frow);
  // [sweep parity][ladder slot][rung]: the energy of the state there
  float* energy = reinterpret_cast<float*>(state + (size_t)C * L.words());

  const int g = blockIdx.y;
  const int c = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int slot = c / M;  // the ladder's slot in the block: warps slot*M .. slot*M + M-1
  const long long ladders = (long long)B * R;
  const long long ladder = (long long)blockIdx.x * ladders_per_block + slot;
  const bool active = ladder < ladders;
  // the last block's spare ladders repeat the group's last ladder, whole, so
  // that every warp takes part in the barriers; they write nothing
  const long long q = active ? ladder : ladders - 1;
  const int b = (int)(q / R);
  const int r = (int)(q % R);
  const size_t p = (size_t)g * B + b;  // problem id
  const size_t GBM = (size_t)G * B * M;
  const size_t slot0 = p * M;  // host slot of the problem's rung 0
  const uint2 key = make_uint2(seed_lo, (uint32_t)p);
  const bool host = uniforms != nullptr;
  const float* Jg = J + (size_t)g * n * L.jrow;
  const float* hp = h + p * n;

  for (int k = threadIdx.x; k < C * (L.frow + L.words()); k += blockDim.x) field_rows[k] = 0.0f;
  __syncthreads();
  float* fr = field_rows + (size_t)c * L.frow;
  uint32_t* st = state + c * L.words();
  unsigned char* sb = reinterpret_cast<unsigned char*>(st);
  int rho = c % M;  // the rung this warp's state sits at; it starts at rung c % M
  for (int i = lane; i < n; i += kLanes) {
    bool bit;
    if (host) {
      bit = init01[((slot0 + rho) * R + r) * n + i] != 0.0f;
    } else {
      const uint4 bits = philox4x32_10(
          make_uint4((uint32_t)r, ((uint32_t)rho << kVarShift) | (uint32_t)(i >> 2), kInitTag,
                     seed_hi),
          key);
      bit = (word(bits, i & 3) & 1u) != 0u;
    }
    sb[i] = bit ? 0xFF : 0x00;
  }

  const size_t u_sweep = GBM * n * R;  // uniforms per sweep
  int changed = 0;
  float e = 0.0f;  // the state's energy after the last sweep
  load_tile(tiles, Jg, 0, n, L.jrow);
  __pipeline_commit();
  int buf = 0;
  for (int t = 0; t < S; ++t) {
    SweepUniforms u{host ? uniforms + (size_t)t * u_sweep + (slot0 + rho) * n * R + r : nullptr,
                    R, key, (uint32_t)r, (uint32_t)t, seed_hi, (uint32_t)rho << kVarShift};
    changed += sweep_tiles<kHeatBath>(tiles, buf, Jg, L, n, t + 1 == S,
                                      t % kRefreshPeriod == 0, betas[slot0 + rho], u, fr, st,
                                      lane, hp);
    // the sweep's last barrier is behind us: the warp's fields and state
    // bytes are in place for all its lanes
    e = 0.0f;
    for (int i = lane; i < n; i += kLanes)
      if (sb[i]) e += hp[i] + fr[i];
    // a butterfly: every lane adds the same two partial sums at every level
#pragma unroll
    for (int d = 1; d < kLanes; d <<= 1) e += __shfl_xor_sync(kFull, e, d);
    e *= 0.5f;
    if (M == 1) continue;  // no link
    float* et = energy + (t & 1) * C + slot * M;  // this sweep's energies of the ladder
    if (lane == 0) et[rho] = e;
    __syncthreads();
    // the link of this sweep's parity that holds rung rho, if any
    const int lo = (rho & 1) == (t & 1) ? rho : rho - 1;
    if (lo >= 0 && lo + 1 < M) {
      const float usw = swap_uniform(swap_u, GBM, slot0, lo, R, r, t, key, seed_hi);
      if (dbeta[slot0 + lo] * (et[lo] - et[lo + 1]) < -logf(usw)) rho = rho == lo ? lo + 1 : lo;
    }
  }

  if (active) {
    if (rho == M - 1) {
      float* op = out + (p * R + r) * n;
      for (int i = lane; i < n; i += kLanes) op[i] = sb[i] ? 1.0f : 0.0f;
    }
    const size_t row = ((slot0 + rho) * R + r) * n;
    if (states_out != nullptr)
      for (int i = lane; i < n; i += kLanes) states_out[row + i] = sb[i] ? 1.0f : 0.0f;
    if (fields_out != nullptr)
      for (int i = lane; i < n; i += kLanes) fields_out[row + i] = fr[i];
    if (energy_out != nullptr && lane == 0) energy_out[(slot0 + rho) * R + r] = e;
    if (flips != nullptr && lane == 0 && changed != 0)
      atomicAdd(flips, (unsigned long long)changed);
  }
}

}  // namespace

// Largest n the kernel takes: two J tiles and one rung's fields, state and
// energies must fit one block's shared memory (K4's bound, 3368).
extern "C" int qbmx_pt_wide_max_n() {
  int n = 1;
  while (smem_bytes(n + 1, 1) <= kSmemMax) ++n;
  return n;
}

// Largest ladder the kernel takes at width n (a ladder a block, a warp a
// rung: at most 32, and what shared memory holds); 0 if none.
extern "C" int qbmx_pt_wide_max_rungs(int n) {
  int M = 0;
  while (M < kMaxChains && smem_bytes(n, M + 1) <= kSmemMax) ++M;
  return M;
}

// Shared-memory bytes of a block of `chains` warps at width n.
extern "C" unsigned long long qbmx_pt_wide_smem(int n, int chains) {
  return (unsigned long long)smem_bytes(n, chains);
}

// Returns the cudaError_t of the launch (0 = success).  J is (G, n, jrow),
// each row padded with zeros to jrow = n rounded up to 4; h (G, B, n);
// betas and dbeta (G*B, M); init01, uniforms and swap_u are all null
// (Philox mode) or all set (host-variate mode); ladders (a block's, its
// rungs a warp each) is the host's geometry; states_out, fields_out,
// energy_out and flips may be null.
extern "C" int qbmx_pt_wide(const float* J, const float* h, const float* betas,
                            const float* dbeta, const float* init01, const float* uniforms,
                            const float* swap_u, float* out, float* states_out,
                            float* fields_out, float* energy_out, unsigned long long* flips,
                            int G, int B, int M, int R, int n, int S, unsigned long long seed,
                            int ladders, void* stream) {
  const bool some = init01 != nullptr || uniforms != nullptr || swap_u != nullptr;
  const bool all = init01 != nullptr && uniforms != nullptr && swap_u != nullptr;
  if (G <= 0 || B <= 0 || M <= 0 || R <= 0 || n <= 0 || S <= 0 || G > 65535 ||
      n > qbmx_pt_wide_max_n() || some != all || ladders < 1 || M > kMaxChains ||
      ladders * M > kMaxChains)
    return (int)cudaErrorInvalidValue;
  const int C = ladders * M;
  const size_t smem = smem_bytes(n, C);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)B * R + ladders - 1) / ladders;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pt_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)blocks, (unsigned)G);
  pt_wide_kernel<<<grid, C * kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      J, h, betas, dbeta, init01, uniforms, swap_u, out, states_out, fields_out, energy_out,
      flips, G, B, M, R, n, S, (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32),
      ladders);
  return (int)cudaGetLastError();
}
