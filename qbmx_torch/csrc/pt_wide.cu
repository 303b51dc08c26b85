// Parallel tempering (replica exchange) with heat-bath sweeps over the
// structured shared-coupling form, for the ladders and couplings that
// pt_heatbath.cu (K3) cannot hold in one block, for NVIDIA Hopper (sm_90a)
// (K5).
//
// Replaces, where K3 cannot hold the call (n > 241, M >= 16 at n = 241, or
// M > 64), the parallel-tempering mode of the TPU kernel of qbmx:
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
// 2.3e10 decisions) J_g is 2.06 MB, nine times a block's shared memory,
// but 98% zeros: 10,100 nonzeros, 14 a row on average and 40 at most.
// Each rung is a sequential chain of n·S decisions, and a third of them
// change a variable, so the time goes to what a change costs and to what a
// rung waits on.  A rung is a warp, with its n incremental fields f = h +
// J·s and its state (a byte a variable) in shared memory, refreshed every
// kRefreshPeriod-th sweep; its 32 lanes draw the next 32 thresholds at
// once.  Two paths share that design; samplers/pt_wide_cuda.py picks one
// by size:
//   * the sparse path (pt_wide_kernel<true>) holds J_g's nonzero rows --
//     fp32 values, 16-bit columns in increasing order, row offsets, built
//     by the wrapper, 61 KB at CDQBM (a) -- whole in shared memory for all
//     S sweeps, beside the block's rungs.  A decision reads f_i; a change
//     has the warp's lanes add d·J_ij to the fields of the row's nonzeros
//     only (two passes at most at CDQBM (a)), where a dense row would take
//     717.  No barrier but the exchange's, one a sweep.  It takes a call
//     when the row lists fit a block beside its rungs;
//   * the dense path (pt_wide_kernel<false>) streams J_g through shared
//     memory in 8-row tiles double-buffered with cp.async, with the tile's
//     fields in registers (anneal_tiles.cuh, K4's machinery): two block
//     barriers a tile, and each change adds a whole row.  It holds random
//     dense QUBOs up to n = 3368 and ladders up to 8 blocks of rungs; the
//     host's rule gives it n <= 1416, where a block holds 20 rungs;
//   * the global path (pt_global_kernel) takes the rest: n > 1416 off the
//     sparse path, or a ladder longer than a portable cluster of
//     dense-path blocks holds.
//     Each state's fields and state bytes live in scratch buffers in
//     global memory, with K4's global-field layout (anneal_tiles.cuh's
//     sweep_global: windows of 128 rows, the window's changes added to the
//     other fields by the dense pass or, where J_g is sparse, by the sparse
//     pass over J_g's row lists; the dense path's fields bit for bit), and a
//     ladder may spread over any number of blocks.  So an exchange round needs every
//     block's energies: the wrapper launches the kernel once a sweep, S + 1
//     launches a call.  Launch t takes the exchanges of round t-1 (from the
//     energies launch t-1 wrote, at slots double-buffered by parity), then
//     sweep t, then writes each state's energy at its rung's slot and its
//     rung; launch S takes round S-1 and writes the outputs.  (A
//     cooperative launch with a grid-wide barrier would need the whole
//     grid co-resident, 4,224 warps on the card, where a training call
//     holds 32,000 states.)
//
// Fields.  Both paths compute the same fields, bit for bit (a zero's sign
// aside, which no comparison sees).  Between refreshes a change of
// variable i adds f_j = fmaf(d, J_ij, f_j) in the order of the decisions:
// the dense path does so for every j, and fmaf(d, 0, f_j) is f_j exactly,
// so the sparse path's adds of the nonzeros alone leave the same values.
// A refresh recomputes f_i just before its decision in K4's order: lane l
// sums, in increasing j, the J_ij with s_j = 1 of the columns j with
// (j / 4) % 32 == l, a butterfly adds the lanes' sums, then h_i; the dense
// path adds zeros besides, which change nothing, and the sparse path scans
// the row's nonzeros for its lane's columns.  So on the same inputs the two
// paths take the same decisions and end in the same states, fields and
// energies (tests/test_torch_cuda.py and chip_smoke.py check it), and
// wide_cuda.field_drift_bound and pt_wide_cuda.energy_drift_bound hold for
// both.
//
// Ladders and blocks.  A block holds L whole ladders of one group (L·M <=
// 32 warps), so that a ladder's exchanges need only the block's barrier;
// at the CDQBM (a) call L = 4, 1,000 blocks of 32 warps.  A ladder of more
// rungs than a block holds (M > 32, or fewer where shared memory ends)
// spreads over a thread block cluster of K blocks (K <= 8, the portable
// size; the host chooses), each holding a run of ceil(M/K) rungs, a warp
// each: its rungs' energies sit in the shared memory of the block that
// holds the rung's slot, written and read through distributed shared
// memory (cooperative_groups' map_shared_rank), and the cluster's barrier
// takes the block's place.  Warps past a ladder's last rung (a cluster's
// last block) and the last block's spare ladders write nothing.
//
// Temperatures, not states, are exchanged, as in K3: a warp keeps its
// state and fields for the whole run and carries rho, the rung it sits at;
// it draws that rung's numbers (Philox counter and host slot p*M + rho) at
// betas[p, rho], so the trajectories are the plain version's, and no state
// moves.  After each sweep every state's energy is recomputed from its
// fields, E = sum_i s_i (h_i + f_i) / 2 (lane l sums variables i = l mod 32
// in increasing order, then a butterfly), so it carries only the fields'
// drift and one sum's rounding.  Each state writes its energy at its rung's
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
// <= 4092) where K3 has 8 (n <= 1020); the global path takes the shift
// from the wrapper (10, or more past n = 4092: pt_wide_cuda.var_shift):
// qbmx_torch/samplers/sa_torch.py::pt_philox_variates(..., var_shift=...)
// writes them out.  With non-null pointers init01 (G*B*M,R,n), uniforms
// (S,G*B*M,n,R) and swap_u (S,G*B*M,R), slot p*M+m, come from the host.
// Optional outputs, null on the main path, each at the slot p*M + rho of
// the rung a state ends at: states_out (G*B*M,R,n) every rung's state,
// fields_out (G*B*M,R,n) its fields, energy_out (G*B*M,R) its energy; and
// flips, two counters: the variables changed and the nonzeros of their
// rows, the work of the changes (for chip_smoke.py's drift check and
// bound).
//
// Build without --use_fast_math (anneal_rules.cuh).

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "anneal_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

using qbmx::global_layout_of;
using qbmx::GlobalLayout;
using qbmx::GlobalSmem;
using qbmx::heatbath_threshold;
using qbmx::kInitTag;
using qbmx::kLanes;
using qbmx::kRows;
using qbmx::Layout;
using qbmx::layout_of;
using qbmx::load_diag;
using qbmx::load_tile;
using qbmx::offsets_len;
using qbmx::philox4x32_10;
using qbmx::RowLists;
using qbmx::sweep_global;
using qbmx::sweep_tiles;
using qbmx::SweepUniforms;
using qbmx::uniform_of;
using qbmx::word;

constexpr int kMaxWarps = 32;        // rungs a block, a warp each: 1024 threads
constexpr int kMaxCluster = 8;       // blocks a ladder: the portable cluster size
constexpr size_t kSmemMax = 232448;  // a block's shared memory on Hopper
constexpr int kRefreshPeriod = 64;   // K4's: the wrappers' field_drift_bound assumes it
constexpr int kHeatBath = 1;         // anneal_tiles.cuh's rule 1: single-variable heat-bath
constexpr int kVarShift = 10;        // Philox counter y = (rung << 10) | variable/4
constexpr unsigned kFull = 0xFFFFFFFFu;

// A group's row lists in shared memory: nnz_pad values (a multiple of 8),
// the offsets, nnz_pad 16-bit columns; a multiple of 16 bytes.
__host__ __device__ inline size_t list_bytes(int n, int nnz_pad) {
  return 6 * (size_t)nnz_pad + 4 * (size_t)offsets_len(n);
}

// The rows of a block of `warps` rungs: K4's fields and state bytes, then
// two energies a warp (by sweep parity).
__host__ __device__ inline size_t rung_bytes(int n, int warps) {
  const Layout L = layout_of(n);
  return 4 * (size_t)warps * (L.frow + L.words()) + 8 * (size_t)warps;
}

// A block's shared memory: two J tiles (dense path) or the row lists
// (sparse path), then the rung rows.
__host__ __device__ inline size_t dense_smem(int n, int warps) {
  return 4 * (size_t)2 * kRows * layout_of(n).jrow + rung_bytes(n, warps);
}

__host__ __device__ inline size_t sparse_smem(int n, int warps, int nnz_pad) {
  return list_bytes(n, nnz_pad) + rung_bytes(n, warps);
}

// Warps a block of the dense path holds at width n (at most 32).
int dense_block_rungs(int n) {
  int W = 0;
  while (W < kMaxWarps && dense_smem(n, W + 1) <= kSmemMax) ++W;
  return W;
}

struct Args {
  const float *J, *h, *betas, *dbeta, *init01, *uniforms, *swap_u;
  float *out, *states_out, *fields_out, *energy_out;
  unsigned long long* flips;  // [variables changed, nonzeros of their rows]
  const int* row_nnz;         // dense path: J_g's nonzeros a row (G, n), with flips
  const float* vals;          // sparse path: the row lists (G, nnz_pad), (G, offsets_len(n))
  const uint16_t* cols;
  const int* offsets;
  int G, B, M, R, n, S;
  uint32_t seed_lo, seed_hi;
  int ladders;  // whole ladders a block (cluster 1)
  int cluster;  // blocks a ladder (ladders 1 when above 1)
  int warps;    // a block's warps: ladders·M, or ceil(M / cluster)
  int nnz_pad;  // sparse path: entries a group's row lists hold
};

// Rung m's uniform for the swap of link (m, m+1) at sweep t (the variable
// block's shift: kVarShift, or the global path's).
__device__ __forceinline__ float swap_uniform(const float* swap_u, size_t GBM, size_t slot0,
                                              int m, int R, int r, int t, uint2 key,
                                              uint32_t seed_hi, int shift = kVarShift) {
  if (swap_u != nullptr) return swap_u[((size_t)t * GBM + slot0 + m) * R + r];
  const uint32_t tag = (1u << shift) - 1;
  const uint4 w = philox4x32_10(
      make_uint4((uint32_t)r, ((uint32_t)(m >> 2) << shift) | tag, (uint32_t)t, seed_hi), key);
  return uniform_of(word(w, m & 3));
}

// `bytes` (a multiple of 16) from global to shared memory as asynchronous
// 16-byte copies by the block's threads.
__device__ __forceinline__ void copy_async(void* dst, const void* src, size_t bytes) {
  float4* d = reinterpret_cast<float4*>(dst);
  const float4* s = reinterpret_cast<const float4*>(src);
  for (size_t q = threadIdx.x; q < bytes / 16; q += blockDim.x)
    __pipeline_memcpy_async(d + q, s + q, sizeof(float4));
}

// One heat-bath sweep of a rung (a warp) on J_g's row lists in shared
// memory (vals, cols, offs: row i's nonzeros are entries offs[i] ..
// offs[i+1]-1, columns increasing).  Lane l draws the threshold of
// variable base + l of each batch of 32 and holds its state bit; a
// decision reads f_i (recomputed first in a refresh sweep, in K4's order:
// see the header); a change flips the batch's bit, writes the state byte
// and adds d·J_ij to f_j over the row's nonzeros, lane l taking entries l,
// l+32, ... (distinct columns: no two lanes write one field).  Adds to
// `changed` and, where COUNT, to `work` (the nonzeros of the changed rows).
template <bool COUNT>
__device__ __forceinline__ void sparse_sweep(const float* vals, const uint16_t* cols,
                                             const int* offs, int n, bool refresh, float beta,
                                             SweepUniforms& u, float* fr, unsigned char* sb,
                                             int lane, const float* hp, int& changed,
                                             unsigned long long& work) {
  for (int base = 0; base < n; base += kLanes) {
    float mine = 0.0f;
    bool s_lane = false;
    if (base + lane < n) {
      mine = heatbath_threshold(u(base + lane), beta);
      s_lane = sb[base + lane] != 0;
    }
    uint32_t bits = __ballot_sync(kFull, s_lane);  // the batch's states
    const int count = min(kLanes, n - base);
    for (int k = 0; k < count; ++k) {
      const int i = base + k;
      const float v = __shfl_sync(kFull, mine, k);
      float f;
      if (refresh) {
        float acc = 0.0f;
        const int e1 = offs[i + 1];
        for (int e = offs[i]; e < e1; ++e) {
          const int j = cols[e];
          if (((j >> 2) & (kLanes - 1)) == lane && sb[j] != 0) acc += vals[e];
        }
#pragma unroll
        for (int d = 1; d < kLanes; d <<= 1) acc += __shfl_xor_sync(kFull, acc, d);
        f = hp[i] + acc;
        if (lane == 0) fr[i] = f;
        __syncwarp();  // every lane sees f_i before a later change adds to it
      } else {
        f = fr[i];
      }
      const bool o = f < v;
      if (o != (((bits >> k) & 1u) != 0u)) {  // the same on the warp's lanes
        bits ^= 1u << k;
        if (lane == 0) sb[i] = o ? 0xFF : 0x00;
        const float d = o ? 1.0f : -1.0f;
        const int e0 = offs[i], e1 = offs[i + 1];
        for (int e = e0 + lane; e < e1; e += kLanes) {
          const int j = cols[e];
          fr[j] = fmaf(d, vals[e], fr[j]);
        }
        ++changed;
        if constexpr (COUNT) work += (unsigned long long)(e1 - e0);
        __syncwarp();  // ... and sees the new fields and state before the next decision
      }
    }
  }
}

// COUNT: the build that also counts the nonzeros of the changed rows (flips
// set, for checks); the main path launches the other.
template <bool SPARSE, bool COUNT>
__global__ void __launch_bounds__(kMaxWarps * kLanes) pt_wide_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, M = a.M, R = a.R, W = a.warps, K = a.cluster;
  const Layout L = layout_of(n);
  // dense path: two J tiles; sparse path: values, offsets, columns
  float* tiles = reinterpret_cast<float*>(smem);
  float* vals = reinterpret_cast<float*>(smem);
  int* offs = reinterpret_cast<int*>(smem + 4 * (size_t)a.nnz_pad);
  uint16_t* cols = reinterpret_cast<uint16_t*>(offs + offsets_len(n));
  float* field_rows = reinterpret_cast<float*>(
      smem + (SPARSE ? list_bytes(n, a.nnz_pad) : 4 * (size_t)2 * kRows * L.jrow));
  uint32_t* state = reinterpret_cast<uint32_t*>(field_rows + (size_t)W * L.frow);
  float* energy = reinterpret_cast<float*>(state + (size_t)W * L.words());  // [parity][warp]

  const int g = blockIdx.y;
  const int c = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int rank = K > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int slot = K > 1 ? 0 : c / M;    // the ladder's slot in the block
  const int m0 = K > 1 ? rank * W + c : c % M;  // the rung the warp starts at
  const long long ladders = (long long)a.B * R;
  const long long ladder =
      K > 1 ? (long long)(blockIdx.x / K) : (long long)blockIdx.x * a.ladders + slot;
  // a warp past its ladder's last rung, or in the last block's spare
  // ladders, takes part in the barriers and writes nothing; on the dense
  // path it also sweeps a copy of a rung, for the tile loop's barriers
  const bool active = ladder < ladders && m0 < M;
  const long long q = ladder < ladders ? ladder : ladders - 1;
  const int b = (int)(q / R);
  const int r = (int)(q % R);
  const size_t p = (size_t)g * a.B + b;  // problem id
  const size_t GBM = (size_t)a.G * a.B * M;
  const size_t slot0 = p * M;  // host slot of the problem's rung 0
  const uint2 key = make_uint2(a.seed_lo, (uint32_t)p);
  const bool host = a.uniforms != nullptr;
  const float* Jg = SPARSE ? nullptr : a.J + (size_t)g * n * L.jrow;
  const float* hp = a.h + p * n;
  const int* nnz = a.row_nnz == nullptr ? nullptr : a.row_nnz + (size_t)g * n;

  // the barrier of the exchange: the block's, or the cluster's where the
  // ladder spans blocks (release and acquire: the energies written before
  // it are read after it)
  auto barrier = [&]() {
    if (K > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
  };
  // rung m's energy slot at sweep parity par: in this block, or in the
  // shared memory of the cluster block that holds rung m's run
  auto energy_slot = [&](int par, int m) -> float* {
    if (K == 1) return energy + par * W + slot * M + m;
    return cg::this_cluster().map_shared_rank(energy + par * W + m % W, m / W);
  };

  if constexpr (SPARSE) {  // the group's row lists, once for all S sweeps
    copy_async(vals, a.vals + (size_t)g * a.nnz_pad, 4 * (size_t)a.nnz_pad);
    copy_async(offs, a.offsets + (size_t)g * offsets_len(n), 4 * (size_t)offsets_len(n));
    copy_async(cols, a.cols + (size_t)g * a.nnz_pad, 2 * (size_t)a.nnz_pad);
    __pipeline_commit();
  }
  for (int k = threadIdx.x; k < W * (L.frow + L.words()); k += blockDim.x) field_rows[k] = 0.0f;
  if constexpr (SPARSE) __pipeline_wait_prior(0);
  // the rows are zeroed and the lists in place; in a cluster, every block
  // has started before any reads another's shared memory
  barrier();
  float* fr = field_rows + (size_t)c * L.frow;
  uint32_t* st = state + c * L.words();
  unsigned char* sb = reinterpret_cast<unsigned char*>(st);
  int rho = m0 < M ? m0 : M - 1;  // the rung this warp's state sits at
  for (int i = lane; i < n; i += kLanes) {
    bool bit;
    if (host) {
      bit = a.init01[((slot0 + rho) * R + r) * n + i] != 0.0f;
    } else {
      const uint4 bits = philox4x32_10(
          make_uint4((uint32_t)r, ((uint32_t)rho << kVarShift) | (uint32_t)(i >> 2), kInitTag,
                     a.seed_hi),
          key);
      bit = (word(bits, i & 3) & 1u) != 0u;
    }
    sb[i] = bit ? 0xFF : 0x00;
  }
  __syncwarp();

  const size_t u_sweep = GBM * n * R;  // uniforms per sweep
  int changed = 0;
  unsigned long long work = 0;  // the nonzeros of the changed variables' rows
  float e = 0.0f;               // the state's energy after the last sweep
  int buf = 0;
  if constexpr (!SPARSE) {
    load_tile(tiles, Jg, 0, n, L.jrow);
    __pipeline_commit();
  }
  for (int t = 0; t < a.S; ++t) {
    SweepUniforms u{host ? a.uniforms + (size_t)t * u_sweep + (slot0 + rho) * n * R + r : nullptr,
                    R, key, (uint32_t)r, (uint32_t)t, a.seed_hi, (uint32_t)rho << kVarShift};
    const bool refresh = t % kRefreshPeriod == 0;
    const float beta = a.betas[slot0 + rho];
    if constexpr (SPARSE) {
      if (active)
        sparse_sweep<COUNT>(vals, cols, offs, n, refresh, beta, u, fr, sb, lane, hp, changed,
                            work);
    } else {  // every warp takes part: the tile loop has block barriers
      unsigned sweep_work = 0;  // at most n² a sweep
      changed += sweep_tiles<kHeatBath, COUNT>(tiles, buf, Jg, L, n, t + 1 == a.S, refresh, beta,
                                               u, fr, st, lane, hp, nnz, sweep_work);
      work += sweep_work;
    }
    // the warp's fields and state bytes are in place for all its lanes; with
    // one rung (no link) only the last sweep's energy is read (energy_out)
    if (active && (M > 1 || t + 1 == a.S)) {
      e = 0.0f;
      for (int i = lane; i < n; i += kLanes)
        if (sb[i]) e += hp[i] + fr[i];
      // a butterfly: every lane adds the same two partial sums at every level
#pragma unroll
      for (int d = 1; d < kLanes; d <<= 1) e += __shfl_xor_sync(kFull, e, d);
      e *= 0.5f;
    }
    if (M == 1) continue;
    if (active && lane == 0) *energy_slot(t & 1, rho) = e;
    barrier();
    // the link of this sweep's parity that holds rung rho, if any
    const int lo = (rho & 1) == (t & 1) ? rho : rho - 1;
    if (active && lo >= 0 && lo + 1 < M) {
      const float usw = swap_uniform(a.swap_u, GBM, slot0, lo, R, r, t, key, a.seed_hi);
      if (a.dbeta[slot0 + lo] * (*energy_slot(t & 1, lo) - *energy_slot(t & 1, lo + 1)) <
          -logf(usw))
        rho = rho == lo ? lo + 1 : lo;
    }
  }
  // no block of a cluster leaves while another may still read its energies
  if (K > 1) cg::this_cluster().sync();

  if (active) {
    if (rho == M - 1) {
      float* op = a.out + (p * R + r) * n;
      for (int i = lane; i < n; i += kLanes) op[i] = sb[i] ? 1.0f : 0.0f;
    }
    const size_t row = ((slot0 + rho) * R + r) * n;
    if (a.states_out != nullptr)
      for (int i = lane; i < n; i += kLanes) a.states_out[row + i] = sb[i] ? 1.0f : 0.0f;
    if (a.fields_out != nullptr)
      for (int i = lane; i < n; i += kLanes) a.fields_out[row + i] = fr[i];
    if (a.energy_out != nullptr && lane == 0) a.energy_out[(slot0 + rho) * R + r] = e;
    if (a.flips != nullptr && lane == 0 && changed != 0) {
      atomicAdd(a.flips, (unsigned long long)changed);
      atomicAdd(a.flips + 1, work);
    }
  }
}

// The global path's arguments: those of the other paths' Args that it
// reads, its scratch and the sweep t this launch takes (t = S: the last
// exchanges and the outputs).
struct GArgs {
  const float *J, *h, *betas, *dbeta, *init01, *uniforms, *swap_u;
  float *out, *states_out, *fields_out, *energy_out;
  unsigned long long* flips;
  const int* row_nnz;
  const float* vals;  // J_g's row lists: the sparse pass (null: the dense pass)
  const uint16_t* cols;
  const int* offsets;
  int nnz_pad;
  float* fields;      // (G*B*R*M, frow) the states' fields
  uint32_t* state;    // (G*B*R*M, frow / 4) their state words
  float* energies;    // (2, G*B*R*M): [parity][(g*B*R + ladder)*M + rung]
  int* rho;           // (G*B*R*M) the rung each state sits at
  int G, B, M, R, n, S, t;
  uint32_t seed_lo, seed_hi;
  int warps;          // states a block, a warp each
  int var_shift;      // Philox counter y = (rung << var_shift) | variable/4
};

// One launch of the global path (header): state k = (b·R + r)·M + m0 of
// group g, a warp, holds the ladder (b, r)'s state that started at rung m0;
// its scratch row, rung and energy slots are indexed by g·B·R·M + k.
// SPARSE: the sparse pass on the group's row lists, else the dense pass.
template <bool SPARSE, bool COUNT>
__global__ void __launch_bounds__(kMaxWarps * kLanes) pt_global_kernel(const GArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, M = a.M, R = a.R, t = a.t;
  const GlobalLayout L = global_layout_of(n);

  const int g = blockIdx.y;
  const int c = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const GlobalSmem sm = GlobalSmem::of(smem, a.warps, c, SPARSE);
  const long long states = (long long)a.B * R * M;  // a group's
  const long long k = (long long)blockIdx.x * a.warps + c;
  // the last block's spare warps take part in the loads and barriers only
  const bool active = k < states;
  const long long kk = active ? k : states - 1;
  const long long ladder = kk / M;  // b·R + r
  const int m0 = (int)(kk % M);
  const int b = (int)(ladder / R), r = (int)(ladder % R);
  const size_t p = (size_t)g * a.B + b;  // problem id
  const size_t GBM = (size_t)a.G * a.B * M;
  const size_t slot0 = p * M;  // host slot of the problem's rung 0
  const size_t id = (size_t)g * states + kk;
  const size_t rungs0 = (size_t)g * states + (size_t)ladder * M;  // the ladder's rung 0 slot
  const size_t all = (size_t)a.G * states;
  const uint2 key = make_uint2(a.seed_lo, (uint32_t)p);
  const bool host = a.uniforms != nullptr;
  float* fr = a.fields + id * L.frow;
  uint32_t* st = a.state + id * L.words();
  unsigned char* sb = reinterpret_cast<unsigned char*>(st);
  const float* hp = a.h + p * n;

  int rho = t == 0 ? m0 : a.rho[id];
  const int rho_swept = rho;  // the rung of the last sweep's energy
  if (t > 0 && M > 1 && active) {  // the exchanges of round t-1, K5's rule
    const int par = (t - 1) & 1;
    const int lo = (rho & 1) == par ? rho : rho - 1;
    if (lo >= 0 && lo + 1 < M) {
      const float* E = a.energies + par * all + rungs0;
      const float usw =
          swap_uniform(a.swap_u, GBM, slot0, lo, R, r, t - 1, key, a.seed_hi, a.var_shift);
      if (a.dbeta[slot0 + lo] * (E[lo] - E[lo + 1]) < -logf(usw)) rho = rho == lo ? lo + 1 : lo;
    }
  }
  if (t == a.S) {  // the outputs, at the rung each state ends at
    if (active) {
      if (rho == M - 1) {
        float* op = a.out + (p * R + r) * n;
        for (int i = lane; i < n; i += kLanes) op[i] = sb[i] ? 1.0f : 0.0f;
      }
      const size_t row = ((slot0 + rho) * R + r) * n;
      if (a.states_out != nullptr)
        for (int i = lane; i < n; i += kLanes) a.states_out[row + i] = sb[i] ? 1.0f : 0.0f;
      if (a.fields_out != nullptr)
        for (int i = lane; i < n; i += kLanes) a.fields_out[row + i] = fr[i];
      if (a.energy_out != nullptr && lane == 0)
        a.energy_out[(slot0 + rho) * R + r] = a.energies[((a.S - 1) & 1) * all + rungs0 +
                                                         rho_swept];
    }
    return;
  }
  if (t == 0 && active) {
    for (int i = lane; i < n; i += kLanes) {
      bool bit;
      if (host) {
        bit = a.init01[((slot0 + rho) * R + r) * n + i] != 0.0f;
      } else {
        const uint4 bits = philox4x32_10(
            make_uint4((uint32_t)r, ((uint32_t)rho << a.var_shift) | (uint32_t)(i >> 2),
                       kInitTag, a.seed_hi),
            key);
        bit = (word(bits, i & 3) & 1u) != 0u;
      }
      sb[i] = bit ? 0xFF : 0x00;
    }
  }

  const float* Jg = a.J + (size_t)g * n * L.jrow;
  const int* nnz = a.row_nnz == nullptr ? nullptr : a.row_nnz + (size_t)g * n;
  const RowLists rl = SPARSE ? RowLists{a.vals + (size_t)g * a.nnz_pad,
                                        a.cols + (size_t)g * a.nnz_pad,
                                        a.offsets + (size_t)g * offsets_len(n)}
                             : RowLists{nullptr, nullptr, nullptr};
  const size_t u_sweep = GBM * n * R;  // uniforms per sweep
  SweepUniforms u{host ? a.uniforms + (size_t)t * u_sweep + (slot0 + rho) * n * R + r : nullptr,
                  R, key, (uint32_t)r, (uint32_t)t, a.seed_hi, (uint32_t)rho << a.var_shift};
  unsigned work = 0;  // at most n² a sweep
  load_diag(sm.diag, Jg, 0, n, L);
  __pipeline_commit();
  const int changed = sweep_global<kHeatBath, SPARSE, COUNT>(
      sm, Jg, rl, L, n, true, t % kRefreshPeriod == 0, active, a.betas[slot0 + rho], u, fr, st,
      lane, hp, nnz, work);
  if (!active) return;
  // the state's energy, as the other paths sum it; its slot and rung
  float e = 0.0f;
  for (int i = lane; i < n; i += kLanes)
    if (sb[i]) e += hp[i] + fr[i];
#pragma unroll
  for (int d = 1; d < kLanes; d <<= 1) e += __shfl_xor_sync(kFull, e, d);
  if (lane == 0) {
    a.energies[(t & 1) * all + rungs0 + rho] = 0.5f * e;
    a.rho[id] = rho;
    if (a.flips != nullptr && changed != 0) {
      atomicAdd(a.flips, (unsigned long long)changed);
      atomicAdd(a.flips + 1, (unsigned long long)work);
    }
  }
}

// Checks a launch's arguments and geometry; cudaSuccess if they hold.
cudaError_t validate(const Args& a, bool sparse) {
  const bool some = a.init01 != nullptr || a.uniforms != nullptr || a.swap_u != nullptr;
  const bool all = a.init01 != nullptr && a.uniforms != nullptr && a.swap_u != nullptr;
  if (a.G <= 0 || a.B <= 0 || a.M <= 0 || a.R <= 0 || a.n <= 0 || a.S <= 0 || a.G > 65535 ||
      some != all || a.ladders < 1 || a.cluster < 1 || a.cluster > kMaxCluster ||
      (a.row_nnz != nullptr && a.flips == nullptr))
    return cudaErrorInvalidValue;
  if (a.cluster == 1 ? a.warps != a.ladders * a.M
                     : a.ladders != 1 || a.warps != (a.M + a.cluster - 1) / a.cluster ||
                           (a.cluster - 1) * a.warps >= a.M)
    return cudaErrorInvalidValue;
  if (a.warps > kMaxWarps) return cudaErrorInvalidValue;
  if (sparse ? a.nnz_pad <= 0 || a.nnz_pad % 8 != 0 || a.n > 32768 : a.J == nullptr)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <bool SPARSE, bool COUNT>
cudaError_t launch(const Args& a, cudaStream_t stream, bool occupancy_only = false,
                   int* clusters = nullptr) {
  const cudaError_t bad = validate(a, SPARSE);
  if (bad != cudaSuccess) return bad;
  const size_t smem = SPARSE ? sparse_smem(a.n, a.warps, a.nnz_pad) : dense_smem(a.n, a.warps);
  if (smem > kSmemMax || (!SPARSE && dense_block_rungs(a.n) < 1)) return cudaErrorInvalidValue;
  const long long blocks = a.cluster > 1 ? (long long)a.B * a.R * a.cluster
                                         : ((long long)a.B * a.R + a.ladders - 1) / a.ladders;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  void (*kernel)(const Args) = pt_wide_kernel<SPARSE, COUNT>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, (unsigned)a.G);
  cfg.blockDim = dim3((unsigned)(a.warps * kLanes));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (a.cluster > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)a.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  if (occupancy_only) return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// Largest n the kernel takes: two J tiles and one rung's fields, state and
// energies must fit one block's shared memory (K4's bound, 3368).
extern "C" int qbmx_pt_wide_max_n() {
  int n = 1;
  while (dense_smem(n + 1, 1) <= kSmemMax) ++n;
  return n;
}

// Rungs a block of the dense path holds at width n (a warp each, at most
// 32, within shared memory); 0 if none.
extern "C" int qbmx_pt_wide_block_rungs(int n) { return dense_block_rungs(n); }

// Largest ladder the kernel takes at width n under the host's rule: the
// dense path's rungs a block over a portable cluster of 8 blocks; 0 if none.
extern "C" int qbmx_pt_wide_max_rungs(int n) {
  return n > qbmx_pt_wide_max_n() ? 0 : dense_block_rungs(n) * kMaxCluster;
}

// Rungs a block of the sparse path holds at width n beside row lists of
// nnz_pad entries; 0 if none.
extern "C" int qbmx_pt_wide_sparse_block_rungs(int n, int nnz_pad) {
  int W = 0;
  while (W < kMaxWarps && sparse_smem(n, W + 1, nnz_pad) <= kSmemMax) ++W;
  return W;
}

// Shared-memory bytes of a block of `warps` warps at width n: the dense
// path's, and the sparse path's beside row lists of nnz_pad entries.
extern "C" unsigned long long qbmx_pt_wide_smem(int n, int warps) {
  return (unsigned long long)dense_smem(n, warps);
}

extern "C" unsigned long long qbmx_pt_wide_sparse_smem(int n, int warps, int nnz_pad) {
  return (unsigned long long)sparse_smem(n, warps, nnz_pad);
}

// How many clusters of `cluster` blocks of a ladder of M rungs the card
// holds at once at width n (cudaOccupancyMaxActiveClusters; 0: a cluster
// of that size does not fit), for the dense path (nnz_pad 0) or the
// sparse one; a negative cudaError_t if the query fails.
extern "C" int qbmx_pt_wide_max_active_clusters(int n, int M, int cluster, int nnz_pad) {
  Args a{};
  a.G = a.B = a.R = a.S = 1;
  a.n = n;
  a.M = M;
  a.ladders = 1;
  a.cluster = cluster;
  a.warps = (M + cluster - 1) / cluster;
  a.nnz_pad = nnz_pad;
  a.J = reinterpret_cast<const float*>(&a);  // never read: the query launches nothing
  int clusters = 0;
  const cudaError_t e = nnz_pad > 0 ? launch<true, false>(a, nullptr, true, &clusters)
                                    : launch<false, false>(a, nullptr, true, &clusters);
  return e == cudaSuccess ? clusters : -(int)e;
}

// Returns the cudaError_t of the launch (0 = success).  The dense path: J
// is (G, n, jrow), each row padded with zeros to jrow = n rounded up to 4;
// row_nnz (G, n) J_g's nonzeros a row, null unless flips.  h (G, B, n);
// betas and dbeta (G*B, M); init01, uniforms and swap_u are all null
// (Philox mode) or all set (host-variate mode); ladders (whole ladders a
// block) and cluster (blocks a ladder, ladders 1 when above 1) are the
// host's geometry; states_out, fields_out, energy_out and flips (two
// counters) may be null.
extern "C" int qbmx_pt_wide(const float* J, const int* row_nnz, const float* h,
                            const float* betas, const float* dbeta, const float* init01,
                            const float* uniforms, const float* swap_u, float* out,
                            float* states_out, float* fields_out, float* energy_out,
                            unsigned long long* flips, int G, int B, int M, int R, int n, int S,
                            unsigned long long seed, int ladders, int cluster, void* stream) {
  if (n <= 0 || n > qbmx_pt_wide_max_n() || cluster < 1) return (int)cudaErrorInvalidValue;
  Args a{J, h, betas, dbeta, init01, uniforms, swap_u, out, states_out, fields_out, energy_out,
         flips, row_nnz, nullptr, nullptr, nullptr, G, B, M, R, n, S,
         (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32), ladders, cluster,
         cluster == 1 ? ladders * M : (M + cluster - 1) / cluster, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(flips != nullptr && row_nnz != nullptr ? launch<false, true>(a, st)
                                                   : launch<false, false>(a, st));
}

// Shared-memory bytes of a block of the global path of `warps` warps (any
// n), with the sparse pass or the dense one.
extern "C" unsigned long long qbmx_pt_wide_global_smem(int warps, int sparse) {
  return (unsigned long long)global_layout_of(1).smem(warps, sparse != 0);
}

// The global path: S + 1 launches of pt_global_kernel on the stream
// (header).  J is (G, n, jrow), rows padded with zeros to jrow = n rounded
// up to 8; vals, cols and offsets, all null or all set (n <= 32768), select
// the sparse pass (qbmx_pt_wide_sparse's row lists of nnz_pad entries a
// group); row_nnz as qbmx_pt_wide's; fields (G*B*R*M, jrow) float32 and
// state (G*B*R*M, jrow) bytes, both 16-byte aligned; energies (2, G*B*R*M)
// float32 and rho (G*B*R*M) int32 scratch; warps the states a block (at
// most 32); var_shift the Philox counter's variable-block bits (10 to 22,
// with ceil(n / 4) <= 2^var_shift - 1 and M <= 2^(32 - var_shift)).  The other
// arguments as qbmx_pt_wide's.
extern "C" int qbmx_pt_wide_global(const float* J, const int* row_nnz, const float* h,
                                   const float* betas, const float* dbeta, const float* init01,
                                   const float* uniforms, const float* swap_u, float* out,
                                   float* states_out, float* fields_out, float* energy_out,
                                   unsigned long long* flips, float* fields, void* state,
                                   float* energies, int* rho, const float* vals,
                                   const int16_t* cols, const int* offsets, int nnz_pad, int G,
                                   int B, int M, int R, int n, int S, unsigned long long seed,
                                   int warps, int var_shift, void* stream) {
  const bool some = init01 != nullptr || uniforms != nullptr || swap_u != nullptr;
  const bool all = init01 != nullptr && uniforms != nullptr && swap_u != nullptr;
  const bool lists = vals != nullptr || cols != nullptr || offsets != nullptr;
  const bool sparse = vals != nullptr && cols != nullptr && offsets != nullptr;
  const long long states = (long long)B * R * M;
  if (G <= 0 || B <= 0 || M <= 0 || R <= 0 || n <= 0 || S <= 0 || G > 65535 || some != all ||
      J == nullptr || fields == nullptr || state == nullptr || energies == nullptr ||
      rho == nullptr || warps < 1 || warps > kMaxWarps || var_shift < kVarShift ||
      var_shift > 22 || (long long)((n + 3) / 4) > (1ll << var_shift) - 1 ||
      (long long)M > (1ll << (32 - var_shift)) ||
      (reinterpret_cast<uintptr_t>(fields) | reinterpret_cast<uintptr_t>(state)) % 16 != 0 ||
      (row_nnz != nullptr && flips == nullptr) || lists != sparse ||
      (sparse && (n > 32768 || nnz_pad <= 0)))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (states + warps - 1) / warps;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = global_layout_of(n).smem(warps, sparse);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const bool count = flips != nullptr && row_nnz != nullptr;
  void (*kernel)(const GArgs) =
      sparse ? (count ? pt_global_kernel<true, true> : pt_global_kernel<true, false>)
             : (count ? pt_global_kernel<false, true> : pt_global_kernel<false, false>);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  GArgs a{J, h, betas, dbeta, init01, uniforms, swap_u, out, states_out, fields_out,
          energy_out, flips, row_nnz, vals, reinterpret_cast<const uint16_t*>(cols), offsets,
          nnz_pad, fields, static_cast<uint32_t*>(state), energies, rho, G, B, M, R, n, S, 0,
          (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32), warps, var_shift};
  const dim3 grid((unsigned)blocks, (unsigned)G);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int t = 0; t <= S; ++t) {
    a.t = t;
    kernel<<<grid, warps * kLanes, smem, st>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// The sparse path: vals (G, nnz_pad) float32 and cols (G, nnz_pad) 16-bit
// columns, each group's nonzeros of J_g row by row in increasing column
// order, zero-padded; offsets (G, n+1 rounded up to 4) int32, row i's
// entries at offsets[g, i] .. offsets[g, i+1]-1; all three 16-byte aligned.
// The other arguments as qbmx_pt_wide's.
extern "C" int qbmx_pt_wide_sparse(const float* vals, const int16_t* cols, const int* offsets,
                                   const float* h, const float* betas, const float* dbeta,
                                   const float* init01, const float* uniforms,
                                   const float* swap_u, float* out, float* states_out,
                                   float* fields_out, float* energy_out,
                                   unsigned long long* flips, int G, int B, int M, int R, int n,
                                   int S, unsigned long long seed, int nnz_pad, int ladders,
                                   int cluster, void* stream) {
  if (n <= 0 || cluster < 1 || vals == nullptr || cols == nullptr || offsets == nullptr ||
      (reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(cols) |
       reinterpret_cast<uintptr_t>(offsets)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Args a{nullptr, h, betas, dbeta, init01, uniforms, swap_u, out, states_out, fields_out,
         energy_out, flips, nullptr, vals, reinterpret_cast<const uint16_t*>(cols), offsets,
         G, B, M, R, n, S, (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32), ladders,
         cluster, cluster == 1 ? ladders * M : (M + cluster - 1) / cluster, nnz_pad};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(flips != nullptr ? launch<true, true>(a, st) : launch<true, false>(a, st));
}
