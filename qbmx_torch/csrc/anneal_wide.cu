// Annealing over the structured shared-coupling form for QUBOs whose
// couplings do not fit one block's shared memory, for NVIDIA Hopper
// (sm_90a): the Metropolis rule and the heat-bath rule at update widths 1,
// 2 and 4 (K4).
//
// Replaces, above n = 241 (where sa_metropolis.cu (K1) and sa_heatbath.cu
// (K2) stage J_g whole in shared memory), both TPU kernels of qbmx:
//   * qbmx/samplers/sa_lane.py   _lane_kernel (entry lane_sample_groups,
//     Metropolis and heat-bath single/pair), which takes n up to 1072 at the
//     CDQBM step's call shape (G=2, B=20, R=100);
//   * qbmx/samplers/sa_pallas.py _sa_kernel   (entries sa_sample_batch_pallas
//     and gibbs_sample_batch_pallas, single/pair/quad), which packs n up to
//     ~1088 at one problem per pack -- here a dense batch is G = B groups of
//     one problem.
// The semantics are K1's and K2's (schedule, thresholds, update rules from
// anneal_rules.cuh, Philox streams, host-variate layout); only the rounding
// of the fields differs (below).
//
// What bounds it on this card.  At the CDQBM probabilistic-pooling shape
// (G=2, B=20, R=100, n=717, S=1000: 4,000 chains, 2.9e9 decisions) J_g is
// 717²·4 B = 2.06 MB, nine times a block's 227 KB of shared memory, so the
// chains of a group share every J read, and each chain is a sequential
// chain of n·S decisions whose latency sets the time:
//   * a block holds C chains of one group, a warp (32 lanes) a chain; C is
//     chosen on the host (samplers/wide_cuda.py::wide_geometry) so that the
//     blocks cover the SMs within shared memory.  At the CDQBM shape: C =
//     31, 130 blocks of 31 warps, ~8 warps per scheduler;
//   * J_g streams through shared memory in tiles of 8 rows, double-buffered
//     with cp.async (16-byte copies from a copy of J_g whose rows the
//     wrapper pads to jrow = n rounded up to 4 floats);
//   * incremental local fields: each chain keeps its n fields
//     f = h + J·s in shared memory beside its state (one byte a variable,
//     0x00 or 0xFF).  A decision reads f_i, O(1); when variables change by
//     d = +/-1, each lane of the chain adds d·J_ij to its float4 chunks of f
//     (chunks q ≡ lane mod 32), with row i from the tile in hand;
//   * every lane also holds the 8 fields and states of the tile in hand in
//     registers and adds a change to the tile's later fields there too, so
//     a decision waits on no shared-memory load and no barrier: within a
//     tile a lane writes only its own chunks and the chain's lane 0 the
//     state bytes, read again after the tile's closing __syncthreads;
//   * the thresholds (Metropolis, heat-bath single) or uniforms (pair,
//     quad) of 32 variables are drawn and computed by the chain's 32 lanes
//     at once before the first's decision and shuffled to the chain when used,
//     so Philox, logf and the division leave the chain of decisions; every
//     lane of the chain takes the same decision from the same values.
//
// Fields, and how far they drift.  At sweep 0 and every kRefreshPeriod-th
// sweep each field is recomputed from the state just before its decision
// (its unit's rows of the tile in hand), in a fixed order: lane l sums, in
// increasing order, the state words w ≡ l (mod 32), each word's four
// variables j = 4w..4w+3 in increasing order, J_ij & mask(s_j) (= J_ij·s_j
// exactly); a butterfly of 5 xor-shuffles adds the lanes' sums (every
// lane gets the same value), and h_i comes last.  Between refreshes, a
// change d of variable i adds f_j = fmaf(d, J_ij, f_j) -- f_j +/- J_ij
// rounded once -- to every field, in the order of the decisions (a pair or
// quad: its rows in increasing order).  So a field carries at most
// kRefreshPeriod·n roundings more than a recomputed one.  K1 and K2 sum
// j = 0..n-1 serially and the plain versions use torch.matmul, so a
// near-tie decision may go the other way in another implementation;
// chip_smoke.py bounds the chains that diverge and the drift.
//
// Random numbers: the streams of K1 and K2 (philox.cuh), keyed by (seed,
// problem id) with the counter over (read, variable/4, sweep), so
// qbmx_torch/samplers/sa_torch.py::philox_variates writes out this kernel's
// draws too.  With non-null pointers the initial state init01 (G,B,R,n) and
// the uniforms (S,G,B,n,R) come from the host.  Optional outputs, null on
// the main path: fields_out (G,B,R,n) the final fields; flips[0] the number
// of variables changed and flips[1] the nonzeros of their rows (row_nnz
// (G,n), J_g's nonzeros a row, from the wrapper), the work a change takes
// on a sparse J (for chip_smoke.py's drift check and bound).
//
// Past n = 1056 (samplers/wide_cuda.py::wide_geometry; the shared layout
// holds up to 3368, but past 1056 a block holds fewer than 31 chains and it
// stops paying) the global-field layout (anneal_global_kernel) keeps each
// chain's fields and state bytes in a scratch buffer in global memory that
// the wrapper allocates, (G*B*R, n rounded up to 8) floats and as many
// state bytes, and walks J_g in windows of 128 rows (anneal_tiles.cuh's
// sweep_global): the window's fields read once into shared memory beside
// its 128x128 diagonal block, the decisions there, then one pass of the
// window's changes onto the chain's other fields in global memory -- the
// dense pass streaming the window's rows of J_g in chunks, or, where J_g is
// sparse (the wrapper's density rule, wide_cuda.sparse_pass), the sparse
// pass over the changed rows' nonzeros from J_g's row lists
// (pt_wide_cuda.row_lists).  The same decisions, fields and streams as the
// shared layout, bit for bit, at any n the card's memory holds.
//
// The tiles, fields and units live in anneal_tiles.cuh, which pt_wide.cu
// (K5, parallel tempering past shared memory) shares.
//
// Build without --use_fast_math (anneal_rules.cuh).

#include <climits>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "anneal_tiles.cuh"

namespace {

using qbmx::global_layout_of;
using qbmx::GlobalLayout;
using qbmx::GlobalSmem;
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
using qbmx::word;

constexpr int kMaxChains = 32;       // chains per block: 1024 threads
constexpr size_t kSmemMax = 232448;  // a block's shared memory on Hopper
// A refresh sweep costs what a sweep cost before the fields were incremental
// (a dot product per variable), so refreshing every 64th sweep adds at most
// 1/64 of that design's time, while a field carries at most 64·n extra
// roundings.  A build may set another period (-DQBMX_K4_REFRESH_PERIOD=1
// recomputes every field before every decision; cli/compare_kernels.py
// builds one to tell the fields' drift from the sum order); the wrappers'
// drift bound assumes 64.
#ifndef QBMX_K4_REFRESH_PERIOD
#define QBMX_K4_REFRESH_PERIOD 64
#endif
constexpr int kRefreshPeriod = QBMX_K4_REFRESH_PERIOD;

// COUNT: the build that also counts the nonzeros of the changed rows
// (row_nnz set, for checks); the main path launches the other.
template <int RULE, bool COUNT>
__global__ void __launch_bounds__(kMaxChains * kLanes)
anneal_wide_kernel(const float* __restrict__ J, const float* __restrict__ h,
                   const float* __restrict__ hot, const float* __restrict__ logr,
                   const float* __restrict__ init01, const float* __restrict__ uniforms,
                   float* __restrict__ out, float* __restrict__ fields_out,
                   unsigned long long* __restrict__ flips, const int* __restrict__ row_nnz,
                   int G, int B, int R, int n, int S, float inv_span, uint32_t seed_lo,
                   uint32_t seed_hi, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout_of(n);
  float* tiles = reinterpret_cast<float*>(smem);
  float* field_rows = tiles + 2 * kRows * L.jrow;
  uint32_t* state = reinterpret_cast<uint32_t*>(field_rows + (size_t)C * L.frow);

  const int g = blockIdx.y;
  const int c = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const long long chains = (long long)B * R;
  const long long chain = (long long)blockIdx.x * C + c;
  const bool active = chain < chains;
  // the last block's spare chains repeat the group's last chain, so that
  // every lane takes part in the shuffles and barriers; they write nothing
  const long long ch = active ? chain : chains - 1;
  const int b = (int)(ch / R);
  const int r = (int)(ch % R);
  const size_t p = (size_t)g * B + b;  // problem id
  const uint2 key = make_uint2(seed_lo, (uint32_t)p);
  const bool host = uniforms != nullptr;
  const float* Jg = J + (size_t)g * n * L.jrow;
  const float* hp = h + p * n;
  const int* nnz = row_nnz == nullptr ? nullptr : row_nnz + (size_t)g * n;

  for (int k = threadIdx.x; k < C * (L.frow + L.words()); k += blockDim.x) field_rows[k] = 0.0f;
  __syncthreads();
  float* fr = field_rows + (size_t)c * L.frow;
  uint32_t* st = state + c * L.words();
  unsigned char* sb = reinterpret_cast<unsigned char*>(st);
  for (int i = lane; i < n; i += kLanes) {
    bool bit;
    if (host) {
      bit = init01[(p * R + r) * n + i] != 0.0f;
    } else {
      const uint4 bits =
          philox4x32_10(make_uint4((uint32_t)r, (uint32_t)(i >> 2), kInitTag, seed_hi), key);
      bit = (word(bits, i & 3) & 1u) != 0u;
    }
    sb[i] = bit ? 0xFF : 0x00;
  }

  const float hot_p = hot[p], logr_p = logr[p];
  const size_t u_sweep = (size_t)G * B * n * R;  // uniforms per sweep
  int changed = 0;
  unsigned long long work = 0;  // the nonzeros of the changed variables' rows
  load_tile(tiles, Jg, 0, n, L.jrow);
  __pipeline_commit();
  int buf = 0;
  for (int t = 0; t < S; ++t) {
    const float beta = hot_p * expf(logr_p * ((float)t * inv_span));
    SweepUniforms u{host ? uniforms + (size_t)t * u_sweep + p * n * R + r : nullptr, R, key,
                    (uint32_t)r, (uint32_t)t, seed_hi};
    unsigned sweep_work = 0;  // at most n² a sweep
    changed += sweep_tiles<RULE, COUNT>(tiles, buf, Jg, L, n, t + 1 == S,
                                        t % kRefreshPeriod == 0, beta, u, fr, st, lane, hp, nnz,
                                        sweep_work);
    work += sweep_work;
  }

  if (active) {
    const size_t row = (p * R + r) * n;
    for (int i = lane; i < n; i += kLanes) out[row + i] = sb[i] ? 1.0f : 0.0f;
    if (fields_out != nullptr)
      for (int i = lane; i < n; i += kLanes) fields_out[row + i] = fr[i];
    if (flips != nullptr && lane == 0 && changed != 0) {
      atomicAdd(flips, (unsigned long long)changed);
      atomicAdd(flips + 1, work);
    }
  }
}

// The kernel in the global-field layout (header): each chain's fields
// (fscr) and state words (sscr) in its row of the scratch buffers, chain
// (g, b·R + r) at row g·B·R + b·R + r; J rows padded to n rounded up to 8;
// SPARSE: the sparse pass on the group's row lists (nnz_pad entries a
// group), else the dense pass.
template <int RULE, bool SPARSE, bool COUNT>
__global__ void __launch_bounds__(kMaxChains * kLanes)
anneal_global_kernel(const float* __restrict__ J, const float* __restrict__ h,
                     const float* __restrict__ hot, const float* __restrict__ logr,
                     const float* __restrict__ init01, const float* __restrict__ uniforms,
                     float* __restrict__ out, float* __restrict__ fields_out,
                     unsigned long long* __restrict__ flips, const int* __restrict__ row_nnz,
                     float* fscr, uint32_t* sscr, const float* __restrict__ vals,
                     const uint16_t* __restrict__ cols, const int* __restrict__ offsets,
                     int nnz_pad, int G, int B, int R, int n, int S, float inv_span,
                     uint32_t seed_lo, uint32_t seed_hi, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const GlobalLayout L = global_layout_of(n);
  const int g = blockIdx.y;
  const int c = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const GlobalSmem sm = GlobalSmem::of(smem, C, c, SPARSE);
  const long long chains = (long long)B * R;
  const long long chain = (long long)blockIdx.x * C + c;
  // the last block's spare chains take part in the loads and barriers only
  const bool active = chain < chains;
  const long long ch = active ? chain : chains - 1;
  const int b = (int)(ch / R);
  const int r = (int)(ch % R);
  const size_t p = (size_t)g * B + b;  // problem id
  const uint2 key = make_uint2(seed_lo, (uint32_t)p);
  const bool host = uniforms != nullptr;
  const float* Jg = J + (size_t)g * n * L.jrow;
  const float* hp = h + p * n;
  const int* nnz = row_nnz == nullptr ? nullptr : row_nnz + (size_t)g * n;
  const RowLists rl = SPARSE ? RowLists{vals + (size_t)g * nnz_pad, cols + (size_t)g * nnz_pad,
                                        offsets + (size_t)g * offsets_len(n)}
                             : RowLists{nullptr, nullptr, nullptr};
  const size_t row_id = (size_t)g * chains + ch;
  float* fr = fscr + row_id * L.frow;
  uint32_t* st = sscr + row_id * L.words();
  unsigned char* sb = reinterpret_cast<unsigned char*>(st);

  if (active) {
    for (int i = lane; i < n; i += kLanes) {
      bool bit;
      if (host) {
        bit = init01[(p * R + r) * n + i] != 0.0f;
      } else {
        const uint4 bits =
            philox4x32_10(make_uint4((uint32_t)r, (uint32_t)(i >> 2), kInitTag, seed_hi), key);
        bit = (word(bits, i & 3) & 1u) != 0u;
      }
      sb[i] = bit ? 0xFF : 0x00;
    }
  }

  const float hot_p = hot[p], logr_p = logr[p];
  const size_t u_sweep = (size_t)G * B * n * R;  // uniforms per sweep
  int changed = 0;
  unsigned long long work = 0;  // the nonzeros of the changed variables' rows
  load_diag(sm.diag, Jg, 0, n, L);
  __pipeline_commit();
  for (int t = 0; t < S; ++t) {
    const float beta = hot_p * expf(logr_p * ((float)t * inv_span));
    SweepUniforms u{host ? uniforms + (size_t)t * u_sweep + p * n * R + r : nullptr, R, key,
                    (uint32_t)r, (uint32_t)t, seed_hi};
    unsigned sweep_work = 0;  // at most n² a sweep
    changed += sweep_global<RULE, SPARSE, COUNT>(sm, Jg, rl, L, n, t + 1 == S,
                                                 t % kRefreshPeriod == 0, active, beta, u, fr,
                                                 st, lane, hp, nnz, sweep_work);
    work += sweep_work;
  }

  if (active) {
    const size_t row = (p * R + r) * n;
    for (int i = lane; i < n; i += kLanes) out[row + i] = sb[i] ? 1.0f : 0.0f;
    if (fields_out != nullptr)
      for (int i = lane; i < n; i += kLanes) fields_out[row + i] = fr[i];
    if (flips != nullptr && lane == 0 && changed != 0) {
      atomicAdd(flips, (unsigned long long)changed);
      atomicAdd(flips + 1, work);
    }
  }
}

struct Args {
  const float *J, *h, *hot, *logr, *init01, *uniforms;
  float *out, *fields_out;
  unsigned long long* flips;
  const int* row_nnz;
  float* fscr;      // the global-field layout's scratch (null: the shared layout)
  uint32_t* sscr;
  const float* vals;      // J_g's row lists: the sparse pass (null: the dense pass)
  const uint16_t* cols;
  const int* offsets;
  int nnz_pad;
  int G, B, R, n, S;
  float inv_span;
  uint32_t seed_lo, seed_hi;
  int C;
};

template <int RULE, bool SPARSE, bool COUNT>
cudaError_t launch_global(const Args& a, dim3 grid, size_t smem, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(anneal_global_kernel<RULE, SPARSE, COUNT>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
  if (e != cudaSuccess) return e;
  anneal_global_kernel<RULE, SPARSE, COUNT><<<grid, a.C * kLanes, smem, stream>>>(
      a.J, a.h, a.hot, a.logr, a.init01, a.uniforms, a.out, a.fields_out, a.flips, a.row_nnz,
      a.fscr, a.sscr, a.vals, a.cols, a.offsets, a.nnz_pad, a.G, a.B, a.R, a.n, a.S,
      a.inv_span, a.seed_lo, a.seed_hi, a.C);
  return cudaGetLastError();
}

template <int RULE, bool COUNT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const bool global = a.fscr != nullptr, sparse = a.vals != nullptr;
  const size_t smem = global ? global_layout_of(a.n).smem(a.C, sparse) : layout_of(a.n).bytes(a.C);
  if (a.C < 1 || a.C > kMaxChains || smem > kSmemMax) return cudaErrorInvalidValue;
  const long long blocks = ((long long)a.B * a.R + a.C - 1) / a.C;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)a.G);
  if (global)
    return sparse ? launch_global<RULE, true, COUNT>(a, grid, smem, stream)
                  : launch_global<RULE, false, COUNT>(a, grid, smem, stream);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        anneal_wide_kernel<RULE, COUNT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  anneal_wide_kernel<RULE, COUNT><<<grid, a.C * kLanes, smem, stream>>>(
      a.J, a.h, a.hot, a.logr, a.init01, a.uniforms, a.out, a.fields_out, a.flips, a.row_nnz,
      a.G, a.B, a.R, a.n, a.S, a.inv_span, a.seed_lo, a.seed_hi, a.C);
  return cudaGetLastError();
}

template <bool COUNT>
cudaError_t dispatch(const Args& a, int rule, cudaStream_t st) {
  switch (rule) {
    case 0: return launch<0, COUNT>(a, st);
    case 1: return launch<1, COUNT>(a, st);
    case 2: return launch<2, COUNT>(a, st);
    case 4: return launch<4, COUNT>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Largest n of the shared layout: two J tiles and one chain's fields and
// state fit one block's shared memory.  Past it the global-field layout.
extern "C" int qbmx_anneal_wide_max_n() {
  int n = 1;
  while (layout_of(n + 1).bytes(1) <= kSmemMax) ++n;
  return n;
}

// Shared-memory bytes of a block of `chains` chains at width n (the shared
// layout), and of a block of the global-field layout (any n) with the
// sparse pass or the dense one.
extern "C" unsigned long long qbmx_anneal_wide_smem(int n, int chains) {
  return (unsigned long long)layout_of(n).bytes(chains);
}

extern "C" unsigned long long qbmx_anneal_wide_global_smem(int chains, int sparse) {
  return (unsigned long long)global_layout_of(1).smem(chains, sparse != 0);
}

// Returns the cudaError_t of the launch (0 = success).  J is (G, n, jrow),
// each row padded with zeros to jrow: n rounded up to 4 in the shared
// layout, to 8 in the global-field one; init01/uniforms are both null
// (Philox mode) or both set (host-variate mode); rule is 0 for Metropolis,
// 1, 2 or 4 for heat-bath at that update width; chains (chains per block, a
// warp each) is the host's geometry; fields_out and flips (two counters)
// may be null, and row_nnz is null unless flips is set.  fscr and sscr,
// both null or both set, select the global-field layout: the chains'
// fields, (G*B*R, n rounded up to 8) float32, and state bytes, as many
// bytes, 16-byte aligned.  There vals, cols and offsets, all null or all
// set (n <= 32768), select the sparse pass: J_g's row lists as
// pt_wide_cuda.row_lists builds them, vals (G, nnz_pad) float32, cols (G,
// nnz_pad) 16-bit columns, offsets (G, n + 1 rounded up to 4) int32.
extern "C" int qbmx_anneal_wide(const float* J, const int* row_nnz, const float* h,
                                const float* hot, const float* logr, const float* init01,
                                const float* uniforms, float* out, float* fields_out,
                                unsigned long long* flips, float* fscr, void* sscr,
                                const float* vals, const int16_t* cols, const int* offsets,
                                int nnz_pad, int G, int B, int R, int n, int S, float inv_span,
                                unsigned long long seed, int rule, int chains, void* stream) {
  const bool some = vals != nullptr || cols != nullptr || offsets != nullptr;
  const bool all = vals != nullptr && cols != nullptr && offsets != nullptr;
  if (G <= 0 || B <= 0 || R <= 0 || n <= 0 || S <= 0 || G > 65535 ||
      (fscr == nullptr) != (sscr == nullptr) ||
      (fscr == nullptr && n > qbmx_anneal_wide_max_n()) ||
      (reinterpret_cast<uintptr_t>(fscr) | reinterpret_cast<uintptr_t>(sscr)) % 16 != 0 ||
      (init01 == nullptr) != (uniforms == nullptr) || (row_nnz != nullptr && flips == nullptr) ||
      some != all || (all && (fscr == nullptr || n > 32768 || nnz_pad <= 0)))
    return (int)cudaErrorInvalidValue;
  const Args a{J, h, hot, logr, init01, uniforms, out, fields_out, flips, row_nnz, fscr,
               static_cast<uint32_t*>(sscr), vals, reinterpret_cast<const uint16_t*>(cols),
               offsets, nnz_pad, G, B, R, n, S, inv_span,
               (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32), chains};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(row_nnz != nullptr ? dispatch<true>(a, rule, st) : dispatch<false>(a, rule, st));
}
