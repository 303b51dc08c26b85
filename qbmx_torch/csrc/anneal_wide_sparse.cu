// K4's shared layout on a sparse J_g: the anneal rules of anneal_wide.cu
// (Metropolis, heat-bath single, pair and quad) with J_g's nonzero rows
// held whole in shared memory, for NVIDIA Hopper (sm_90a).
//
// Replaces, where J_g is sparse (samplers/wide_cuda.py::shared_path: the
// CDQBM (a) step's QUBOs, 717 variables, 1.96% nonzeros; the restricted flat
// model, J_g all zeros but the output's row and column), the same TPU
// kernels as anneal_wide.cu's shared layout:
//   * qbmx/samplers/sa_lane.py   _lane_kernel (entry lane_sample_groups);
//   * qbmx/samplers/sa_pallas.py _sa_kernel   (entries sa_sample_batch_pallas
//     and gibbs_sample_batch_pallas; a dense batch is G = B groups of one).
//
// What bounds it on this card.  At the CDQBM (a) call (G=2, B=20, R=100,
// n=717, S=1000: 4,000 chains, a warp each) J_g holds 10,100 nonzeros, 14 a
// row on average and 40 at most.  The dense shared layout streams all
// 2.06 MB of J_g through 8-row tiles with two block barriers a tile and
// adds a whole row of 717 floats on a change.  Here the block holds the
// group's row lists -- fp32 values, 16-bit columns in increasing order, row
// offsets, built by the wrapper (pt_wide_cuda.row_lists), 61 KB at CDQBM
// (a) -- and a table of the couplings within a unit (J_{i,i+1}, J_{i,i+2},
// J_{i,i+3} for every i, from J, for the pair and quad rules), copied once
// for all S sweeps beside the block's chains.  So:
//   * a decision reads f_i (or, in a refresh sweep, recomputes it from the
//     row lists) and the unit's couplings from shared memory; the chain's
//     32 lanes draw the next 32 thresholds (Metropolis, heat-bath single) or
//     uniforms (pair, quad) at once, as anneal_wide.cu does;
//   * a change of variable i by d adds fmaf(d, J_ij, f_j) over row i's
//     nonzeros only, lane l taking entries l, l+32, ... (distinct columns),
//     a pair's or quad's rows in increasing order with a warp barrier
//     between them (commit_unit);
//   * there is no block barrier after the lists are in place, and no tile:
//     a chain waits on nothing but its own warp.
//
// Commit sweeps.  A sweep is a sequence of decisions in a fixed order, each
// a shared load and a compare; taken one at a time by the chain's warp, 31
// of its 32 lanes sit idle through every decision.  On J_g this sparse a
// decision rarely reads a field that the change before it wrote, so outside
// the refresh sweeps the warp decides a batch's units at once, a unit a
// lane, and commits their changes in order, the units after each change
// reading their fields and deciding again (commit_sweep): each unit still
// decides on its fields after every earlier change of the sweep.  At CDQBM
// (a) a batch of 32 decisions takes about 9 rounds.  A refresh sweep, the
// units past n rounded down to the rule's width, and every quad sweep go
// one unit at a time: a quad changes at nearly every decision, so its
// commits would decide each later quad again (slower than one at a time at
// CDQBM (a), PERF.md §6).
//
// Fields.  fmaf(d, 0, f) is f exactly, so skipping the zeros of a row leaves
// every field the value the dense shared layout gives it; a refresh (every
// kRefreshPeriod-th sweep, before each decision) sums, as anneal_wide.cu's
// fields<M> does, lane l the J_ij with s_j = 1 of the columns with
// (j / 4) % 32 == l in increasing j, a butterfly, then h_i, where the dense
// layout adds zeros besides (anneal_tiles.cuh's sparse_fields).  So on the
// same Philox streams or host variates the samples, final fields and flip
// counters are the dense shared layout's, bit for bit (a zero's sign
// aside), and wide_cuda.field_drift_bound holds unchanged.
//
// Random numbers, host variates and optional outputs are anneal_wide.cu's.
// The last block's spare chains repeat no chain: with no block barrier to
// take part in, they stop once the lists are in place.
//
// -DQBMX_K4S_CLOCKS builds the variant cli/compare_kernels.py splits the
// time with: each chain's lane 0 sums the clock64 cycles of its draws,
// refreshes, decisions and changes, read by qbmx_anneal_wide_sparse_clocks.
//
// Build without --use_fast_math (anneal_rules.cuh).

#include <climits>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "anneal_tiles.cuh"

namespace {

using qbmx::decide_with;
using qbmx::heatbath_threshold;
using qbmx::kInitTag;
using qbmx::kLanes;
using qbmx::Layout;
using qbmx::layout_of;
using qbmx::metropolis_threshold;
using qbmx::offsets_len;
using qbmx::philox4x32_10;
using qbmx::RowLists;
using qbmx::sparse_fields;
using qbmx::SweepUniforms;
using qbmx::Width;
using qbmx::word;

constexpr int kMaxChains = 32;       // chains per block: 1024 threads
constexpr size_t kSmemMax = 232448;  // a block's shared memory on Hopper
constexpr int kRefreshPeriod = 64;   // anneal_wide.cu's: the fields are its fields
constexpr int kUnitStride = 3;       // the unit table: J_{i,i+1}, J_{i,i+2}, J_{i,i+3}
constexpr unsigned kFull = 0xFFFFFFFFu;

// Floats of a group's unit table: 3n rounded up to 4 (16-byte copies).
__host__ __device__ inline int units_len(int n) { return (kUnitStride * n + 3) / 4 * 4; }

// A block's shared memory: the group's row lists (nnz_pad fp32 values, the
// offsets, nnz_pad 16-bit columns; nnz_pad a multiple of 8), its unit
// table, then each chain's fields and state words as in anneal_wide.cu's
// shared layout.  The lists and the table fill whole 16-byte words, so the
// fields start aligned for the copies.
__host__ __device__ inline size_t sparse_bytes(int n, int chains, int nnz_pad) {
  const Layout L = layout_of(n);
  return 6 * (size_t)nnz_pad + 4 * (size_t)offsets_len(n) + 4 * (size_t)units_len(n) +
         4 * (size_t)chains * (L.frow + L.words());
}

// The clock64 cycles of a chain's parts (QBMX_K4S_CLOCKS), or nothing.
enum Part { kDraw, kRefresh, kDecide, kChange, kParts };
#ifdef QBMX_K4S_CLOCKS
__device__ unsigned long long part_cycles[kParts];
struct PartClocks {
  long long t = 0;
  unsigned long long cycles[kParts] = {};
  __device__ __forceinline__ void start() { t = clock64(); }
  __device__ __forceinline__ void lap(Part part) {
    const long long now = clock64();
    cycles[part] += (unsigned long long)(now - t);
    t = now;
  }
  __device__ __forceinline__ void flush(int lane) {
    if (lane == 0)
      for (int k = 0; k < kParts; ++k) atomicAdd(part_cycles + k, cycles[k]);
  }
};
#else
struct PartClocks {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void lap(Part) {}
  __device__ __forceinline__ void flush(int) {}
};
#endif

// The changes d of a unit of variables i..i+M-1 (the same on every lane of
// the chain's warp) committed: lane `writer` writes each changed variable's
// state byte, and each changed row's nonzeros take fmaf(d, J_ij, f_j), rows
// in increasing order with a warp barrier after each, so that its adds land
// before the next row's and before any field is read again.  Returns the
// variables changed; where COUNT adds the nonzeros of their rows to `work`.
template <int M, bool COUNT>
__device__ __forceinline__ int commit_unit(const RowLists& rl, int i, const float d[M],
                                           int writer, float* fr, unsigned char* sb, int lane,
                                           unsigned& work) {
  int changed = 0;
#pragma unroll
  for (int a = 0; a < M; ++a) {
    if (d[a] == 0.0f) continue;
    if (lane == writer) sb[i + a] = d[a] > 0.0f ? 0xFF : 0x00;
    const int e0 = rl.offs[i + a], e1 = rl.offs[i + a + 1];
    for (int e = e0 + lane; e < e1; e += kLanes) {
      const int j = rl.cols[e];
      fr[j] = fmaf(d[a], rl.vals[e], fr[j]);
    }
    if constexpr (COUNT) work += (unsigned)(e1 - e0);
    ++changed;
    __syncwarp();
  }
  return changed;
}

// A unit of variables i..i+M-1 (M = 1, 2 or 4) of a chain's sweep, decided
// by the whole warp: its fields read from fr, or, in a REFRESH sweep,
// recomputed from the row lists and written there; its states from `bits`
// (the batch of 32 that starts at `base`); the decision on the unit table
// uc; a change written to bits and committed (commit_unit).  Returns the
// variables changed; where COUNT adds the nonzeros of their rows to `work`.
template <int RULE, int M, bool COUNT, bool REFRESH>
__device__ __forceinline__ int sparse_unit(const RowLists& rl, const float* uc, int i, int base,
                                           float beta, float v, float* fr, unsigned char* sb,
                                           uint32_t& bits, int lane, const float* hp,
                                           unsigned& work, PartClocks& clk) {
  float f[M], s[M], o[M], d[M];
#pragma unroll
  for (int a = 0; a < M; ++a) s[a] = (bits >> (i + a - base)) & 1u ? 1.0f : 0.0f;
  if constexpr (REFRESH) {
    sparse_fields<M>(rl, i, sb, lane, hp, f);
    clk.lap(kRefresh);
  } else {
#pragma unroll
    for (int a = 0; a < M; ++a) f[a] = fr[i + a];
  }
  decide_with<RULE, M>(
      f, s, [&](int a, int b) { return uc[(i + a) * kUnitStride + (b - a - 1)]; }, beta, v, o);
  int changed = 0;
#pragma unroll
  for (int a = 0; a < M; ++a) {
    d[a] = o[a] - s[a];
    changed += d[a] != 0.0f;
  }
  clk.lap(kDecide);
  if constexpr (REFRESH) {
    if (lane == 0) {
#pragma unroll
      for (int a = 0; a < M; ++a) fr[i + a] = f[a];
    }
  }
  if (changed == 0) {  // the same on the chain's lanes
    if constexpr (REFRESH) __syncwarp();  // the refreshed fields in place for every lane
    return 0;
  }
  // every lane has read the unit's fields and the state bytes, and sees the
  // refreshed fields, before any adds to them
  __syncwarp();
#pragma unroll
  for (int a = 0; a < M; ++a)
    if (d[a] != 0.0f) bits ^= 1u << (i + a - base);
  commit_unit<M, COUNT>(rl, i, d, 0, fr, sb, lane, work);
  clk.lap(kChange);
  return changed;
}

// The units of a batch ending at `end` past n rounded down to the rule's
// width, from variable i, one at a time by unit(i, Width<M>{}): a pair
// and/or a single (RULE 4), a single (RULE 2), none (RULE 0, 1).  Returns
// the variables changed.
template <int RULE, typename Unit>
__device__ __forceinline__ int trailing_units(int i, int end, Unit unit) {
  int changed = 0;
  if constexpr (RULE == 4) {
    if (i + 2 <= end) {
      changed += unit(i, Width<2>{});
      i += 2;
    }
  }
  if constexpr (RULE >= 2) {
    if (i < end) changed += unit(i, Width<1>{});
  }
  return changed;
}

// One sweep of a chain (a warp) on the row lists rl and unit table uc, one
// unit at a time (a refresh sweep, each unit's fields recomputed before its
// decision; or a quad sweep): batch by batch of 32 variables, lane l drawing
// variable base + l's threshold (RULE 0, 1) or uniform (RULE 2, 4) and
// reading its state; then the batch's units in anneal_wide.cu's order
// (tile_schedule's): singles (RULE 0, 1); pairs, and a trailing single at
// odd n (RULE 2); quads, and past n rounded down to 4 a pair and/or a single
// (RULE 4).  A unit never straddles a batch.  One loop over the units of the
// rule's width keeps one copy of a unit's code.  Returns the variables
// changed.
template <int RULE, bool COUNT, bool REFRESH>
__device__ __forceinline__ int sparse_sweep(const RowLists& rl, const float* uc, int n,
                                            float beta, SweepUniforms& u, float* fr,
                                            unsigned char* sb, int lane, const float* hp,
                                            unsigned& work, PartClocks& clk) {
  constexpr int W = RULE <= 1 ? 1 : RULE;  // the width of the rule's units
  const int units_end = n & ~(W - 1);      // where they stop
  int changed = 0;
  for (int base = 0; base < n; base += kLanes) {
    float mine = 0.0f;  // this lane's threshold or uniform of the batch
    bool s_lane = false;
    if (base + lane < n) {
      const float uu = u(base + lane);
      mine = RULE == 0 ? metropolis_threshold(uu, beta)
             : RULE == 1 ? heatbath_threshold(uu, beta) : uu;
      s_lane = sb[base + lane] != 0;
    }
    uint32_t bits = __ballot_sync(kFull, s_lane);  // the batch's states
    clk.lap(kDraw);
    const int end = min(base + kLanes, n);
    auto unit = [&](int i, auto width) {
      constexpr int M = decltype(width)::value;
      const float v = __shfl_sync(kFull, mine, i - base);
      return sparse_unit<RULE, M, COUNT, REFRESH>(rl, uc, i, base, beta, v, fr, sb, bits,
                                                  lane, hp, work, clk);
    };
    int i = base;
    for (; i < min(end, units_end); i += W) changed += unit(i, Width<W>{});
    changed += trailing_units<RULE>(i, end, unit);
  }
  return changed;
}

// A sweep of a chain (a warp) outside the refresh sweeps: a batch's units
// decided at once, a unit a lane (lane t the unit of variables base + tW ..
// base + tW + W - 1, W the rule's width), then committed in order.  The
// first unit that changes is final (every unit before it decided, not to
// change, on its fields after every earlier change); its change is
// committed, and only the units after it read their fields and decide
// again.  So
// each unit decides on its fields after every earlier change of the sweep,
// as in a sweep of one unit at a time, and a batch takes one round a change
// where that sweep takes one a unit.  The units past n rounded down to W go
// one at a time (trailing_units).  RULE 0, 1 and 2.  Returns the variables
// changed.
template <int RULE, bool COUNT>
__device__ __forceinline__ int commit_sweep(const RowLists& rl, const float* uc, int n,
                                            float beta, SweepUniforms& u, float* fr,
                                            unsigned char* sb, int lane, const float* hp,
                                            unsigned& work, PartClocks& clk) {
  constexpr int W = RULE <= 1 ? 1 : RULE;
  const int units_end = n & ~(W - 1);
  int changed = 0;
  for (int base = 0; base < n; base += kLanes) {
    float mine = 0.0f;  // variable base + lane's threshold or uniform
    if (base + lane < n) {
      const float uu = u(base + lane);
      mine = RULE == 0 ? metropolis_threshold(uu, beta)
             : RULE == 1 ? heatbath_threshold(uu, beta) : uu;
    }
    clk.lap(kDraw);
    const int end = min(base + kLanes, n);
    const int stop = min(end, units_end);
    const int i = base + lane * W;  // this lane's unit
    const bool mine_unit = i < stop;
    const float v = __shfl_sync(kFull, mine, (lane * W) & (kLanes - 1));
    float f[W], s[W], o[W];
#pragma unroll
    for (int a = 0; a < W; ++a) {
      s[a] = mine_unit && sb[i + a] != 0 ? 1.0f : 0.0f;
      f[a] = mine_unit ? fr[i + a] : 0.0f;
      o[a] = s[a];
    }
    auto wants = [&]() {  // the unit's decision on its fields: whether it changes
      if (!mine_unit) return false;
      decide_with<RULE, W>(
          f, s, [&](int a, int b) { return uc[(i + a) * kUnitStride + (b - a - 1)]; }, beta, v,
          o);
      bool w = false;
#pragma unroll
      for (int a = 0; a < W; ++a) w |= o[a] != s[a];
      return w;
    };
    uint32_t pending = __ballot_sync(kFull, wants());
    clk.lap(kDecide);
    while (pending != 0) {
      const int t = __ffs(pending) - 1;  // the first unit that changes
      float d[W];
#pragma unroll
      for (int a = 0; a < W; ++a) d[a] = __shfl_sync(kFull, o[a] - s[a], t);
      changed += commit_unit<W, COUNT>(rl, base + t * W, d, t, fr, sb, lane, work);
      if (lane > t && mine_unit) {
#pragma unroll
        for (int a = 0; a < W; ++a) f[a] = fr[i + a];
      }
      pending = __ballot_sync(kFull, lane > t && wants());
      clk.lap(kChange);
    }
    if (stop < end) {
      uint32_t bits = __ballot_sync(kFull, base + lane < n && sb[base + lane] != 0);
      changed += trailing_units<RULE>(stop, end, [&](int k, auto width) {
        return sparse_unit<RULE, decltype(width)::value, COUNT, false>(
            rl, uc, k, base, beta, __shfl_sync(kFull, mine, k - base), fr, sb, bits, lane, hp,
            work, clk);
      });
    }
  }
  return changed;
}

// `bytes` (a multiple of 16) from global to shared memory as asynchronous
// 16-byte copies by the block's threads.
__device__ __forceinline__ void copy_async(void* dst, const void* src, size_t bytes) {
  float4* d = reinterpret_cast<float4*>(dst);
  const float4* s = reinterpret_cast<const float4*>(src);
  for (size_t q = threadIdx.x; q < bytes / 16; q += blockDim.x)
    __pipeline_memcpy_async(d + q, s + q, sizeof(float4));
}

// COUNT: the build that also counts the nonzeros of the changed rows (flips
// set, for checks); the main path launches the other.  One resident block an
// SM (__launch_bounds__'s second argument) lets a thread have 64 registers:
// asked for two, ptxas keeps 32 and spills, and the kernel ran slower
// (PERF.md §6).
template <int RULE, bool COUNT>
__global__ void __launch_bounds__(kMaxChains* kLanes, 1)
anneal_wide_sparse_kernel(const float* __restrict__ vals_g, const uint16_t* __restrict__ cols_g,
                          const int* __restrict__ offsets_g, const float* __restrict__ units_g,
                          const float* __restrict__ h, const float* __restrict__ hot,
                          const float* __restrict__ logr, const float* __restrict__ init01,
                          const float* __restrict__ uniforms, float* __restrict__ out,
                          float* __restrict__ fields_out, unsigned long long* __restrict__ flips,
                          int nnz_pad, int G, int B, int R, int n, int S, float inv_span,
                          uint32_t seed_lo, uint32_t seed_hi, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout_of(n);
  float* vals = reinterpret_cast<float*>(smem);
  int* offs = reinterpret_cast<int*>(vals + nnz_pad);
  uint16_t* cols = reinterpret_cast<uint16_t*>(offs + offsets_len(n));
  float* uc = reinterpret_cast<float*>(cols + nnz_pad);
  float* field_rows = uc + units_len(n);
  uint32_t* state = reinterpret_cast<uint32_t*>(field_rows + (size_t)C * L.frow);

  const int g = blockIdx.y;
  const int c = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const long long chains = (long long)B * R;
  const long long chain = (long long)blockIdx.x * C + c;

  // the group's row lists and unit table, once for all S sweeps
  copy_async(vals, vals_g + (size_t)g * nnz_pad, 4 * (size_t)nnz_pad);
  copy_async(offs, offsets_g + (size_t)g * offsets_len(n), 4 * (size_t)offsets_len(n));
  copy_async(cols, cols_g + (size_t)g * nnz_pad, 2 * (size_t)nnz_pad);
  copy_async(uc, units_g + (size_t)g * units_len(n), 4 * (size_t)units_len(n));
  __pipeline_commit();
  for (int k = threadIdx.x; k < C * (L.frow + L.words()); k += blockDim.x) field_rows[k] = 0.0f;
  __pipeline_wait_prior(0);
  __syncthreads();  // the lists in place and the rows zeroed: the block's only barrier
  if (chain >= chains) return;  // a spare chain of the last block

  const int b = (int)(chain / R);
  const int r = (int)(chain % R);
  const size_t p = (size_t)g * B + b;  // problem id
  const uint2 key = make_uint2(seed_lo, (uint32_t)p);
  const bool host = uniforms != nullptr;
  const float* hp = h + p * n;
  const RowLists rl{vals, cols, offs};
  float* fr = field_rows + (size_t)c * L.frow;
  unsigned char* sb = reinterpret_cast<unsigned char*>(state + c * L.words());
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
  __syncwarp();

  const float hot_p = hot[p], logr_p = logr[p];
  const size_t u_sweep = (size_t)G * B * n * R;  // uniforms per sweep
  int changed = 0;
  unsigned long long work = 0;  // the nonzeros of the changed variables' rows
  PartClocks clk;
  clk.start();
  for (int t = 0; t < S; ++t) {
    const float beta = hot_p * expf(logr_p * ((float)t * inv_span));
    SweepUniforms u{host ? uniforms + (size_t)t * u_sweep + p * n * R + r : nullptr, R, key,
                    (uint32_t)r, (uint32_t)t, seed_hi};
    unsigned sweep_work = 0;  // at most n² a sweep
    if (t % kRefreshPeriod == 0)
      changed += sparse_sweep<RULE, COUNT, true>(rl, uc, n, beta, u, fr, sb, lane, hp,
                                                 sweep_work, clk);
    else if constexpr (RULE == 4)  // a quad changes at nearly every decision
      changed += sparse_sweep<RULE, COUNT, false>(rl, uc, n, beta, u, fr, sb, lane, hp,
                                                  sweep_work, clk);
    else
      changed += commit_sweep<RULE, COUNT>(rl, uc, n, beta, u, fr, sb, lane, hp, sweep_work,
                                           clk);
    work += sweep_work;
  }
  clk.flush(lane);

  const size_t row = (p * R + r) * n;
  for (int i = lane; i < n; i += kLanes) out[row + i] = sb[i] ? 1.0f : 0.0f;
  if (fields_out != nullptr)
    for (int i = lane; i < n; i += kLanes) fields_out[row + i] = fr[i];
  if (flips != nullptr && lane == 0 && changed != 0) {
    atomicAdd(flips, (unsigned long long)changed);
    atomicAdd(flips + 1, work);
  }
}

struct Args {
  const float* vals;
  const uint16_t* cols;
  const int* offsets;
  const float *units, *h, *hot, *logr, *init01, *uniforms;
  float *out, *fields_out;
  unsigned long long* flips;
  int nnz_pad, G, B, R, n, S;
  float inv_span;
  uint32_t seed_lo, seed_hi;
  int C;
};

template <int RULE, bool COUNT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = sparse_bytes(a.n, a.C, a.nnz_pad);
  if (a.C < 1 || a.C > kMaxChains || smem > kSmemMax) return cudaErrorInvalidValue;
  const long long blocks = ((long long)a.B * a.R + a.C - 1) / a.C;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(anneal_wide_sparse_kernel<RULE, COUNT>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
  if (e != cudaSuccess) return e;
  anneal_wide_sparse_kernel<RULE, COUNT><<<dim3((unsigned)blocks, (unsigned)a.G),
                                           a.C * kLanes, smem, stream>>>(
      a.vals, a.cols, a.offsets, a.units, a.h, a.hot, a.logr, a.init01, a.uniforms, a.out,
      a.fields_out, a.flips, a.nnz_pad, a.G, a.B, a.R, a.n, a.S, a.inv_span, a.seed_lo,
      a.seed_hi, a.C);
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

// Shared-memory bytes of a block of `chains` chains at width n whose
// group's row lists hold nnz_pad entries.
extern "C" unsigned long long qbmx_anneal_wide_sparse_smem(int n, int chains, int nnz_pad) {
  return (unsigned long long)sparse_bytes(n, chains, nnz_pad);
}

// Returns the cudaError_t of the launch (0 = success).  vals (G, nnz_pad)
// float32, cols (G, nnz_pad) 16-bit columns and offsets (G, n + 1 rounded
// up to 4) int32 are J_g's row lists as pt_wide_cuda.row_lists builds them
// (nnz_pad a multiple of 8, n <= 32768); units (G, 3n rounded up to 4)
// float32 holds J_g[i, i+k] at 3i + k - 1 for k = 1, 2, 3 (zero past n).
// The rest is qbmx_anneal_wide's: h (G, B, n), hot and logr (G, B),
// init01/uniforms both null (Philox mode) or both set, rule 0 Metropolis or
// 1, 2, 4 heat-bath at that width, chains a block; fields_out and flips
// (two counters: the variables changed and the nonzeros of their rows) may
// be null.
extern "C" int qbmx_anneal_wide_sparse(const float* vals, const int16_t* cols, const int* offsets,
                                       const float* units, const float* h, const float* hot,
                                       const float* logr, const float* init01,
                                       const float* uniforms, float* out, float* fields_out,
                                       unsigned long long* flips, int nnz_pad, int G, int B,
                                       int R, int n, int S, float inv_span,
                                       unsigned long long seed, int rule, int chains,
                                       void* stream) {
  if (G <= 0 || B <= 0 || R <= 0 || n <= 0 || S <= 0 || G > 65535 || n > 32768 ||
      nnz_pad <= 0 || nnz_pad % 8 != 0 || vals == nullptr || cols == nullptr ||
      offsets == nullptr || units == nullptr || (init01 == nullptr) != (uniforms == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{vals, reinterpret_cast<const uint16_t*>(cols), offsets, units, h, hot, logr,
               init01, uniforms, out, fields_out, flips, nnz_pad, G, B, R, n, S, inv_span,
               (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32), chains};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(flips != nullptr ? dispatch<true>(a, rule, st) : dispatch<false>(a, rule, st));
}

#ifdef QBMX_K4S_CLOCKS
// The summed cycles of the chains' parts since the last call (draws,
// refreshes, decisions, changes) into out[4], and zeroed.
extern "C" int qbmx_anneal_wide_sparse_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, part_cycles, sizeof(part_cycles));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[kParts] = {};
  return (int)cudaMemcpyToSymbol(part_cycles, zero, sizeof(part_cycles));
}
#endif
