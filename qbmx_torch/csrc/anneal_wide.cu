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
// the main path: fields_out (G,B,R,n) the final fields, flips the number of
// variables changed (for chip_smoke.py's drift check and bound).
//
// Build without --use_fast_math (anneal_rules.cuh).

#include <climits>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "anneal_rules.cuh"

namespace {

using qbmx::heatbath_threshold;
using qbmx::kInitTag;
using qbmx::metropolis_accept;
using qbmx::metropolis_threshold;
using qbmx::pair_rule;
using qbmx::philox4x32_10;
using qbmx::quad_rule;
using qbmx::single_rule;
using qbmx::SweepUniforms;
using qbmx::word;

constexpr int kRows = 8;             // J rows per tile
constexpr int kLanes = 32;           // threads a chain: a warp
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

// Shared-memory layout of a block at width n: two J tiles, then C rows of
// fields, then C rows of state words.  A chain's rows cover whole tiles (n
// rounded up to 8), since a tile's 8 fields and states are read at once,
// the last tile's too.  A warp touches one chain's rows only, at
// consecutive words, so the rows need no padding against bank conflicts.
struct Layout {
  int jrow;  // floats per (padded) J row and tile row: n rounded up to 4
  int frow;  // floats per chain's fields: n rounded up to 8

  __host__ __device__ int words() const { return frow / 4; }  // state words per chain
  __host__ __device__ size_t bytes(int chains) const {
    return 4 * ((size_t)2 * kRows * jrow + (size_t)chains * (frow + words()));
  }
};

__host__ __device__ inline Layout layout_of(int n) {
  return Layout{(n + 3) / 4 * 4, (n + kRows - 1) / kRows * kRows};
}

// Rows [8·tile, 8·tile + 8) of the padded J_g into a tile buffer, as
// asynchronous 16-byte copies.
__device__ __forceinline__ void load_tile(float* dst, const float* Jg, int tile, int n,
                                          int jrow) {
  const int i0 = tile * kRows;
  const int count = min(kRows, n - i0) * jrow / 4;
  const float4* src = reinterpret_cast<const float4*>(Jg + (size_t)i0 * jrow);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int q = threadIdx.x; q < count; q += blockDim.x)
    __pipeline_memcpy_async(d4 + q, src + q, sizeof(float4));
}

__device__ __forceinline__ float masked(float x, uint32_t mask) {
  return __uint_as_float(__float_as_uint(x) & mask);
}

// Fields of variables i..i+M-1 (tile rows Ji, row stride jrow) recomputed
// on the chain's state st; every lane of the chain gets the same M values.
template <int M>
__device__ __forceinline__ void fields(const float* Ji, int jrow, const uint32_t* st,
                                       int lane, const float* hp, float f[M]) {
  float acc[M];
#pragma unroll
  for (int a = 0; a < M; ++a) acc[a] = 0.0f;
  const int q4 = jrow / 4;
  const float4* T = reinterpret_cast<const float4*>(Ji);
  for (int w = lane; w < q4; w += kLanes) {
    const uint32_t s = st[w];
    const uint32_t m0 = __byte_perm(s, 0, 0x0000), m1 = __byte_perm(s, 0, 0x1111);
    const uint32_t m2 = __byte_perm(s, 0, 0x2222), m3 = __byte_perm(s, 0, 0x3333);
#pragma unroll
    for (int a = 0; a < M; ++a) {
      const float4 v = T[a * q4 + w];
      acc[a] += masked(v.x, m0);
      acc[a] += masked(v.y, m1);
      acc[a] += masked(v.z, m2);
      acc[a] += masked(v.w, m3);
    }
  }
#pragma unroll
  for (int a = 0; a < M; ++a) {
#pragma unroll
    for (int d = 1; d < kLanes; d <<= 1) acc[a] += __shfl_xor_sync(0xFFFFFFFFu, acc[a], d);
    f[a] = hp[a] + acc[a];
  }
}

// Variables i..i+M-1's new values o by RULE -- 0 Metropolis, 1 heat-bath;
// M = 2 or 4 the joint pair or quad draw, M = 1 under RULE 2 or 4 the
// trailing single -- from their fields f and states s, the couplings among
// them (tile rows rr.., row stride jrow) and v, the first variable's
// threshold (RULE 0, 1) or uniform (RULE 2, 4).
template <int RULE, int M>
__device__ __forceinline__ void decide(const float f[M], const float s[M], const float* tile,
                                       int rr, int jrow, int i, float beta, float v,
                                       float o[M]) {
  if constexpr (M == 4) {
    float c[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = a + 1; b < 4; ++b) c[a][b] = tile[(rr + a) * jrow + i + b];
    quad_rule(f, c, s, beta, v, o);
  } else if constexpr (M == 2) {
    pair_rule(f[0], f[1], tile[rr * jrow + i + 1], s[0], s[1], beta, v, o[0], o[1]);
  } else if constexpr (RULE == 0) {
    o[0] = metropolis_accept(f[0], s[0], v) ? 1.0f - s[0] : s[0];
  } else if constexpr (RULE == 1) {
    o[0] = f[0] < v ? 1.0f : 0.0f;
  } else {
    o[0] = single_rule(f[0], beta, v);
  }
}

// Adds d[a]·J_{i+a, j} (tile rows rr.., a in increasing order) to the
// chain's fields fr, each lane to its float4 chunks q ≡ lane (mod 32).
template <int M>
__device__ __forceinline__ void add_rows(float* fr, const float* tile, int rr, int jrow,
                                         int lane, const float d[M]) {
  const int q4 = jrow / 4;
  const float4* T = reinterpret_cast<const float4*>(tile + rr * jrow);
  float4* F = reinterpret_cast<float4*>(fr);
#pragma unroll 4
  for (int q = lane; q < q4; q += kLanes) {
    float4 x = F[q];
#pragma unroll
    for (int a = 0; a < M; ++a) {
      if (d[a] != 0.0f) {
        const float4 t = T[a * q4 + q];
        x.x = fmaf(d[a], t.x, x.x);
        x.y = fmaf(d[a], t.y, x.y);
        x.z = fmaf(d[a], t.z, x.z);
        x.w = fmaf(d[a], t.w, x.w);
      }
    }
    F[q] = x;
  }
}

// A unit of a refresh sweep: the fields of variables i..i+M-1 recomputed
// from the state in shared memory, the decision, and its change applied to
// the state and every field.  Returns the number of variables changed.
template <int RULE, int M>
__device__ __forceinline__ int refresh_unit(const float* tile, int rr, int jrow, float* fr,
                                            uint32_t* st, int lane, const float* hp, int i,
                                            float beta, float v) {
  float f[M], s[M], o[M], d[M];
  unsigned char* sb = reinterpret_cast<unsigned char*>(st);
  fields<M>(tile + rr * jrow, jrow, st, lane, hp + i, f);
#pragma unroll
  for (int a = 0; a < M; ++a) s[a] = sb[i + a] ? 1.0f : 0.0f;
  decide<RULE, M>(f, s, tile, rr, jrow, i, beta, v, o);
  int changed = 0;
#pragma unroll
  for (int a = 0; a < M; ++a) {
    d[a] = o[a] - s[a];
    changed += d[a] != 0.0f;
  }
  __syncwarp();  // every lane has read the state
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < M; ++a) {
      fr[i + a] = f[a];
      sb[i + a] = o[a] != 0.0f ? 0xFF : 0x00;
    }
  }
  __syncwarp();  // ... and sees the refreshed fields before adding to them
  if (changed != 0) add_rows<M>(fr, tile, rr, jrow, lane, d);  // the same on the chain's lanes
  __syncwarp();  // ... and sees the new fields and state before the next unit
  return changed;
}

// A unit of any other sweep, at tile row rr (a constant once the tile's
// units are unrolled).  Every lane holds the tile's 8 fields ft and states
// sv in registers, so a decision waits on no memory: a change adds
// d·J_ij to the tile's later fields there, by the same fmaf, in the same
// order, as add_rows adds it to their copies in shared memory, and the
// state byte is written for the next tile.  Within a tile no lane reads
// what another writes, so no barrier is needed until the tile's end.
template <int RULE, int M>
__device__ __forceinline__ int tile_unit(const float* tile, int rr, int jrow, float* fr,
                                         unsigned char* sb, int lane, int i0, float beta,
                                         float v, float ft[8], float sv[8]) {
  float f[M], s[M], o[M], d[M];
#pragma unroll
  for (int a = 0; a < M; ++a) {
    f[a] = ft[rr + a];
    s[a] = sv[rr + a];
  }
  decide<RULE, M>(f, s, tile, rr, jrow, i0 + rr, beta, v, o);
  int changed = 0;
#pragma unroll
  for (int a = 0; a < M; ++a) {
    d[a] = o[a] - s[a];
    changed += d[a] != 0.0f;
  }
  if (changed != 0) {  // the same on the chain's lanes
#pragma unroll
    for (int a = 0; a < M; ++a) {
      sv[rr + a] = o[a];
      if (lane == 0) sb[i0 + rr + a] = o[a] != 0.0f ? 0xFF : 0x00;
    }
#pragma unroll
    for (int r2 = rr + M; r2 < kRows; ++r2)
#pragma unroll
      for (int a = 0; a < M; ++a)
        if (d[a] != 0.0f) ft[r2] = fmaf(d[a], tile[(rr + a) * jrow + i0 + r2], ft[r2]);
    add_rows<M>(fr, tile, rr, jrow, lane, d);
  }
  return changed;
}

template <int M>
struct Width {
  static constexpr int value = M;
};

// The units of one tile (variables i0..i0+7, i0 a multiple of 8) in sweep
// order, unit(rr, Width<M>{}) for each: singles (RULE 0, 1); pairs, then a
// trailing single (RULE 2); quads, then a remainder pair and/or a single
// (RULE 4).  rr is a constant once the loops are unrolled.  Returns the sum
// of the units' results.
template <int RULE, typename Unit>
__device__ __forceinline__ int tile_schedule(int i0, int n, Unit&& unit) {
  int sum = 0;
  if constexpr (RULE <= 1) {
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
      if (i0 + rr < n) sum += unit(rr, Width<1>{});
  } else if constexpr (RULE == 2) {
#pragma unroll
    for (int rr = 0; rr < kRows; rr += 2) {
      if (i0 + rr + 2 <= n)
        sum += unit(rr, Width<2>{});
      else if (i0 + rr < n)
        sum += unit(rr, Width<1>{});
    }
  } else {
    const int n4 = n & ~3;
#pragma unroll
    for (int rr = 0; rr < kRows; rr += 4) {
      const int i = i0 + rr;
      if (i + 4 <= n4) {
        sum += unit(rr, Width<4>{});
      } else if (i + 2 <= n) {  // the remainder n4..n-1 starts here
        sum += unit(rr, Width<2>{});
        if (i + 3 <= n) sum += unit(rr + 2, Width<1>{});
      } else if (i < n) {
        sum += unit(rr, Width<1>{});
      }
    }
  }
  return sum;
}

template <int RULE>
__global__ void __launch_bounds__(kMaxChains * kLanes)
anneal_wide_kernel(const float* __restrict__ J, const float* __restrict__ h,
                   const float* __restrict__ hot, const float* __restrict__ logr,
                   const float* __restrict__ init01, const float* __restrict__ uniforms,
                   float* __restrict__ out, float* __restrict__ fields_out,
                   unsigned long long* __restrict__ flips, int G, int B, int R, int n, int S,
                   float inv_span, uint32_t seed_lo, uint32_t seed_hi, int C) {
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
  const int ntiles = (n + kRows - 1) / kRows;
  const int tile_floats = kRows * L.jrow;
  int changed = 0;
  float mine = 0.0f;  // this lane's threshold or uniform of the current batch
  load_tile(tiles, Jg, 0, n, L.jrow);
  __pipeline_commit();
  int buf = 0;
  for (int t = 0; t < S; ++t) {
    const bool refresh = t % kRefreshPeriod == 0;
    const float beta = hot_p * expf(logr_p * ((float)t * inv_span));
    SweepUniforms u{host ? uniforms + (size_t)t * u_sweep + p * n * R + r : nullptr, R, key,
                    (uint32_t)r, (uint32_t)t, seed_hi};
    for (int k = 0; k < ntiles; ++k) {
      if (t + 1 < S || k + 1 < ntiles)  // prefetch the next tile, wrapping to the next sweep
        load_tile(tiles + (buf ^ 1) * tile_floats, Jg, k + 1 < ntiles ? k + 1 : 0, n, L.jrow);
      __pipeline_commit();
      const int i0 = k * kRows;
      const int base = i0 - i0 % kLanes;  // first variable of the lanes' batch
      if (base == i0) {  // every 4th tile
        // lane l draws variable i0 + l's uniform and, for RULE 0 and 1,
        // turns it into its threshold; the units shuffle it from there
        mine = 0.0f;
        if (i0 + lane < n) {
          const float uu = u(i0 + lane);
          mine = RULE == 0 ? metropolis_threshold(uu, beta)
                 : RULE == 1 ? heatbath_threshold(uu, beta) : uu;
        }
      }
      __pipeline_wait_prior(1);  // this thread's copies of tile k have landed
      __syncthreads();           // ... and every thread's, and the last tile's writes
      const float* tile = tiles + buf * tile_floats;
      auto v_at = [&](int rr) { return __shfl_sync(0xFFFFFFFFu, mine, i0 + rr - base); };
      if (refresh) {
        changed += tile_schedule<RULE>(i0, n, [&](int rr, auto w) {
          constexpr int M = decltype(w)::value;
          return refresh_unit<RULE, M>(tile, rr, L.jrow, fr, st, lane, hp, i0 + rr, beta,
                                          v_at(rr));
        });
      } else {
        // the tile's 8 fields and states, into every lane's registers
        float ft[kRows], sv[kRows];
        const float4 f0 = *reinterpret_cast<const float4*>(fr + i0);
        const float4 f1 = *reinterpret_cast<const float4*>(fr + i0 + 4);
        const uint32_t w0 = st[i0 / 4], w1 = st[i0 / 4 + 1];
        ft[0] = f0.x, ft[1] = f0.y, ft[2] = f0.z, ft[3] = f0.w;
        ft[4] = f1.x, ft[5] = f1.y, ft[6] = f1.z, ft[7] = f1.w;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          sv[b] = (w0 >> (8 * b)) & 0xFFu ? 1.0f : 0.0f;
          sv[b + 4] = (w1 >> (8 * b)) & 0xFFu ? 1.0f : 0.0f;
        }
        changed += tile_schedule<RULE>(i0, n, [&](int rr, auto w) {
          constexpr int M = decltype(w)::value;
          return tile_unit<RULE, M>(tile, rr, L.jrow, fr, sb, lane, i0, beta, v_at(rr), ft,
                                       sv);
        });
      }
      __syncthreads();  // tile buffer buf is free for the prefetch after next
      buf ^= 1;
    }
  }

  if (active) {
    const size_t row = (p * R + r) * n;
    for (int i = lane; i < n; i += kLanes) out[row + i] = sb[i] ? 1.0f : 0.0f;
    if (fields_out != nullptr)
      for (int i = lane; i < n; i += kLanes) fields_out[row + i] = fr[i];
    if (flips != nullptr && lane == 0 && changed != 0)
      atomicAdd(flips, (unsigned long long)changed);
  }
}

struct Args {
  const float *J, *h, *hot, *logr, *init01, *uniforms;
  float *out, *fields_out;
  unsigned long long* flips;
  int G, B, R, n, S;
  float inv_span;
  uint32_t seed_lo, seed_hi;
  int C;
};

template <int RULE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = layout_of(a.n).bytes(a.C);
  if (a.C < 1 || a.C > kMaxChains || smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        anneal_wide_kernel<RULE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long blocks = ((long long)a.B * a.R + a.C - 1) / a.C;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)a.G);
  anneal_wide_kernel<RULE><<<grid, a.C * kLanes, smem, stream>>>(
      a.J, a.h, a.hot, a.logr, a.init01, a.uniforms, a.out, a.fields_out, a.flips, a.G, a.B,
      a.R, a.n, a.S, a.inv_span, a.seed_lo, a.seed_hi, a.C);
  return cudaGetLastError();
}

cudaError_t dispatch(const Args& a, int rule, cudaStream_t st) {
  switch (rule) {
    case 0: return launch<0>(a, st);
    case 1: return launch<1>(a, st);
    case 2: return launch<2>(a, st);
    case 4: return launch<4>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Largest n the kernel takes: two J tiles and one chain's fields and state
// must fit one block's shared memory.
extern "C" int qbmx_anneal_wide_max_n() {
  int n = 1;
  while (layout_of(n + 1).bytes(1) <= kSmemMax) ++n;
  return n;
}

// Shared-memory bytes of a block of `chains` chains at width n.
extern "C" unsigned long long qbmx_anneal_wide_smem(int n, int chains) {
  return (unsigned long long)layout_of(n).bytes(chains);
}

// Returns the cudaError_t of the launch (0 = success).  J is (G, n, jrow),
// each row padded with zeros to jrow = n rounded up to 4; init01/uniforms
// are both null (Philox mode) or both set (host-variate mode); rule is 0 for
// Metropolis, 1, 2 or 4 for heat-bath at that update width; chains (chains
// per block, a warp each) is the host's geometry; fields_out and flips may
// be null.
extern "C" int qbmx_anneal_wide(const float* J, const float* h, const float* hot,
                                const float* logr, const float* init01,
                                const float* uniforms, float* out, float* fields_out,
                                unsigned long long* flips, int G, int B, int R, int n, int S,
                                float inv_span, unsigned long long seed, int rule, int chains,
                                void* stream) {
  if (G <= 0 || B <= 0 || R <= 0 || n <= 0 || S <= 0 || G > 65535 ||
      n > qbmx_anneal_wide_max_n() || (init01 == nullptr) != (uniforms == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{J, h, hot, logr, init01, uniforms, out, fields_out, flips, G, B, R, n, S,
               inv_span, (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32), chains};
  return (int)dispatch(a, rule, static_cast<cudaStream_t>(stream));
}
