// The tile machinery of the kernels whose couplings J_g stream through
// shared memory in row tiles, a warp a chain: anneal_wide.cu (K4, every
// anneal rule) and pt_wide.cu (K5's dense path, parallel tempering, the
// heat-bath rule).  Moved here from anneal_wide.cu; anneal_wide.cu's header
// comment describes the scheme (tiles double-buffered with cp.async,
// incremental local fields with a refresh every so many sweeps, the tile's
// fields and states in registers, 32 thresholds drawn by a warp's lanes at
// once) and how far the fields drift.  Two layouts: the shared one
// (sweep_tiles: a chain's fields and state in shared memory, n <= 3368)
// and the global-field one (sweep_global: in a scratch buffer in global
// memory, any n), which compute the same fields bit for bit.
// anneal_wide_sparse.cu (K4's shared layout on J_g's row lists) takes its
// units, decisions and refreshed fields from here too (tile_schedule,
// decide_with, sparse_fields).
//
// Build without --use_fast_math (anneal_rules.cuh).

#pragma once

#include <cstdint>
#include <cuda_pipeline.h>

#include "anneal_rules.cuh"

namespace qbmx {

constexpr int kRows = 8;    // J rows per tile
constexpr int kLanes = 32;  // threads a chain: a warp

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
// them (coupling(a, b) = J_{i+a, i+b}, a < b) and v, the first variable's
// threshold (RULE 0, 1) or uniform (RULE 2, 4).
template <int RULE, int M, typename Coupling>
__device__ __forceinline__ void decide_with(const float f[M], const float s[M],
                                            Coupling&& coupling, float beta, float v,
                                            float o[M]) {
  if constexpr (M == 4) {
    float c[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = a + 1; b < 4; ++b) c[a][b] = coupling(a, b);
    quad_rule(f, c, s, beta, v, o);
  } else if constexpr (M == 2) {
    pair_rule(f[0], f[1], coupling(0, 1), s[0], s[1], beta, v, o[0], o[1]);
  } else if constexpr (RULE == 0) {
    o[0] = metropolis_accept(f[0], s[0], v) ? 1.0f - s[0] : s[0];
  } else if constexpr (RULE == 1) {
    o[0] = f[0] < v ? 1.0f : 0.0f;
  } else {
    o[0] = single_rule(f[0], beta, v);
  }
}

// decide_with on the couplings of tile rows rr.. (row stride jrow).
template <int RULE, int M>
__device__ __forceinline__ void decide(const float f[M], const float s[M], const float* tile,
                                       int rr, int jrow, int i, float beta, float v,
                                       float o[M]) {
  decide_with<RULE, M>(
      f, s, [&](int a, int b) { return tile[(rr + a) * jrow + i + b]; }, beta, v, o);
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

// Adds to `work` the nonzeros nnz[i+a] of each changed variable's row (the
// work a change does on a sparse J, for the bound), where COUNT: the
// kernels' counting build, launched only for checks (the main path's
// build has none of it).
template <int M, bool COUNT>
__device__ __forceinline__ void count_rows(const int* nnz, int i, const float d[M],
                                           unsigned& work) {
  if constexpr (!COUNT) return;
#pragma unroll
  for (int a = 0; a < M; ++a)
    if (d[a] != 0.0f) work += (unsigned)nnz[i + a];
}

// A unit of a refresh sweep: the fields of variables i..i+M-1 recomputed
// from the state in shared memory, the decision, and its change applied to
// the state and every field.  Returns the number of variables changed.
template <int RULE, int M, bool COUNT>
__device__ __forceinline__ int refresh_unit(const float* tile, int rr, int jrow, float* fr,
                                            uint32_t* st, int lane, const float* hp, int i,
                                            float beta, float v, const int* nnz,
                                            unsigned& work) {
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
  if (changed != 0) {  // the same on the chain's lanes
    add_rows<M>(fr, tile, rr, jrow, lane, d);
    count_rows<M, COUNT>(nnz, i, d, work);
  }
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
template <int RULE, int M, bool COUNT>
__device__ __forceinline__ int tile_unit(const float* tile, int rr, int jrow, float* fr,
                                         unsigned char* sb, int lane, int i0, float beta,
                                         float v, float ft[8], float sv[8], const int* nnz,
                                         unsigned& work) {
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
    count_rows<M, COUNT>(nnz, i0 + rr, d, work);
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

// One sweep of the block's chains, a warp each, over the tiles of J_g
// (Jg, rows padded to L.jrow), at the chain's beta and uniforms u: while
// tile k is used, tile k+1 is prefetched into the other buffer (wrapping
// to tile 0 of the next sweep unless `last`); every 4th tile the chain's
// 32 lanes draw the next 32 variables' thresholds (RULE 0, 1) or uniforms
// (RULE 2, 4) at once; then the tile's units, each field recomputed just
// before its decision (`refresh`) or incremental.  Every thread of the
// block calls it (it has a barrier a tile); the first call must follow a
// load_tile of tile 0 into buffer `buf` and its commit.  Returns the
// variables the chain changed, and, where COUNT, adds to `work` the
// nonzeros of their rows (nnz: J_g's nonzeros a row).
template <int RULE, bool COUNT>
__device__ __forceinline__ int sweep_tiles(float* tiles, int& buf, const float* Jg, Layout L,
                                           int n, bool last, bool refresh, float beta,
                                           SweepUniforms& u, float* fr, uint32_t* st, int lane,
                                           const float* hp, const int* nnz, unsigned& work) {
  unsigned char* sb = reinterpret_cast<unsigned char*>(st);
  const int ntiles = (n + kRows - 1) / kRows;
  const int tile_floats = kRows * L.jrow;
  int changed = 0;
  float mine = 0.0f;  // this lane's threshold or uniform of the current batch
  for (int k = 0; k < ntiles; ++k) {
    if (!last || k + 1 < ntiles)  // prefetch the next tile, wrapping to the next sweep
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
        return refresh_unit<RULE, M, COUNT>(tile, rr, L.jrow, fr, st, lane, hp, i0 + rr,
                                            beta, v_at(rr), nnz, work);
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
        return tile_unit<RULE, M, COUNT>(tile, rr, L.jrow, fr, sb, lane, i0, beta, v_at(rr),
                                         ft, sv, nnz, work);
      });
    }
    __syncthreads();  // tile buffer buf is free for the prefetch after next
    buf ^= 1;
  }
  return changed;
}

// ---- The global-field layout --------------------------------------------
//
// Past n = 1056 a block of the shared layout holds fewer than 31 chains,
// and past n = 3368 not one.  There each chain's n fields and its state bytes
// live in a scratch buffer in global memory (the wrapper allocates it: a
// row of frow floats and frow bytes a chain), and a sweep walks J_g's rows
// in windows of kWin = 128.  For each window, shared memory holds the
// window's kWin x kWin diagonal block of J_g and, for each chain (a warp),
// the window's fields and state bytes, read once from global memory at the
// window's start, and the list of the window's changes:
//   * the decisions run tile by tile (8 rows), on registers as tile_unit's
//     do: the tile's 8 fields and states, the couplings among them from the
//     diagonal block; a change adds d·J_ij to all 8 of the tile's fields in
//     registers.  At the tile's end the tile's changes are added to the
//     window's other fields in shared memory (each lane its fields j ≡ lane
//     mod 32, rows in increasing order, by fmaf, from the diagonal block),
//     the tile's own 8 are written from the registers, and the changes are
//     appended to the list;
//   * at the window's end its fields go back to global memory, and one pass
//     adds the window's changes to the chain's other fields there, rows in
//     increasing order, by fmaf:
//       - the dense pass (any J_g) streams the window's rows of J_g through
//         shared memory in column chunks of kWin floats, double-buffered
//         with cp.async and shared by the block's chains; each lane adds to
//         its float4 of the chunk;
//       - the sparse pass (a sparse J_g; the wrapper's density rule picks
//         it) reads each changed row's nonzeros from J_g's row lists in
//         global memory, columns increasing, lane l taking entries l, l+32,
//         ... of a row (distinct columns), the rows in increasing order with
//         a warp barrier between them; a lane keeps the last field it added
//         to in a register while its next entry is the same column (and
//         writes it back before any other lane may read it), so where the
//         changed rows share one column (the restricted flat model: every
//         hidden row's only nonzero is the output's) that field is read
//         and written once a window.  It streams no tiles of J_g.
// So every field takes the same adds in the same order as in the shared
// layout (fmaf(d, 0, f) is f exactly, so the sparse pass's skipping of the
// zeros changes nothing), and the fields, states and decisions are the same
// bit for bit (a zero's sign aside).  A refresh sweep recomputes a unit's
// fields in the shared layout's order from the state in global memory: by
// fields<M> on J_g's dense rows (dense pass), or on the row lists (sparse
// pass: lane l sums, in increasing j, the nonzero J_ij with s_j = 1 of the
// columns with (j / 4) % 32 == l; zeros add nothing).  A field is read and
// written in global memory about 2·n/kWin times a sweep, not once a tile
// with a change (the parent design's n/8).

constexpr int kWin = 128;  // rows a window, and columns a dense pass chunk
constexpr int kWinFloats = kWin * kWin;
constexpr int kWinChainBytes = 4 * kWin + kWin + kWin;  // fields, state bytes, change list

struct GlobalLayout {
  int jrow;  // floats per (padded) J row: n rounded up to 8
  int frow;  // floats per chain's fields (and bytes of its state): n rounded up to 8

  __host__ __device__ int words() const { return frow / 4; }  // state words per chain
  __host__ __device__ int chunks() const { return (jrow + kWin - 1) / kWin; }
  // A block's shared memory: the diagonal block, the dense pass's two
  // chunk buffers, and each chain's window rows.
  __host__ __device__ size_t smem(int chains, bool sparse) const {
    return 4 * (size_t)kWinFloats * (sparse ? 1 : 3) + (size_t)chains * kWinChainBytes;
  }
};

__host__ __device__ inline GlobalLayout global_layout_of(int n) {
  const int r8 = (n + kRows - 1) / kRows * kRows;
  return GlobalLayout{r8, r8};
}

// Ints of a group's row offsets in J_g's row lists: n + 1 rounded up to 4
// (16-byte copies).
__host__ __device__ inline int offsets_len(int n) { return (n + 4) / 4 * 4; }

// J_g's nonzero rows for the sparse pass (pt_wide_cuda.row_lists): row i's
// entries at offs[i] .. offs[i+1]-1 of vals and cols, columns increasing;
// null pointers on the dense pass.
struct RowLists {
  const float* vals;
  const uint16_t* cols;
  const int* offs;
};

// The shared memory of a global-field block and a chain's part of it.
struct GlobalSmem {
  float* diag;   // the window's kWin x kWin diagonal block (row stride kWin)
  float* tiles;  // the dense pass: two chunks of kWin rows x kWin floats
  float* wf;     // the chain's window fields
  unsigned char* ws;    // ... its window state bytes (0x00 or 0xFF)
  unsigned char* list;  // ... the window's changes: (row - window start) << 1 | (d > 0)

  __device__ static GlobalSmem of(unsigned char* smem, int chains, int c, bool sparse) {
    float* diag = reinterpret_cast<float*>(smem);
    float* tiles = diag + kWinFloats;
    float* wf0 = tiles + (sparse ? 0 : 2 * kWinFloats);
    unsigned char* ws0 = reinterpret_cast<unsigned char*>(wf0 + (size_t)chains * kWin);
    unsigned char* list0 = ws0 + (size_t)chains * kWin;
    return GlobalSmem{diag, tiles, wf0 + (size_t)c * kWin, ws0 + (size_t)c * kWin,
                      list0 + (size_t)c * kWin};
  }
};

// Rows [w0, w0 + rows) and columns [c0, c0 + cols) of the padded J_g (row
// stride L.jrow) into dst (row stride kWin), as asynchronous 16-byte
// copies by the block's threads; c0 and cols are multiples of 4.
__device__ __forceinline__ void load_block(float* dst, const float* Jg, int w0, int rows, int c0,
                                           int cols, GlobalLayout L) {
  const int q4 = cols / 4, s4 = L.jrow / 4;
  const float4* src = reinterpret_cast<const float4*>(Jg) + (size_t)w0 * s4 + c0 / 4;
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int q = threadIdx.x; q < rows * q4; q += blockDim.x) {
    const int row = q / q4, col = q - row * q4;
    __pipeline_memcpy_async(d4 + row * (kWin / 4) + col, src + (size_t)row * s4 + col,
                            sizeof(float4));
  }
}

// Window k's diagonal block: its rows past n are not loaded (no change
// reads them), its columns up to the padded row's end.
__device__ __forceinline__ void load_diag(float* diag, const float* Jg, int k, int n,
                                          GlobalLayout L) {
  const int w0 = k * kWin;
  load_block(diag, Jg, w0, min(kWin, n - w0), w0, min(kWin, L.jrow - w0), L);
}

// Variables i..i+M-1's fields recomputed from J_g's row lists and the
// chain's state sb, in fields<M>'s order (header); every lane gets the
// same M values.
template <int M>
__device__ __forceinline__ void sparse_fields(const RowLists& rl, int i,
                                              const unsigned char* sb, int lane, const float* hp,
                                              float f[M]) {
#pragma unroll
  for (int a = 0; a < M; ++a) {
    float acc = 0.0f;
    const int e1 = rl.offs[i + a + 1];
    for (int e = rl.offs[i + a]; e < e1; ++e) {
      const int j = rl.cols[e];
      if (((j >> 2) & (kLanes - 1)) == lane && sb[j] != 0) acc += rl.vals[e];
    }
#pragma unroll
    for (int d = 1; d < kLanes; d <<= 1) acc += __shfl_xor_sync(0xFFFFFFFFu, acc, d);
    f[a] = hp[i + a] + acc;
  }
}

// A unit of the global-field layout at tile row rr (a constant once the
// tile's units are unrolled): its fields from the registers ft, or, in a
// refresh sweep, recomputed from J_g's rows (Jrow: row i0+rr in global
// memory; SPARSE: the row lists) and the chain's state st; the decision on
// the diagonal block's tile dg (row stride kWin); a change updates the
// registers sv, ft (all 8 of the tile's fields, each by its rows in
// increasing order, as add_rows orders them), the state bytes (global and
// the window's) and d8, the tile's changes.
template <int RULE, int M, bool SPARSE, bool COUNT>
__device__ __forceinline__ int global_unit(const float* dg, const float* Jrow, const RowLists& rl,
                                           int jrow, int rr, int i0, bool refresh, uint32_t* st,
                                           unsigned char* wsb, int lane, const float* hp,
                                           float beta, float v, float ft[8], float sv[8],
                                           float d8[8], const int* nnz, unsigned& work) {
  float f[M], s[M], o[M], d[M];
  unsigned char* sb = reinterpret_cast<unsigned char*>(st);
  if (refresh) {
    if constexpr (SPARSE)
      sparse_fields<M>(rl, i0 + rr, sb, lane, hp, f);
    else
      fields<M>(Jrow, jrow, st, lane, hp + i0 + rr, f);
#pragma unroll
    for (int a = 0; a < M; ++a) ft[rr + a] = f[a];
  } else {
#pragma unroll
    for (int a = 0; a < M; ++a) f[a] = ft[rr + a];
  }
#pragma unroll
  for (int a = 0; a < M; ++a) s[a] = sv[rr + a];
  decide<RULE, M>(f, s, dg, rr, kWin, rr, beta, v, o);
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
      d8[rr + a] = d[a];
      if (lane == 0 && d[a] != 0.0f) {
        const unsigned char byte = o[a] != 0.0f ? 0xFF : 0x00;
        sb[i0 + rr + a] = byte;
        wsb[rr + a] = byte;
      }
    }
#pragma unroll
    for (int r2 = 0; r2 < kRows; ++r2)
#pragma unroll
      for (int a = 0; a < M; ++a)
        if (d[a] != 0.0f) ft[r2] = fmaf(d[a], dg[(rr + a) * kWin + r2], ft[r2]);
    count_rows<M, COUNT>(nnz, i0 + rr, d, work);
    if (refresh) __syncwarp();  // the chain's lanes see the state before the next refresh
  }
  return changed;
}

// The window's decisions for one chain (a warp) on the diagonal block in
// shared memory: tile by tile, each tile's changes then added to the
// window's other fields in shared memory and appended to the change list.
// Returns the variables changed; `count` is the list's length.
template <int RULE, bool SPARSE, bool COUNT>
__device__ __forceinline__ int window_decisions(const GlobalSmem& sm, const float* Jg,
                                                const RowLists& rl, GlobalLayout L, int n, int w0,
                                                bool refresh, float beta, SweepUniforms& u,
                                                uint32_t* st, int lane, const float* hp,
                                                const int* nnz, unsigned& work, int& count) {
  const int rows = min(kWin, n - w0), nf = min(kWin, L.frow - w0);
  int changed = 0;
  float mine = 0.0f;  // this lane's threshold or uniform of the current batch
  for (int t = 0; t < rows; t += kRows) {
    const int i0 = w0 + t;
    if (t % kLanes == 0) {  // every 4th tile, as sweep_tiles
      mine = 0.0f;
      if (i0 + lane < n) {
        const float uu = u(i0 + lane);
        mine = RULE == 0 ? metropolis_threshold(uu, beta)
               : RULE == 1 ? heatbath_threshold(uu, beta) : uu;
      }
    }
    const float* dg = sm.diag + t * kWin + t;
    float ft[kRows], sv[kRows], d8[kRows];
    const float4 f0 = *reinterpret_cast<const float4*>(sm.wf + t);
    const float4 f1 = *reinterpret_cast<const float4*>(sm.wf + t + 4);
    const uint32_t w0s = reinterpret_cast<const uint32_t*>(sm.ws)[t / 4];
    const uint32_t w1s = reinterpret_cast<const uint32_t*>(sm.ws)[t / 4 + 1];
    ft[0] = f0.x, ft[1] = f0.y, ft[2] = f0.z, ft[3] = f0.w;
    ft[4] = f1.x, ft[5] = f1.y, ft[6] = f1.z, ft[7] = f1.w;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      sv[b] = (w0s >> (8 * b)) & 0xFFu ? 1.0f : 0.0f;
      sv[b + 4] = (w1s >> (8 * b)) & 0xFFu ? 1.0f : 0.0f;
      d8[b] = d8[b + 4] = 0.0f;
    }
    const int base = i0 - i0 % kLanes;
    auto v_at = [&](int rr) { return __shfl_sync(0xFFFFFFFFu, mine, i0 + rr - base); };
    const int tile_changed = tile_schedule<RULE>(i0, n, [&](int rr, auto w) {
      constexpr int M = decltype(w)::value;
      return global_unit<RULE, M, SPARSE, COUNT>(dg, Jg + (size_t)(i0 + rr) * L.jrow, rl, L.jrow,
                                                 rr, i0, refresh, st, sm.ws + t, lane, hp, beta,
                                                 v_at(rr), ft, sv, d8, nnz, work);
    });
    if (lane == 0) {
      *reinterpret_cast<float4*>(sm.wf + t) = make_float4(ft[0], ft[1], ft[2], ft[3]);
      *reinterpret_cast<float4*>(sm.wf + t + 4) = make_float4(ft[4], ft[5], ft[6], ft[7]);
    }
    if (tile_changed != 0) {  // the same on the chain's lanes
      // the tile's changes onto the window's other fields, rows increasing
      for (int j = lane; j < nf; j += kLanes) {
        if (j >= t && j < t + kRows) continue;  // the tile's own: from ft
        float x = sm.wf[j];
#pragma unroll
        for (int a = 0; a < kRows; ++a)
          if (d8[a] != 0.0f) x = fmaf(d8[a], sm.diag[(t + a) * kWin + j], x);
        sm.wf[j] = x;
      }
      if (lane == 0) {
        int c = count;
#pragma unroll
        for (int a = 0; a < kRows; ++a)
          if (d8[a] != 0.0f) sm.list[c++] = (unsigned char)(((t + a) << 1) | (d8[a] > 0.0f));
      }
#pragma unroll
      for (int a = 0; a < kRows; ++a) count += d8[a] != 0.0f;
      changed += tile_changed;
    }
    __syncwarp();  // the tile's fields, state bytes and list in place for every lane
  }
  return changed;
}

// The dense pass's work on one chunk of kWin columns (tile T: the window's
// changed rows, row stride kWin): lane l adds the changes, in list order
// (rows increasing), to its float4 of the chain's fields there.
__device__ __forceinline__ void dense_chunk(const float* T, const unsigned char* list, int count,
                                            float* fr, int c0, int cols, int lane) {
  if (4 * lane >= cols) return;
  float4* F = reinterpret_cast<float4*>(fr + c0) + lane;
  const float4* T4 = reinterpret_cast<const float4*>(T) + lane;
  float4 x = *F;
  for (int e = 0; e < count; ++e) {
    const int entry = list[e];
    const float d = entry & 1 ? 1.0f : -1.0f;
    const float4 t = T4[(entry >> 1) * (kWin / 4)];
    x.x = fmaf(d, t.x, x.x);
    x.y = fmaf(d, t.y, x.y);
    x.z = fmaf(d, t.z, x.z);
    x.w = fmaf(d, t.w, x.w);
  }
  *F = x;
}

// The sparse pass of one chain (header): the window's changes (list,
// count; window w0, its fields [w0, w0 + nf)) onto the fields outside the
// window, from the row lists.
__device__ __forceinline__ void sparse_pass(const RowLists& rl, const unsigned char* list,
                                            int count, float* fr, int w0, int nf, int lane) {
  int cj = -1;      // the column whose field this lane holds in cf
  float cf = 0.0f;
  for (int e = 0; e < count; ++e) {
    const int entry = list[e];
    const float d = entry & 1 ? 1.0f : -1.0f;
    const int a = w0 + (entry >> 1);
    const int e0 = rl.offs[a], e1 = rl.offs[a + 1];
    for (int b = e0; b < e1; b += kLanes) {  // the same steps on every lane
      int j = -1;
      float v = 0.0f;
      if (b + lane < e1) {
        j = rl.cols[b + lane];
        if (j >= w0 && j < w0 + nf)
          j = -1;  // a window field: the decisions added it
        else
          v = rl.vals[b + lane];
      }
      if (cj >= 0 && cj != j) {  // write back before another lane may read it
        fr[cj] = cf;
        cj = -1;
      }
      __syncwarp();
      if (j >= 0) {
        if (cj != j) {
          cf = fr[j];
          cj = j;
        }
        cf = fmaf(d, v, cf);
      }
    }
  }
  if (cj >= 0) fr[cj] = cf;
  __syncwarp();
}

// One sweep of the block's chains, a warp each, in the global-field layout
// (header), window by window; the dense pass (SPARSE false) streams J_g's
// rows (Jg, padded to L.jrow) in chunks, the sparse pass reads the row
// lists rl.  fr and st are the chain's fields and state in global memory;
// an inactive warp (a spare chain) takes part in the loads and barriers
// only.  The first call must follow a load_diag of window 0 and its
// commit; unless `last`, the sweep ends with window 0's loaded for the
// next.  Returns the variables the chain changed, and, where COUNT, adds to
// `work` the nonzeros of their rows.
template <int RULE, bool SPARSE, bool COUNT>
__device__ __forceinline__ int sweep_global(const GlobalSmem& sm, const float* Jg,
                                            const RowLists& rl, GlobalLayout L, int n, bool last,
                                            bool refresh, bool active, float beta,
                                            SweepUniforms& u, float* fr, uint32_t* st, int lane,
                                            const float* hp, const int* nnz, unsigned& work) {
  const int nwin = (n + kWin - 1) / kWin, nch = L.chunks();
  int changed = 0;
  for (int k = 0; k < nwin; ++k) {
    const int w0 = k * kWin, nf = min(kWin, L.frow - w0);
    const bool more = !(last && k + 1 == nwin);  // a next window's block to load
    const int next = k + 1 < nwin ? k + 1 : 0;
    __pipeline_wait_prior(0);  // this thread's copies of the diagonal block
    __syncthreads();           // ... every thread's; the last pass's fields in place
    int count = 0;             // the window's changes
    if (active) {  // the window's fields and state, read once
      for (int q = lane; q < nf / 4; q += kLanes) {
        reinterpret_cast<float4*>(sm.wf)[q] = reinterpret_cast<const float4*>(fr + w0)[q];
        reinterpret_cast<uint32_t*>(sm.ws)[q] = st[w0 / 4 + q];
      }
      __syncwarp();
      changed += window_decisions<RULE, SPARSE, COUNT>(sm, Jg, rl, L, n, w0, refresh, beta, u,
                                                        st, lane, hp, nnz, work, count);
      for (int q = lane; q < nf / 4; q += kLanes)
        reinterpret_cast<float4*>(fr + w0)[q] = reinterpret_cast<const float4*>(sm.wf)[q];
    }
    __syncthreads();  // every chain is done with the diagonal block
    if constexpr (SPARSE) {
      if (more) load_diag(sm.diag, Jg, next, n, L);
      __pipeline_commit();
      if (active && count > 0) sparse_pass(rl, sm.list, count, fr, w0, nf, lane);
    } else {
      // the window's rows of J_g chunk by chunk (chunk k: the window's own
      // columns, skipped), the next chunk, or after the last the next
      // window's diagonal block, prefetched into the other buffer
      const int rows = min(kWin, n - w0), passes = nch - 1;
      int buf = 0;
      auto chunk_of = [&](int p) { return p < k ? p : p + 1; };
      auto load = [&](int p, int b) {
        const int c0 = chunk_of(p) * kWin;
        load_block(sm.tiles + b * kWinFloats, Jg, w0, rows, c0, min(kWin, L.jrow - c0), L);
      };
      if (passes > 0) load(0, 0);
      else if (more) load_diag(sm.diag, Jg, next, n, L);
      __pipeline_commit();
      for (int p = 0; p < passes; ++p) {
        if (p + 1 < passes) load(p + 1, buf ^ 1);
        else if (more) load_diag(sm.diag, Jg, next, n, L);
        __pipeline_commit();
        __pipeline_wait_prior(1);  // this thread's copies of chunk p
        __syncthreads();           // ... every thread's
        const int c0 = chunk_of(p) * kWin;
        if (active && count > 0)
          dense_chunk(sm.tiles + buf * kWinFloats, sm.list, count, fr, c0,
                      min(kWin, L.jrow - c0), lane);
        __syncthreads();  // buffer buf is free for the prefetch after next
        buf ^= 1;
      }
    }
  }
  return changed;
}

}  // namespace qbmx
