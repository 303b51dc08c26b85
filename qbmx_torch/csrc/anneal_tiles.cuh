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
// Past n = 3368 one chain's fields and state no longer fit a block beside
// two 8-row tiles.  There each chain's n fields and its state bytes live in
// a scratch buffer in global memory (the wrapper allocates it: a row of
// frow floats and frow bytes a chain), and shared memory holds J_g alone:
// two buffers of a tile of 8 rows cut to a column chunk of cw floats, and
// two of the tile's 8x8 diagonal block.  Up to n = 3624 a chunk is the whole
// row; past it a row takes several chunks, so no width bound is left short
// of the card's memory.  Per tile, a chain (a warp) takes the tile's
// decisions first, on registers as tile_unit does: the tile's 8 fields and
// states, the couplings among them from the diagonal block; a change adds
// d·J_ij to all 8 of the tile's fields in registers and is kept (d8).  Then
// every chunk of the tile's rows adds the kept changes to the chain's other
// fields in global memory, each lane its float4s q = lane (mod 32), rows in
// increasing order, by fmaf; the tile's own 8 fields are written from the
// registers.  So every field takes the same adds in the same order as in the
// shared layout, and the fields, states and decisions are the same bit for
// bit (a zero's sign aside).  A refresh sweep recomputes a unit's fields by
// fields<M> on J_g's rows read from global memory (L2) and the state there,
// in the shared layout's order.  The cost of the layout: a tile with a
// change rewrites the chain's n fields in global memory (L2 while the
// chains' fields fit its 50 MB), where the shared layout adds to shared
// memory.

constexpr int kDiag = kRows * kRows;  // floats of a tile's diagonal block
// Floats a tile row holds: two 8-row tiles and two diagonal blocks fill a
// block's 232,448 bytes of shared memory at 3624 (a multiple of 8).
constexpr int kChunkMax = 3624;

struct GlobalLayout {
  int jrow;  // floats per (padded) J row: n rounded up to 8, so a diagonal
             // block's two float4s a row stay inside the row
  int frow;  // floats per chain's fields (and bytes of its state): n rounded up to 8
  int cw;    // floats a tile row holds: min(jrow, kChunkMax)

  __host__ __device__ int words() const { return frow / 4; }  // state words per chain
  __host__ __device__ int chunks() const { return (jrow + cw - 1) / cw; }
  __host__ __device__ size_t smem() const {
    return 4 * ((size_t)2 * kRows * cw + 2 * (size_t)kDiag);
  }
};

__host__ __device__ inline GlobalLayout global_layout_of(int n) {
  const int r8 = (n + kRows - 1) / kRows * kRows;
  return GlobalLayout{r8, r8, r8 < kChunkMax ? r8 : kChunkMax};
}

// Chunk `chunk` of rows [8·tile, 8·tile + 8) of the padded J_g (row stride
// L.jrow) into a tile buffer of row stride L.cw, and with chunk 0 the
// tile's diagonal block into `diag`, as asynchronous 16-byte copies.  Rows
// past n are not loaded: no change reads them.
__device__ __forceinline__ void load_chunk(float* dst, float* diag, const float* Jg, int tile,
                                           int chunk, int n, GlobalLayout L) {
  const int i0 = tile * kRows;
  const int rows = min(kRows, n - i0);
  const int c0 = chunk * L.cw;
  const int q4 = min(L.cw, L.jrow - c0) / 4;  // float4s a row of the chunk
  const int s4 = L.jrow / 4, d4 = L.cw / 4;
  const float4* src = reinterpret_cast<const float4*>(Jg) + (size_t)i0 * s4;
  float4* dst4 = reinterpret_cast<float4*>(dst);
  for (int q = threadIdx.x; q < rows * q4; q += blockDim.x) {
    const int row = q / q4, col = q - row * q4;
    __pipeline_memcpy_async(dst4 + row * d4 + col, src + (size_t)row * s4 + c0 / 4 + col,
                            sizeof(float4));
  }
  if (chunk == 0) {
    float4* g4 = reinterpret_cast<float4*>(diag);
    for (int q = threadIdx.x; q < 2 * rows; q += blockDim.x)
      __pipeline_memcpy_async(g4 + q, src + (size_t)(q >> 1) * s4 + i0 / 4 + (q & 1),
                              sizeof(float4));
  }
}

// A unit of the global-field layout at tile row rr (a constant once the
// tile's units are unrolled): its fields from the registers ft, or, in a
// refresh sweep, recomputed from J_g's rows (Jrow: row i0+rr in global
// memory) and the chain's state st; the decision on the diagonal block dg;
// a change updates the registers sv, ft (all 8 of the tile's fields, each
// by its rows in increasing order, as add_rows orders them), the state
// bytes and d8, the tile's changes kept for the chunks' adds.
template <int RULE, int M, bool COUNT>
__device__ __forceinline__ int global_unit(const float* dg, const float* Jrow, int jrow, int rr,
                                           int i0, bool refresh, uint32_t* st, int lane,
                                           const float* hp, float beta, float v, float ft[8],
                                           float sv[8], float d8[8], const int* nnz,
                                           unsigned& work) {
  float f[M], s[M], o[M], d[M];
  unsigned char* sb = reinterpret_cast<unsigned char*>(st);
  if (refresh) {
    fields<M>(Jrow, jrow, st, lane, hp + i0 + rr, f);
#pragma unroll
    for (int a = 0; a < M; ++a) ft[rr + a] = f[a];
  } else {
#pragma unroll
    for (int a = 0; a < M; ++a) f[a] = ft[rr + a];
  }
#pragma unroll
  for (int a = 0; a < M; ++a) s[a] = sv[rr + a];
  decide<RULE, M>(f, s, dg, rr, kRows, rr, beta, v, o);
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
      if (lane == 0) sb[i0 + rr + a] = o[a] != 0.0f ? 0xFF : 0x00;
    }
#pragma unroll
    for (int r2 = 0; r2 < kRows; ++r2)
#pragma unroll
      for (int a = 0; a < M; ++a)
        if (d[a] != 0.0f) ft[r2] = fmaf(d[a], dg[(rr + a) * kRows + r2], ft[r2]);
    count_rows<M, COUNT>(nnz, i0 + rr, d, work);
    if (refresh) __syncwarp();  // the chain's lanes see the state before the next refresh
  }
  return changed;
}

// sweep_tiles in the global-field layout: one sweep of the block's chains
// over the tiles of J_g (Jg, rows padded to L.jrow), each tile's chunks in
// turn, the next chunk (or the next tile's first, wrapping to tile 0 of the
// next sweep unless `last`) prefetched into the other buffer while one is
// used.  fr and st are the chain's fields and state in global memory; an
// inactive warp (a spare chain) takes part in the loads and barriers only.
// The first call must follow a load_chunk of tile 0, chunk 0 into buffer
// `buf` and its commit.  Returns the variables the chain changed, and,
// where COUNT, adds to `work` the nonzeros of their rows.
template <int RULE, bool COUNT>
__device__ __forceinline__ int sweep_global(float* tiles, float* diags, int& buf, const float* Jg,
                                            GlobalLayout L, int n, bool last, bool refresh,
                                            bool active, float beta, SweepUniforms& u, float* fr,
                                            uint32_t* st, int lane, const float* hp,
                                            const int* nnz, unsigned& work) {
  const int ntiles = (n + kRows - 1) / kRows, nch = L.chunks();
  const int tile_floats = kRows * L.cw, d4 = L.cw / 4;
  int changed = 0;
  float mine = 0.0f;  // this lane's threshold or uniform of the current batch
  for (int k = 0; k < ntiles; ++k) {
    const int i0 = k * kRows;
    const int base = i0 - i0 % kLanes;  // first variable of the lanes' batch
    if (active && base == i0) {  // every 4th tile, as sweep_tiles
      mine = 0.0f;
      if (i0 + lane < n) {
        const float uu = u(i0 + lane);
        mine = RULE == 0 ? metropolis_threshold(uu, beta)
               : RULE == 1 ? heatbath_threshold(uu, beta) : uu;
      }
    }
    float d8[kRows];  // the tile's changes, by row
#pragma unroll
    for (int a = 0; a < kRows; ++a) d8[a] = 0.0f;
    for (int c = 0; c < nch; ++c) {
      const bool tile_end = c + 1 == nch;
      if (!(last && tile_end && k + 1 == ntiles))
        load_chunk(tiles + (buf ^ 1) * tile_floats, diags + (buf ^ 1) * kDiag, Jg,
                   tile_end ? (k + 1 < ntiles ? k + 1 : 0) : k, tile_end ? 0 : c + 1, n, L);
      __pipeline_commit();
      __pipeline_wait_prior(1);  // this thread's copies of the chunk have landed
      __syncthreads();           // ... and every thread's, and the last chunk's writes
      if (active && c == 0) {    // the tile's decisions
        const float* dg = diags + buf * kDiag;
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
        auto v_at = [&](int rr) { return __shfl_sync(0xFFFFFFFFu, mine, i0 + rr - base); };
        changed += tile_schedule<RULE>(i0, n, [&](int rr, auto w) {
          constexpr int M = decltype(w)::value;
          return global_unit<RULE, M, COUNT>(dg, Jg + (size_t)(i0 + rr) * L.jrow, L.jrow, rr, i0,
                                             refresh, st, lane, hp, beta, v_at(rr), ft, sv, d8,
                                             nnz, work);
        });
        if (lane == 0) {
          *reinterpret_cast<float4*>(fr + i0) = make_float4(ft[0], ft[1], ft[2], ft[3]);
          *reinterpret_cast<float4*>(fr + i0 + 4) = make_float4(ft[4], ft[5], ft[6], ft[7]);
        }
      }
      bool any = false;
#pragma unroll
      for (int a = 0; a < kRows; ++a) any |= d8[a] != 0.0f;
      if (active && any) {  // the tile's changes onto the chunk's other fields
        const int q0 = c * d4, qn = min(L.cw, L.jrow - c * L.cw) / 4;
        const float4* T = reinterpret_cast<const float4*>(tiles + buf * tile_floats);
        float4* F = reinterpret_cast<float4*>(fr);
        for (int q = lane; q < qn; q += kLanes) {
          const int gq = q0 + q;
          if (gq == i0 / 4 || gq == i0 / 4 + 1) continue;  // the tile's own: from ft
          float4 x = F[gq];
#pragma unroll
          for (int a = 0; a < kRows; ++a) {
            if (d8[a] != 0.0f) {
              const float4 t = T[a * d4 + q];
              x.x = fmaf(d8[a], t.x, x.x);
              x.y = fmaf(d8[a], t.y, x.y);
              x.z = fmaf(d8[a], t.z, x.z);
              x.w = fmaf(d8[a], t.w, x.w);
            }
          }
          F[gq] = x;
        }
      }
      __syncthreads();  // buffer buf is free for the prefetch after next; fields in place
      buf ^= 1;
    }
  }
  return changed;
}

}  // namespace qbmx
