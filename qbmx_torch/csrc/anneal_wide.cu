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
// anneal_rules.cuh, Philox streams, host-variate layout); only the order of
// a field's float32 sum differs (below).
//
// What bounds it on this card.  At the CDQBM probabilistic-pooling shape
// (G=2, B=20, R=100, n=717, S=1000: 4,000 chains) J_g is 717²·4 B = 2.06 MB,
// nine times a block's 227 KB of shared memory, so K1's layout is
// impossible, and a chain reading its own J rows from L2 every sweep would
// move ~8 PB a call.  So the chains of a group share every J read:
//   * a block holds C = 32 chains of one group, P = 8 threads (lanes) per
//     chain, 256 threads; the grid is (ceil(B·R / 32), G): 126 blocks at the
//     CDQBM shape, about one per SM (132);
//   * J_g streams through shared memory in tiles of 8 rows (8 × 736 floats,
//     23.5 KB at n=717), double-buffered with cp.async so that the next tile
//     loads while this one is used; J traffic is ~126 × 2.06 MB a sweep,
//     ~260 GB a call, from L2;
//   * each chain's state sits in shared memory, one byte per variable (0x00
//     or 0xFF), in a row of W 32-bit words with W ≡ P (mod 32), so the 32
//     lanes of a warp (4 chains × 8 lanes) read 32 different banks;
//   * a field is split over its chain's 8 lanes, and J_ij & mask(s_j) equals
//     J_ij·s_j exactly for s_j in {0, 1}.  A butterfly of three shuffles gives
//     every lane the same sum, so all 8 lanes take the same decision, and
//     lane 0 writes the state byte(s).  Pairs and quads start at multiples of
//     2 and 4 and never straddle an 8-row tile.
// What remains is arithmetic: 4,000 × 717² × 1,000 ≈ 2·10¹² masked adds a
// call.  Incremental fields, packed state bits and tensor cores for a
// block-sweep product are later work.
//
// Sum order (fixed): field_i = h_i + ((L0 + L1) + (L2 + L3)) + ((L4 + L5) +
// (L6 + L7)), where lane l's L_l sums, in increasing order, the state words
// w ≡ l (mod 8), each word's four variables j = 4w..4w+3 in increasing
// order.  K1 and K2 sum j = 0..n-1 serially and the plain versions use
// torch.matmul, so a near-tie decision may go the other way in another
// implementation; chip_smoke.py bounds the chains that diverge.
//
// Random numbers: the streams of K1 and K2 (philox.cuh), keyed by (seed,
// problem id) with the counter over (read, variable/4, sweep), so
// qbmx_torch/samplers/sa_torch.py::philox_variates writes out this kernel's
// draws too.  With non-null pointers the initial state init01 (G,B,R,n) and
// the uniforms (S,G,B,n,R) come from the host.
//
// Build without --use_fast_math (anneal_rules.cuh).

#include <climits>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "anneal_rules.cuh"

namespace {

using qbmx::heatbath_rule;
using qbmx::kInitTag;
using qbmx::metropolis_rule;
using qbmx::pair_rule;
using qbmx::philox4x32_10;
using qbmx::quad_rule;
using qbmx::single_rule;
using qbmx::SweepUniforms;
using qbmx::word;

constexpr int kLanes = 8;                   // threads per chain
constexpr int kChains = 32;                 // chains per block
constexpr int kThreads = kLanes * kChains;  // 256
constexpr int kRows = 8;                    // J rows per tile
constexpr size_t kSmemMax = 232448;         // a block's shared memory on Hopper

// Shared-memory layout of a block at width n.
struct Layout {
  int jrow;   // floats per tile row: n rounded up to a multiple of 4·kLanes
  int words;  // state words per chain: >= jrow/4 and ≡ kLanes (mod 32)

  __host__ __device__ size_t bytes() const {
    return (size_t)kChains * words * 4 + (size_t)2 * kRows * jrow * 4;
  }
};

__host__ __device__ inline Layout layout_of(int n) {
  Layout L;
  L.jrow = (n + 4 * kLanes - 1) / (4 * kLanes) * (4 * kLanes);
  const int w = L.jrow / 4;
  L.words = w + ((kLanes - w) % 32 + 32) % 32;
  return L;
}

// Rows [8·tile, 8·tile + 8) of J_g into a tile buffer (row stride jrow),
// as asynchronous 4-byte copies; columns n..jrow-1 are never read unmasked.
__device__ __forceinline__ void load_tile(float* dst, const float* Jg, int tile, int n,
                                          int jrow) {
  const int i0 = tile * kRows;
  const int rows = min(kRows, n - i0);
  for (int rr = 0; rr < rows; ++rr) {
    const float* src = Jg + (size_t)(i0 + rr) * n;
    for (int j = threadIdx.x; j < n; j += kThreads)
      __pipeline_memcpy_async(dst + rr * jrow + j, src + j, sizeof(float));
  }
}

__device__ __forceinline__ float masked(float x, uint32_t mask) {
  return __uint_as_float(__float_as_uint(x) & mask);
}

// Fields of variables i..i+M-1 (tile rows Ji, row stride jrow) on the
// chain's state st; every lane of the chain gets the same M values.
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

// Update variables i..i+M-1 (tile row rr = i mod 8) by RULE: 0 Metropolis,
// 1 heat-bath; M = 2 or 4 the joint pair or quad draw, M = 1 under RULE 2
// or 4 the trailing single.
template <int RULE, int M>
__device__ __forceinline__ void update(const float* tile, int rr, int jrow, uint32_t* st,
                                       int lane, const float* hp, int i, float beta,
                                       float u) {
  float f[M], s[M], o[M];
  fields<M>(tile + rr * jrow, jrow, st, lane, hp + i, f);
  unsigned char* sb = reinterpret_cast<unsigned char*>(st);
#pragma unroll
  for (int a = 0; a < M; ++a) s[a] = sb[i + a] ? 1.0f : 0.0f;
  if constexpr (M == 4) {
    float c[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = a + 1; b < 4; ++b) c[a][b] = tile[(rr + a) * jrow + i + b];
    quad_rule(f, c, s, beta, u, o);
  } else if constexpr (M == 2) {
    pair_rule(f[0], f[1], tile[rr * jrow + i + 1], s[0], s[1], beta, u, o[0], o[1]);
  } else if constexpr (RULE == 0) {
    o[0] = metropolis_rule(f[0], s[0], beta, u);
  } else if constexpr (RULE == 1) {
    o[0] = heatbath_rule(f[0], beta, u);
  } else {
    o[0] = single_rule(f[0], beta, u);
  }
  __syncwarp();  // every lane has read the state before lane 0 writes it
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < M; ++a) sb[i + a] = o[a] != 0.0f ? 0xFF : 0x00;
  }
  __syncwarp();  // ... and sees the write before the next field
}

// Variables updated together at i: quads, then a remainder pair and/or a
// trailing single (RULE 4); pairs, then a trailing single (RULE 2); else 1.
template <int RULE>
__device__ __forceinline__ int unit_width(int i, int n) {
  if (RULE == 4 && i + 4 <= (n & ~3)) return 4;
  if (RULE >= 2 && i + 2 <= n) return 2;
  return 1;
}

template <int RULE>
__global__ void __launch_bounds__(kThreads)
anneal_wide_kernel(const float* __restrict__ J, const float* __restrict__ h,
                   const float* __restrict__ hot, const float* __restrict__ logr,
                   const float* __restrict__ init01, const float* __restrict__ uniforms,
                   float* __restrict__ out, int G, int B, int R, int n, int S,
                   float inv_span, uint32_t seed_lo, uint32_t seed_hi) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout_of(n);
  uint32_t* state = reinterpret_cast<uint32_t*>(smem);
  float* tiles = reinterpret_cast<float*>(smem + (size_t)kChains * L.words * 4);

  const int g = blockIdx.y;
  const int c = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const long long chains = (long long)B * R;
  const long long chain = (long long)blockIdx.x * kChains + c;
  const bool active = chain < chains;
  // the last block's spare chains repeat the group's last chain, so that
  // every lane takes part in the shuffles and barriers; they write nothing
  const long long ch = active ? chain : chains - 1;
  const int b = (int)(ch / R);
  const int r = (int)(ch % R);
  const size_t p = (size_t)g * B + b;  // problem id
  const uint2 key = make_uint2(seed_lo, (uint32_t)p);
  const bool host = uniforms != nullptr;
  const float* Jg = J + (size_t)g * n * n;
  const float* hp = h + p * n;

  for (int k = threadIdx.x; k < kChains * L.words; k += kThreads) state[k] = 0u;
  __syncthreads();
  uint32_t* st = state + c * L.words;
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
  load_tile(tiles, Jg, 0, n, L.jrow);
  __pipeline_commit();
  int buf = 0;
  for (int t = 0; t < S; ++t) {
    const float beta = hot_p * expf(logr_p * ((float)t * inv_span));
    SweepUniforms u{host ? uniforms + (size_t)t * u_sweep + p * n * R + r : nullptr, R, key,
                    (uint32_t)r, (uint32_t)t, seed_hi};
    for (int k = 0; k < ntiles; ++k) {
      if (t + 1 < S || k + 1 < ntiles)  // prefetch the next tile, wrapping to the next sweep
        load_tile(tiles + (buf ^ 1) * tile_floats, Jg, k + 1 < ntiles ? k + 1 : 0, n, L.jrow);
      __pipeline_commit();
      __pipeline_wait_prior(1);  // this thread's copies of tile k have landed
      __syncthreads();           // ... and every thread's
      const float* tile = tiles + buf * tile_floats;
      const int i0 = k * kRows, i1 = min(n, i0 + kRows);
      for (int i = i0; i < i1;) {
        const int m = unit_width<RULE>(i, n);
        if (m == 4)
          update<RULE, 4>(tile, i - i0, L.jrow, st, lane, hp, i, beta, u(i));
        else if (m == 2)
          update<RULE, 2>(tile, i - i0, L.jrow, st, lane, hp, i, beta, u(i));
        else
          update<RULE, 1>(tile, i - i0, L.jrow, st, lane, hp, i, beta, u(i));
        i += m;
      }
      __syncthreads();  // tile buffer buf is free for the prefetch after next
      buf ^= 1;
    }
  }

  if (active) {
    float* op = out + (p * R + r) * n;
    for (int i = lane; i < n; i += kLanes) op[i] = sb[i] ? 1.0f : 0.0f;
  }
}

template <int RULE>
cudaError_t launch(const float* J, const float* h, const float* hot, const float* logr,
                   const float* init01, const float* uniforms, float* out, int G, int B,
                   int R, int n, int S, float inv_span, unsigned long long seed,
                   cudaStream_t stream) {
  const size_t smem = layout_of(n).bytes();
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        anneal_wide_kernel<RULE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long blocks = ((long long)B * R + kChains - 1) / kChains;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)G);
  anneal_wide_kernel<RULE><<<grid, kThreads, smem, stream>>>(
      J, h, hot, logr, init01, uniforms, out, G, B, R, n, S, inv_span,
      (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32));
  return cudaGetLastError();
}

}  // namespace

// Largest n the kernel takes: the state of 32 chains and two J tiles must
// fit one block's shared memory (2400 with this layout).
extern "C" int qbmx_anneal_wide_max_n() {
  int n = 1;
  while (layout_of(n + 1).bytes() <= kSmemMax) ++n;
  return n;
}

// Returns the cudaError_t of the launch (0 = success).  init01/uniforms are
// both null (Philox mode) or both set (host-variate mode); rule is 0 for
// Metropolis, 1, 2 or 4 for heat-bath at that update width.
extern "C" int qbmx_anneal_wide(const float* J, const float* h, const float* hot,
                                const float* logr, const float* init01,
                                const float* uniforms, float* out, int G, int B, int R,
                                int n, int S, float inv_span, unsigned long long seed,
                                int rule, void* stream) {
  if (G <= 0 || B <= 0 || R <= 0 || n <= 0 || S <= 0 || G > 65535 ||
      n > qbmx_anneal_wide_max_n() || (init01 == nullptr) != (uniforms == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rule) {
    case 0:
      return (int)launch<0>(J, h, hot, logr, init01, uniforms, out, G, B, R, n, S, inv_span, seed, st);
    case 1:
      return (int)launch<1>(J, h, hot, logr, init01, uniforms, out, G, B, R, n, S, inv_span, seed, st);
    case 2:
      return (int)launch<2>(J, h, hot, logr, init01, uniforms, out, G, B, R, n, S, inv_span, seed, st);
    case 4:
      return (int)launch<4>(J, h, hot, logr, init01, uniforms, out, G, B, R, n, S, inv_span, seed, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
