// K3's entry, and its layouts a rung on L lanes (GROUP, L = 4, 8, 16) and a
// rung a warp (WARP); pt_heatbath.cuh describes the kernel and its layouts,
// pt_heatbath_rung.cu holds a rung a thread (RUNG).

#include "pt_heatbath.cuh"

namespace {

// WARP layout: a ladder a block of ceil(M/RPW) warps, warp c carrying the
// states that start at rungs c and c + warps (RPW of them); K slots a lane.
// The sweep, refresh and energy are GROUP's at L = 32.
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
  stage_J(Js, J, b, n, n);

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
                                         rung_init_bit(init01, slot0 + rho[a], rho[a], R, r, n,
                                                       i, key, seed_hi));
      f[a][k] = 0.0f;
    }
  }

  for (int t = 0; t < S; ++t) {
#pragma unroll
    for (int a = 0; a < RPW; ++a) {
      if (rho[a] >= M) continue;  // the same in the whole warp
      if (t % kRefreshPeriod == 0) {
        const float e0 = group_refresh<K, 32>(f[a], w[a], hv, Js, n, lane, t == 0);
        if (t == 0) e[a] = e0;  // afterwards the energy stays incremental
      }
      SweepUniforms u{host ? uniforms + ((size_t)t * BM + slot0 + rho[a]) * n * R + r : nullptr,
                      R, key, (uint32_t)r, (uint32_t)t, seed_hi, (uint32_t)rho[a] << 8};
      group_sweep<K, 32>(f[a], w[a], e[a], Js, n, lane, betas[slot0 + rho[a]], u);
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

template <int K, int RPW>
cudaError_t launch_warp(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(32, a.n, a.M);
  const cudaError_t e = set_smem(pt_heatbath_warp_kernel<K, RPW>, smem);
  if (e != cudaSuccess) return e;
  const int warps = (a.M + RPW - 1) / RPW;
  const dim3 grid((unsigned)a.R, (unsigned)a.B);
  pt_heatbath_warp_kernel<K, RPW><<<grid, 32 * warps, smem, stream>>>(
      a.J, a.h, a.betas, a.dbeta, a.init01, a.uniforms, a.swap_u, a.out, a.B, a.M, a.R, a.n,
      a.S, a.seed_lo, a.seed_hi);
  return cudaGetLastError();
}

template <int K, int L>
cudaError_t launch_group(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(L, a.n, a.M);
  const cudaError_t e = set_smem(pt_heatbath_group_kernel<K, L>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)a.R, (unsigned)a.B);
  int threads = 32 * ((a.M * L + 31) / 32);  // a ladder a block
  if (a.M * L <= 32) {  // ladders within a warp, 4 warps a block
    const int per_block = kBlockWarps * (32 / (a.M * L));
    grid.x = (unsigned)((a.R + per_block - 1) / per_block);
    threads = kThreads;
  }
  pt_heatbath_group_kernel<K, L><<<grid, threads, smem, stream>>>(
      a.J, a.h, a.betas, a.dbeta, a.init01, a.uniforms, a.swap_u, a.out, a.B, a.M, a.R, a.n,
      a.S, a.seed_lo, a.seed_hi);
  return cudaGetLastError();
}

// The slot bound K of GROUP(L) and WARP: ceil(n/L) rounded up to a power
// of 2, at most kMaxSlots (8 slots of a warp cover kMaxN); wider n at that
// L is refused (samplers/pt_cuda.py::max_n).
template <int L>
cudaError_t dispatch_group(const Args& a, cudaStream_t st) {
  const int k = (a.n + L - 1) / L;
  if (k <= 1) return launch_group<1, L>(a, st);
  if (k <= 2) return launch_group<2, L>(a, st);
  if (k <= 4) return launch_group<4, L>(a, st);
  if (k <= 8) return launch_group<8, L>(a, st);
  return cudaErrorInvalidValue;
}

// WARP: RPW = 1 up to 32 rungs, else 2.
template <int RPW>
cudaError_t dispatch_warp(const Args& a, cudaStream_t st) {
  const int k = (a.n + 31) / 32;
  if (k <= 1) return launch_warp<1, RPW>(a, st);
  if (k <= 2) return launch_warp<2, RPW>(a, st);
  if (k <= 4) return launch_warp<4, RPW>(a, st);
  return launch_warp<8, RPW>(a, st);
}

}  // namespace

// Bounds of the kernel: n (J_b in shared memory) and the rungs of a ladder;
// and the shared memory of a block at `lanes` lanes a rung (1 RUNG; 4, 8,
// 16 GROUP; 32 WARP), which must not exceed 232,448 bytes -- so a ladder
// over warps takes M <= 15 at n = 241 (J_b and the 2·M exchanged energies).
extern "C" int qbmx_pt_heatbath_max_n() { return kMaxN; }
extern "C" int qbmx_pt_heatbath_max_rungs() { return kMaxRungs; }
extern "C" unsigned long long qbmx_pt_heatbath_smem(int lanes, int n, int M) {
  return (unsigned long long)smem_bytes(lanes, n, M);
}

// Returns the cudaError_t of the launch (0 = success).  init01, uniforms and
// swap_u are all null (Philox mode) or all set (host-variate mode); lanes
// (the host's choice) is 1 (RUNG: n <= 32, M <= 32), 4, 8 or 16 (GROUP:
// n <= 8·lanes) or 32 (WARP).
extern "C" int qbmx_pt_heatbath(const float* J, const float* h, const float* betas,
                                const float* dbeta, const float* init01,
                                const float* uniforms, const float* swap_u, float* out,
                                int B, int M, int R, int n, int S, unsigned long long seed,
                                int lanes, void* stream) {
  const bool some = init01 != nullptr || uniforms != nullptr || swap_u != nullptr;
  const bool all = init01 != nullptr && uniforms != nullptr && swap_u != nullptr;
  const bool known = lanes == 1 || lanes == 4 || lanes == 8 || lanes == 16 || lanes == 32;
  if (B <= 0 || M <= 0 || R <= 0 || n <= 0 || S <= 0 || B > 65535 || n > kMaxN ||
      M > kMaxRungs || some != all || !known || smem_bytes(lanes, n, M) > kSmemMax ||
      (lanes == 1 && (n > kRungMaxN || M > kRungMaxM)) ||
      (lanes > 1 && lanes < 32 && n > lanes * kMaxSlots))
    return (int)cudaErrorInvalidValue;
  const Args a{J, h, betas, dbeta, init01, uniforms, swap_u, out, B, M, R, n, S,
               (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1: return (int)launch_rung(a, st);
    case 4: return (int)dispatch_group<4>(a, st);
    case 8: return (int)dispatch_group<8>(a, st);
    case 16: return (int)dispatch_group<16>(a, st);
    default: return (int)(M <= 32 ? dispatch_warp<1>(a, st) : dispatch_warp<2>(a, st));
  }
}
