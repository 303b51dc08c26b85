// K3 a rung a thread (RUNG): one fully unrolled instance a width n = 1..32,
// in a source of its own so that nvcc builds it beside pt_heatbath.cu
// (pt_heatbath.cuh describes the kernel).

#include "pt_heatbath.cuh"

namespace {

template <int N>
cudaError_t launch_rung_n(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(1, N, a.M);
  const cudaError_t e = set_smem(pt_heatbath_rung_kernel<N>, smem);
  if (e != cudaSuccess) return e;
  const int per_block = kBlockWarps * (32 / a.M);  // ladders a block
  const dim3 grid((unsigned)((a.R + per_block - 1) / per_block), (unsigned)a.B);
  pt_heatbath_rung_kernel<N><<<grid, kThreads, smem, stream>>>(
      a.J, a.h, a.betas, a.dbeta, a.init01, a.uniforms, a.swap_u, a.out, a.B, a.M, a.R, a.S,
      a.seed_lo, a.seed_hi);
  return cudaGetLastError();
}

// The instance of width n, for n <= N.
template <int N>
cudaError_t dispatch_rung(const Args& a, cudaStream_t st) {
  if (a.n == N) return launch_rung_n<N>(a, st);
  if constexpr (N > 1) return dispatch_rung<N - 1>(a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t qbmx::pt::launch_rung(const Args& a, cudaStream_t st) {
  return dispatch_rung<kRungMaxN>(a, st);
}
