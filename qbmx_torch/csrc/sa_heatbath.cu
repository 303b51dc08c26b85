// Annealed heat-bath ("BMS") sampling over the structured shared-coupling
// form, for NVIDIA Hopper (sm_90a) (K2): its C entry and its single-variable
// updates.  The kernels, their layouts and what they replace are described
// in sa_heatbath.cuh; sa_heatbath_pair.cu and sa_heatbath_quad.cu build the
// pair and quad updates, so that nvcc compiles the three widths at once.

#include "sa_heatbath.cuh"

cudaError_t qbmx::heatbath::launch_width1(const Args& a, int lanes, cudaStream_t st) {
  return dispatch<1>(a, lanes, st);
}

// Largest n the kernel takes: J_g must fit one block's shared memory.
extern "C" int qbmx_sa_heatbath_max_n() { return kMaxN; }

// Widest n of the THREAD layout in this build.
extern "C" int qbmx_sa_heatbath_thread_max_n() { return kThreadMaxN; }

// Returns the cudaError_t of the launch (0 = success).  init01/uniforms are
// both null (Philox mode) or both set (host-variate mode); width is 1, 2 or
// 4; lanes is 1 for the THREAD layout (n <= kThreadMaxN), 4, 8 or 16 for
// GROUP (quad: 16), 32 for LANES; fields_out (GROUP and LANES only) and
// flips may be null.
extern "C" int qbmx_sa_heatbath(const float* J, const float* h, const float* hot,
                                const float* logr, const float* init01,
                                const float* uniforms, float* out, float* fields_out,
                                unsigned long long* flips, int G, int B, int R, int n, int S,
                                float inv_span, unsigned long long seed, int width, int lanes,
                                void* stream) {
  if (G <= 0 || B <= 0 || R <= 0 || n <= 0 || n > kMaxN || S <= 0 || G > 65535 ||
      (init01 == nullptr) != (uniforms == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{J, h, hot, logr, init01, uniforms, out, fields_out, flips, G, B, R, n, S,
               inv_span, (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 1: return (int)qbmx::heatbath::launch_width1(a, lanes, st);
    case 2: return (int)qbmx::heatbath::launch_width2(a, lanes, st);
    case 4: return (int)qbmx::heatbath::launch_width4(a, lanes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
