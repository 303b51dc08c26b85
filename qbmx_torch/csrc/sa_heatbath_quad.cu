// K2's quad updates (update width 4), built apart from sa_heatbath.cu so that
// nvcc compiles the three widths at once; the kernels are in sa_heatbath.cuh.

#include "sa_heatbath.cuh"

cudaError_t qbmx::heatbath::launch_width4(const Args& a, int lanes, cudaStream_t st) {
  return dispatch<4>(a, lanes, st);
}
