// Error text for the codes the C entries of this library return.

#include <cuda_runtime.h>

extern "C" const char* ss_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
