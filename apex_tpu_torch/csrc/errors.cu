// The CUDA runtime's name for an error code, for the Python wrappers'
// messages when a launch entry point returns one.

#include <cuda_runtime.h>

extern "C" const char* apex_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
