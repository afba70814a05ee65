// Helpers shared by the kernel wrappers: readable CUDA error names.

#include <cuda_runtime.h>

extern "C" const char* loco_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
