// The CUDA runtime's message for an error code returned by a kernel entry.
#include <cuda_runtime.h>

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
