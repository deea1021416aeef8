// Error text for the status codes the kernel entry points return
// (each returns cudaGetLastError() after its launches).
#include <cuda_runtime.h>

extern "C" const char* picha_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
