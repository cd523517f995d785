// Fixture: a fake kernel library with two extern "C" entries, one left unbound.
#include <cuda_runtime.h>

__global__ void doubled_kernel(const float* x, float* out, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) out[i] = 2.0f * x[i];
}

extern "C" {

int fake_doubled(const float* x, float* out, long long n,  // VIOLATION: cuda-ref
                 cudaStream_t stream) {
  doubled_kernel<<<(n + 255) / 256, 256, 0, stream>>>(x, out, n);
  return (int)cudaGetLastError();
}

const char* fake_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
