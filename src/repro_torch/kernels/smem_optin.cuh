// The shared memory a block of the current device may opt in to (227 KB
// on an H100), queried once; kernels that size their shared memory by
// the input use it to choose between shared memory and a global scratch.
#pragma once
#include <cuda_runtime.h>

inline int max_smem_optin() {
  static const int bytes = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return v;
  }();
  return bytes;
}
