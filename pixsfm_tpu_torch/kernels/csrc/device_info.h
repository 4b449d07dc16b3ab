// What the kernels' launch code asks the card (shared by the sources here).

#pragma once

#include <cuda_runtime.h>

namespace pixsfm {

// Number of SMs of the current device, asked once per library (a process
// serves one kind of card). A failed query is the caller's launch error.
inline cudaError_t sm_count(int* out) {
  static int count = 0;
  if (count == 0) {
    int dev = 0, n = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (n <= 0) return cudaErrorInvalidDevice;
    count = n;
  }
  *out = count;
  return cudaSuccess;
}

}  // namespace pixsfm
