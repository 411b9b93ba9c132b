// Make card `device` current for the life of the guard, and restore the
// card that was current before, only when the two differ: the C entry
// points that take a device index use it in place of a Python-side
// `torch.cuda.device` context.
#pragma once

#include <cuda_runtime.h>

struct DeviceGuard {
  int prev = -1;               // the card to restore, or -1
  cudaError_t err = cudaSuccess;

  explicit DeviceGuard(int device) {
    int cur = 0;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) {
      err = cudaSetDevice(device);
      if (err == cudaSuccess) prev = cur;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};
