// The calling thread's current CUDA device, set for one entry point and
// restored when it returns, on every path.
//
// Each entry point takes the device of its tensors and makes it current for
// its launches. Left set, a launch on cuda:1 would move the caller's
// current device to 1, and a later torch.device("cuda") without an index
// would land there.
#pragma once

#include <cuda_runtime.h>

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      restore_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (restore_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  // cudaSuccess, or the error of reading or setting the device
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool restore_ = false;
  cudaError_t err_;
};
