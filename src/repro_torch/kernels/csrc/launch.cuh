// Host-side launch helpers shared by the kernels in this directory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace repro_torch {

// The number of SMs of the current device (0 if it cannot be read).
inline int sm_count() {
  int dev = 0;
  int n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  return n;
}

// Lets one kernel use more than 48 KB of dynamic shared memory. The
// attribute belongs to the device the launch goes to (the current one),
// so it is set once for each device, not at every launch. Keep one
// instance for each kernel (a function-local static).
class SmemOptIn {
 public:
  template <typename Kernel>
  cudaError_t allow(Kernel kernel, int bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
    if (bit != 0 && (done_.load(std::memory_order_acquire) & bit) != 0) {
      return cudaSuccess;
    }
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) done_.fetch_or(bit, std::memory_order_release);
    return err;
  }

 private:
  std::atomic<uint64_t> done_{0};
};

}  // namespace repro_torch
