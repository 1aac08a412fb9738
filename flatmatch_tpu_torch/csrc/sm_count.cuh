// The number of SMs of the current device, found once per device and kept
// (a grid sized to whole waves of blocks needs it on every launch). -1 on a
// CUDA error.
#pragma once
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDevices = 64;

inline int sm_count() {
  static int sms[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (dev < kMaxDevices && sms[dev] > 0) return sms[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess) {
    return -1;
  }
  if (dev < kMaxDevices) sms[dev] = n;
  return n;
}

// the CUDA error of a failed sm_count(), never cudaSuccess
inline int sm_count_error() {
  const cudaError_t err = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidDevice);
}

}  // namespace
