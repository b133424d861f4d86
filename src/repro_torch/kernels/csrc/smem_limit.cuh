// Raising a kernel's dynamic shared-memory limit, once per device.
//
// The limit is an attribute of a kernel in one device's context:
// cudaFuncSetAttribute acts on the current device only.  So each launcher
// raises it once per DEVICE (the current one, which the wrappers set to
// the operands' device), not once per process: a flag per process would
// leave every card but the first at the 48 KB default, and the first
// launch there would fail.
#pragma once

#include <cuda_runtime.h>

constexpr int MAX_DEVICES = 64;

// `done` is the launcher's own flag per device (a function-local static).
// Returns 0, or the CUDA error code.
template <typename Kernel>
inline int raise_smem_limit(bool (&done)[MAX_DEVICES], Kernel kernel,
                            int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < MAX_DEVICES && done[dev]) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e != cudaSuccess) return (int)e;
  if (dev < MAX_DEVICES) done[dev] = true;
  return 0;
}
