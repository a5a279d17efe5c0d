// Shared device helpers for the port's kernels (f32 throughout).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ggps {

// Activation codes shared with the Python wrappers (ops/kernels/build.py ACTS).
enum Act { ACT_IDENTITY = 0, ACT_RELU = 1, ACT_GELU = 2 };

// gelu is the exact-erf form (torch nn.GELU() default, graphgps_tpu
// models/common.py act registry); the TPU kernels approximate erf with
// Abramowitz-Stegun (|err| < 1.5e-7), here erff is used directly.
__device__ __forceinline__ float apply_act(float z, int act) {
  if (act == ACT_RELU) return fmaxf(z, 0.0f);
  if (act == ACT_GELU) return 0.5f * z * (1.0f + erff(z * 0.70710678118654752f));
  return z;
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace ggps
