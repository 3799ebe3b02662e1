// axhelm_common.cuh -- what the two axhelm kernel bodies share: the geometry
// sources (the variants of the TPU kernel's _kernel) and the storage
// conversions.  axhelm.cu holds the one-thread-per-node body (K1, K3, K4),
// axhelm_column.cu the one-thread-per-column body (K2, K5).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace axhelm_detail {

// Where a kernel takes its geometric factors from (the variants of _kernel).
enum GeomSource : int {
  kPrecomputed = 0,     // K1
  kTrilinear = 1,       // K2
  kParallelepiped = 2,  // K3
  kMerged = 3,          // K4
  kPartial = 4,         // K5
};

__host__ __device__ constexpr bool uses_vertices(GeomSource src) {
  return src == kTrilinear || src == kMerged || src == kPartial;
}

// Storage loads widen to fp32; the one store of y rounds once.
__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

}  // namespace axhelm_detail
