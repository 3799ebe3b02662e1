// axhelm_common.cuh -- what the three axhelm kernel bodies share: the
// geometry sources (the variants of the TPU kernel's _kernel), the storage
// conversions and the hoisted Alg. 3.  axhelm.cu holds the one-thread-per-node
// body (K1, and the timing-only twins of K2-K5), axhelm_column.cu the
// one-thread-per-column body (K2, K5), axhelm_line.cu the one-thread-per-line
// body (K3, K4).
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

// Paper Alg. 3, hoisted along k (the column body's K2/K5 and the line body's
// K4): the element's 12 edge differences once, the terms of a node column
// (i, j) once, then per node the affine update.

// Edge q of the element's 12 (q / 4: the r, s or t direction; q % 4: which
// of its four parallel edges, in the order of the other two bits): the
// vertices at its ends, vertex = br + 2*bs + 4*bt.
__device__ __forceinline__ void edge_vertices(int q, int& lo, int& hi) {
  const int dir = q >> 2, p = q & 3;
  lo = ((p >> dir) << (dir + 1)) | (p & ((1 << dir) - 1));
  hi = lo | (1 << dir);
}

// The terms of Alg. 3 that do not vary along k in node column (i, j).
struct ColumnTerms {
  float e0[3], e1[3];  // J~ column 0 (d/dr) = e0 + xi_k e1
  float f0[3], f1[3];  // J~ column 1 (d/ds) = f0 + xi_k f1
  float c2[3];         // J~ column 2 (d/dt)
  float k22;           // c2 . c2
};

// From the element's edge differences E[3q + a] (edge_vertices order) at
// (r, s) = (xi_i, xi_j): column 0 from the vertex pairs differing in the r
// bit, weighted at s = xi_j; column 1 from the s bit, at r = xi_i; column 2
// from the t bit.
__device__ __forceinline__ ColumnTerms column_terms(const float* E, float xi_i,
                                                    float xi_j) {
  const float lo_i = 1.f - xi_i, hi_i = 1.f + xi_i;
  const float lo_j = 1.f - xi_j, hi_j = 1.f + xi_j;
  ColumnTerms ct;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ra = lo_j * E[3 * 0 + a] + hi_j * E[3 * 1 + a];  // t = -1
    const float rb = lo_j * E[3 * 2 + a] + hi_j * E[3 * 3 + a];  // t = +1
    ct.e0[a] = ra + rb;
    ct.e1[a] = rb - ra;
    const float sa = lo_i * E[3 * 4 + a] + hi_i * E[3 * 5 + a];
    const float sb = lo_i * E[3 * 6 + a] + hi_i * E[3 * 7 + a];
    ct.f0[a] = sa + sb;
    ct.f1[a] = sb - sa;
    ct.c2[a] = lo_j * (lo_i * E[3 * 8 + a] + hi_i * E[3 * 9 + a]) +
               hi_j * (lo_i * E[3 * 10 + a] + hi_i * E[3 * 11 + a]);
  }
  ct.k22 = ct.c2[0] * ct.c2[0] + ct.c2[1] * ct.c2[1] + ct.c2[2] * ct.c2[2];
  return ct;
}

// The affine update: J~ columns 0 and 1 at xi_k = t.
__device__ __forceinline__ void jacobian_at(const ColumnTerms& ct, float t,
                                            float* c0, float* c1) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    c0[a] = fmaf(t, ct.e1[a], ct.e0[a]);
    c1[a] = fmaf(t, ct.f1[a], ct.f0[a]);
  }
}

// det(J~), J~[a][b] = column b, component a.
__device__ __forceinline__ float det_j(const float* c0, const float* c1,
                                       const float* c2) {
  return c0[0] * (c1[1] * c2[2] - c1[2] * c2[1]) -
         c0[1] * (c1[0] * c2[2] - c1[2] * c2[0]) +
         c0[2] * (c1[0] * c2[1] - c1[1] * c2[0]);
}

}  // namespace axhelm_detail
