// axhelm_common.cuh -- what the axhelm kernel bodies share: the geometry
// sources (the variants of the TPU kernel's _kernel), the storage
// conversions, the staging of values into shared memory, the hoisted Alg. 3
// (the column body's K2/K5, the line body's K4 and the slab body's K2, K4,
// K5) and the per-node factors of the node walk (the generic body of
// axhelm.cu, the slab body of axhelm_slab.cu, the plane body of
// axhelm_plane.cu and the staged body's t gradient in axhelm_staged.cu).
// axhelm.cu holds the generic body and the one-thread-per-node twins,
// axhelm_column.cu the one-thread-per-column body (K2, K5), axhelm_line.cu
// the one-thread-per-line body (K1, K3, K4), axhelm_slab.cu the body that
// runs an element's contractions as register-tiled products, a slab of
// t-planes a block with the whole element's x in shared memory (N1 from 17
// to 24), axhelm_plane.cu the body that runs them a t-plane a block (N1
// above 24), axhelm_staged.cu the body that stages an element's
// contractions through device memory (N1 above the plane body's 48).
#pragma once

#include <cstdint>

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

// Shared memory a block may use without opting in (48 KB).
constexpr int kStaticSmemMax = 48 * 1024;

// The tuned bodies' shared memory, one struct S a block (axhelm_column.cu,
// axhelm_line.cu): a static __shared__ variable when it fits in the default
// 48 KB, else the launch's dynamic shared memory, which the launcher sizes to
// sizeof(S) and opts in to (opt_in_smem).
template <typename S>
__host__ __device__ constexpr bool dynamic_smem() {
  return sizeof(S) > kStaticSmemMax;
}

template <typename S>
__device__ __forceinline__ S& block_shared() {
  if constexpr (dynamic_smem<S>()) {
    extern __shared__ __align__(16) unsigned char tuned_dynamic_smem[];
    return *reinterpret_cast<S*>(tuned_dynamic_smem);
  } else {
    __shared__ S s;
    return s;
  }
}

// The dynamic shared memory of a launch whose block holds S: 0 when S is
// static.  Above the default 48 KB a kernel must opt in to its size; the
// attribute belongs to the current device, so every such launch sets it (a
// host call that enqueues nothing, allowed while a graph captures).
template <typename S, typename Kernel>
size_t opt_in_smem(Kernel kernel, cudaError_t& err) {
  err = cudaSuccess;
  if constexpr (!dynamic_smem<S>()) {
    return 0;
  } else {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(S)));
    return sizeof(S);
  }
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

// One value into shared memory (the plane and slab bodies' staging): an
// asynchronous 4-byte copy from fp32 (cp_async_wait completes it and every
// cp.async before it), a load and a widening from bf16.
__device__ __forceinline__ void stage_value(float* dst, const float* src) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(at),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void stage_value(float* dst,
                                            const __nv_bfloat16* src) {
  *dst = load(src);
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// The node walk of the generic body (axhelm.cu), the plane body's plane
// pass (axhelm_plane.cu) and the staged body's t gradient
// (axhelm_staged.cu): the factors of one node, loaded or recomputed.

struct Factors {
  float g00, g01, g02, g11, g12, g22, gwj;
};

// Paper Algorithm 3 at node (k, j, i), up to the adjugate: the unscaled
// Jacobian J~ from the vertices (columns = d/dr, d/ds, d/dt), then
// f.g** = adj(J~^T J~) and the return value det(J~) -- the arithmetic of
// repro_torch.core.geometry.jacobian_trilinear_at and adjugate6.  A caller
// that ignores the determinant (K4, K5) never computes it.
__device__ __forceinline__ float trilinear_adjugate(const float* v, float xi_i,
                                                    float xi_j, float xi_k,
                                                    Factors& f) {
  const float lo_i = 1.f - xi_i, hi_i = 1.f + xi_i;
  const float lo_j = 1.f - xi_j, hi_j = 1.f + xi_j;
  float c0[3], c1[3], c2[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    // column 0: vertex pairs differing in the r bit, weighted at s = xi_j
    const float ra = lo_j * (v[3 * 1 + a] - v[3 * 0 + a]) +
                     hi_j * (v[3 * 3 + a] - v[3 * 2 + a]);
    const float rb = lo_j * (v[3 * 5 + a] - v[3 * 4 + a]) +
                     hi_j * (v[3 * 7 + a] - v[3 * 6 + a]);
    c0[a] = (ra + rb) + xi_k * (rb - ra);
    // column 1: vertex pairs differing in the s bit, weighted at r = xi_i
    const float sa = lo_i * (v[3 * 2 + a] - v[3 * 0 + a]) +
                     hi_i * (v[3 * 3 + a] - v[3 * 1 + a]);
    const float sb = lo_i * (v[3 * 6 + a] - v[3 * 4 + a]) +
                     hi_i * (v[3 * 7 + a] - v[3 * 5 + a]);
    c1[a] = (sa + sb) + xi_k * (sb - sa);
    // column 2: vertex pairs differing in the t bit, at (r, s) = (xi_i, xi_j)
    c2[a] = lo_i * lo_j * (v[3 * 4 + a] - v[3 * 0 + a]) +
            hi_i * lo_j * (v[3 * 5 + a] - v[3 * 1 + a]) +
            hi_i * hi_j * (v[3 * 7 + a] - v[3 * 3 + a]) +
            lo_i * hi_j * (v[3 * 6 + a] - v[3 * 2 + a]);
  }
  const float k00 = c0[0] * c0[0] + c0[1] * c0[1] + c0[2] * c0[2];
  const float k01 = c0[0] * c1[0] + c0[1] * c1[1] + c0[2] * c1[2];
  const float k02 = c0[0] * c2[0] + c0[1] * c2[1] + c0[2] * c2[2];
  const float k11 = c1[0] * c1[0] + c1[1] * c1[1] + c1[2] * c1[2];
  const float k12 = c1[0] * c2[0] + c1[1] * c2[1] + c1[2] * c2[2];
  const float k22 = c2[0] * c2[0] + c2[1] * c2[1] + c2[2] * c2[2];
  f.g00 = k11 * k22 - k12 * k12;
  f.g01 = k02 * k12 - k01 * k22;
  f.g02 = k01 * k12 - k02 * k11;
  f.g11 = k00 * k22 - k02 * k02;
  f.g12 = k01 * k02 - k00 * k12;
  f.g22 = k00 * k11 - k01 * k01;
  // J~[a][b] = column b, component a
  return c0[0] * (c1[1] * c2[2] - c1[2] * c2[1]) -
         c0[1] * (c1[0] * c2[2] - c1[2] * c2[0]) +
         c0[2] * (c1[0] * c2[1] - c1[1] * c2[0]);
}

__device__ __forceinline__ void scale_factors(Factors& f, float s) {
  f.g00 *= s;
  f.g01 *= s;
  f.g02 *= s;
  f.g11 *= s;
  f.g12 *= s;
  f.g22 *= s;
}

// Words of per-element geometry a block stages in shared memory (K1 reads
// none: its factors are per node).
template <GeomSource SRC>
__host__ __device__ constexpr int geometry_words() {
  return uses_vertices(SRC) ? 24 : (SRC == kParallelepiped ? 7 : 0);
}

// The factors of node (i, j, k) = `node` of element e (np nodes an element),
// loaded or recomputed, with the lam0 slot folded in, and its mass
// coefficient (0 for Poisson).  s_g holds the element's geometry words.
template <GeomSource SRC, typename T>
__device__ __forceinline__ Factors node_factors(
    const T* __restrict__ geom, const float* s_g, const T* __restrict__ lam0,
    const T* __restrict__ lam1, const float* __restrict__ xi,
    const float* __restrict__ w3, int64_t e, int np, int node, int i, int j,
    int k, int helmholtz, float& mass) {
  const int64_t nidx = e * np + node;
  Factors f;
  if constexpr (SRC == kPrecomputed) {
    // the element's planes, plane p at geom[(7 e + p) np]
    const T* p = geom + e * 7 * np + node;
    f.g00 = load(p);
    f.g01 = load(p + np);
    f.g02 = load(p + 2 * np);
    f.g11 = load(p + 3 * np);
    f.g12 = load(p + 4 * np);
    f.g22 = load(p + 5 * np);
    f.gwj = helmholtz ? load(p + 6 * np) : 0.f;
  } else if constexpr (SRC == kTrilinear) {
    // G = (1/8) w3 adj(J~^T J~) / det(J~),  gwj = (1/8)^3 w3 det(J~)
    const float w = w3[node];
    const float det = trilinear_adjugate(s_g, xi[i], xi[j], xi[k], f);
    scale_factors(f, 0.125f * w / det);
    f.gwj = w * 0.001953125f * det;  // (1/8)^3
  } else if constexpr (SRC == kParallelepiped) {
    const float w = w3[node];
    f.g00 = s_g[0] * w;
    f.g01 = s_g[1] * w;
    f.g02 = s_g[2] * w;
    f.g11 = s_g[3] * w;
    f.g12 = s_g[4] * w;
    f.g22 = s_g[5] * w;
    f.gwj = s_g[6] * w;
  } else {  // kMerged, kPartial: adj(K~) only, the scale is in the lam0 slot
    trilinear_adjugate(s_g, xi[i], xi[j], xi[k], f);
    f.gwj = 0.f;
  }
  if (lam0 != nullptr) scale_factors(f, load(lam0 + nidx));
  mass = 0.f;
  if (helmholtz) {
    if constexpr (SRC == kMerged) {
      mass = load(lam1 + nidx);  // Lam3 = gwj * lam1, precomputed
    } else {
      mass = (lam1 != nullptr) ? load(lam1 + nidx) * f.gwj : f.gwj;
    }
  }
  return f;
}

}  // namespace axhelm_detail
