// axhelm.cu -- hand-written Hopper (sm_90a) kernels for the axhelm element
// operator, with a plain C interface (bound from Python with ctypes).
//
// Replaces the TPU kernel repro/kernels/axhelm/kernel.py::_kernel, the body of
// the one pl.pallas_call (kernel.py:233), in two of its variants:
//   axhelm_precomputed_f32  variant "precomputed" (kernel.py:122-125, paper
//                           Alg. 2): the geometric factors are read from memory;
//   axhelm_trilinear_f32    variant "trilinear" (kernel.py:126-131, paper
//                           Alg. 3): the factors are recomputed at every node
//                           from the element's 8 vertices.
// Per element e and column c (c runs over the nrhs*d columns, which all share
// the element's factors):
//   y = D^T [lam0 * G (D x)]  (+ mass * x for Helmholtz, mass = lam1 * gwj)
//
// What bounds it on the H100 (E=4096, N1=8, one column, Poisson, fp32):
//   precomputed moves 4*N1^3*(1+6+1) bytes per element and does
//   12*N1^4+15*N1^3 FLOPs: memory-bound (bytes over 3.35 TB/s);
//   trilinear moves only 4*(2*N1^3+24) bytes but adds ~90 FLOPs a node of
//   geometry: bounded by FP32 CUDA-core arithmetic (FLOPs over 67 TFLOP/s).
// What the design does about it:
//   * one thread block per element, one thread per node; the x column and the
//     three weighted gradient components live in shared memory (4*N1^3
//     floats, 8 KB at N1=8), so x is read from device memory once and y is
//     written once per column;
//   * each thread loads (precomputed) or recomputes (trilinear) its node's
//     6(+1) factors ONCE, folds lam0 into them, keeps them in registers and
//     reuses them for every column -- the per-element sharing across the RHS
//     and component axes;
//   * the trilinear kernel stages only the 24 vertex words of its element;
//   * D-hat sits in shared memory and every contraction is plain fp32 FFMA
//     (no TF32 tensor cores), so the 1e-4 relative budget holds by
//     construction.  Tensor-core contractions (wgmma) and TMA staging, which
//     the trilinear kernel needs to leave the FP32 roofline, are later work.
//
// Layouts (all fp32, contiguous, the element axis outermost):
//   x, y   (E, ncols, N1^3)  node index i + N1*j + N1^2*k
//   geom   precomputed: (E, N1^3, 7) packed [g00 g01 g02 g11 g12 g22 gwj]
//          trilinear:   (E, 8, 3) vertices, vertex = br + 2*bs + 4*bt
//   lam0, lam1  (E, N1^3) or null;  dhat (N1, N1);  xi (N1);  w3 (N1^3)
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

struct Factors {
  float g00, g01, g02, g11, g12, g22, gwj;
};

// Paper Algorithm 3 at node (k, j, i): the unscaled Jacobian J~ from the
// vertices (columns = d/dr, d/ds, d/dt), then
//   G = (1/8) * w3 * adj(J~^T J~) / det(J~),   gwj = (1/8)^3 * w3 * det(J~),
// the arithmetic of repro_torch.core.geometry.jacobian_trilinear_at and
// factors_from_jacobian.
__device__ __forceinline__ Factors trilinear_factors(const float* v, float xi_i,
                                                     float xi_j, float xi_k,
                                                     float w) {
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
  // J~[a][b] = column b, component a
  const float det = c0[0] * (c1[1] * c2[2] - c1[2] * c2[1]) -
                    c0[1] * (c1[0] * c2[2] - c1[2] * c2[0]) +
                    c0[2] * (c1[0] * c2[1] - c1[1] * c2[0]);
  const float k00 = c0[0] * c0[0] + c0[1] * c0[1] + c0[2] * c0[2];
  const float k01 = c0[0] * c1[0] + c0[1] * c1[1] + c0[2] * c1[2];
  const float k02 = c0[0] * c2[0] + c0[1] * c2[1] + c0[2] * c2[2];
  const float k11 = c1[0] * c1[0] + c1[1] * c1[1] + c1[2] * c1[2];
  const float k12 = c1[0] * c2[0] + c1[1] * c2[1] + c1[2] * c2[2];
  const float k22 = c2[0] * c2[0] + c2[1] * c2[1] + c2[2] * c2[2];
  const float gscale = 0.125f * w / det;
  Factors f;
  f.g00 = (k11 * k22 - k12 * k12) * gscale;
  f.g01 = (k02 * k12 - k01 * k22) * gscale;
  f.g02 = (k01 * k12 - k02 * k11) * gscale;
  f.g11 = (k00 * k22 - k02 * k02) * gscale;
  f.g12 = (k01 * k02 - k00 * k12) * gscale;
  f.g22 = (k00 * k11 - k01 * k01) * gscale;
  f.gwj = w * 0.001953125f * det;  // (1/8)^3
  return f;
}

template <int N1, bool TRILINEAR>
__global__ void __launch_bounds__(N1 * N1 * N1)
    axhelm_kernel(const float* __restrict__ x, float* __restrict__ y,
                  const float* __restrict__ geom,
                  const float* __restrict__ lam0,
                  const float* __restrict__ lam1,
                  const float* __restrict__ dhat,
                  const float* __restrict__ xi, const float* __restrict__ w3,
                  int ncols, int helmholtz) {
  constexpr int NP = N1 * N1 * N1;
  __shared__ float s_d[N1 * N1];  // dhat(row, col), row-major
  __shared__ float s_x[NP];       // the current column of x
  __shared__ float s_r[NP];       // lam0 * G . grad, r component
  __shared__ float s_s[NP];
  __shared__ float s_t[NP];
  __shared__ float s_v[24];       // trilinear: the element's vertices

  const int node = threadIdx.x;
  const int i = node % N1;
  const int j = (node / N1) % N1;
  const int k = node / (N1 * N1);
  const int64_t e = blockIdx.x;
  const int64_t nidx = e * NP + node;

  if (node < N1 * N1) s_d[node] = dhat[node];
  if (TRILINEAR && node < 24) s_v[node] = geom[e * 24 + node];
  __syncthreads();

  // This node's factors, loaded or recomputed once for all columns.
  Factors f;
  if (TRILINEAR) {
    f = trilinear_factors(s_v, xi[i], xi[j], xi[k], w3[node]);
  } else {
    const float* p = geom + nidx * 7;
    f.g00 = p[0];
    f.g01 = p[1];
    f.g02 = p[2];
    f.g11 = p[3];
    f.g12 = p[4];
    f.g22 = p[5];
    f.gwj = helmholtz ? p[6] : 0.f;
  }
  if (lam0 != nullptr) {
    const float l = lam0[nidx];
    f.g00 *= l;
    f.g01 *= l;
    f.g02 *= l;
    f.g11 *= l;
    f.g12 *= l;
    f.g22 *= l;
  }
  float mass = 0.f;
  if (helmholtz) mass = (lam1 != nullptr) ? lam1[nidx] * f.gwj : f.gwj;

  const int row_r = (k * N1 + j) * N1;  // s_*[k][j][m] = s_*[row_r + m]
  for (int c = 0; c < ncols; ++c) {
    const int64_t off = (e * ncols + c) * NP + node;
    const float xv = x[off];
    s_x[node] = xv;
    __syncthreads();

    // grad: x_r = D_r x, x_s = D_s x, x_t = D_t x at this node
    float xr = 0.f, xs = 0.f, xt = 0.f;
#pragma unroll
    for (int m = 0; m < N1; ++m) {
      xr = fmaf(s_d[i * N1 + m], s_x[row_r + m], xr);
      xs = fmaf(s_d[j * N1 + m], s_x[(k * N1 + m) * N1 + i], xs);
      xt = fmaf(s_d[k * N1 + m], s_x[(m * N1 + j) * N1 + i], xt);
    }
    s_r[node] = f.g00 * xr + f.g01 * xs + f.g02 * xt;
    s_s[node] = f.g01 * xr + f.g11 * xs + f.g12 * xt;
    s_t[node] = f.g02 * xr + f.g12 * xs + f.g22 * xt;
    // also orders this column's reads of s_x before the next column's write
    __syncthreads();

    // y = D_r^T s_r + D_s^T s_s + D_t^T s_t (+ mass * x)
    float yv = helmholtz ? mass * xv : 0.f;
#pragma unroll
    for (int m = 0; m < N1; ++m) {
      yv = fmaf(s_d[m * N1 + i], s_r[row_r + m], yv);
      yv = fmaf(s_d[m * N1 + j], s_s[(k * N1 + m) * N1 + i], yv);
      yv = fmaf(s_d[m * N1 + k], s_t[(m * N1 + j) * N1 + i], yv);
    }
    y[off] = yv;
    // the next column's first barrier orders these reads of s_r, s_s, s_t
    // before that column's writes to them
  }
}

template <bool TRILINEAR>
int launch(const float* x, float* y, const float* geom, const float* lam0,
           const float* lam1, const float* dhat, const float* xi,
           const float* w3, int n1, int n_elem, int ncols, int helmholtz,
           cudaStream_t stream) {
  if (n_elem <= 0 || ncols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_elem));
  switch (n1) {
    case 4:
      axhelm_kernel<4, TRILINEAR><<<grid, 4 * 4 * 4, 0, stream>>>(
          x, y, geom, lam0, lam1, dhat, xi, w3, ncols, helmholtz);
      break;
    case 8:
      axhelm_kernel<8, TRILINEAR><<<grid, 8 * 8 * 8, 0, stream>>>(
          x, y, geom, lam0, lam1, dhat, xi, w3, ncols, helmholtz);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int axhelm_precomputed_f32(const float* x, float* y,
                                      const float* geom, const float* lam0,
                                      const float* lam1, const float* dhat,
                                      int n1, int n_elem, int ncols,
                                      int helmholtz, void* stream) {
  return launch<false>(x, y, geom, lam0, lam1, dhat, nullptr, nullptr, n1,
                       n_elem, ncols, helmholtz,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int axhelm_trilinear_f32(const float* x, float* y,
                                    const float* verts, const float* lam0,
                                    const float* lam1, const float* dhat,
                                    const float* xi, const float* w3, int n1,
                                    int n_elem, int ncols, int helmholtz,
                                    void* stream) {
  return launch<true>(x, y, verts, lam0, lam1, dhat, xi, w3, n1, n_elem,
                      ncols, helmholtz, static_cast<cudaStream_t>(stream));
}
