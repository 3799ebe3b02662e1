// axhelm.cu -- hand-written Hopper (sm_90a) kernels for the axhelm element
// operator, with a plain C interface (bound from Python with ctypes): the
// generic body, for every variant at any order up to ops.N1_MAX, and the
// one-thread-per-node body, kept as the timing-only twin of the tuned
// bodies.
//
// Replaces the TPU kernel repro/kernels/axhelm/kernel.py::_kernel, the body of
// the one pl.pallas_call (kernel.py:233), in all five of its variants and
// both of its storage types: _kernel takes any N1 from the shape of x
// (kernel.py:159).  The entry points run it nowhere now: from N1 = 2 to 16,
// K2 "trilinear" (kernel.py:126-131, Alg. 3) and K5 "partial"
// (kernel.py:154-157, §4.1.2) run the one-thread-per-column body of
// axhelm_column.cu, and K1 "precomputed" (kernel.py:122-125, Alg. 2: the
// factors read from memory), K3 "parallelepiped" (kernel.py:132-136, Alg. 4:
// G = gelem[:6]*w3 and gwj = gelem[6]*w3 from 7 words per element) and K4
// "merged" (kernel.py:137-153, §4.1.1, Helmholtz only: G = adj(K~)*Lam2 and
// mass = Lam3) the one-thread-per-line body of axhelm_line.cu; from 17 to
// 24 every variant runs the slab body of axhelm_slab.cu, the fastest in the
// measured turns but for K1 at N1 = 17 (PERF.md).
//
// Per element e and column c (c runs over the nrhs*d columns, which all share
// the element's factors):
//   y = D^T [lam0 * G (D x)]  (+ mass * x for Helmholtz, mass = lam1 * gwj)
//
// The generic body (entry points axhelm_<variant>_<T>_any, any N1 up to
// ops.N1_MAX; only the timing-only twin ops.generic, beside the tuned and
// slab bodies): one block an
// element, at most kAnyThreads threads, each walking the nodes t, t +
// blockDim, ... of its element; N1 is a runtime argument; D-hat, the
// element's geometry words, x and the three weighted gradient components
// live in dynamic shared memory (4 (N1^2 + 32 + 4 N1^3) bytes: 227 KB, what
// a block may have on the H100, holds N1 <= 24; above that the entry points
// run the plane body of axhelm_plane.cu, which runs an element's
// contractions as register-tiled products, a t-plane a block).  Per column:
// x into shared memory; per node the factors (node_factors, the node
// body's arithmetic) and the weighted gradient; per node y, recomputing the
// mass term for Helmholtz.  The factors are recomputed per column and
// nothing is tuned: it is plain fp32 FFMA and reads every value of a
// contraction from shared memory N1 times, like the node body, and has to
// be right, not fast.
//
// The node body (axhelm_<variant>_<T>_rowwise, N1 = 4 and 8; timing only,
// the wrapper's axhelm never calls it; chip_smoke.py times it beside the
// bodies that replaced it):
//   * one thread block per element, one thread per node; the x column and
//     the three weighted gradient components live in shared memory (4*N1^3
//     floats, 8 KB at N1=8), so x is read from device memory once and y is
//     written once per column;
//   * each thread loads or recomputes its node's 6(+1) factors ONCE, folds
//     the lam0 slot into them (lambda0, Lam2 or gScale), keeps them in
//     registers and reuses them for every column;
//   * the per-element geometry (24 vertex words, or K3's 7 words) is staged
//     in shared memory once per block; K4/K5 stop Alg. 3 at adj(J~^T J~), so
//     the compiler drops the determinant that K2 needs.
//   What held it to 36-49 us at E=4096, N1=8, whatever the geometry source,
//   is shared memory: every value a contraction reads passes through it N1
//   times (1,728 wavefronts an element and column).
//
// Storage (the TPU kernel's bf16 path, kernel.py:27, :172): the storage type T
// of x, y, geom, lam0 and lam1 is a template parameter, float or
// __nv_bfloat16.  A bf16 load widens to fp32 (__bfloat162float), the shared
// memory, the factors in registers and every FFMA stay fp32, and the single
// store of y rounds to nearest even (__float2bfloat16_rn, what
// Tensor.to(torch.bfloat16) does).  dhat, xi and w3 are fp32 arrays; for bf16
// storage they hold the bf16-rounded values (ops.py:157-160 of the reference
// rounds them to the storage type).
//
// Layouts (contiguous, the element axis outermost; x, y, geom and the lambda
// fields in the storage type, dhat, xi and w3 in fp32):
//   x, y   (E, ncols, N1^3)  node index i + N1*j + N1^2*k
//   geom   precomputed:     (E, 7, N1^3) planes g00 g01 g02 g11 g12 g22 gwj
//          trilinear, merged, partial: (E, 8, 3) vertices,
//                           vertex = br + 2*bs + 4*bt
//          parallelepiped:  (E, 7) [adjK/det x6, det], unweighted
//   lam0, lam1  (E, N1^3) or null (merged: Lam2, Lam3; partial: gScale);
//   dhat (N1, N1);  xi (N1);  w3 (N1^3)
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).

#include <cstdint>

#include "axhelm_common.cuh"

namespace {

using namespace axhelm_detail;

template <int N1, GeomSource SRC, typename T>
__global__ void __launch_bounds__(N1 * N1 * N1)
    axhelm_kernel(const T* __restrict__ x, T* __restrict__ y,
                  const T* __restrict__ geom,
                  const T* __restrict__ lam0,
                  const T* __restrict__ lam1,
                  const float* __restrict__ dhat,
                  const float* __restrict__ xi, const float* __restrict__ w3,
                  int ncols, int helmholtz) {
  constexpr int NP = N1 * N1 * N1;
  constexpr int NG = geometry_words<SRC>();
  __shared__ float s_d[N1 * N1];  // dhat(row, col), row-major
  __shared__ float s_x[NP];       // the current column of x
  __shared__ float s_r[NP];       // lam0 * G . grad, r component
  __shared__ float s_s[NP];
  __shared__ float s_t[NP];
  __shared__ float s_g[24];       // the element's vertices or gelem

  const int node = threadIdx.x;
  const int i = node % N1;
  const int j = (node / N1) % N1;
  const int k = node / (N1 * N1);
  const int64_t e = blockIdx.x;

  if (node < N1 * N1) s_d[node] = dhat[node];
  if (node < NG) s_g[node] = load(geom + e * NG + node);
  __syncthreads();

  // This node's factors, loaded or recomputed once for all columns.
  float mass;
  const Factors f = node_factors<SRC, T>(geom, s_g, lam0, lam1, xi, w3, e, NP,
                                         node, i, j, k, helmholtz, mass);

  const int row_r = (k * N1 + j) * N1;  // s_*[k][j][m] = s_*[row_r + m]
  for (int c = 0; c < ncols; ++c) {
    const int64_t off = (e * ncols + c) * NP + node;
    const float xv = load(x + off);
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
    store(y + off, yv);
    // the next column's first barrier orders these reads of s_r, s_s, s_t
    // before that column's writes to them
  }
}

constexpr int kAnyThreads = 512;  // most threads a block (GENERIC_THREADS)
constexpr int kSmemPerBlock = 232448;  // bytes a block may use (227 KB)

// The generic body: one block an element, any N1 (see the note at the top).
// Dynamic shared memory: D-hat (N1^2), the geometry words (32), then x and
// the three weighted gradient components (N1^3 each), all fp32.
template <GeomSource SRC, typename T>
__global__ void __launch_bounds__(kAnyThreads)
    axhelm_any_kernel(const T* __restrict__ x, T* __restrict__ y,
                      const T* __restrict__ geom,
                      const T* __restrict__ lam0,
                      const T* __restrict__ lam1,
                      const float* __restrict__ dhat,
                      const float* __restrict__ xi,
                      const float* __restrict__ w3, int n1, int ncols,
                      int helmholtz) {
  constexpr int NG = geometry_words<SRC>();
  extern __shared__ float smem[];
  const int nc = n1 * n1, np = nc * n1;
  float* s_d = smem;       // dhat(row, col), row-major
  float* s_g = s_d + nc;   // the element's vertices or gelem
  float* s_x = s_g + 32;   // the current column of x
  float* s_r = s_x + np;   // lam0 * G . grad, r component
  float* s_s = s_r + np;
  float* s_t = s_s + np;
  const int64_t e = blockIdx.x;

  for (int q = threadIdx.x; q < nc; q += blockDim.x) s_d[q] = dhat[q];
  if (threadIdx.x < NG) s_g[threadIdx.x] = load(geom + e * NG + threadIdx.x);

  for (int c = 0; c < ncols; ++c) {
    const int64_t off = (e * ncols + c) * np;
    for (int node = threadIdx.x; node < np; node += blockDim.x) {
      s_x[node] = load(x + off + node);
    }
    // also orders the column before's reads of s_x, s_r, s_s and s_t before
    // this column's writes (and D-hat and the geometry before every read)
    __syncthreads();

    // grad, the factors, and the weighted components at each node
    for (int node = threadIdx.x; node < np; node += blockDim.x) {
      const int i = node % n1, j = (node / n1) % n1, k = node / nc;
      float mass;
      const Factors f = node_factors<SRC, T>(geom, s_g, lam0, lam1, xi, w3, e,
                                             np, node, i, j, k, helmholtz,
                                             mass);
      float xr = 0.f, xs = 0.f, xt = 0.f;
      for (int m = 0; m < n1; ++m) {
        xr = fmaf(s_d[i * n1 + m], s_x[(k * n1 + j) * n1 + m], xr);
        xs = fmaf(s_d[j * n1 + m], s_x[(k * n1 + m) * n1 + i], xs);
        xt = fmaf(s_d[k * n1 + m], s_x[(m * n1 + j) * n1 + i], xt);
      }
      s_r[node] = f.g00 * xr + f.g01 * xs + f.g02 * xt;
      s_s[node] = f.g01 * xr + f.g11 * xs + f.g12 * xt;
      s_t[node] = f.g02 * xr + f.g12 * xs + f.g22 * xt;
    }
    __syncthreads();

    // y = D_r^T s_r + D_s^T s_s + D_t^T s_t (+ mass * x)
    for (int node = threadIdx.x; node < np; node += blockDim.x) {
      const int i = node % n1, j = (node / n1) % n1, k = node / nc;
      float yv = 0.f;
      if (helmholtz) {
        float mass;
        node_factors<SRC, T>(geom, s_g, lam0, lam1, xi, w3, e, np, node, i, j,
                             k, helmholtz, mass);
        yv = mass * s_x[node];
      }
      for (int m = 0; m < n1; ++m) {
        yv = fmaf(s_d[m * n1 + i], s_r[(k * n1 + j) * n1 + m], yv);
        yv = fmaf(s_d[m * n1 + j], s_s[(k * n1 + m) * n1 + i], yv);
        yv = fmaf(s_d[m * n1 + k], s_t[(m * n1 + j) * n1 + i], yv);
      }
      store(y + off + node, yv);
    }
    __syncthreads();
  }
}

// Shared memory of one generic block (ops.generic_smem_bytes).
size_t any_smem_bytes(int n1) {
  const size_t nc = static_cast<size_t>(n1) * n1;
  return sizeof(float) * (nc + 32 + 4 * nc * n1);
}

template <GeomSource SRC, typename T>
int launch_any(const T* x, T* y, const T* geom, const T* lam0, const T* lam1,
               const float* dhat, const float* xi, const float* w3, int n1,
               int n_elem, int ncols, int helmholtz, void* stream) {
  if (n_elem <= 0 || ncols <= 0 || n1 < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = any_smem_bytes(n1);
  if (smem > kSmemPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  // Above the default 48 KB a kernel must opt in to its dynamic size.  The
  // attribute belongs to the current device, so every such launch sets it:
  // a host call that enqueues nothing, allowed while a graph captures.
  if (smem > 48 * 1024) {
    const cudaError_t opted = cudaFuncSetAttribute(
        axhelm_any_kernel<SRC, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (opted != cudaSuccess) return static_cast<int>(opted);
  }
  const int np = n1 * n1 * n1;
  const int threads = np < kAnyThreads ? (np + 31) / 32 * 32 : kAnyThreads;
  axhelm_any_kernel<SRC, T>
      <<<static_cast<unsigned>(n_elem), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(x, y, geom, lam0, lam1, dhat, xi,
                                              w3, n1, ncols, helmholtz);
  return static_cast<int>(cudaGetLastError());
}

template <GeomSource SRC, typename T>
int launch(const T* x, T* y, const T* geom, const T* lam0, const T* lam1,
           const float* dhat, const float* xi, const float* w3, int n1,
           int n_elem, int ncols, int helmholtz, void* stream) {
  if (n_elem <= 0 || ncols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_elem));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n1) {
    case 4:
      axhelm_kernel<4, SRC, T><<<grid, 4 * 4 * 4, 0, s>>>(
          x, y, geom, lam0, lam1, dhat, xi, w3, ncols, helmholtz);
      break;
    case 8:
      axhelm_kernel<8, SRC, T><<<grid, 8 * 8 * 8, 0, s>>>(
          x, y, geom, lam0, lam1, dhat, xi, w3, ncols, helmholtz);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The entry points for storage type T: axhelm_<variant>_<SUFFIX>_any (the
// generic body, any N1; one signature for all five) and
// axhelm_<variant>_<SUFFIX>_rowwise (the node body, timing only).
// merged is Helmholtz always (lam2 = Lam2 and lam3 = Lam3 must be given),
// partial Poisson always (gscale must be given).
#define AXHELM_ANY_ENTRY_POINT(VARIANT, SRC, T, SUFFIX)                      \
  extern "C" int axhelm_##VARIANT##_##SUFFIX##_any(                           \
      const T* x, T* y, const T* geom, const T* lam0, const T* lam1,         \
      const float* dhat, const float* xi, const float* w3, int n1,            \
      int n_elem, int ncols, int helmholtz, void* stream) {                   \
    if (SRC == kMerged && (lam0 == nullptr || lam1 == nullptr)) {             \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    }                                                                         \
    if (SRC == kPartial && lam0 == nullptr) {                                 \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    }                                                                         \
    if (SRC == kMerged) helmholtz = 1;                                        \
    if (SRC == kPartial) helmholtz = 0;                                       \
    return launch_any<SRC, T>(x, y, geom, lam0, lam1, dhat, xi, w3, n1,       \
                              n_elem, ncols, helmholtz, stream);              \
  }

#define AXHELM_ENTRY_POINTS(T, SUFFIX)                                        \
  AXHELM_ANY_ENTRY_POINT(precomputed, kPrecomputed, T, SUFFIX)                \
  AXHELM_ANY_ENTRY_POINT(trilinear, kTrilinear, T, SUFFIX)                    \
  AXHELM_ANY_ENTRY_POINT(parallelepiped, kParallelepiped, T, SUFFIX)          \
  AXHELM_ANY_ENTRY_POINT(merged, kMerged, T, SUFFIX)                          \
  AXHELM_ANY_ENTRY_POINT(partial, kPartial, T, SUFFIX)                        \
  extern "C" int axhelm_precomputed_##SUFFIX##_rowwise(                       \
      const T* x, T* y, const T* geom, const T* lam0, const T* lam1,         \
      const float* dhat, int n1, int n_elem, int ncols, int helmholtz,        \
      void* stream) {                                                         \
    return launch<kPrecomputed, T>(x, y, geom, lam0, lam1, dhat, nullptr,     \
                                   nullptr, n1, n_elem, ncols, helmholtz,     \
                                   stream);                                   \
  }                                                                           \
  extern "C" int axhelm_trilinear_##SUFFIX##_rowwise(                         \
      const T* x, T* y, const T* verts, const T* lam0, const T* lam1,        \
      const float* dhat, const float* xi, const float* w3, int n1,            \
      int n_elem, int ncols, int helmholtz, void* stream) {                   \
    return launch<kTrilinear, T>(x, y, verts, lam0, lam1, dhat, xi, w3, n1,   \
                                 n_elem, ncols, helmholtz, stream);           \
  }                                                                           \
  extern "C" int axhelm_parallelepiped_##SUFFIX##_rowwise(                     \
      const T* x, T* y, const T* gelem, const T* lam0, const T* lam1,        \
      const float* dhat, const float* w3, int n1, int n_elem, int ncols,      \
      int helmholtz, void* stream) {                                          \
    return launch<kParallelepiped, T>(x, y, gelem, lam0, lam1, dhat,          \
                                      nullptr, w3, n1, n_elem, ncols,         \
                                      helmholtz, stream);                     \
  }                                                                           \
  extern "C" int axhelm_merged_##SUFFIX##_rowwise(                             \
      const T* x, T* y, const T* verts, const T* lam2, const T* lam3,        \
      const float* dhat, const float* xi, int n1, int n_elem, int ncols,      \
      void* stream) {                                                         \
    if (lam2 == nullptr || lam3 == nullptr) {                                 \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    }                                                                         \
    return launch<kMerged, T>(x, y, verts, lam2, lam3, dhat, xi, nullptr, n1, \
                              n_elem, ncols, 1, stream);                      \
  }                                                                           \
  extern "C" int axhelm_partial_##SUFFIX##_rowwise(                           \
      const T* x, T* y, const T* verts, const T* gscale, const float* dhat,  \
      const float* xi, int n1, int n_elem, int ncols, void* stream) {         \
    if (gscale == nullptr) return static_cast<int>(cudaErrorInvalidValue);    \
    return launch<kPartial, T>(x, y, verts, gscale, nullptr, dhat, xi,        \
                               nullptr, n1, n_elem, ncols, 0, stream);        \
  }

AXHELM_ENTRY_POINTS(float, f32)
AXHELM_ENTRY_POINTS(__nv_bfloat16, bf16)
