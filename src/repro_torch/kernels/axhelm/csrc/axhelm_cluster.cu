// axhelm_cluster.cu -- the axhelm element operator for elements too large for
// one block's shared memory: every variant at N1 from ops.N1_MAX + 1 (25) to
// ops.N1_CLUSTER_MAX (48), an element split across a thread-block cluster
// (sm_90a), with a plain C interface (bound from Python with ctypes).
//
// Replaces the TPU kernel repro/kernels/axhelm/kernel.py::_kernel, the body
// of the one pl.pallas_call (kernel.py:233), in all five of its variants
// (K1 precomputed :122-125, K2 trilinear :126-131, K3 parallelepiped
// :132-136, K4 merged :137-153, K5 partial :154-157) and both storage types,
// at the orders the generic body of axhelm.cu cannot hold: _kernel takes any
// N1 from the shape of x (kernel.py:159), and the generic body keeps D-hat,
// x and three weighted gradient components of a whole element in one
// block's shared memory, 4 (N1^2 + 32 + 4 N1^3) bytes, 252,628 at N1 = 25
// against the 232,448 a block may have on the H100.
//
// Per element e and column c (c runs over the nrhs*d columns, which all
// share the element's factors):
//   y = D^T [lam0 * G (D x)]  (+ mass * x for Helmholtz, mass = lam1 * gwj)
//
// Design.  One element takes a cluster of P blocks (P = 2, 4 or 8, the
// smallest power of two whose slab fits, ops.cluster_launch; P depends on
// N1 at run time, so the launch sets the cluster dimension with
// cudaLaunchKernelEx).  Block b of the cluster holds the t-planes
// k in [b K, min((b + 1) K, N1)), K = ceil(N1 / P) (the last block's slab
// may be short, or empty), and keeps in dynamic shared memory D-hat (rows
// padded to N1 + 1 floats, so that the lanes of a warp reading D-hat(i, m)
// for consecutive i hit distinct banks), the element's geometry words, its
// planes of x and its planes of the three weighted components.  Per column:
//   1. the block stages its planes of x;                    cluster.sync()
//   2. per node of its planes: the factors (node_factors, the generic
//      body's arithmetic), x_r and x_s from its own planes, x_t from every
//      plane m of the element -- a peer's planes read through distributed
//      shared memory (cluster.map_shared_rank) -- and the weighted
//      components into its planes;                            cluster.sync()
//   3. per node: y = D_r^T s_r + D_s^T s_s (own planes) + D_t^T s_t (every
//      plane, the peers' through DSMEM) (+ mass * x, the mass recomputed),
//      stored once;                                           cluster.sync()
// The last barrier of a column keeps a block from overwriting its planes
// for the next column, or exiting, while a peer may still read them.  Each
// sum runs m upward, the peers' planes in their order; nothing is atomic.
//
// What bounds it: every value a contraction reads passes through shared
// memory (the t terms through DSMEM, (P - 1) / P of them remote) N1 times,
// as in the generic body, so it is bound by shared-memory and DSMEM
// traffic, far above its operation bound (chip_smoke.py::axhelm_bound; 12
// N1^4 FLOPs an element and column); one block an SM at these slab sizes,
// 16 warps.  It has to be right, not fast: wgmma, TMA multicast of x into
// the cluster and the like are later work.
//
// Storage, layouts and the lambda slots are those of axhelm.cu's generic
// body (see its note): x, y (E, ncols, N1^3), geom per variant, lam0/lam1
// (E, N1^3) or null, dhat (N1, N1), xi (N1), w3 (N1^3), fp32 arithmetic,
// one rounding of y to the storage type.  Offsets are int64 (E N1^3 reaches
// 1.3e8 at E = 4096, N1 = 32).  Every entry point launches on the given
// stream, allocates nothing, and returns the launch's error or
// cudaGetLastError() (0 on success).

#include <atomic>
#include <climits>
#include <cstdint>

#include <cooperative_groups.h>

#include "axhelm_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace axhelm_detail;

constexpr int kClusterThreads = 512;   // most threads a block (CLUSTER_THREADS)
constexpr int kClusterMax = 8;         // the portable cluster size limit
constexpr int kSmemPerBlock = 232448;  // bytes a block may use (227 KB)
constexpr int kMaxN1 = 64;             // N1 the residency cache keeps

// Dynamic shared memory of one block (ops.cluster_smem_bytes): D-hat with
// rows padded to N1 + 1, 32 geometry words, then x and the three weighted
// components of `planes` t-planes, all fp32.
size_t cluster_smem_bytes(int n1, int planes) {
  const size_t nc = static_cast<size_t>(n1) * n1;
  return sizeof(float) *
         (static_cast<size_t>(n1) * (n1 + 1) + 32 + 4 * planes * nc);
}

template <GeomSource SRC, typename T>
__global__ void __launch_bounds__(kClusterThreads)
    axhelm_cluster_kernel(const T* __restrict__ x, T* __restrict__ y,
                          const T* __restrict__ geom,
                          const T* __restrict__ lam0,
                          const T* __restrict__ lam1,
                          const float* __restrict__ dhat,
                          const float* __restrict__ xi,
                          const float* __restrict__ w3, int n1, int ncols,
                          int helmholtz, int planes) {
  constexpr int NG = geometry_words<SRC>();
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = n1 * n1, np = nc * n1, ld = n1 + 1;
  const int rank = static_cast<int>(cluster.block_rank());
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int k0 = rank * planes;                      // this block's planes
  const int nodes = max(0, min(planes, n1 - k0)) * nc;
  const int slab = planes * nc;  // the same layout in every block
  float* s_d = smem;             // dhat(row, col) at row * ld + col
  float* s_g = s_d + n1 * ld;    // the element's vertices or gelem
  float* s_x = s_g + 32;         // this block's planes of the column of x
  float* s_r = s_x + slab;       // lam0 * G . grad, r component
  float* s_s = s_r + slab;
  float* s_t = s_s + slab;
  const int64_t e = blockIdx.x / blocks;
  const int64_t node0 = static_cast<int64_t>(k0) * nc;

  for (int q = threadIdx.x; q < nc; q += blockDim.x) {
    s_d[(q / n1) * ld + q % n1] = dhat[q];
  }
  if (threadIdx.x < NG) s_g[threadIdx.x] = load(geom + e * NG + threadIdx.x);

  for (int c = 0; c < ncols; ++c) {
    const int64_t off = (e * ncols + c) * np + node0;
    for (int q = threadIdx.x; q < nodes; q += blockDim.x) {
      s_x[q] = load(x + off + q);
    }
    // every block's planes of x (and D-hat and the geometry) are staged
    cluster.sync();

    // grad, the factors, and the weighted components at each node
    for (int q = threadIdx.x; q < nodes; q += blockDim.x) {
      const int i = q % n1, j = (q / n1) % n1, kl = q / nc, k = k0 + kl;
      float mass;
      const Factors f = node_factors<SRC, T>(
          geom, s_g, lam0, lam1, xi, w3, e, np, static_cast<int>(node0) + q,
          i, j, k, helmholtz, mass);
      float xr = 0.f, xs = 0.f, xt = 0.f;
      for (int m = 0; m < n1; ++m) {
        xr = fmaf(s_d[i * ld + m], s_x[(kl * n1 + j) * n1 + m], xr);
        xs = fmaf(s_d[j * ld + m], s_x[(kl * n1 + m) * n1 + i], xs);
      }
      for (int b = 0; b < blocks; ++b) {
        const int m0 = b * planes, m1 = min(m0 + planes, n1);
        const float* px = b == rank ? s_x : cluster.map_shared_rank(s_x, b);
        for (int m = m0; m < m1; ++m) {
          xt = fmaf(s_d[k * ld + m], px[((m - m0) * n1 + j) * n1 + i], xt);
        }
      }
      s_r[q] = f.g00 * xr + f.g01 * xs + f.g02 * xt;
      s_s[q] = f.g01 * xr + f.g11 * xs + f.g12 * xt;
      s_t[q] = f.g02 * xr + f.g12 * xs + f.g22 * xt;
    }
    // every block's planes of the weighted components are written
    cluster.sync();

    // y = D_r^T s_r + D_s^T s_s + D_t^T s_t (+ mass * x)
    for (int q = threadIdx.x; q < nodes; q += blockDim.x) {
      const int i = q % n1, j = (q / n1) % n1, kl = q / nc, k = k0 + kl;
      float yv = 0.f;
      if (helmholtz) {
        float mass;
        node_factors<SRC, T>(geom, s_g, lam0, lam1, xi, w3, e, np,
                             static_cast<int>(node0) + q, i, j, k, helmholtz,
                             mass);
        yv = mass * s_x[q];
      }
      for (int m = 0; m < n1; ++m) {
        yv = fmaf(s_d[m * ld + i], s_r[(kl * n1 + j) * n1 + m], yv);
      }
      for (int m = 0; m < n1; ++m) {
        yv = fmaf(s_d[m * ld + j], s_s[(kl * n1 + m) * n1 + i], yv);
      }
      for (int b = 0; b < blocks; ++b) {
        const int m0 = b * planes, m1 = min(m0 + planes, n1);
        const float* pt = b == rank ? s_t : cluster.map_shared_rank(s_t, b);
        for (int m = m0; m < m1; ++m) {
          yv = fmaf(s_d[m * ld + k], pt[((m - m0) * n1 + j) * n1 + i], yv);
        }
      }
      store(y + off + q, yv);
    }
    // no block overwrites its planes (next column) or exits (last column)
    // while a peer may still read them
    cluster.sync();
  }
}

template <GeomSource SRC, typename T>
int launch_cluster(const T* x, T* y, const T* geom, const T* lam0,
                   const T* lam1, const float* dhat, const float* xi,
                   const float* w3, int n1, int n_elem, int ncols,
                   int helmholtz, int cluster, int planes, void* stream) {
  if (n_elem <= 0 || ncols <= 0 || n1 < 2 || n1 > kMaxN1 || cluster < 1 ||
      cluster > kClusterMax || planes < 1 || planes * cluster < n1 ||
      n_elem > INT_MAX / cluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = cluster_smem_bytes(n1, planes);
  if (smem > kSmemPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const T*, T*, const T*, const T*, const T*, const float*,
                 const float*, const float*, int, int, int, int) =
      axhelm_cluster_kernel<SRC, T>;
  // The opt-in to the dynamic size belongs to the current device, so every
  // launch sets it: a host call that enqueues nothing, allowed while a
  // graph captures.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nodes = planes * n1 * n1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_elem * cluster));
  cfg.blockDim =
      dim3(nodes < kClusterThreads ? (nodes + 31) / 32 * 32 : kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // Once per (entry point, N1, cluster shape): can one such cluster be
  // resident at all?  Its P blocks, each with its shared memory, must find
  // P SMs of one GPC.
  static std::atomic<int> resident[kMaxN1 + 1];
  const int shape = cluster * 256 + planes;
  if (resident[n1].load(std::memory_order_relaxed) != shape) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[n1].store(shape, std::memory_order_relaxed);
  }
  err = cudaLaunchKernelEx(&cfg, kernel, x, y, geom, lam0, lam1, dhat, xi, w3,
                           n1, ncols, helmholtz, planes);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

// The entry points axhelm_<variant>_<SUFFIX>_cluster for storage type T: the
// generic body's arguments (axhelm.cu) plus the cluster size and the planes
// a block holds (ops.cluster_launch).  merged is Helmholtz always (lam2 =
// Lam2 and lam3 = Lam3 must be given), partial Poisson always (gscale must
// be given).
#define AXHELM_CLUSTER_ENTRY_POINT(VARIANT, SRC, T, SUFFIX)                  \
  extern "C" int axhelm_##VARIANT##_##SUFFIX##_cluster(                       \
      const T* x, T* y, const T* geom, const T* lam0, const T* lam1,         \
      const float* dhat, const float* xi, const float* w3, int n1,            \
      int n_elem, int ncols, int helmholtz, int cluster, int planes,          \
      void* stream) {                                                         \
    if (SRC == kMerged && (lam0 == nullptr || lam1 == nullptr)) {             \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    }                                                                         \
    if (SRC == kPartial && lam0 == nullptr) {                                 \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    }                                                                         \
    if (SRC == kMerged) helmholtz = 1;                                        \
    if (SRC == kPartial) helmholtz = 0;                                       \
    return launch_cluster<SRC, T>(x, y, geom, lam0, lam1, dhat, xi, w3, n1,   \
                                  n_elem, ncols, helmholtz, cluster, planes,  \
                                  stream);                                    \
  }

#define AXHELM_CLUSTER_ENTRY_POINTS(T, SUFFIX)                                \
  AXHELM_CLUSTER_ENTRY_POINT(precomputed, kPrecomputed, T, SUFFIX)            \
  AXHELM_CLUSTER_ENTRY_POINT(trilinear, kTrilinear, T, SUFFIX)                \
  AXHELM_CLUSTER_ENTRY_POINT(parallelepiped, kParallelepiped, T, SUFFIX)      \
  AXHELM_CLUSTER_ENTRY_POINT(merged, kMerged, T, SUFFIX)                      \
  AXHELM_CLUSTER_ENTRY_POINT(partial, kPartial, T, SUFFIX)

AXHELM_CLUSTER_ENTRY_POINTS(float, f32)
AXHELM_CLUSTER_ENTRY_POINTS(__nv_bfloat16, bf16)
