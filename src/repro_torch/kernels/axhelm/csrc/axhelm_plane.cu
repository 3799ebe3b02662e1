// axhelm_plane.cu -- the axhelm element operator for elements too large for
// one block's shared memory at the orders HOSFEM users run high: every variant
// at N1 from ops.N1_MAX + 1 (25) to ops.N1_PLANE_MAX (48), an application
// run as three launches -- the t contraction, a pass over t-planes, the
// transposed t contraction -- on register-tiled fp32 products (sm_90a), with
// a plain C interface (bound from Python with ctypes).
//
// Replaces the TPU kernel repro/kernels/axhelm/kernel.py::_kernel, the body
// of the one pl.pallas_call (kernel.py:233), with _grad :46, _grad_transpose
// :72 and _apply_factors :88, in all five of its variants (K1 precomputed
// :122-125, K2 trilinear :126-131, K3 parallelepiped :132-136, K4 merged
// :137-153, K5 partial :154-157) and both storage types, at the orders the
// generic body of axhelm.cu cannot hold: _kernel takes any N1 from the shape
// of x (kernel.py:159), and the generic body keeps D-hat, x and three
// weighted gradient components of a whole element in one block, 4 (N1^2 + 32
// + 4 N1^3) bytes, 252,628 at N1 = 25 against the 232,448 a block may have.
//
// Per element e and column c (c runs over the nrhs*d columns, which all
// share the element's factors):
//   y = D^T [lam0 * G (D x)]  (+ mass * x for Helmholtz, mass = lam1 * gwj)
//
// Design.  One application is three launches on the given stream, over fp32
// scratch T and Ypart of E ncols N1^3 words each (allocated by the caller):
//   1. T = D_t x: per batch row b = e ncols + c, out(p, q) = sum_m D(p, m)
//      x(m, q) over the N1^2 contiguous (j, i) lines q   (line kernel, first)
//   2. per (element, t-plane k), looping over the columns: plane k of x
//      and of T staged in shared memory (cp.async for fp32, the first
//      column's in flight while D-hat comes); x_r = X D^T and x_s = D X in
//      the plane; the node's factors (node_factors, once a node: held in
//      shared memory for every column when there are several, else
//      computed where they are used); s_r, s_s and s_t into shared memory,
//      s_t then written back over T in place (a block owns its plane);
//      Ypart = D_r^T s_r + D_s^T s_s (+ mass x)              (plane kernel)
//   3. y = Ypart + D_t^T S_t, rounded once to the storage type
//                                                       (line kernel, last)
// Every product is a register tile of kReg x kReg outputs a thread, summed
// from shared memory, so that each shared-memory wavefront feeds at least
// two FFMAs (3.2 in the line kernel); every copy into shared memory is
// cp.async where the source is fp32 (D-hat, the panels, the planes):
//   * the line kernel: a block holds all of D-hat (or its transpose) as
//     s_a(m, p) and a panel of kLineTileQ lines, the whole contracted axis;
//     its output tile spans the whole p axis, N1 rounded up to kReg; a
//     warp takes kReg rows p and 32 lanes of lines (a step's D-hat loads
//     one 16-byte broadcast, its panel loads 32 consecutive words each);
//   * the plane kernel: ceil(N1 / kReg)^2 threads, thread (ti, tj) owning
//     the nodes (j, i) = (tj + u L, ti + v L), L = ceil(N1 / kReg); D-hat,
//     the plane and s_r, s_s in rows of N1 | 1 words (an odd pitch), so
//     that the rows a warp reads at once meet in no bank.
// Ragged tiles (N1 = 25 to 48 fits no power-of-two tile) read clamped rows
// and store only the outputs that exist.  Each sum runs m upward; nothing is
// atomic.  Launch 1 reads x, launch 3 writes y; neither needs the mass,
// which belongs to the plane.
//
// What bounds it: 12 N1^4 FLOPs an element and column (the operation bound
// of chip_smoke.py::axhelm_bound; 2 N1^4 in each line launch, 8 N1^4 in the
// plane), which the card runs as fp32 FFMAs fed from shared memory at 2 FMAs
// a load, so at most half the FFMA rate; and the scratch traffic, about 8
// words a node and column through L2 (x, T written, read and rewritten,
// Ypart written and read, y).  It holds 13-21% of that bound at N1 = 32:
// with its steps compiled out one at a time (scripts/plane_phase_probe.py,
// PERF.md), about half an application goes to the two line launches and the
// plane kernel's staging, barriers and stores, a quarter to step B (for K2
// the Alg. 3 recomputation of every node's factors) and a quarter to the
// four products of steps A and C.  A plane block has 2-5 warps and an SM 3
// such blocks at 128 registers a thread (more registers, fewer blocks:
// slower at N1 = 48), so little hides the latency of the loads and the
// barriers.  Tensor cores are left out on purpose: TF32 keeps 10 mantissa
// bits, and 3xTF32 products are later work.
//
// Storage, layouts and the lambda slots are those of axhelm.cu's generic
// body (see its note): x, y (E, ncols, N1^3), geom per variant, lam0/lam1
// (E, N1^3) or null, dhat (N1, N1), xi (N1), w3 (N1^3), fp32 arithmetic,
// the scratch fp32, one rounding of y to the storage type.  Offsets are
// int64.  Any operand offset the other bodies take is taken: the plane is
// staged a value a copy (4 bytes in fp32, a load and a widening in bf16),
// since its padded rows leave no wider copy aligned.  Every entry point
// launches on the given stream, allocates nothing, and returns the first
// launch error or cudaGetLastError() (0 on success).

#include <climits>
#include <cstdint>

#include "axhelm_common.cuh"

namespace {

using namespace axhelm_detail;

constexpr int kReg = 4;                         // outputs a thread, each axis
constexpr int kLineLanes = 32;                  // line kernel: lanes along q
constexpr int kLineTileQ = kReg * kLineLanes;   // 128 lines a block
constexpr int kPlaneN1Max = 48;                 // the largest N1 a launch
constexpr int kLineThreadsMax = kLineLanes * (kPlaneN1Max / kReg);  // 384
// a plane block's threads at kPlaneN1Max (12^2 in whole warps), and the
// blocks an SM it promises: 128 registers a thread, 4 of its warps to each
// quarter of an SM
constexpr int kPlaneThreadsMax =
    ((kPlaneN1Max / kReg) * (kPlaneN1Max / kReg) + 31) / 32 * 32;
constexpr int kPlaneMinBlocks = 3;
constexpr int kFactorWords = 7;                 // g00 .. g22, mass
constexpr int kSmemPerBlock = 232448;

// Threads along each axis of a tile: N1 rounded up to kReg, over kReg.
__host__ __device__ constexpr int lanes_of(int n1) {
  return (n1 + kReg - 1) / kReg;
}
// The plane kernel's row pitch: odd, so that rows meet in no bank.
__host__ __device__ constexpr int pitch_of(int n1) { return n1 | 1; }

int plane_threads(int n1) {
  const int l = lanes_of(n1);
  return (l * l + 31) / 32 * 32;
}

int line_threads(int n1) { return kLineLanes * lanes_of(n1); }

// Dynamic shared memory of a line-kernel block (ops.plane_launch): s_a
// (N1 x kReg L) and the panel (N1 x kLineTileQ), fp32.
size_t line_smem_bytes(int n1) {
  return sizeof(float) * static_cast<size_t>(n1) *
         (kReg * lanes_of(n1) + kLineTileQ);
}

// Dynamic shared memory of a plane-kernel block (ops.plane_launch): D-hat,
// s_r, s_s and the planes of T and x in rows of pitch_of(N1), and, when the
// block holds the factors for several columns, kFactorWords words a node.
size_t plane_smem_bytes(int n1, bool hold) {
  const size_t n = static_cast<size_t>(n1);
  return sizeof(float) *
         (5 * n * pitch_of(n1) + (hold ? kFactorWords * n * n : 0));
}

// The operands of one application, by value in every launch.
template <typename T>
struct PlaneArgs {
  const T* x;
  T* y;
  const T* geom;
  const T* lam0;
  const T* lam1;
  const float* dhat;
  const float* xi;
  const float* w3;
  float* t;      // D_t x, then s_t in place
  float* ypart;  // D_r^T s_r + D_s^T s_s (+ mass x)
  int n1, ncols, helmholtz;
};

// N1 x N1 values from src (a plane, or D-hat) into s_x, rows of pitch ld.
template <typename T>
__device__ __forceinline__ void stage_plane(float* s_x, const T* src, int n1,
                                            int ld) {
#pragma unroll 4
  for (int q = threadIdx.x; q < n1 * n1; q += blockDim.x) {
    stage_value(s_x + (q / n1) * ld + q % n1, src + q);
  }
}

// Launches 1 and 3: out(b, p, q) = sum_m A(p, m) in(b, m, q) over the lines
// q = (j, i) of batch row b, A = D-hat (first: in = x, out = T) or its
// transpose (last: in = S_t in T, out = y = Ypart + the sum).  Grid: (E
// ncols, ceil(N1^2 / kLineTileQ)); threads kLineLanes x L, a warp kReg p.
template <bool LAST, typename T>
__global__ void __launch_bounds__(kLineThreadsMax)
    axhelm_plane_line_kernel(const PlaneArgs<T> a) {
  extern __shared__ float smem[];
  const int n1 = a.n1, nc = n1 * n1, np = nc * n1;
  const int lanes = lanes_of(n1), pp = kReg * lanes;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * np;
  const int q0 = blockIdx.y * kLineTileQ;
  const int lines = min(kLineTileQ, nc - q0);
  float* s_a = smem;              // s_a[m * pp + p] = A(p, m), 0 past N1
  float* panel = s_a + n1 * pp;   // panel[m * kLineTileQ + ql]
#pragma unroll 4
  for (int idx = threadIdx.x; idx < n1 * pp; idx += blockDim.x) {
    const int m = idx / pp, p = idx % pp;
    if (p < n1) {
      stage_value(s_a + idx, a.dhat + (LAST ? m * n1 + p : p * n1 + m));
    } else {
      s_a[idx] = 0.f;
    }
  }
#pragma unroll 4
  for (int idx = threadIdx.x; idx < n1 * kLineTileQ; idx += blockDim.x) {
    const int m = idx / kLineTileQ, ql = idx % kLineTileQ;
    if (ql < lines) {
      const int64_t at = base + static_cast<int64_t>(m) * nc + q0 + ql;
      if constexpr (LAST) {
        stage_value(panel + idx, a.t + at);
      } else {
        stage_value(panel + idx, a.x + at);
      }
    } else {
      panel[idx] = 0.f;
    }
  }
  cp_async_wait();
  __syncthreads();
  // thread (lp, lq) owns the rows p = kReg lp + u and the lines lq + v
  // kLineLanes: its rows' A(p, m) are one 16-byte broadcast a step
  const int lq = threadIdx.x % kLineLanes, lp = threadIdx.x / kLineLanes;
  float acc[kReg][kReg];
#pragma unroll
  for (int u = 0; u < kReg; ++u) {
#pragma unroll
    for (int v = 0; v < kReg; ++v) acc[u][v] = 0.f;
  }
#pragma unroll 2
  for (int m = 0; m < n1; ++m) {
    const float4 a4 =
        *reinterpret_cast<const float4*>(s_a + m * pp + kReg * lp);
    const float av[kReg] = {a4.x, a4.y, a4.z, a4.w};
    float xv[kReg];
#pragma unroll
    for (int v = 0; v < kReg; ++v) {
      xv[v] = panel[m * kLineTileQ + lq + v * kLineLanes];
    }
#pragma unroll
    for (int u = 0; u < kReg; ++u) {
#pragma unroll
      for (int v = 0; v < kReg; ++v) {
        acc[u][v] = fmaf(av[u], xv[v], acc[u][v]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kReg; ++u) {
    const int p = kReg * lp + u;
    if (p >= n1) continue;
#pragma unroll
    for (int v = 0; v < kReg; ++v) {
      const int ql = lq + v * kLineLanes;
      if (ql >= lines) continue;
      const int64_t at = base + static_cast<int64_t>(p) * nc + q0 + ql;
      if constexpr (LAST) {
        store(a.y + at, a.ypart[at] + acc[u][v]);
      } else {
        a.t[at] = acc[u][v];
      }
    }
  }
}

// Launch 2: one block per (element, t-plane k), looping over the columns.
// Grid: E N1 blocks; threads L^2 in whole warps (the last threads of the
// last warp own no tile node).  Per column, the planes of x and T staged
// together, then three steps between barriers:
//   A. x_r and x_s on the thread's register tile, into s_r and s_s;
//   B. per node (node q = thread, thread + blockDim, ...), one at a time:
//      the factors, the weighted components in place in s_r, s_s and s_t,
//      and mass x over the plane of x (Helmholtz);
//   C. s_t back over T, a coalesced pass; Ypart on the register tile, from
//      the mass term.
// Step B's factors never share registers with a tile, so neither spills,
// and it stores nothing to device memory, so its loads of the factors'
// operands may run ahead of its arithmetic.
template <GeomSource SRC, typename T>
__global__ void __launch_bounds__(kPlaneThreadsMax, kPlaneMinBlocks)
    axhelm_plane_kernel(const PlaneArgs<T> a) {
  constexpr int NG = geometry_words<SRC>();
  extern __shared__ float smem[];
  __shared__ float s_g[32];
  const int n1 = a.n1, nc = n1 * n1, np = nc * n1;
  const int lanes = lanes_of(n1), ld = pitch_of(n1), words = n1 * ld;
  const int64_t e = blockIdx.x / n1;
  const int k = blockIdx.x % n1;
  const bool hold = a.ncols > 1;
  float* s_d = smem;               // D-hat(r, c) at r * ld + c
  float* s_r = s_d + words;        // r component, (j, i) at j * ld + i
  float* s_s = s_r + words;        // s component
  float* s_t = s_s + words;        // the plane of T, then the t component
  float* s_x = s_t + words;        // the plane of x
  float* s_f = s_x + words;        // held factors: word w of q at w nc + q
  const int64_t plane0 = static_cast<int64_t>(k) * nc;

  // the first column's planes, in flight while D-hat and the factors come
  stage_plane(s_x, a.x + e * a.ncols * np + plane0, n1, ld);
  stage_plane(s_t, a.t + e * a.ncols * np + plane0, n1, ld);
  stage_plane(s_d, a.dhat, n1, ld);
  if (threadIdx.x < NG) s_g[threadIdx.x] = load(a.geom + e * NG + threadIdx.x);
  cp_async_wait();
  __syncthreads();
  if (hold) {
    for (int q = threadIdx.x; q < nc; q += blockDim.x) {
      float mass;
      const Factors f = node_factors<SRC, T>(
          a.geom, s_g, a.lam0, a.lam1, a.xi, a.w3, e, np,
          static_cast<int>(plane0) + q, q % n1, q / n1, k, a.helmholtz, mass);
      s_f[0 * nc + q] = f.g00;
      s_f[1 * nc + q] = f.g01;
      s_f[2 * nc + q] = f.g02;
      s_f[3 * nc + q] = f.g11;
      s_f[4 * nc + q] = f.g12;
      s_f[5 * nc + q] = f.g22;
      s_f[6 * nc + q] = mass;
    }
  }

  // this thread's tile rows j and columns i, clamped for the loads
  const int ti = threadIdx.x % lanes, tj = threadIdx.x / lanes;
  int jr[kReg], ir[kReg];
  bool jv[kReg], iv[kReg];
#pragma unroll
  for (int u = 0; u < kReg; ++u) {
    const int j = tj + u * lanes, i = ti + u * lanes;
    jv[u] = tj < lanes && j < n1;
    iv[u] = i < n1;
    jr[u] = min(j, n1 - 1);
    ir[u] = min(i, n1 - 1);
  }

  for (int c = 0; c < a.ncols; ++c) {
    const int64_t off = (e * a.ncols + c) * np + plane0;
    if (c > 0) {
      // the last column's step C is done with every plane
      __syncthreads();
      stage_plane(s_x, a.x + off, n1, ld);
      stage_plane(s_t, a.t + off, n1, ld);
    }
    cp_async_wait();
    // the planes are staged (and, first, D-hat and the held factors)
    __syncthreads();

    {  // A. x_r(j, i) = sum_m X(j, m) D(i, m), x_s = sum_m D(j, m) X(m, i)
      float xr[kReg][kReg], xs[kReg][kReg];
#pragma unroll
      for (int u = 0; u < kReg; ++u) {
#pragma unroll
        for (int v = 0; v < kReg; ++v) xr[u][v] = xs[u][v] = 0.f;
      }
#pragma unroll 2
      for (int m = 0; m < n1; ++m) {
        float xj[kReg], dj[kReg], di[kReg], xm[kReg];
#pragma unroll
        for (int u = 0; u < kReg; ++u) {
          xj[u] = s_x[jr[u] * ld + m];
          dj[u] = s_d[jr[u] * ld + m];
          di[u] = s_d[ir[u] * ld + m];
          xm[u] = s_x[m * ld + ir[u]];
        }
#pragma unroll
        for (int u = 0; u < kReg; ++u) {
#pragma unroll
          for (int v = 0; v < kReg; ++v) {
            xr[u][v] = fmaf(xj[u], di[v], xr[u][v]);
            xs[u][v] = fmaf(dj[u], xm[v], xs[u][v]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kReg; ++u) {
#pragma unroll
        for (int v = 0; v < kReg; ++v) {
          if (jv[u] && iv[v]) {
            s_r[jr[u] * ld + ir[v]] = xr[u][v];
            s_s[jr[u] * ld + ir[v]] = xs[u][v];
          }
        }
      }
    }
    __syncthreads();

    // B. per node: the factors, the weighted components, mass x
#pragma unroll 2
    for (int q = threadIdx.x; q < nc; q += blockDim.x) {
      const int j = q / n1, i = q % n1, at = j * ld + i;
      Factors f;
      float mass;
      if (hold) {
        f.g00 = s_f[0 * nc + q];
        f.g01 = s_f[1 * nc + q];
        f.g02 = s_f[2 * nc + q];
        f.g11 = s_f[3 * nc + q];
        f.g12 = s_f[4 * nc + q];
        f.g22 = s_f[5 * nc + q];
        mass = s_f[6 * nc + q];
      } else {
        f = node_factors<SRC, T>(a.geom, s_g, a.lam0, a.lam1, a.xi, a.w3, e,
                                 np, static_cast<int>(plane0) + q, i, j, k,
                                 a.helmholtz, mass);
      }
      const float r = s_r[at], s = s_s[at], t = s_t[at];
      s_r[at] = f.g00 * r + f.g01 * s + f.g02 * t;
      s_s[at] = f.g01 * r + f.g11 * s + f.g12 * t;
      s_t[at] = f.g02 * r + f.g12 * s + f.g22 * t;
      if (a.helmholtz) s_x[at] = mass * s_x[at];
    }
    __syncthreads();

    // C. s_t over T; Ypart(j, i) = mass x + sum_m s_r(j, m) D(m, i)
    //    + D(m, j) s_s(m, i)
    for (int q = threadIdx.x; q < nc; q += blockDim.x) {
      a.t[off + q] = s_t[(q / n1) * ld + q % n1];
    }
    float yp[kReg][kReg];
#pragma unroll
    for (int u = 0; u < kReg; ++u) {
#pragma unroll
      for (int v = 0; v < kReg; ++v) {
        yp[u][v] = a.helmholtz ? s_x[jr[u] * ld + ir[v]] : 0.f;
      }
    }
#pragma unroll 2
    for (int m = 0; m < n1; ++m) {
      float rj[kReg], dmi[kReg], dmj[kReg], si[kReg];
#pragma unroll
      for (int u = 0; u < kReg; ++u) {
        rj[u] = s_r[jr[u] * ld + m];
        dmj[u] = s_d[m * ld + jr[u]];
        dmi[u] = s_d[m * ld + ir[u]];
        si[u] = s_s[m * ld + ir[u]];
      }
#pragma unroll
      for (int u = 0; u < kReg; ++u) {
#pragma unroll
        for (int v = 0; v < kReg; ++v) {
          yp[u][v] = fmaf(rj[u], dmi[v], yp[u][v]);
          yp[u][v] = fmaf(dmj[u], si[v], yp[u][v]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kReg; ++u) {
#pragma unroll
      for (int v = 0; v < kReg; ++v) {
        if (jv[u] && iv[v]) a.ypart[off + jr[u] * n1 + ir[v]] = yp[u][v];
      }
    }
  }
}

template <bool LAST, typename T>
cudaError_t line_product(const PlaneArgs<T>& a, dim3 grid, int threads,
                         size_t smem, cudaStream_t stream) {
  void (*kernel)(const PlaneArgs<T>) = axhelm_plane_line_kernel<LAST, T>;
  // The opt-in to the dynamic size belongs to the current device, so every
  // launch sets it: a host call that enqueues nothing, allowed while a
  // graph captures.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <GeomSource SRC, typename T>
int launch_plane(const T* x, T* y, const T* geom, const T* lam0,
                 const T* lam1, const float* dhat, const float* xi,
                 const float* w3, float* scratch, int n1, int n_elem,
                 int ncols, int helmholtz, void* stream) {
  if (n_elem <= 0 || ncols <= 0 || n1 < 2 || n1 > kPlaneN1Max ||
      scratch == nullptr || n_elem > INT_MAX / ncols ||
      n_elem > INT_MAX / n1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool hold = ncols > 1;
  const size_t line_smem = line_smem_bytes(n1);
  const size_t plane_smem = plane_smem_bytes(n1, hold);
  if (line_smem > kSmemPerBlock || plane_smem > kSmemPerBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t np = static_cast<int64_t>(n1) * n1 * n1;
  const int64_t words = static_cast<int64_t>(n_elem) * ncols * np;
  const PlaneArgs<T> a{x,    y,    geom,    lam0,          lam1,
                       dhat, xi,   w3,      scratch,       scratch + words,
                       n1,   ncols, helmholtz};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 line_grid(
      static_cast<unsigned>(n_elem * ncols),
      static_cast<unsigned>((n1 * n1 + kLineTileQ - 1) / kLineTileQ));
  cudaError_t err =
      line_product<false>(a, line_grid, line_threads(n1), line_smem, s);
  if (err == cudaSuccess) {
    void (*plane)(const PlaneArgs<T>) = axhelm_plane_kernel<SRC, T>;
    err = cudaFuncSetAttribute(plane,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(plane_smem));
    if (err == cudaSuccess) {
      plane<<<static_cast<unsigned>(n_elem * n1), plane_threads(n1),
              plane_smem, s>>>(a);
      err = cudaGetLastError();
    }
  }
  if (err == cudaSuccess) {
    err = line_product<true>(a, line_grid, line_threads(n1), line_smem, s);
  }
  return static_cast<int>(err);
}

}  // namespace

// The entry points axhelm_<variant>_<SUFFIX>_plane for storage type T: the
// generic body's arguments (axhelm.cu) plus the fp32 scratch of 2 ncols
// n_elem N1^3 words (ops.plane_launch).  merged is Helmholtz always (lam2 =
// Lam2 and lam3 = Lam3 must be given), partial Poisson always (gscale must
// be given).
#define AXHELM_PLANE_ENTRY_POINT(VARIANT, SRC, T, SUFFIX)                    \
  extern "C" int axhelm_##VARIANT##_##SUFFIX##_plane(                         \
      const T* x, T* y, const T* geom, const T* lam0, const T* lam1,         \
      const float* dhat, const float* xi, const float* w3, float* scratch,   \
      int n1, int n_elem, int ncols, int helmholtz, void* stream) {          \
    if (SRC == kMerged && (lam0 == nullptr || lam1 == nullptr)) {             \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    }                                                                         \
    if (SRC == kPartial && lam0 == nullptr) {                                 \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    }                                                                         \
    if (SRC == kMerged) helmholtz = 1;                                        \
    if (SRC == kPartial) helmholtz = 0;                                       \
    return launch_plane<SRC, T>(x, y, geom, lam0, lam1, dhat, xi, w3,         \
                                scratch, n1, n_elem, ncols, helmholtz,        \
                                stream);                                      \
  }

#define AXHELM_PLANE_ENTRY_POINTS(T, SUFFIX)                                  \
  AXHELM_PLANE_ENTRY_POINT(precomputed, kPrecomputed, T, SUFFIX)              \
  AXHELM_PLANE_ENTRY_POINT(trilinear, kTrilinear, T, SUFFIX)                  \
  AXHELM_PLANE_ENTRY_POINT(parallelepiped, kParallelepiped, T, SUFFIX)        \
  AXHELM_PLANE_ENTRY_POINT(merged, kMerged, T, SUFFIX)                        \
  AXHELM_PLANE_ENTRY_POINT(partial, kPartial, T, SUFFIX)

AXHELM_PLANE_ENTRY_POINTS(float, f32)
AXHELM_PLANE_ENTRY_POINTS(__nv_bfloat16, bf16)
