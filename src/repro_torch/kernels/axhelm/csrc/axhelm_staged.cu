// axhelm_staged.cu -- the axhelm element operator for the largest
// elements: every variant at N1 above ops.N1_PLANE_MAX (48), an
// application run as a short sequence of launches that stage the
// sum-factorisation contractions through device memory and L2 (sm_90a),
// with a plain C interface (bound from Python with ctypes).
//
// Replaces the TPU kernel repro/kernels/axhelm/kernel.py::_kernel, the body
// of the one pl.pallas_call (kernel.py:233), in all five of its variants
// (K1 precomputed :122-125, K2 trilinear :126-131, K3 parallelepiped
// :132-136, K4 merged :137-153, K5 partial :154-157) and both storage types,
// at the orders above the plane body of axhelm_plane.cu: _kernel takes any
// N1 from the shape of x (kernel.py:159); at N1 = 100 one fp32 element (4
// MB) is more than the shared memory of 16 blocks.
//
// Per element e and column c (c runs over the nrhs*d columns, which all
// share the element's factors):
//   y = D^T [lam0 * G (D x)]  (+ mass * x for Helmholtz, mass = lam1 * gwj)
//
// Design.  _kernel's own body: its six contractions (_grad :46,
// _grad_transpose :72) are batched products with D-hat (N1 x N1) of depth
// N1, and _apply_factors (:88) is pointwise.  One application is seven
// launches on the given stream, over fp32 scratch S0, S1, S2 of E ncols
// N1^3 words each, and for Helmholtz M of E N1^3 words (allocated by the
// caller):
//   1-3. S0 = D_r x, S1 = D_s x, S2 = D_t x          (contract, MODE kGrad)
//   4.   per node the factors and mass (node_factors, the node walk's
//        arithmetic, once a node for every column), the weighted
//        components in place, S0, S1, S2 = lam0 G (S0, S1, S2), and M =
//        the mass                                  (axhelm_staged_factors)
//   5.   S0 = D_r^T S0, in place                        (contract, kFirst)
//   6.   S0 = S0 + D_s^T S1                        (contract, kAccumulate)
//   7.   y = S0 + D_t^T S2 (+ M x), rounded once to the storage type
//                                                        (contract, kLast)
// Only pass 4 depends on the geometry source.  (The mass is a node's, not
// an output's: recomputed in pass 7's epilogue, for each of a thread's 16
// outputs, it made ptxas spill registers.)
// Every contraction is the same tiled product.  Its operand, per batch row
// b = e ncols + c, is read as lines: q runs over the N1^2 lines of the
// contracted axis (D_t: q = (j, i); D_s: q = (k, i); D_r: q = (k, j)) and m
// along it, and out(b, p, q) = sum_m A(p, m) in(b, m, q), A = D-hat (kGrad)
// or its transpose.  A block owns kTileQ whole lines of one batch row: it
// stages them, the whole contracted axis (its panel, N1 x kTileQ floats,
// with rows padded to kTileQ + 1 so that D_r's panel, staged along m, meets
// no bank twice), then walks the output in kTileP-row tiles, each summed
// over m in kTileK-deep steps of D-hat staged in shared memory, kRegP x
// kRegQ outputs a thread in registers.  Because a block reads every value
// of its lines before it writes any, and no other block reads them, pass 5
// may write its own operand.  The innermost index i moves fastest in every
// global access: D_t and D_s stage and store along q = (.., i), D_r stages
// along m = i and stores along p = i (its warp spans p, not q).  Tiles at
// the ragged edges (N1 = 49 fits no power-of-two tile) are masked.  The
// sums run m upward; nothing is atomic.
//
// What bounds it: 12 N1^4 FLOPs an element and column (the operation bound
// of chip_smoke.py::axhelm_bound), against which the six contractions run
// fp32 FMAs from shared memory, one D-hat value and one panel value per
// kRegP x kRegQ / (kRegP + kRegQ) = 2 FMAs; and the scratch traffic, about
// 14 words a node and column through device memory and L2 (x, three
// components written and read twice, y), which passes the card's memory
// bound once N1 falls below ~40.  It has to be right, not fast: tensor
// cores, TMA and a fused pass are later work.
//
// Storage, layouts and the lambda slots are those of axhelm.cu's generic
// body (see its note): x, y (E, ncols, N1^3), geom per variant, lam0/lam1
// (E, N1^3) or null, dhat (N1, N1), xi (N1), w3 (N1^3), fp32 arithmetic,
// the scratch fp32, one rounding of y to the storage type.  Offsets are
// int64 (E ncols N1^3 passes 2^31 at N1 = 64 with E ncols >= 8192).  Every
// entry point launches on the given stream, allocates nothing, and returns
// the first launch error or cudaGetLastError() (0 on success).

#include <climits>
#include <cstdint>

#include "axhelm_common.cuh"

namespace {

using namespace axhelm_detail;

constexpr int kStagedThreads = 256;  // a block of a contraction
constexpr int kLanes = 16;           // its threads: kLanes x kLanes
constexpr int kRegP = 4;             // outputs a thread along p
constexpr int kRegQ = 4;             // outputs a thread along q
constexpr int kTileP = kLanes * kRegP;  // 64 output rows a tile
constexpr int kTileQ = kLanes * kRegQ;  // 64 lines a block
constexpr int kTileK = 16;           // D-hat columns a step
constexpr int kPitch = kTileQ + 1;   // panel row, padded
constexpr int kFactorThreads = 256;  // a block of the pointwise pass
constexpr int kSmemPerBlock = 232448;

enum Dir : int { kDirR = 0, kDirS = 1, kDirT = 2 };
enum Mode : int { kGrad = 0, kFirst = 1, kAccumulate = 2, kLast = 3 };

// Dynamic shared memory of one contraction block (ops.staged_smem_bytes):
// the panel (N1 rows of kPitch floats) and a kTileK x kTileP step of D-hat.
size_t staged_smem_bytes(int n1) {
  return sizeof(float) * (static_cast<size_t>(n1) * kPitch + kTileK * kTileP);
}

// The operands of one application, by value in every launch.
template <typename T>
struct StagedArgs {
  const T* x;
  T* y;
  const T* geom;
  const T* lam0;
  const T* lam1;
  const float* dhat;
  const float* xi;
  const float* w3;
  float* s0;    // r component; after pass 5 the running sum of y
  float* s1;    // s component
  float* s2;    // t component
  float* mass;  // per node, Helmholtz only
  int n1, ncols, helmholtz;
};

// Where line q of a batch row starts (in nodes), and the stride along the
// contracted axis: D_t q = (j, i), D_s q = (k, i), D_r q = (k, j).
template <int DIR>
__device__ __forceinline__ int64_t line_offset(int q, int n1) {
  if constexpr (DIR == kDirT) {
    return q;
  } else if constexpr (DIR == kDirS) {
    return static_cast<int64_t>(q / n1) * n1 * n1 + q % n1;
  } else {
    return static_cast<int64_t>(q) * n1;
  }
}

template <int DIR>
__device__ __forceinline__ int64_t axis_stride(int n1) {
  return DIR == kDirT ? static_cast<int64_t>(n1) * n1
                      : (DIR == kDirS ? n1 : 1);
}

// The contraction of direction DIR in pass MODE: kGrad reads x and writes
// component DIR, the transposed passes read component DIR and write S0
// (kFirst, in place for DIR = kDirR), add into it (kAccumulate) or end in y
// (kLast).  Grid: (E ncols, ceil(N1^2 / kTileQ)).
template <int DIR, int MODE, typename T>
__global__ void __launch_bounds__(kStagedThreads)
    axhelm_staged_contract_kernel(const StagedArgs<T> a) {
  constexpr bool kTransposed = MODE != kGrad;
  extern __shared__ float smem[];
  const int n1 = a.n1, nc = n1 * n1, np = nc * n1;
  const int64_t b = blockIdx.x;  // batch row: element * ncols + column
  const int q0 = blockIdx.y * kTileQ;
  const int lines = min(kTileQ, nc - q0);
  const int64_t base = b * np;
  const int64_t stride = axis_stride<DIR>(n1);
  float* panel = smem;                   // panel[m * kPitch + ql]
  float* s_a = panel + n1 * kPitch;      // s_a[kk * kTileP + pl]
  float* comp = DIR == kDirR ? a.s0 : (DIR == kDirS ? a.s1 : a.s2);

  // the panel: this block's lines, the whole contracted axis
  for (int idx = threadIdx.x; idx < n1 * kTileQ; idx += blockDim.x) {
    const bool along_m = DIR == kDirR;   // D_r's lines are contiguous
    const int m = along_m ? idx % n1 : idx / kTileQ;
    const int ql = along_m ? idx / n1 : idx % kTileQ;
    float v = 0.f;
    if (ql < lines) {
      const int64_t at = base + line_offset<DIR>(q0 + ql, n1) + m * stride;
      if constexpr (MODE == kGrad) {
        v = load(a.x + at);
      } else {
        v = comp[at];
      }
    }
    panel[m * kPitch + ql] = v;
  }

  // D_r's warps span p (its outputs are contiguous along p), the others' q
  const int tid = threadIdx.x;
  const int lp = DIR == kDirR ? tid % kLanes : tid / kLanes;
  const int lq = DIR == kDirR ? tid / kLanes : tid % kLanes;
  for (int p0 = 0; p0 < n1; p0 += kTileP) {
    float acc[kRegP][kRegQ];
#pragma unroll
    for (int u = 0; u < kRegP; ++u) {
#pragma unroll
      for (int v = 0; v < kRegQ; ++v) acc[u][v] = 0.f;
    }
    for (int m0 = 0; m0 < n1; m0 += kTileK) {
      // the last step's D-hat is consumed (and, first, the panel staged)
      __syncthreads();
      for (int idx = tid; idx < kTileK * kTileP; idx += blockDim.x) {
        const int pl = idx % kTileP, kk = idx / kTileP;
        const int p = p0 + pl, m = m0 + kk;
        float v = 0.f;
        if (p < n1 && m < n1) {
          v = kTransposed ? a.dhat[m * n1 + p] : a.dhat[p * n1 + m];
        }
        s_a[kk * kTileP + pl] = v;
      }
      __syncthreads();
      const int depth = min(kTileK, n1 - m0);
      for (int kk = 0; kk < depth; ++kk) {
        float av[kRegP], xv[kRegQ];
#pragma unroll
        for (int u = 0; u < kRegP; ++u) {
          av[u] = s_a[kk * kTileP + lp + u * kLanes];
        }
#pragma unroll
        for (int v = 0; v < kRegQ; ++v) {
          xv[v] = panel[(m0 + kk) * kPitch + lq + v * kLanes];
        }
#pragma unroll
        for (int u = 0; u < kRegP; ++u) {
#pragma unroll
          for (int v = 0; v < kRegQ; ++v) {
            acc[u][v] = fmaf(av[u], xv[v], acc[u][v]);
          }
        }
      }
    }
    // this tile's outputs; every read of the block's lines is done
#pragma unroll
    for (int u = 0; u < kRegP; ++u) {
      const int p = p0 + lp + u * kLanes;
      if (p >= n1) continue;
#pragma unroll
      for (int v = 0; v < kRegQ; ++v) {
        const int ql = lq + v * kLanes;
        if (ql >= lines) continue;
        const int64_t node = line_offset<DIR>(q0 + ql, n1) + p * stride;
        const int64_t at = base + node;
        if constexpr (MODE == kGrad) {
          comp[at] = acc[u][v];
        } else if constexpr (MODE == kFirst) {
          a.s0[at] = acc[u][v];
        } else if constexpr (MODE == kAccumulate) {
          a.s0[at] = a.s0[at] + acc[u][v];
        } else {
          float yv = a.s0[at] + acc[u][v];
          if (a.helmholtz) {
            const int e = static_cast<int>(blockIdx.x) / a.ncols;
            yv = fmaf(a.mass[static_cast<int64_t>(e) * np + node],
                      load(a.x + at), yv);
          }
          store(a.y + at, yv);
        }
      }
    }
  }
}

// Pass 4: per node of one element the factors and the mass (computed once,
// used by every column), the weighted components in place.  Grid:
// E * ceil(N1^3 / kFactorThreads) blocks, the element's chunks together.
template <GeomSource SRC, typename T>
__global__ void __launch_bounds__(kFactorThreads)
    axhelm_staged_factors_kernel(const StagedArgs<T> a) {
  constexpr int NG = geometry_words<SRC>();
  __shared__ float s_g[32];
  const int n1 = a.n1, nc = n1 * n1, np = nc * n1;
  const int chunks = (np + kFactorThreads - 1) / kFactorThreads;
  const int64_t e = blockIdx.x / chunks;
  const int node = (blockIdx.x % chunks) * kFactorThreads + threadIdx.x;
  if (threadIdx.x < NG) s_g[threadIdx.x] = load(a.geom + e * NG + threadIdx.x);
  __syncthreads();
  if (node >= np) return;
  const int i = node % n1, j = (node / n1) % n1, k = node / nc;
  float mass;
  const Factors f = node_factors<SRC, T>(a.geom, s_g, a.lam0, a.lam1, a.xi,
                                         a.w3, e, np, node, i, j, k,
                                         a.helmholtz, mass);
  if (a.helmholtz) a.mass[e * np + node] = mass;
  for (int c = 0; c < a.ncols; ++c) {
    const int64_t at = (e * a.ncols + c) * np + node;
    const float xr = a.s0[at], xs = a.s1[at], xt = a.s2[at];
    a.s0[at] = f.g00 * xr + f.g01 * xs + f.g02 * xt;
    a.s1[at] = f.g01 * xr + f.g11 * xs + f.g12 * xt;
    a.s2[at] = f.g02 * xr + f.g12 * xs + f.g22 * xt;
  }
}

// One contraction launch.
template <int DIR, int MODE, typename T>
cudaError_t contract(const StagedArgs<T>& a, dim3 grid, size_t smem,
                     cudaStream_t stream) {
  void (*kernel)(const StagedArgs<T>) =
      axhelm_staged_contract_kernel<DIR, MODE, T>;
  // The opt-in to the dynamic size belongs to the current device, so every
  // launch sets it: a host call that enqueues nothing, allowed while a
  // graph captures.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kStagedThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <GeomSource SRC, typename T>
int launch_staged(const T* x, T* y, const T* geom, const T* lam0,
                  const T* lam1, const float* dhat, const float* xi,
                  const float* w3, float* scratch, int n1, int n_elem,
                  int ncols, int helmholtz, void* stream) {
  if (n_elem <= 0 || ncols <= 0 || n1 < 2 || scratch == nullptr ||
      n_elem > INT_MAX / ncols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t np = static_cast<int64_t>(n1) * n1 * n1;
  const int64_t q_tiles =
      (static_cast<int64_t>(n1) * n1 + kTileQ - 1) / kTileQ;
  const int64_t chunks = (np + kFactorThreads - 1) / kFactorThreads;
  const size_t smem = staged_smem_bytes(n1);
  if (np > INT_MAX || q_tiles > 65535 || chunks * n_elem > INT_MAX ||
      smem > kSmemPerBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t words = static_cast<int64_t>(n_elem) * ncols * np;
  float* mass = helmholtz ? scratch + 3 * words : nullptr;
  const StagedArgs<T> a{x,      y,      geom,  lam0,
                        lam1,   dhat,   xi,    w3,
                        scratch, scratch + words, scratch + 2 * words,
                        mass,   n1,     ncols, helmholtz};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_elem * ncols),
                  static_cast<unsigned>(q_tiles));
  cudaError_t err = contract<kDirR, kGrad>(a, grid, smem, s);
  if (err == cudaSuccess) err = contract<kDirS, kGrad>(a, grid, smem, s);
  if (err == cudaSuccess) err = contract<kDirT, kGrad>(a, grid, smem, s);
  if (err == cudaSuccess) {
    axhelm_staged_factors_kernel<SRC, T>
        <<<static_cast<unsigned>(chunks * n_elem), kFactorThreads, 0, s>>>(a);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) err = contract<kDirR, kFirst>(a, grid, smem, s);
  if (err == cudaSuccess) err = contract<kDirS, kAccumulate>(a, grid, smem, s);
  if (err == cudaSuccess) err = contract<kDirT, kLast>(a, grid, smem, s);
  return static_cast<int>(err);
}

}  // namespace

// The entry points axhelm_<variant>_<SUFFIX>_staged for storage type T: the
// generic body's arguments (axhelm.cu) plus the fp32 scratch of (3 ncols +
// helmholtz) n_elem N1^3 words (ops.staged_launch).  merged is Helmholtz always (lam2 =
// Lam2 and lam3 = Lam3 must be given), partial Poisson always (gscale must
// be given).
#define AXHELM_STAGED_ENTRY_POINT(VARIANT, SRC, T, SUFFIX)                   \
  extern "C" int axhelm_##VARIANT##_##SUFFIX##_staged(                        \
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
    return launch_staged<SRC, T>(x, y, geom, lam0, lam1, dhat, xi, w3,        \
                                 scratch, n1, n_elem, ncols, helmholtz,       \
                                 stream);                                     \
  }

#define AXHELM_STAGED_ENTRY_POINTS(T, SUFFIX)                                 \
  AXHELM_STAGED_ENTRY_POINT(precomputed, kPrecomputed, T, SUFFIX)             \
  AXHELM_STAGED_ENTRY_POINT(trilinear, kTrilinear, T, SUFFIX)                 \
  AXHELM_STAGED_ENTRY_POINT(parallelepiped, kParallelepiped, T, SUFFIX)       \
  AXHELM_STAGED_ENTRY_POINT(merged, kMerged, T, SUFFIX)                       \
  AXHELM_STAGED_ENTRY_POINT(partial, kPartial, T, SUFFIX)

AXHELM_STAGED_ENTRY_POINTS(float, f32)
AXHELM_STAGED_ENTRY_POINTS(__nv_bfloat16, bf16)
