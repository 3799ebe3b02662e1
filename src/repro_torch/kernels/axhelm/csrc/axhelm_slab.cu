// axhelm_slab.cu -- the axhelm element operator at the orders between the
// tuned bodies and the plane body: every variant at N1 from
// ops.N1_TUNED_MAX + 1 (17) to ops.N1_SLAB_MAX (24), an application run as
// two launches -- a pass of one block per (element, slab of t-planes), then
// the transposed t contraction -- on register-tiled fp32 products (sm_90a),
// with a plain C interface (bound from Python with ctypes).
//
// Replaces the TPU kernel repro/kernels/axhelm/kernel.py::_kernel, the body
// of the one pl.pallas_call (kernel.py:233), with _grad :46, _grad_transpose
// :72 and _apply_factors :88, in all five of its variants (K1 precomputed
// :122-125, K2 trilinear :126-131, K3 parallelepiped :132-136, K4 merged
// :137-153, K5 partial :154-157) and both storage types, at the orders where
// the generic body of axhelm.cu (one block an element) ran them: _kernel
// takes any N1 from the shape of x (kernel.py:159).  The generic body reads
// both operands of every FFMA from shared memory, and its block holds a whole
// element's x and three gradient components (129,728 bytes at N1 = 20), so
// one 512-thread block fits an SM and 216 elements leave a 64% second wave.
//
// Per element e and column c (c runs over the nrhs*d columns, which all
// share the element's factors):
//   y = D^T [lam0 * G (D x)]  (+ mass * x for Helmholtz, mass = lam1 * gwj)
//
// Design.  One application is two launches on the given stream, over fp32
// scratch S_t and Ypart of E ncols N1^3 words each (allocated by the
// caller):
//   1. per (element, slab of kSlabPlanes consecutive t-planes k0 ...),
//      looping over the columns: the element's whole x copied into shared
//      memory in whole 16-byte units (stage_x: cp.async in fp32, widened
//      loads in bf16, any offset), D-hat in rows of N1 | 1 words (an odd
//      pitch, as the plane body's); on the slab's planes, x_r = X D^T and
//      x_s = D X in each plane and x_t = D_t x across the planes, from the
//      copy of x (a block holds all of x at these N1, so the plane body's
//      first launch and its round trip through scratch are not needed);
//      per node column (j, i) of the slab, its planes' nodes together: the
//      factors (node_factors; for K2, K4, K5 from Alg. 3's terms of the
//      column, computed once -- column_factors; the Helmholtz mass in the
//      same pass; held in shared memory for every column when there are
//      several) with the operands they read from device memory loaded
//      before any is used; s_r, s_s and s_t weighted in shared memory, s_t
//      then written to S_t; Ypart = D_r^T s_r + D_s^T s_s (+ mass x)
//                                                          (slab kernel)
//   2. y = Ypart + D_t^T S_t, rounded once to the storage type, a thread a
//      line (j, i) of a batch row holding its N1 sums        (last kernel)
// Every product of launch 1 is a register tile of kReg x kReg outputs a
// thread, summed from shared memory, each load feeding kReg FFMAs (0.5
// loads an FFMA against the generic body's 2): x_r, x_s and Ypart on the
// (j, i) tiles of one plane, thread (p, tj, ti) owning the nodes (j, i) =
// (tj + u L, ti + v L), L = ceil(N1 / kReg), of slab plane p; x_t on (k, i)
// tiles, thread (tj, ti) owning the slab's kSlabPlanes planes at row j = tj
// and the columns ti + v L.  Ragged tiles and the last slab (N1 = 17 to 24
// fits no power-of-two tile) read clamped rows and store only the outputs
// that exist.  Each sum runs m upward; nothing is atomic.  N1 is a runtime
// argument up to kSlabN1Max.
//
// Launch shape (ops.slab_launch).  Shared memory (slab_smem_bytes,
// ops.slab_smem_bytes): D-hat, the copy of x and three slab arrays, 53,872
// bytes at N1 = 20 and 86,528 at 24, and kFactorWords words a slab node
// more when the factors are held.  A block has kSlabPlanes L^2 threads in
// whole warps (128 at N1 <= 20, 160 above) at up to 168 registers
// (kSlabMinBlocks: two blocks of five warps an SM; 136 spilled), so an SM
// holds three blocks at N1 <= 20 and two above; E = 216 elements give 216
// ceil(N1 / 4) blocks, 1,080 at N1 = 20.  Launch 2: kLastThreads threads a
// block, 106-110 registers.
//
// What bounds it: 12 N1^4 FLOPs an element and column (the operation bound
// of chip_smoke.py::axhelm_bound; 10 N1^4 in launch 1, 2 N1^4 in launch 2),
// which launch 1 runs fed from shared memory at two FMAs a load; and the
// scratch traffic, 4 words a node and column through L2 (S_t and Ypart
// written, then read).  Each block copies the whole element's x for its
// slab alone, ceil(N1 / 4) copies of x an element through L2.  Where its
// time goes (scripts/slab_phase_probe.py, PERF.md): at N1 = 20 about a
// fifth each to x_r, x_s and x_t, to the factors, to Ypart, to launch 2
// and to the rest of launch 1 (its launch, the copies, the barriers, the
// stores).
//
// Storage, layouts and the lambda slots are those of axhelm.cu's generic
// body (see its note): x, y (E, ncols, N1^3), geom per variant, lam0/lam1
// (E, N1^3) or null, dhat (N1, N1), xi (N1), w3 (N1^3), fp32 arithmetic,
// the scratch fp32, one rounding of y to the storage type.  Offsets are
// int64; x may start at any offset the other bodies take (the copy reads
// the 16-byte units that hold its first and last values whole, the values
// beside them landing in the copy's margins).  Every entry point launches
// on the given stream, allocates nothing, and returns the first launch
// error or cudaGetLastError() (0 on success).

#include <climits>
#include <cstdint>

#include "axhelm_common.cuh"

namespace {

using namespace axhelm_detail;

constexpr int kReg = 4;          // outputs a thread, each axis of a tile
constexpr int kSlabPlanes = 4;   // t-planes a block: x_t's tile spans them
constexpr int kSlabN1Max = 24;   // the largest N1 a launch
// a block's threads at kSlabN1Max (kSlabPlanes 6^2 tiles in whole warps),
// and the blocks an SM its registers are bounded for: at most 168 a thread,
// so that two blocks' ten warps fit an SM's four register files
constexpr int kSlabThreadsMax =
    (kSlabPlanes * ((kSlabN1Max + kReg - 1) / kReg) *
         ((kSlabN1Max + kReg - 1) / kReg) + 31) / 32 * 32;
constexpr int kSlabMinBlocks = 2;
constexpr int kFactorWords = 7;  // g00 .. g22, mass
constexpr int kLastThreads = 128;  // launch 2's threads a block
constexpr int kSmemPerBlock = 232448;

// Threads along each axis of a tile: N1 rounded up to kReg, over kReg.
__host__ __device__ constexpr int lanes_of(int n1) {
  return (n1 + kReg - 1) / kReg;
}
// The row pitch: odd, so that rows meet in no bank.
__host__ __device__ constexpr int pitch_of(int n1) { return n1 | 1; }
// Slabs of kSlabPlanes t-planes an element (the last may be ragged).
__host__ __device__ constexpr int slabs_of(int n1) {
  return (n1 + kSlabPlanes - 1) / kSlabPlanes;
}
// Words of D-hat's rows in shared memory, rounded up to 16 bytes.
__host__ __device__ constexpr int dhat_words(int n1) {
  return (n1 * pitch_of(n1) + 3) / 4 * 4;
}
// Words of the copy of x: N1^3 values behind a shift of up to 7 words, in
// whole 16-byte units (stage_x).
__host__ __device__ constexpr int x_words(int n1) {
  return (n1 * n1 * n1 + 7 + 7) / 8 * 8;
}

int slab_threads(int n1) {
  const int l = lanes_of(n1);
  return (kSlabPlanes * l * l + 31) / 32 * 32;
}

// Dynamic shared memory of a slab block (ops.slab_smem_bytes): D-hat in rows
// of pitch_of(N1) (dhat_words), the copy of the element's x (x_words), the
// slab's s_r, s_s and s_t in rows of pitch_of(N1), and, when the block holds
// the factors for several columns, kFactorWords words a slab node.
size_t slab_smem_bytes(int n1, bool hold) {
  const size_t n = static_cast<size_t>(n1);
  return sizeof(float) *
         (dhat_words(n1) + x_words(n1) + 3 * kSlabPlanes * n * pitch_of(n1) +
          (hold ? kFactorWords * kSlabPlanes * n * n : 0));
}

// The operands of one application, by value.
template <typename T>
struct SlabArgs {
  const T* x;
  const T* geom;
  const T* lam0;
  const T* lam1;
  const float* dhat;
  const float* xi;
  const float* w3;
  float* t;      // s_t
  float* ypart;  // D_r^T s_r + D_s^T s_s (+ mass x)
  int n1, ncols, helmholtz;
};

// N1 x N1 values of D-hat into s_d, rows of pitch ld.
__device__ __forceinline__ void stage_dhat(float* s_d, const float* dhat,
                                           int n1, int ld) {
  for (int q = threadIdx.x; q < n1 * n1; q += blockDim.x) {
    stage_value(s_d + (q / n1) * ld + q % n1, dhat + q);
  }
}

// A column of an element's x, `count` values from src, into shared memory
// at s_xa + shift, shift being src's offset in its 16-byte unit of device
// memory, so that every copy moves one whole unit (16-byte aligned at both
// ends): from the unit that holds src[0] to the one that holds src[count -
// 1], the values around the column in those units landing in s_xa's
// margins.  fp32: a cp.async a unit; bf16: a 16-byte load of eight values
// widened into two float4 stores.  Returns the shift.
__device__ __forceinline__ int stage_x(float* s_xa, const float* src,
                                       int count) {
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(src) % 16) /
                    static_cast<int>(sizeof(float));
  const float* base = src - shift;
  const int units = (shift + count + 3) / 4;
#pragma unroll 4
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const unsigned at =
        static_cast<unsigned>(__cvta_generic_to_shared(s_xa + 4 * u));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(at),
                 "l"(base + 4 * u)
                 : "memory");
  }
  return shift;
}
__device__ __forceinline__ int stage_x(float* s_xa, const __nv_bfloat16* src,
                                       int count) {
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(src) % 16) /
                    static_cast<int>(sizeof(__nv_bfloat16));
  const __nv_bfloat16* base = src - shift;
  const int units = (shift + count + 7) / 8;
#pragma unroll 4
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const uint4 raw = *reinterpret_cast<const uint4*>(base + 8 * u);
    const float2 v0 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 v1 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    const float2 v2 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.z));
    const float2 v3 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.w));
    float4* dst = reinterpret_cast<float4*>(s_xa + 8 * u);
    dst[0] = make_float4(v0.x, v0.y, v1.x, v1.y);
    dst[1] = make_float4(v2.x, v2.y, v3.x, v3.y);
  }
  return shift;
}

// node_factors (axhelm_common.cuh) for the sources that recompute Alg. 3
// (K2, K4, K5), from the terms of the node's column (ct = column_terms of
// the element's edge differences at (xi_i, xi_j)) and the node's operands
// in device memory, loaded beforehand: w3 (K2), the lam0 slot (l0, 1 when
// there is none) and lam1 (l1: Lam3 for K4, else 1 when there is none).
// Per node the affine update at xi_k, K~, adj(K~) and, for K2, det(J~);
// multiplying by a missing lambda's 1 is exact, so the factors differ from
// node_factors' only in the order of Alg. 3's sums.
template <GeomSource SRC>
__device__ __forceinline__ Factors column_factors(const ColumnTerms& ct,
                                                  float xi_k, float w,
                                                  float l0, float l1,
                                                  int helmholtz, float& mass) {
  float c0[3], c1[3];
  jacobian_at(ct, xi_k, c0, c1);
  const float* c2 = ct.c2;
  const float k00 = c0[0] * c0[0] + c0[1] * c0[1] + c0[2] * c0[2];
  const float k01 = c0[0] * c1[0] + c0[1] * c1[1] + c0[2] * c1[2];
  const float k02 = c0[0] * c2[0] + c0[1] * c2[1] + c0[2] * c2[2];
  const float k11 = c1[0] * c1[0] + c1[1] * c1[1] + c1[2] * c1[2];
  const float k12 = c1[0] * c2[0] + c1[1] * c2[1] + c1[2] * c2[2];
  Factors f;
  f.g00 = k11 * ct.k22 - k12 * k12;
  f.g01 = k02 * k12 - k01 * ct.k22;
  f.g02 = k01 * k12 - k02 * k11;
  f.g11 = k00 * ct.k22 - k02 * k02;
  f.g12 = k01 * k02 - k00 * k12;
  f.g22 = k00 * k11 - k01 * k01;
  f.gwj = 0.f;
  if constexpr (SRC == kTrilinear) {
    const float det = det_j(c0, c1, c2);
    scale_factors(f, 0.125f * w / det);
    f.gwj = w * 0.001953125f * det;  // (1/8)^3
  }
  scale_factors(f, l0);
  mass = 0.f;
  if (helmholtz) mass = SRC == kMerged ? l1 : l1 * f.gwj;
  return f;
}

// The factors held in shared memory for every column: word w of slab node
// q at w step + q.
__device__ __forceinline__ Factors held_factors(const float* s_f, int step,
                                                int q, float& mass) {
  Factors f;
  f.g00 = s_f[0 * step + q];
  f.g01 = s_f[1 * step + q];
  f.g02 = s_f[2 * step + q];
  f.g11 = s_f[3 * step + q];
  f.g12 = s_f[4 * step + q];
  f.g22 = s_f[5 * step + q];
  mass = s_f[6 * step + q];
  return f;
}

// Step B at one node: the weighted components in place at `at` of s_r, s_s
// and s_t.
__device__ __forceinline__ void weigh(const Factors& f, int at, float* s_r,
                                      float* s_s, float* s_t) {
  const float rr = s_r[at], ss = s_s[at], tt = s_t[at];
  s_r[at] = f.g00 * rr + f.g01 * ss + f.g02 * tt;
  s_s[at] = f.g01 * rr + f.g11 * ss + f.g12 * tt;
  s_t[at] = f.g02 * rr + f.g12 * ss + f.g22 * tt;
}

// Launch 1: one block per (element, slab).  Grid: E slabs_of(N1) blocks;
// threads kSlabPlanes L^2 in whole warps.  Per column, the element's x
// staged, then three steps between barriers:
//   A. x_r and x_s on the (j, i) tiles of each slab plane, into s_r and
//      s_s; x_t on the (k, i) tiles of each row j, into s_t;
//   B. per node column (j, i) of the slab (r = thread, thread + blockDim,
//      ...), its planes' nodes together, so that their loads are in flight
//      at once: the factors, the weighted components in place in s_r, s_s
//      and s_t, and mass x over the slab's planes of x (Helmholtz);
//   C. s_t to S_t, a coalesced pass; Ypart on the (j, i) tiles, from the
//      mass term.
// Each step derives its tile's rows itself, so that none is live across
// step B, whose factors then never share registers with a tile.
template <GeomSource SRC, typename T>
__global__ void __launch_bounds__(kSlabThreadsMax, kSlabMinBlocks)
    axhelm_slab_kernel(const SlabArgs<T> a) {
  constexpr int NG = geometry_words<SRC>();
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_g[32];
  __shared__ float s_e[uses_vertices(SRC) ? 36 : 1];  // Alg. 3's edges
  const int n1 = a.n1, nc = n1 * n1, np = nc * n1;
  const int lanes = lanes_of(n1), ld = pitch_of(n1), words = n1 * ld;
  const int slabs = slabs_of(n1);
  const int64_t e = blockIdx.x / slabs;
  const int k0 = (blockIdx.x % slabs) * kSlabPlanes;
  const int planes = min(kSlabPlanes, n1 - k0);   // the slab's planes
  const bool hold = a.ncols > 1;
  float* s_d = smem;                        // D-hat(r, c) at r ld + c
  float* s_xa = s_d + dhat_words(n1);       // x(k, j, i) at shift + k nc +
                                            // j n1 + i
  float* s_r = s_xa + x_words(n1);          // slab plane p at p words
  float* s_s = s_r + kSlabPlanes * words;   // row j at j ld
  float* s_t = s_s + kSlabPlanes * words;
  float* s_f = s_t + kSlabPlanes * words;   // held: word w of q at w P nc + q
  const int64_t slab0 = static_cast<int64_t>(k0) * nc;
  // the thread's tile of steps A (x_r, x_s) and C: plane tp, (tj, ti)
  const int tp = threadIdx.x / (lanes * lanes);
  const int tj = threadIdx.x % (lanes * lanes) / lanes;
  const int ti = threadIdx.x % lanes;
  const int tjt = threadIdx.x / lanes;       // x_t: row j = tjt, columns ti
  const bool pv = tp < planes;

  // the first column's x, in flight while D-hat and the factors come
  int shift = stage_x(s_xa, a.x + e * a.ncols * np, np);
  stage_dhat(s_d, a.dhat, n1, ld);
  if (threadIdx.x < NG) s_g[threadIdx.x] = load(a.geom + e * NG + threadIdx.x);
  if constexpr (uses_vertices(SRC)) {
    // the element's 12 edge differences, for the column terms of step B
    if (threadIdx.x < 36) {
      int lo, hi;
      edge_vertices(threadIdx.x / 3, lo, hi);
      const T* v = a.geom + e * 24 + threadIdx.x % 3;
      s_e[threadIdx.x] = load(v + 3 * hi) - load(v + 3 * lo);
    }
  }
  cp_async_wait();
  __syncthreads();
  if (hold) {
    const int step = kSlabPlanes * nc;
    for (int r = threadIdx.x; r < nc; r += blockDim.x) {
      const int j = r / n1, i = r - j * n1;
#pragma unroll
      for (int p = 0; p < kSlabPlanes; ++p) {
        if (p < planes) {
          const int q = p * nc + r;
          float mass;
          const Factors f = node_factors<SRC, T>(
              a.geom, s_g, a.lam0, a.lam1, a.xi, a.w3, e, np,
              static_cast<int>(slab0) + q, i, j, k0 + p, a.helmholtz, mass);
          s_f[0 * step + q] = f.g00;
          s_f[1 * step + q] = f.g01;
          s_f[2 * step + q] = f.g02;
          s_f[3 * step + q] = f.g11;
          s_f[4 * step + q] = f.g12;
          s_f[5 * step + q] = f.g22;
          s_f[6 * step + q] = mass;
        }
      }
    }
  }

  for (int c = 0; c < a.ncols; ++c) {
    const int64_t off = (e * a.ncols + c) * np;
    if (c > 0) {
      // the last column's step C is done with x and the slab arrays
      __syncthreads();
      shift = stage_x(s_xa, a.x + off, np);
    }
    cp_async_wait();
    // x is staged (and, first, D-hat and the held factors)
    __syncthreads();
    float* s_x = s_xa + shift;

    if (pv) {  // A. x_r(j, i) = sum_m X(j, m) D(i, m), x_s = sum D(j, m) X(m, i)
      const float* x_p = s_x + (k0 + tp) * nc;
      int jr[kReg], ir[kReg];
#pragma unroll
      for (int u = 0; u < kReg; ++u) {
        jr[u] = min(tj + u * lanes, n1 - 1);
        ir[u] = min(ti + u * lanes, n1 - 1);
      }
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
          xj[u] = x_p[jr[u] * n1 + m];
          dj[u] = s_d[jr[u] * ld + m];
          di[u] = s_d[ir[u] * ld + m];
          xm[u] = x_p[m * n1 + ir[u]];
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
      float* r_p = s_r + tp * words;
      float* s_p = s_s + tp * words;
#pragma unroll
      for (int u = 0; u < kReg; ++u) {
#pragma unroll
        for (int v = 0; v < kReg; ++v) {
          if (tj + u * lanes < n1 && ti + v * lanes < n1) {
            r_p[jr[u] * ld + ir[v]] = xr[u][v];
            s_p[jr[u] * ld + ir[v]] = xs[u][v];
          }
        }
      }
    }
    if (tjt < n1) {  // A. x_t(k0 + u, j, i) = sum_m D(k0 + u, m) x(m, j, i)
      const float* x_j = s_x + tjt * n1;
      int kr[kReg], ir[kReg];
#pragma unroll
      for (int u = 0; u < kReg; ++u) {
        kr[u] = min(k0 + u, n1 - 1);
        ir[u] = min(ti + u * lanes, n1 - 1);
      }
      float xt[kReg][kReg];
#pragma unroll
      for (int u = 0; u < kReg; ++u) {
#pragma unroll
        for (int v = 0; v < kReg; ++v) xt[u][v] = 0.f;
      }
#pragma unroll 2
      for (int m = 0; m < n1; ++m) {
        float dk[kReg], xm[kReg];
#pragma unroll
        for (int u = 0; u < kReg; ++u) {
          dk[u] = s_d[kr[u] * ld + m];
          xm[u] = x_j[m * nc + ir[u]];
        }
#pragma unroll
        for (int u = 0; u < kReg; ++u) {
#pragma unroll
          for (int v = 0; v < kReg; ++v) {
            xt[u][v] = fmaf(dk[u], xm[v], xt[u][v]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kReg; ++u) {
#pragma unroll
        for (int v = 0; v < kReg; ++v) {
          if (u < planes && ti + v * lanes < n1) {
            s_t[u * words + tjt * ld + ir[v]] = xt[u][v];
          }
        }
      }
    }
    __syncthreads();

    // B. per node column (j, i) of the slab: the factors of its planes'
    //    nodes, the weighted components and mass x
    float* s_xs = s_x + slab0;   // the slab's planes of x
    for (int r = threadIdx.x; r < nc; r += blockDim.x) {
      const int j = r / n1, i = r - j * n1;
      if constexpr (uses_vertices(SRC)) {
        // the column's terms and its nodes' operands in device memory (K2:
        // w3; K4: Lam2, Lam3; K5: gScale), loaded together; then node by
        // node (K2's optional lambdas loaded where they are used)
        ColumnTerms ct;
        float w[kSlabPlanes], l0[kSlabPlanes], l1[kSlabPlanes];
        if (!hold) {
          ct = column_terms(s_e, a.xi[i], a.xi[j]);
#pragma unroll
          for (int p = 0; p < kSlabPlanes; ++p) {
            const int node = static_cast<int>(slab0) +
                             min(p, planes - 1) * nc + r;
            if constexpr (SRC == kTrilinear) {
              w[p] = a.w3[node];
            } else {  // the lam0 slot is always given; merged's lam1 too
              l0[p] = load(a.lam0 + e * np + node);
              l1[p] = SRC == kMerged ? load(a.lam1 + e * np + node) : 1.f;
            }
          }
        }
#pragma unroll
        for (int p = 0; p < kSlabPlanes; ++p) {
          if (p < planes) {
            const int q = p * nc + r;
            Factors f;
            float mass;
            if (hold) {
              f = held_factors(s_f, kSlabPlanes * nc, q, mass);
            } else if constexpr (SRC == kTrilinear) {
              const int64_t nidx = e * np + static_cast<int>(slab0) + q;
              f = column_factors<SRC>(
                  ct, a.xi[k0 + p], w[p],
                  a.lam0 != nullptr ? load(a.lam0 + nidx) : 1.f,
                  a.helmholtz && a.lam1 != nullptr ? load(a.lam1 + nidx) : 1.f,
                  a.helmholtz, mass);
            } else {
              f = column_factors<SRC>(ct, a.xi[k0 + p], 0.f, l0[p], l1[p],
                                      a.helmholtz, mass);
            }
            weigh(f, p * words + j * ld + i, s_r, s_s, s_t);
            if (a.helmholtz) s_xs[q] *= mass;
          }
        }
      } else {
        // the factors of the column's nodes first (their loads in flight
        // together; a ragged slab's missing planes repeat its last one),
        // then the nodes that exist
        Factors f[kSlabPlanes];
        float mass[kSlabPlanes];
#pragma unroll
        for (int p = 0; p < kSlabPlanes; ++p) {
          const int q = min(p, planes - 1) * nc + r;
          if (hold) {
            f[p] = held_factors(s_f, kSlabPlanes * nc, q, mass[p]);
          } else {
            f[p] = node_factors<SRC, T>(
                a.geom, s_g, a.lam0, a.lam1, a.xi, a.w3, e, np,
                static_cast<int>(slab0) + q, i, j, k0 + min(p, planes - 1),
                a.helmholtz, mass[p]);
          }
        }
#pragma unroll
        for (int p = 0; p < kSlabPlanes; ++p) {
          if (p < planes) {
            weigh(f[p], p * words + j * ld + i, s_r, s_s, s_t);
            if (a.helmholtz) s_xs[p * nc + r] *= mass[p];
          }
        }
      }
    }
    __syncthreads();

    // C. s_t to S_t; Ypart(j, i) = mass x + sum_m s_r(j, m) D(m, i)
    //    + D(m, j) s_s(m, i)
    const int64_t out = off + slab0;
    for (int r = threadIdx.x; r < nc; r += blockDim.x) {
      const int j = r / n1, i = r - j * n1;
#pragma unroll
      for (int p = 0; p < kSlabPlanes; ++p) {
        if (p < planes) a.t[out + p * nc + r] = s_t[p * words + j * ld + i];
      }
    }
    if (pv) {
      const float* x_p = s_x + (k0 + tp) * nc;
      const float* r_p = s_r + tp * words;
      const float* s_p = s_s + tp * words;
      int jr[kReg], ir[kReg];
#pragma unroll
      for (int u = 0; u < kReg; ++u) {
        jr[u] = min(tj + u * lanes, n1 - 1);
        ir[u] = min(ti + u * lanes, n1 - 1);
      }
      float yp[kReg][kReg];
#pragma unroll
      for (int u = 0; u < kReg; ++u) {
#pragma unroll
        for (int v = 0; v < kReg; ++v) {
          yp[u][v] = a.helmholtz ? x_p[jr[u] * n1 + ir[v]] : 0.f;
        }
      }
#pragma unroll 2
      for (int m = 0; m < n1; ++m) {
        float rj[kReg], dmi[kReg], dmj[kReg], si[kReg];
#pragma unroll
        for (int u = 0; u < kReg; ++u) {
          rj[u] = r_p[jr[u] * ld + m];
          dmj[u] = s_d[m * ld + jr[u]];
          dmi[u] = s_d[m * ld + ir[u]];
          si[u] = s_p[m * ld + ir[u]];
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
      float* y_p = a.ypart + out + static_cast<int64_t>(tp) * nc;
#pragma unroll
      for (int u = 0; u < kReg; ++u) {
#pragma unroll
        for (int v = 0; v < kReg; ++v) {
          if (tj + u * lanes < n1 && ti + v * lanes < n1) {
            y_p[jr[u] * n1 + ir[v]] = yp[u][v];
          }
        }
      }
    }
  }
}

// Launch 2: y(k, q) = Ypart(k, q) + sum_m D(m, k) S_t(m, q) over the N1^2
// lines q = (j, i) of every batch row, rounded once to T.  Grid: E ncols
// N1^2 / kLastThreads blocks, one thread a line holding its N1 sums
// (kSlabN1Max registers, those past N1 idle): the line's N1 values of S_t
// and of Ypart loaded together (a warp's lines are consecutive words),
// D-hat's row m (the same for the whole block) from shared memory four
// values a load.  Each sum runs m upward from 0, then adds Ypart, as the
// plane body's last launch does.  It computes what that launch
// (axhelm_plane_line_kernel<true> of axhelm_plane.cu, a warp kReg rows of
// a tile of lines) computes, and is a kernel of its own by choice: a
// thread a line measured faster at these N1 (PERF.md, the slab body).
template <typename T>
__global__ void __launch_bounds__(kLastThreads)
    axhelm_slab_last_kernel(T* __restrict__ y, const float* __restrict__ dhat,
                            const float* __restrict__ st,
                            const float* __restrict__ ypart, int n1,
                            int64_t lines) {
  __shared__ __align__(16) float s_d[kSlabN1Max * kSlabN1Max];
  for (int q = threadIdx.x; q < kSlabN1Max * kSlabN1Max; q += blockDim.x) {
    const int m = q / kSlabN1Max, k = q % kSlabN1Max;  // D(m, k), 0 past N1
    s_d[q] = (m < n1 && k < n1) ? dhat[m * n1 + k] : 0.f;
  }
  __syncthreads();
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (g >= lines) return;
  const int nc = n1 * n1;
  const int64_t at = g / nc * nc * n1 + g % nc;  // (b, 0, q)
  float sv[kSlabN1Max], yv[kSlabN1Max], acc[kSlabN1Max];
#pragma unroll
  for (int m = 0; m < kSlabN1Max; ++m) {
    sv[m] = m < n1 ? st[at + m * nc] : 0.f;
    yv[m] = m < n1 ? ypart[at + m * nc] : 0.f;
    acc[m] = 0.f;
  }
#pragma unroll
  for (int m = 0; m < kSlabN1Max; ++m) {
    if (m < n1) {
#pragma unroll
      for (int k = 0; k < kSlabN1Max; k += 4) {
        const float4 d =
            *reinterpret_cast<const float4*>(s_d + m * kSlabN1Max + k);
        acc[k] = fmaf(d.x, sv[m], acc[k]);
        acc[k + 1] = fmaf(d.y, sv[m], acc[k + 1]);
        acc[k + 2] = fmaf(d.z, sv[m], acc[k + 2]);
        acc[k + 3] = fmaf(d.w, sv[m], acc[k + 3]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kSlabN1Max; ++k) {
    if (k < n1) store(y + at + k * nc, yv[k] + acc[k]);
  }
}

template <GeomSource SRC, typename T>
int launch_slab(const T* x, T* y, const T* geom, const T* lam0,
                const T* lam1, const float* dhat, const float* xi,
                const float* w3, float* scratch, int n1, int n_elem,
                int ncols, int helmholtz, void* stream) {
  if (n_elem <= 0 || ncols <= 0 || n1 < 2 || n1 > kSlabN1Max ||
      scratch == nullptr || n_elem > INT_MAX / ncols ||
      n_elem > INT_MAX / slabs_of(n1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = slab_smem_bytes(n1, ncols > 1);
  if (smem > kSmemPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t words =
      static_cast<int64_t>(n_elem) * ncols * n1 * n1 * n1;
  const SlabArgs<T> a{x,  geom,    lam0,           lam1,  dhat, xi,
                      w3, scratch, scratch + words, n1,    ncols,
                      helmholtz};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  void (*slab)(const SlabArgs<T>) = axhelm_slab_kernel<SRC, T>;
  // The opt-in to the dynamic size belongs to the current device, so every
  // launch sets it: a host call that enqueues nothing, allowed while a
  // graph captures.
  cudaError_t err = cudaFuncSetAttribute(
      slab, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) {
    slab<<<static_cast<unsigned>(n_elem * slabs_of(n1)), slab_threads(n1),
           smem, s>>>(a);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    const int64_t lines = static_cast<int64_t>(n_elem) * ncols * n1 * n1;
    axhelm_slab_last_kernel<T>
        <<<static_cast<unsigned>((lines + kLastThreads - 1) / kLastThreads),
           kLastThreads, 0, s>>>(y, dhat, scratch, scratch + words, n1,
                                 lines);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// The entry points axhelm_<variant>_<SUFFIX>_slab for storage type T: the
// generic body's arguments (axhelm.cu) plus the fp32 scratch of 2 ncols
// n_elem N1^3 words (ops.slab_launch).  merged is Helmholtz always (lam2 =
// Lam2 and lam3 = Lam3 must be given), partial Poisson always (gscale must
// be given).
#define AXHELM_SLAB_ENTRY_POINT(VARIANT, SRC, T, SUFFIX)                     \
  extern "C" int axhelm_##VARIANT##_##SUFFIX##_slab(                          \
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
    return launch_slab<SRC, T>(x, y, geom, lam0, lam1, dhat, xi, w3,          \
                               scratch, n1, n_elem, ncols, helmholtz,         \
                               stream);                                       \
  }

#define AXHELM_SLAB_ENTRY_POINTS(T, SUFFIX)                                   \
  AXHELM_SLAB_ENTRY_POINT(precomputed, kPrecomputed, T, SUFFIX)               \
  AXHELM_SLAB_ENTRY_POINT(trilinear, kTrilinear, T, SUFFIX)                   \
  AXHELM_SLAB_ENTRY_POINT(parallelepiped, kParallelepiped, T, SUFFIX)         \
  AXHELM_SLAB_ENTRY_POINT(merged, kMerged, T, SUFFIX)                         \
  AXHELM_SLAB_ENTRY_POINT(partial, kPartial, T, SUFFIX)

AXHELM_SLAB_ENTRY_POINTS(float, f32)
AXHELM_SLAB_ENTRY_POINTS(__nv_bfloat16, bf16)
