// axhelm_line.cu -- the one-thread-per-line body of the axhelm kernels K1, K3
// and K4 for Hopper (sm_90a), with a plain C interface (bound from Python
// with ctypes: kernels/axhelm/build.py, ops.py).
//
// Replaces the TPU kernel repro/kernels/axhelm/kernel.py::_kernel (the body of
// the one pl.pallas_call, kernel.py:233) in three of its variants, for both
// storage types (entry points *_f32 and *_bf16), at N1 = 4 and 8 (the
// generic body of axhelm.cu runs every other N1):
//   axhelm_precomputed_f32     K1, "precomputed" (kernel.py:122-125, paper
//                              Alg. 2): the six factor planes G (and gwj for
//                              Helmholtz) read from memory per node;
//   axhelm_parallelepiped_f32  K3, "parallelepiped" (kernel.py:132-136, paper
//                              Alg. 4): G = gelem[:6] w3, gwj = gelem[6] w3
//                              from 7 words an element;
//   axhelm_merged_f32          K4, "merged" (kernel.py:137-153, §4.1.1,
//                              Helmholtz only): G = adj(K~) Lam2, mass = Lam3,
//                              with Lam2 and Lam3 read per node.
// K~ = J~^T J~, J~ the unscaled trilinear Jacobian.  Per element e and column
// c (c runs over the nrhs*d columns):
//   y = D^T [lam0 G (D x)]  (+ mass x for Helmholtz)
// For these three variants it also replaces the one-thread-per-node body of
// axhelm.cu, which stays built as their timing-only *_rowwise entry points.
//
// What bounds it on the H100 (chip_smoke.py::axhelm_bound; E = 4096, N1 = 8,
// one column, fp32): K1 moves x and y and its 6 factor planes (7 for
// Helmholtz), 8 N1^3 words an element for Poisson: bound by bytes, 20.0 us
// (bf16 10.0 us).  K3 moves x and y and 7 words an element: bound by bytes,
// 5.04 us.  K4 adds Lam2, Lam3 and 24 vertex words an element and ~66 FLOPs
// a node of geometry: bound by bytes, 10.1 us.  With bf16 storage both are
// operation-bound (3.47 and 5.88 us).  What held the one-thread-per-node body
// to 36-48 us, and the column body near its shared-memory floor of ~10.7 us,
// is shared memory: every value a contraction reads passes through it N1
// times.  Here each passes once per direction; what remains is instruction
// issue (48 FFMA a node, and the loads, stores and factors) and the DRAM
// bytes, floors of about the same size.
//
// Design:
//   * Three roles for the N1^2 threads of an element.  Thread t = i + N1 j
//     owns the node column (i, j, 0..N1-1): it contracts along t in
//     registers, applies the factors and stores y.  The same thread owns the
//     r line (0..N1-1, j' = t / N1, k' = t % N1) and the s line (i' = t % N1,
//     0..N1-1, k'' = a permutation of t / N1): it loads the line's N1 values
//     from shared memory once, contracts them in registers with D-hat and
//     writes the N1 results.  The owner sums the three directions.
//   * D-hat and xi by value, as one __grid_constant__ kernel parameter
//     (LineConsts, N1^2 + N1 floats), filled on the host
//     (ops._column_consts) with the values the plain version computes with:
//     at bf16 storage the bf16-rounded ones.  After unrolling every D-hat
//     index is a compile-time constant, so D-hat enters each FFMA from the
//     constant bank.  K3's w3 comes from the device, rounded the same way
//     (the bf16-rounded products, not w_i w_j w_k recomputed in fp32); each
//     thread reads its column's N1 values into registers once, coalesced.
//     Read from the parameter instead, with an index that differs across a
//     warp, they serialised on the constant cache: K3 took 14.95 us at E =
//     4096 that way, 11.12 us this way (PERF.md).
//   * Per element column and stage, four barriers: at the top, once the
//     stage's x is in shared memory, and after each of (A) the lines compute
//     D_r x and D_s x into s_r and s_s, the owner D_t x in registers; (B) the
//     owner reads its r and s components, applies the factors, writes the
//     weighted r and s components back in place and accumulates D_t^T of the
//     weighted t component and the mass term in registers; (C) the lines
//     apply D_r^T and D_s^T in place.  Then (D) the owner adds the three and
//     stores y, coalesced.  K4's geometry is the column body's hoisted Alg. 3
//     (axhelm_common.cuh): each thread reads the 24 vertex words of its
//     element into registers at the start of a group (broadcast loads),
//     forms the edge differences and its column's terms, then per node
//     jacobian_at, K and adj(K).  K3's is its 7 words, read the same way and
//     folded into a scale of x_r, x_s, x_t per node.  K1's are its factor
//     planes, (E, 7, N1^3): the element's six G planes are one contiguous
//     span of 6 N1^3 values (12 KB at N1 = 8 in fp32), gwj after them, read
//     only for Helmholtz.  At (B) the owner loads its node's six (seven)
//     factors straight from device memory at fixed k, 32 consecutive words
//     a warp a plane, their latency hidden by the other resident warps.  It
//     loads them again for each column of the element: from the second
//     column on they may come from the cache, not from DRAM.  One 1-D bulk
//     copy an element of its planes into a shared buffer a group ahead (TMA)
//     was slower on the H100 (scripts/line_staging_sweep.py holds it;
//     PERF.md).
//   * Staging one stage ahead: persistent blocks (the grid is at most the
//     SMs times the resident blocks, ops.line_launch) walk over groups of
//     elements; a stage is one column of a group's elements (and, with the
//     group's first column, K4's Lam2 and Lam3).  Each thread loads its
//     share of the next stage into registers as 16-byte vectors (Stager)
//     while the current one computes, and stores it to the second buffer at
//     the top of the next stage.  The wrapper raises for an x, Lam2 or Lam3
//     that is not 16-byte aligned, and the entry point refuses it.  Staging
//     with 1-D bulk copies (TMA, cp.async.bulk with an mbarrier a buffer,
//     issued one copy a lane by warp 0) was 3-13% slower on the H100 at
//     the shipped launch setting, and no faster with three buffers
//     (scripts/line_staging_sweep.py holds it; PERF.md).
//   * Bank conflicts: a k-slab of x takes 16 bytes more than its values in
//     shared memory (68 words at N1 = 8 in fp32, 72 bf16 values in bf16),
//     and so do s_r and s_s (fp32).  The owner reads 32 consecutive words
//     at fixed k; an r line reads its N1 contiguous values as 16-byte
//     vectors, and the eight lanes of a vector phase (k' = 0..7 at fixed j')
//     start 17 k' + 2 j' 16-byte words apart, distinct mod 8; an s line reads
//     x[k''][m][i'] with the four k'' of a warp 0, 2, 4, 6 (or 1, 3, 5, 7)
//     apart, whose padded slab offsets fall 8 banks apart.  Conflict free at
//     N1 = 8, both storage types, but for the Stager's vector stores (two
//     ways in fp32).
//   * 64 threads a block: N1^2 threads an element (1 element at N1 = 8, 4 at
//     N1 = 4), at most 128 registers a thread (__launch_bounds__ with 8
//     blocks an SM).  Measured on the H100 beside 128-thread blocks and 10 or
//     12 blocks an SM, this was the fastest setting at which K4 does not
//     spill (PERF.md).  The threads of absent elements in the ragged last
//     group compute on the last element's data, reach every barrier and
//     store nothing.
//   * FFMA in fp32 throughout, no tensor cores: in fp32 K3 and K4 are bound
//     by bytes, and TF32 alone misses the 1e-4 budget at depth 8.
//   * Storage T (float or __nv_bfloat16): the staged x and Lam fields stay in
//     T in shared memory and widen to fp32 on the read; everything else is
//     fp32, and the one store of y rounds to nearest even.
//
// Shared-memory wavefronts per element and column at N1 = 8 in fp32, counted
// from the code (a wavefront is one pass of the 32 banks; a warp's 16-byte
// vector access of 32 distinct addresses takes 4):
//   a warp (32 of the element's 64 threads): the Stager's 2 vector stores,
//   16; (A) r line 2 vector loads and 2 vector stores, 16; s line 8 loads
//   and 8 stores, 16; t line 8 loads; (B) 8 loads and 8 stores each of s_r
//   and s_s, 32 (K4 also reads Lam2 and Lam3, 16, and for the mass x, 8);
//   (C) 32, as (A)'s lines; (D) 16.  K3 Poisson: 136 a warp, 272 an element,
//   17 words a node; K4: 160 a warp, 320 an element (and 32 a group for
//   storing Lam2 and Lam3).  The column body takes <= 656 an element, the
//   node body 1,728.
//
// Layouts (contiguous, the element axis outermost):
//   x, y   (E, ncols, N1^3) in T, node index i + N1*j + N1^2*k; x 16-byte
//          aligned
//   gelem  (E, 7) in T (parallelepiped): [adjK/det x6, det], unweighted
//   verts  (E, 8, 3) in T (merged), vertex = br + 2*bs + 4*bt
//   lam0, lam1  (E, N1^3) in T or null (merged: Lam2, Lam3, both given and
//          16-byte aligned)
//   w3 (N1^3) fp32 on the device (parallelepiped only)
//   consts (N1^2 + N1) fp32 on the host: D-hat row-major, then xi
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "axhelm_common.cuh"

namespace {

using namespace axhelm_detail;

constexpr int kLineThreads = 64;   // threads a block (ops.LINE_THREADS)
constexpr int kLineMinBlocks = 8;  // blocks an SM (ops.LINE_BLOCKS_PER_SM)
constexpr int kStages = 2;  // x buffers: a stage is fetched kStages-1 ahead

template <int N1>
__host__ __device__ constexpr int line_elems_per_block() {
  return kLineThreads / (N1 * N1);
}

// Values of T from one k-slab to the next in shared memory: N1^2 and 16
// bytes of padding.
template <int N1, typename T>
__host__ __device__ constexpr int slab_stride() {
  return N1 * N1 + 16 / static_cast<int>(sizeof(T));
}

// D-hat and xi by value: the kernel parameter in the constant bank.
template <int N1>
struct LineConsts {
  float d[N1 * N1];  // D-hat(row, col), row-major
  float xi[N1];      // GLL points
};

template <int N1, GeomSource SRC, typename T>
struct LineShared {
  static constexpr int EPB = line_elems_per_block<N1>();
  static constexpr int NP = N1 * N1 * N1;
  static constexpr int SX = slab_stride<N1, T>();      // x slabs, in T
  static constexpr int SP = slab_stride<N1, float>();  // s_r, s_s slabs
  // K4's Lam2 and Lam3, staged per group, kStages buffers
  static constexpr int LAM_BUFS = SRC == kMerged ? kStages : 1;
  static constexpr int LAM_NODES = SRC == kMerged ? NP : 1;
  alignas(16) T x[kStages][EPB][N1 * SX];  // x, a stage's column
  alignas(16) float r[EPB][N1 * SP];  // r components, then D_r^T of them
  alignas(16) float s[EPB][N1 * SP];  // s components, then D_s^T of them
  alignas(16) T lam[LAM_BUFS][EPB][2][LAM_NODES];
};

// N1 contiguous values from shared memory, widened to fp32, as 16-byte (or,
// for 4 bf16 values, 8-byte) vectors.
template <int N1>
__device__ __forceinline__ void load_row(const float* p, float* v) {
#pragma unroll
  for (int q = 0; q < N1 / 4; ++q) {
    const float4 u = reinterpret_cast<const float4*>(p)[q];
    v[4 * q + 0] = u.x;
    v[4 * q + 1] = u.y;
    v[4 * q + 2] = u.z;
    v[4 * q + 3] = u.w;
  }
}

// Two bf16 values of a 32-bit word (the first in the low half): exact, the
// 16 bits move to the top of an fp32 word.
__device__ __forceinline__ void widen2(uint32_t w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

template <int N1>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* v) {
  if constexpr (N1 % 8 == 0) {
#pragma unroll
    for (int q = 0; q < N1 / 8; ++q) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[q];
      widen2(u.x, v + 8 * q);
      widen2(u.y, v + 8 * q + 2);
      widen2(u.z, v + 8 * q + 4);
      widen2(u.w, v + 8 * q + 6);
    }
  } else {
#pragma unroll
    for (int q = 0; q < N1 / 4; ++q) {
      const uint2 u = reinterpret_cast<const uint2*>(p)[q];
      widen2(u.x, v + 4 * q);
      widen2(u.y, v + 4 * q + 2);
    }
  }
}

template <int N1>
__device__ __forceinline__ void store_row(float* p, const float* o) {
#pragma unroll
  for (int q = 0; q < N1 / 4; ++q) {
    reinterpret_cast<float4*>(p)[q] =
        make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
  }
}

// How a stage (one column of a group's elements: x, and at the group's first
// column K4's Lam2 and Lam3) reaches shared memory.  At the top of each stage
// the kernel calls land() for it, then fetch() for the stage kStages - 1
// ahead, then __syncthreads().  Here fetch() loads a thread's share of the
// next stage into registers, land() stores it to the stage's buffers: each
// thread moves N1 consecutive values of each array, the values of thread t
// of an element at t N1 .. t N1 + N1 - 1, as 16-byte vectors (one 8-byte
// vector for 4 bf16 values), coalesced.  They lie within one k-slab, at
// offset t N1 % N1^2 in slab t N1 / N1^2.
template <int N1, GeomSource SRC, typename T>
struct Stager {
  static_assert(kStages == 2, "registers hold one stage ahead");
  using Smem = LineShared<N1, SRC, T>;
  static constexpr int NC = N1 * N1, NP = Smem::NP, EPB = Smem::EPB;
  static constexpr int kBytes = N1 * static_cast<int>(sizeof(T));
  using Vec = typename std::conditional<kBytes % 16 == 0, uint4, uint2>::type;
  static constexpr int kVecs = kBytes / static_cast<int>(sizeof(Vec));
  Vec xv[kVecs];      // the next stage's x
  Vec lv[2][kVecs];   // K4: its Lam2 and Lam3

  __device__ void init(Smem& sm) {}

  // stage (group g, column c) into registers
  __device__ void fetch(Smem& sm, const T* x, const T* lam0, const T* lam1,
                        int n_elem, int ncols, int g, int c, int buf,
                        int fbuf) {
    const int le = threadIdx.x / NC, t = threadIdx.x % NC;
    const int64_t el = static_cast<int64_t>(g) * EPB + le;
    const int64_t ev = el < n_elem ? el : n_elem - 1;
    const Vec* src =
        reinterpret_cast<const Vec*>(x + (ev * ncols + c) * NP + t * N1);
#pragma unroll
    for (int q = 0; q < kVecs; ++q) xv[q] = src[q];
    if constexpr (SRC == kMerged) {
      if (c == 0) {
        const Vec* l0 = reinterpret_cast<const Vec*>(lam0 + ev * NP + t * N1);
        const Vec* l1 = reinterpret_cast<const Vec*>(lam1 + ev * NP + t * N1);
#pragma unroll
        for (int q = 0; q < kVecs; ++q) {
          lv[0][q] = l0[q];
          lv[1][q] = l1[q];
        }
      }
    }
  }

  // the block's stage number `stage`, column c, into buffers buf, fbuf
  __device__ void land(Smem& sm, int stage, int c, int buf, int fbuf) {
    const int le = threadIdx.x / NC, t = threadIdx.x % NC;
    Vec* dst = reinterpret_cast<Vec*>(
        &sm.x[buf][le][(t * N1 / NC) * Smem::SX + t * N1 % NC]);
#pragma unroll
    for (int q = 0; q < kVecs; ++q) dst[q] = xv[q];
    if constexpr (SRC == kMerged) {
      if (c == 0) {
        Vec* d0 = reinterpret_cast<Vec*>(&sm.lam[fbuf][le][0][t * N1]);
        Vec* d1 = reinterpret_cast<Vec*>(&sm.lam[fbuf][le][1][t * N1]);
#pragma unroll
        for (int q = 0; q < kVecs; ++q) {
          d0[q] = lv[0][q];
          d1[q] = lv[1][q];
        }
      }
    }
  }
};

template <int N1, GeomSource SRC, typename T>
__global__ void __launch_bounds__(kLineThreads, kLineMinBlocks)
    axhelm_line_kernel(const T* __restrict__ x, T* __restrict__ y,
                       const T* __restrict__ geom,
                       const T* __restrict__ lam0,
                       const T* __restrict__ lam1,
                       const float* __restrict__ w3,
                       const __grid_constant__ LineConsts<N1> cc, int n_elem,
                       int ncols, int helmholtz) {
  static_assert(SRC == kPrecomputed || SRC == kParallelepiped ||
                    SRC == kMerged,
                "the line body computes K1, K3 and K4");
  static_assert(N1 % 4 == 0, "rows are read as 16-byte vectors");
  using Smem = LineShared<N1, SRC, T>;
  constexpr int NC = N1 * N1;  // threads (node columns) an element
  constexpr int NP = Smem::NP;
  constexpr int EPB = Smem::EPB;
  constexpr int SX = Smem::SX, SP = Smem::SP;
  static_assert(NC <= kLineThreads, "one block holds a whole element");
  __shared__ Smem sm;

  const int le = threadIdx.x / NC;  // element within the block
  const int t = threadIdx.x % NC;   // node column (i, j), t = i + N1 j
  const int i = t % N1, j = t / N1;
  const int rj = t / N1, rk = t % N1;  // r line (., rj, rk)
  const int si = t % N1;               // s line (si, ., sk)
  const int sk = (2 * (t / N1)) % N1 + (2 * (t / N1)) / N1;
  const int n_groups = (n_elem + EPB - 1) / EPB;

  Stager<N1, SRC, T> stager;
  stager.init(sm);
  __syncthreads();

  float w[N1];  // K3: w3 along this thread's node column
  if constexpr (SRC == kParallelepiped) {
#pragma unroll
    for (int k = 0; k < N1; ++k) w[k] = w3[k * NC + t];
  }
  // Stage number s of the block is column s % ncols of its group
  // blockIdx.x + (s / ncols) gridDim.x, in x buffer s % kStages and field
  // buffer (s / ncols) % kStages (K4's Lam2 and Lam3, fetched with the
  // group's first column).
  auto fetch = [&](int s) {
    const int lg = s / ncols;
    const int g = blockIdx.x + lg * gridDim.x;
    if (g < n_groups) {
      stager.fetch(sm, x, lam0, lam1, n_elem, ncols, g, s % ncols,
                   s % kStages, lg % kStages);
    }
  };
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  int stage = 0;
  for (int g = blockIdx.x, lg = 0; g < n_groups; g += gridDim.x, ++lg) {
    const int64_t e = static_cast<int64_t>(g) * EPB + le;
    const bool live = e < n_elem;
    const int64_t ev = live ? e : n_elem - 1;  // absent: compute, store nothing
    // The element's geometry, straight from global memory into registers
    // (broadcast loads, in flight while x lands): K4's Alg. 3 terms of this
    // node column, K3's 7 words.
    ColumnTerms ct;
    float ge[7];
    if constexpr (SRC == kMerged) {
      float v[24], ed[36];
#pragma unroll
      for (int q = 0; q < 24; ++q) v[q] = load(geom + ev * 24 + q);
#pragma unroll
      for (int q = 0; q < 12; ++q) {
        int lo, hi;
        edge_vertices(q, lo, hi);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          ed[3 * q + a] = v[3 * hi + a] - v[3 * lo + a];
        }
      }
      ct = column_terms(ed, cc.xi[i], cc.xi[j]);
    } else if constexpr (SRC == kParallelepiped) {
#pragma unroll
      for (int q = 0; q < 7; ++q) ge[q] = load(geom + ev * 7 + q);
    }
    const int fbuf = lg % kStages;
    for (int c = 0; c < ncols; ++c, ++stage) {
      const int buf = stage % kStages;
      stager.land(sm, stage, c, buf, fbuf);
      // into the buffers of the stage before: every thread is past its (B)
      fetch(stage + kStages - 1);
      // also orders the stage before's reads of s_r and s_s in (D) before
      // the writes of (A)
      __syncthreads();
      const T* xs = sm.x[buf][le];
      float* pr = sm.r[le];
      float* ps = sm.s[le];

      // (A) grad: x_r on the r line, x_s on the s line, x_t on the column
      {
        float v[N1], o[N1];
        load_row<N1>(xs + rk * SX + rj * N1, v);
#pragma unroll
        for (int n = 0; n < N1; ++n) {
          float acc = 0.f;
#pragma unroll
          for (int m = 0; m < N1; ++m) acc = fmaf(cc.d[n * N1 + m], v[m], acc);
          o[n] = acc;
        }
        store_row<N1>(pr + rk * SP + rj * N1, o);
      }
      {
        float v[N1];
#pragma unroll
        for (int m = 0; m < N1; ++m) v[m] = load(xs + sk * SX + m * N1 + si);
#pragma unroll
        for (int n = 0; n < N1; ++n) {
          float acc = 0.f;
#pragma unroll
          for (int m = 0; m < N1; ++m) acc = fmaf(cc.d[n * N1 + m], v[m], acc);
          ps[sk * SP + n * N1 + si] = acc;
        }
      }
      float xt[N1];
      {
        float v[N1];
#pragma unroll
        for (int m = 0; m < N1; ++m) v[m] = load(xs + m * SX + t);
#pragma unroll
        for (int n = 0; n < N1; ++n) {
          float acc = 0.f;
#pragma unroll
          for (int m = 0; m < N1; ++m) acc = fmaf(cc.d[n * N1 + m], v[m], acc);
          xt[n] = acc;
        }
      }
      __syncthreads();

      // (B) the factors at each node of the column: the weighted r and s
      // components back in place, D_t^T of the t component and the mass
      // term into yv
      float yv[N1];
#pragma unroll
      for (int n = 0; n < N1; ++n) yv[n] = 0.f;
      // K1: the element's factor planes, plane p at fp[p NP]
      const T* fp = nullptr;
      if constexpr (SRC == kPrecomputed) fp = geom + ev * 7 * NP + t;
#pragma unroll
      for (int k = 0; k < N1; ++k) {
        const int o = k * SP + t;
        float gr = pr[o], gs = ps[o], gt = xt[k];
        float g00, g01, g02, g11, g12, g22, scale, mass = 0.f;
        if constexpr (SRC == kMerged) {
          // G = adj(K~) Lam2, mass = Lam3
          float c0[3], c1[3];
          jacobian_at(ct, cc.xi[k], c0, c1);
          const float* c2 = ct.c2;
          const float k00 = c0[0] * c0[0] + c0[1] * c0[1] + c0[2] * c0[2];
          const float k01 = c0[0] * c1[0] + c0[1] * c1[1] + c0[2] * c1[2];
          const float k02 = c0[0] * c2[0] + c0[1] * c2[1] + c0[2] * c2[2];
          const float k11 = c1[0] * c1[0] + c1[1] * c1[1] + c1[2] * c1[2];
          const float k12 = c1[0] * c2[0] + c1[1] * c2[1] + c1[2] * c2[2];
          g00 = k11 * ct.k22 - k12 * k12;
          g01 = k02 * k12 - k01 * ct.k22;
          g02 = k01 * k12 - k02 * k11;
          g11 = k00 * ct.k22 - k02 * k02;
          g12 = k01 * k02 - k00 * k12;
          g22 = k00 * k11 - k01 * k01;
          scale = load(&sm.lam[fbuf][le][0][k * NC + t]);
          mass = load(&sm.lam[fbuf][le][1][k * NC + t]);
        } else if constexpr (SRC == kPrecomputed) {
          // G (lam0), gwj (lam1) of the node
          const T* q = fp + k * NC;
          g00 = load(q);
          g01 = load(q + NP);
          g02 = load(q + 2 * NP);
          g11 = load(q + 3 * NP);
          g12 = load(q + 4 * NP);
          g22 = load(q + 5 * NP);
          const int64_t node = ev * NP + k * NC + t;
          scale = lam0 != nullptr ? load(lam0 + node) : 1.f;
          if (helmholtz) {
            mass = load(q + 6 * NP);
            if (lam1 != nullptr) mass *= load(lam1 + node);
          }
        } else {
          // G = gelem[:6] w3 (lam0), gwj = gelem[6] w3 (lam1)
          g00 = ge[0];
          g01 = ge[1];
          g02 = ge[2];
          g11 = ge[3];
          g12 = ge[4];
          g22 = ge[5];
          const int64_t node = ev * NP + k * NC + t;
          scale = w[k];
          if (lam0 != nullptr) scale *= load(lam0 + node);
          if (helmholtz) {
            mass = ge[6] * w[k];
            if (lam1 != nullptr) mass *= load(lam1 + node);
          }
        }
        gr *= scale;
        gs *= scale;
        gt *= scale;
        pr[o] = g00 * gr + g01 * gs + g02 * gt;
        ps[o] = g01 * gr + g11 * gs + g12 * gt;
        const float wt = g02 * gr + g12 * gs + g22 * gt;
#pragma unroll
        for (int n = 0; n < N1; ++n) yv[n] = fmaf(cc.d[k * N1 + n], wt, yv[n]);
        if (helmholtz) yv[k] = fmaf(mass, load(xs + k * SX + t), yv[k]);
      }
      __syncthreads();

      // (C) D_r^T and D_s^T on the lines, in place
      {
        float v[N1], o[N1];
        load_row<N1>(pr + rk * SP + rj * N1, v);
#pragma unroll
        for (int n = 0; n < N1; ++n) {
          float acc = 0.f;
#pragma unroll
          for (int m = 0; m < N1; ++m) acc = fmaf(cc.d[m * N1 + n], v[m], acc);
          o[n] = acc;
        }
        store_row<N1>(pr + rk * SP + rj * N1, o);
      }
      {
        float v[N1];
#pragma unroll
        for (int m = 0; m < N1; ++m) v[m] = ps[sk * SP + m * N1 + si];
#pragma unroll
        for (int n = 0; n < N1; ++n) {
          float acc = 0.f;
#pragma unroll
          for (int m = 0; m < N1; ++m) acc = fmaf(cc.d[m * N1 + n], v[m], acc);
          ps[sk * SP + n * N1 + si] = acc;
        }
      }
      __syncthreads();

      // (D) y = D_r^T + D_s^T + D_t^T (+ mass x), one coalesced store a k
      if (live) {
        T* out = y + (ev * ncols + c) * NP + t;
#pragma unroll
        for (int k = 0; k < N1; ++k) {
          store(out + k * NC, yv[k] + pr[k * SP + t] + ps[k * SP + t]);
        }
      }
    }
  }
}

template <int N1, GeomSource SRC, typename T>
int launch_n1(const T* x, T* y, const T* geom, const T* lam0, const T* lam1,
              const float* w3, const float* consts, int n_elem, int ncols,
              int helmholtz, int elems_per_block_given, int grid,
              cudaStream_t s) {
  constexpr int EPB = line_elems_per_block<N1>();
  // the wrapper's launch arithmetic must be this instantiation's; any grid
  // up to one block a group covers every element
  const int n_groups = (n_elem + EPB - 1) / EPB;
  if (elems_per_block_given != EPB || grid < 1 || grid > n_groups) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LineConsts<N1> cc;
  std::memcpy(&cc, consts, sizeof cc);
  axhelm_line_kernel<N1, SRC, T><<<grid, kLineThreads, 0, s>>>(
      x, y, geom, lam0, lam1, w3, cc, n_elem, ncols, helmholtz);
  return static_cast<int>(cudaGetLastError());
}

bool misaligned(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) != 0;
}

template <GeomSource SRC, typename T>
int launch_line(const T* x, T* y, const T* geom, const T* lam0,
                const T* lam1, const float* w3, const float* consts, int n1,
                int n_elem, int ncols, int helmholtz, int elems_per_block,
                int grid, void* stream) {
  if (n_elem <= 0 || ncols <= 0 || consts == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the vector loads' sources (the wrapper raises before this)
  if (misaligned(x) ||
      (SRC == kMerged && (misaligned(lam0) || misaligned(lam1)))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n1) {
    case 4:
      return launch_n1<4, SRC, T>(x, y, geom, lam0, lam1, w3, consts,
                                  n_elem, ncols, helmholtz, elems_per_block,
                                  grid, s);
    case 8:
      return launch_n1<8, SRC, T>(x, y, geom, lam0, lam1, w3, consts,
                                  n_elem, ncols, helmholtz, elems_per_block,
                                  grid, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The K1, K3 and K4 entry points for storage type T.  precomputed takes the
// planar factors (E, 7, N1^3); parallelepiped takes w3 on the device; merged
// is Helmholtz always (lam2 = Lam2 and lam3 = Lam3 must be given).  consts
// is the host pointer to D-hat and xi; elems_per_block and grid are the
// wrapper's (ops.line_launch), checked against this build.
#define AXHELM_LINE_ENTRY_POINTS(T, SUFFIX)                                   \
  extern "C" int axhelm_precomputed_##SUFFIX(                                 \
      const T* x, T* y, const T* geom, const T* lam0, const T* lam1,         \
      const float* consts, int n1, int n_elem, int ncols, int helmholtz,      \
      int elems_per_block, int grid, void* stream) {                          \
    return launch_line<kPrecomputed, T>(x, y, geom, lam0, lam1, nullptr,      \
                                        consts, n1, n_elem, ncols, helmholtz, \
                                        elems_per_block, grid, stream);       \
  }                                                                           \
  extern "C" int axhelm_parallelepiped_##SUFFIX(                              \
      const T* x, T* y, const T* gelem, const T* lam0, const T* lam1,        \
      const float* w3, const float* consts, int n1, int n_elem, int ncols,    \
      int helmholtz, int elems_per_block, int grid, void* stream) {           \
    if (w3 == nullptr) return static_cast<int>(cudaErrorInvalidValue);        \
    return launch_line<kParallelepiped, T>(x, y, gelem, lam0, lam1, w3,       \
                                           consts, n1, n_elem, ncols,         \
                                           helmholtz, elems_per_block, grid,  \
                                           stream);                           \
  }                                                                           \
  extern "C" int axhelm_merged_##SUFFIX(                                      \
      const T* x, T* y, const T* verts, const T* lam2, const T* lam3,        \
      const float* consts, int n1, int n_elem, int ncols,                     \
      int elems_per_block, int grid, void* stream) {                          \
    if (lam2 == nullptr || lam3 == nullptr) {                                 \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    }                                                                         \
    return launch_line<kMerged, T>(x, y, verts, lam2, lam3, nullptr, consts,  \
                                   n1, n_elem, ncols, 1, elems_per_block,     \
                                   grid, stream);                             \
  }

AXHELM_LINE_ENTRY_POINTS(float, f32)
AXHELM_LINE_ENTRY_POINTS(__nv_bfloat16, bf16)
