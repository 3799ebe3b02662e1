// axhelm_column.cu -- the one-thread-per-column body of the axhelm kernels K2
// and K5 for Hopper (sm_90a), with a plain C interface (bound from Python
// with ctypes: kernels/axhelm/build.py, ops.py).
//
// Replaces the TPU kernel repro/kernels/axhelm/kernel.py::_kernel (the body of
// the one pl.pallas_call, kernel.py:233) in two of its variants, for both
// storage types (entry points *_f32 and *_bf16), at every N1 from 2 to 16
// (orders 1 to 15; ops.N1_TUNED_MAX):
//   axhelm_trilinear_f32  K2, "trilinear" (kernel.py:126-131, paper Alg. 3):
//                         G = (1/8) w3 adj(K~) / det(J~), gwj = w3 det(J~)/512
//                         recomputed from the element's 8 vertices;
//   axhelm_partial_f32    K5, "partial" (kernel.py:154-157, §4.1.2, Poisson
//                         only): G = adj(K~) * gScale, gScale = w3/(8 det)
//                         read per node from the lam0 slot.
// K~ = J~^T J~, J~ the unscaled trilinear Jacobian.  Per element e and column
// c (c runs over the nrhs*d columns):
//   y = D^T [lam0 * G (D x)]  (+ mass * x for K2 Helmholtz, mass = lam1 * gwj)
// For these two variants it also replaces the one-thread-per-node body of
// axhelm.cu (its timing-only *_rowwise entry points, N1 = 4 and 8) and, at
// N1 up to 16, the generic body (the timing-only *_any entry points there).
//
// What bounds it on the H100 (chip_smoke.py::axhelm_bound; E = 4096, N1 = 8,
// one column, fp32): K2 moves x, y and 24 vertex words an element and does
// the contraction's 12 N1 + 15 FLOPs a node plus ~84 of geometry: bound by
// fp32 CUDA-core arithmetic, 6.3 us.  K5 adds the gScale field and does ~66
// FLOPs a node of geometry: bound by bytes, 7.6 us.  With bf16 storage both
// are operation-bound (6.3 and 5.7 us).  The contraction's share of the
// operations grows with N1 (12 N1 a node), so above N1 = 8 both are bound by
// operations in both storage types.  What held the one-thread-per-node body
// to 46-47 us was neither: every one of its six contractions read both
// operands from shared memory, and each thread recomputed all of Alg. 3.
//
// Design:
//   * One thread per node column along k: thread (i, j) of an element owns
//     the N1 nodes (i, j, 0..N1-1).  k is the slowest node axis, so for each k
//     a warp's loads of x and stores of y cover consecutive words, and the
//     geometry hoists best along k: the third Jacobian column c2 and k22
//     depend on (i, j) only, the first two columns are affine in xi_k.
//   * The thread's N1 values of x live in registers, so the t contraction
//     reads no shared memory; its transpose reads back only the thread's own
//     N1 t components (s_t, one load each: kept in registers they would hold
//     N1 more through the forward pass, and the registers spill).  Only the
//     r (i) and s (j) directions go through shared memory, one N1 x N1 slab
//     (fixed k) at a time: s_x holds x, s_r and s_s the r and s components of
//     lam0 G (D x).  Along r a thread reads N1 contiguous words, as float4
//     loads where N1 % 4 == 0, float2 where N1 is even, else one word a load
//     (row_fma).
//   * D-hat along the register axis: after unrolling, its index there is a
//     compile-time constant, so D-hat and xi are passed by value as one
//     __grid_constant__ kernel parameter (ColumnConsts: N1^2 + N1 floats).
//     It lives in the constant bank and enters each FFMA as an operand, with
//     no load instruction.  Not a __constant__ symbol: two streams, or an
//     fp32 and a bf16 launch (whose D-hat values differ), would race on one.
//     The C entry point takes a host pointer to the packed values (ops.py,
//     _column_consts) and copies them into the parameter, so a launch captured
//     in a CUDA graph keeps its own copy.  The D-hat rows a thread needs for
//     the two shared-memory directions (D[i][:], D[j][:] forward, D[:][i],
//     D[:][j] for the transpose) come from two N1 x N1 copies in shared
//     memory laid out for conflict-free reads (the lanes of a warp read at
//     most N1 consecutive words, or one): up to N1 = kColumnDRegsMax (8) into
//     registers at the start of each pass; above, four rows of N1 beside the
//     N1 values of x would spill, so each FFMA reads its D-hat entry from
//     shared memory.  Never from the parameter with an index that differs
//     across the lanes of a warp: the constant cache serialises such reads.
//     Above kColumnDRegsMax the loops over k also stay rolled (fully
//     unrolled, every instantiation from N1 = 9 spilled: the compiler hoisted
//     the loads of all N1 nodes), and D-hat along k comes from the parameter
//     by an index that is the same in every lane, one load a value.
//   * Alg. 3 hoisted (edge_vertices, column_terms, jacobian_at and det_j,
//     shared with the line body in axhelm_common.cuh): once per element,
//     into shared memory, the 12 edge
//     differences of the vertices (36 words); once per thread, the terms
//     that do not vary along k (c0 = e0 + xi_k e1, c1 = f0 + xi_k f1, c2,
//     k22); per node only the affine update, the five other entries of
//     K = J~^T J~, adj(K) and, for K2, det(J~) and its scale with one
//     reciprocal (MUFU.RCP through __fdividef: ~1 ulp, far inside the 1e-4
//     budget).  The scale multiplies x_r, x_s, x_t (3 products) rather than
//     the 6 factors.  K5 reads gScale per node, coalesced, in the storage
//     type.  K2's Helmholtz mass, lam1 w3 det(J~)/512, is recomputed in the
//     transpose pass, where x is still in s_x.
//   * The factors are recomputed for each of the c columns, not kept: N1 x 6
//     factors in registers would hold ~48 registers through the column loop
//     and spill, and staging them in shared memory would cost 6 N1^3 words an
//     element (12 KB at N1 = 8).  Recomputing costs ~60 instructions a node
//     for each column beyond the first, against ~70 of the column's
//     contraction.  The first column of x is loaded before the first
//     barrier, each next one during the transpose pass of the one before.
//   * Several elements a block (column_elems): at N1 = 4 and 8, 128 threads
//     (8 and 2 elements) and at most 128 registers a thread
//     (__launch_bounds__ with 4 blocks an SM: 16 warps); measured on the H100
//     beside 256-thread blocks and 80- to 168-register caps, this was the
//     fastest setting without spills (PERF.md).  At every other N1 the
//     elements a block are chosen so that its EPB N1^2 threads leave few
//     lanes of their last warp idle (7 elements of 36 threads fill 252 of
//     256 lanes at N1 = 6), one element from N1 = 12, and as many blocks an
//     SM as give 16 warps (column_min_blocks), which caps a thread at about
//     128 registers.  The wrapper gives the grid, ceil(E / elements per
//     block); the threads of absent elements in the ragged last block
//     compute on the last element's data, reach every __syncthreads and
//     store nothing.  Shared memory (ColumnShared): 4 (N1^3 + pad) + 36
//     words an element and 2 N1^2 a block, 16.8 KB a block at N1 = 8, 67.7
//     KB at N1 = 16; above 48 KB it is the launch's dynamic shared memory
//     (block_shared, from N1 = 15).
//   * FFMA in fp32 throughout, no tensor cores: at N1 = 8 a contraction is an
//     8-deep product, TF32 alone misses the 1e-4 budget, and 3xTF32 would pay
//     three products to beat this path (see PERF.md for what remains).
//   * Storage T (float or __nv_bfloat16): loads widen to fp32, everything
//     else is fp32, and the one store of y rounds to nearest even, as in
//     axhelm.cu.  D-hat, xi and w3 hold the storage type's rounded values.
//     x is read one value a load (a node column's values lie N1^2 apart), so
//     no N1 and no element offset needs an aligned operand.
//
// Shared-memory wavefronts per element and column at N1 = 8, counted from the
// code (a wavefront is one pass of the 32 banks; loads of one word that every
// thread of a warp reads are broadcast):
//   before (axhelm.cu, 512 threads = 16 warps an element): per m, forward
//     s_d[i*N1+m] 2 (i and i+4 share a bank) and five more loads of 1 each:
//     8 x 7 = 56; transpose 8 x 6 = 48; 4 stores: 108 a warp, 1,728 an
//     element.
//   after (this file, 64 threads = 2 warps an element): a warp stores its 8
//     slab rows of x, r, s and t (32) and loads 4 N1 D-hat rows (32); per k,
//     forward along r 2 float4 loads (at most 4 wavefronts each: a warp reads
//     4 distinct 16-byte words) and along s 8 loads of 1: 8 x 16 = 128; the
//     transpose the same, 128, and its own t components, 8: at most 328 a
//     warp, 656 an element, 2.6x fewer (plus 36 broadcast reads of the edges
//     a thread, once).
//
// Bank conflicts at every N1 (tests/test_torch_axhelm_column.py holds the
// model: a 16-byte access runs in phases of 8 lanes, an 8-byte one in phases
// of 16, a phase takes as many wavefronts as the most distinct words in one
// bank): the ways of the worst phase of each access, over every warp of a
// block, with element e of a block at e (N1^3 + pad) words (column_pads) --
// "store" the stores (and the owner's loads) at fixed k of s_x, s_r, s_s and
// s_t, "row" the r rows, "col" the s columns at fixed m, in both passes.  The
// D-hat copies are conflict free at every N1.  A pad of 0 keeps N1 = 4 as it
// was measured (its 2 ways: two elements a warp, 64 words apart); every other
// pad is the smallest that takes each access to its fewest ways (at N1 = 6
// and 10 a float2 row needs an even pad, and no even pad frees the stores).
//   N1:     2  3  4  5  6  7  8  9 10 11 12 13 14 15 16
//   pad:    4 14  0 28  2 26  0 24  2  6  0  0  0  0  0
//   store:  1  1  2  1  2  1  1  1  2  1  1  1  1  1  1
//   row:    1  1  1  1  1  1  1  1  1  1  1  1  1  1  1
//   col:    1  1  2  1  1  1  1  1  1  1  1  1  1  1  1
//
// Layouts (contiguous, the element axis outermost):
//   x, y   (E, ncols, N1^3) in T, node index i + N1*j + N1^2*k
//   verts  (E, 8, 3) in T, vertex = br + 2*bs + 4*bt
//   lam0, lam1  (E, N1^3) in T or null (partial: lam0 = gScale)
//   w3 (N1^3) fp32 on the device (trilinear only)
//   consts (N1^2 + N1) fp32 on the host: D-hat row-major, then xi
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).
//
// Build: this file is compiled once for each part, -DAXHELM_PART=p
// (build.PARTS), every part at the same time.  Part p instantiates the N1 of
// AXHELM_COLUMN_PART<p>; part 0 also holds the entry points, which reach the
// other parts' instantiations through the linker (extern template).

#include <cstdint>
#include <cstring>

#include "axhelm_common.cuh"

#ifndef AXHELM_PART
#define AXHELM_PART 0
#endif

// The N1 of each part: about the same unrolled code in each.
#define AXHELM_COLUMN_PART0(X) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10)
#define AXHELM_COLUMN_PART1(X) X(11) X(12)
#define AXHELM_COLUMN_PART2(X) X(13) X(14)
#define AXHELM_COLUMN_PART3(X) X(15)
#define AXHELM_COLUMN_PART4(X) X(16)

namespace column_body {

using namespace axhelm_detail;

// At N1 = 4 and 8: threads a block (ops.COLUMN_THREADS) and blocks an SM,
// at most 128 registers a thread.
constexpr int kColumnThreads = 128;
constexpr int kColumnMinBlocks = 4;
constexpr int kColumnDRegsMax = 8;  // D-hat rows in registers up to this N1

// Elements a block (ops.COLUMN_ELEMS): at N1 = 4 and 8, kColumnThreads / N1^2.
__host__ __device__ constexpr int column_elems(int n1) {
  constexpr int elems[17] = {0, 0, 32, 14, 0, 5, 7, 5, 0,
                             3, 2, 2, 1, 1, 1, 1, 1};
  return n1 == 4 || n1 == 8 ? kColumnThreads / (n1 * n1) : elems[n1];
}

// Words of padding after each element's N1^3 in s_x, s_r, s_s and s_t
// (ops.COLUMN_PADS; the table in the note above).
__host__ __device__ constexpr int column_pads(int n1) {
  constexpr int pads[17] = {0, 0, 4, 14, 0, 28, 2, 26, 0,
                            24, 2, 6, 0, 0, 0, 0, 0};
  return pads[n1];
}

template <int N1>
__host__ __device__ constexpr int elems_per_block() {
  return column_elems(N1);
}

template <int N1>
__host__ __device__ constexpr int column_threads() {
  return elems_per_block<N1>() * N1 * N1;
}

// Blocks an SM for __launch_bounds__ (ops.column_min_blocks): at N1 = 4 and 8
// kColumnMinBlocks, else as many as give 16 warps (at least one).
template <int N1>
__host__ __device__ constexpr int column_min_blocks() {
  constexpr int warps = (column_threads<N1>() + 31) / 32;
  return N1 == 4 || N1 == 8 ? kColumnMinBlocks
                            : (warps >= 16 ? 1 : 16 / warps);
}

// D-hat and xi by value: the kernel parameter that lives in the constant bank.
template <int N1>
struct ColumnConsts {
  float d[N1 * N1];  // D-hat(row, col), row-major
  float xi[N1];      // GLL points
};

template <int N1>
struct ColumnShared {
  static constexpr int EPB = elems_per_block<N1>();
  static constexpr int NC = N1 * N1;
  static constexpr int ES = NC * N1 + column_pads(N1);  // words an element
  alignas(16) float x[EPB][ES];  // x, the current column
  alignas(16) float r[EPB][ES];  // lam0 G (D x), r component
  alignas(16) float s[EPB][ES];  // ... s component
  alignas(16) float t[EPB][ES];  // ... t component
  float e[EPB][36];              // edge q, component a: 3q + a
  float d[NC];                   // D-hat(m, n) at m N1 + n
  float dt[NC];                  // D-hat(n, m) at m N1 + n
};

// acc + sum_m c(m) row[m] over N1 contiguous floats of shared memory, m
// ascending: float4 loads where N1 % 4 == 0, float2 where N1 is even, else
// one word a load.
template <int N1, typename Coef>
__device__ __forceinline__ float row_fma(const float* row, Coef c,
                                         float acc) {
  if constexpr (N1 % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N1 / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(row)[q];
      acc = fmaf(c(4 * q + 0), v.x, acc);
      acc = fmaf(c(4 * q + 1), v.y, acc);
      acc = fmaf(c(4 * q + 2), v.z, acc);
      acc = fmaf(c(4 * q + 3), v.w, acc);
    }
  } else if constexpr (N1 % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N1 / 2; ++q) {
      const float2 v = reinterpret_cast<const float2*>(row)[q];
      acc = fmaf(c(2 * q + 0), v.x, acc);
      acc = fmaf(c(2 * q + 1), v.y, acc);
    }
  } else {
#pragma unroll
    for (int m = 0; m < N1; ++m) acc = fmaf(c(m), row[m], acc);
  }
  return acc;
}

template <int N1, GeomSource SRC, typename T>
__global__ void __launch_bounds__(column_threads<N1>(),
                                  column_min_blocks<N1>())
    axhelm_column_kernel(const T* __restrict__ x, T* __restrict__ y,
                         const T* __restrict__ verts,
                         const T* __restrict__ lam0,
                         const T* __restrict__ lam1,
                         const float* __restrict__ w3,
                         const __grid_constant__ ColumnConsts<N1> cc,
                         int n_elem, int ncols, int helmholtz) {
  static_assert(SRC == kTrilinear || SRC == kPartial,
                "the column body computes K2 and K5");
  using Smem = ColumnShared<N1>;
  constexpr int NC = N1 * N1;  // threads (node columns) an element
  constexpr int NP = N1 * NC;  // nodes an element
  constexpr int EPB = Smem::EPB;
  constexpr bool kDRegs = N1 <= kColumnDRegsMax;
  // Above kColumnDRegsMax the k loops stay rolled: unrolled, the compiler
  // hoists the loads of all N1 nodes and spills.  D-hat along k then comes
  // from the constant bank by a warp-uniform index, one load a value.
  constexpr int kUnrollK = kDRegs ? N1 : 1;
  static_assert(EPB >= 1, "one block holds a whole element");
  Smem& sm = block_shared<Smem>();

  const int le = threadIdx.x / NC;  // element within the block
  const int col = threadIdx.x % NC;
  const int i = col % N1, j = col / N1;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * EPB + le;
  const bool live = e < n_elem;
  const int64_t ev = live ? e : n_elem - 1;  // absent: compute, store nothing

  // The first column of x, loaded before the first barrier so that its
  // latency overlaps the staging below.
  const int64_t node0 = ev * NP + col;  // node (i, j, 0)
  float xk[N1];
#pragma unroll
  for (int k = 0; k < N1; ++k) {
    xk[k] = load(x + ev * ncols * NP + col + k * NC);
  }

  // Alg. 3, per element: the 12 edge differences of the vertices.
  for (int q = col; q < 36; q += NC) {
    int lo, hi;
    edge_vertices(q / 3, lo, hi);
    const T* v = verts + ev * 24 + q % 3;
    sm.e[le][q] = load(v + 3 * hi) - load(v + 3 * lo);
  }
  // D-hat for the rows of the two shared-memory directions, laid out so
  // that a warp reads each of them without a bank conflict.
  if (threadIdx.x < NC) {
    const int m = threadIdx.x / N1, n = threadIdx.x % N1;
    sm.d[threadIdx.x] = cc.d[threadIdx.x];
    sm.dt[n * N1 + m] = cc.d[threadIdx.x];
  }
  __syncthreads();

  // Alg. 3, per node column.
  const ColumnTerms ct = column_terms(sm.e[le], cc.xi[i], cc.xi[j]);

  for (int c = 0; c < ncols; ++c) {
    const int64_t base = (ev * ncols + c) * NP + col;  // node (i, j, 0)
#pragma unroll
    for (int k = 0; k < N1; ++k) sm.x[le][k * NC + col] = xk[k];
    // also orders the previous column's reads of s_r, s_s before the writes
    // below
    __syncthreads();

    float dri[kDRegs ? N1 : 1], dsj[kDRegs ? N1 : 1];  // D-hat(i, m), (j, m)
    if constexpr (kDRegs) {
#pragma unroll
      for (int m = 0; m < N1; ++m) {
        dri[m] = sm.dt[m * N1 + i];
        dsj[m] = sm.dt[m * N1 + j];
      }
    }
    auto d_ri = [&](int m) -> float {
      if constexpr (kDRegs) return dri[m];
      else return sm.dt[m * N1 + i];
    };
    auto d_sj = [&](int m) -> float {
      if constexpr (kDRegs) return dsj[m];
      else return sm.dt[m * N1 + j];
    };
#pragma unroll (kUnrollK)
    for (int k = 0; k < N1; ++k) {
      // grad at node (i, j, k): x_r, x_s through shared memory, x_t in
      // registers with D-hat from the constant bank
      const float* slab = sm.x[le] + k * NC;
      float xr = row_fma<N1>(slab + j * N1, d_ri, 0.f);
      float xs = 0.f, xt = 0.f;
#pragma unroll
      for (int m = 0; m < N1; ++m) {
        xs = fmaf(d_sj(m), slab[m * N1 + i], xs);
        xt = fmaf(cc.d[k * N1 + m], xk[m], xt);
      }

      // the factors at this node: the affine update, K, adj(K), the scale
      float c0[3], c1[3];
      jacobian_at(ct, cc.xi[k], c0, c1);
      const float* c2 = ct.c2;
      const float k00 = c0[0] * c0[0] + c0[1] * c0[1] + c0[2] * c0[2];
      const float k01 = c0[0] * c1[0] + c0[1] * c1[1] + c0[2] * c1[2];
      const float k02 = c0[0] * c2[0] + c0[1] * c2[1] + c0[2] * c2[2];
      const float k11 = c1[0] * c1[0] + c1[1] * c1[1] + c1[2] * c1[2];
      const float k12 = c1[0] * c2[0] + c1[1] * c2[1] + c1[2] * c2[2];
      const float g00 = k11 * ct.k22 - k12 * k12;
      const float g01 = k02 * k12 - k01 * ct.k22;
      const float g02 = k01 * k12 - k02 * k11;
      const float g11 = k00 * ct.k22 - k02 * k02;
      const float g12 = k01 * k02 - k00 * k12;
      const float g22 = k00 * k11 - k01 * k01;
      float scale;
      if constexpr (SRC == kTrilinear) {
        // G = (1/8) w3 adj(K~) / det(J~): one reciprocal
        scale = __fdividef(0.125f * w3[k * NC + col], det_j(c0, c1, c2));
        if (lam0 != nullptr) scale *= load(lam0 + node0 + k * NC);
      } else {  // kPartial: G = adj(K~) gScale, gScale in the lam0 slot
        scale = load(lam0 + node0 + k * NC);
      }
      xr *= scale;
      xs *= scale;
      xt *= scale;
      sm.r[le][k * NC + col] = g00 * xr + g01 * xs + g02 * xt;
      sm.s[le][k * NC + col] = g01 * xr + g11 * xs + g12 * xt;
      sm.t[le][k * NC + col] = g02 * xr + g12 * xs + g22 * xt;
    }
    __syncthreads();
    if (c + 1 < ncols) {  // the next column of x, in flight during this one
#pragma unroll
      for (int k = 0; k < N1; ++k) xk[k] = load(x + base + NP + k * NC);
    }

    // y = D_r^T s_r + D_s^T s_s + D_t^T gt (+ mass * x)
    float dti[kDRegs ? N1 : 1], dtj[kDRegs ? N1 : 1];  // D-hat(m, i), (m, j)
    float gt[N1];
#pragma unroll
    for (int m = 0; m < N1; ++m) {
      gt[m] = sm.t[le][m * NC + col];
      if constexpr (kDRegs) {
        dti[m] = sm.d[m * N1 + i];
        dtj[m] = sm.d[m * N1 + j];
      }
    }
    auto d_ti = [&](int m) -> float {
      if constexpr (kDRegs) return dti[m];
      else return sm.d[m * N1 + i];
    };
    auto d_tj = [&](int m) -> float {
      if constexpr (kDRegs) return dtj[m];
      else return sm.d[m * N1 + j];
    };
#pragma unroll (kUnrollK)
    for (int k = 0; k < N1; ++k) {
      const float* slab_r = sm.r[le] + k * NC;
      const float* slab_s = sm.s[le] + k * NC;
      float yv = 0.f;
      if constexpr (SRC == kTrilinear) {
        if (helmholtz) {
          // mass = lam1 gwj, gwj = (1/8)^3 w3 det(J~), recomputed here
          // rather than held in registers through the forward pass; x is
          // still in s_x
          float c0[3], c1[3];
          jacobian_at(ct, cc.xi[k], c0, c1);
          float mass =
              w3[k * NC + col] * 0.001953125f * det_j(c0, c1, ct.c2);
          if (lam1 != nullptr) mass *= load(lam1 + node0 + k * NC);
          yv = mass * sm.x[le][k * NC + col];
        }
      }
      yv = row_fma<N1>(slab_r + j * N1, d_ti, yv);
#pragma unroll
      for (int m = 0; m < N1; ++m) {
        yv = fmaf(d_tj(m), slab_s[m * N1 + i], yv);
        yv = fmaf(cc.d[m * N1 + k], gt[m], yv);
      }
      if (live) store(y + base + k * NC, yv);
    }
    // the next column's first barrier orders these reads of s_r and s_s
    // before that column's writes to them (of s_x a thread reads back only
    // its own nodes)
  }
}

template <int N1, GeomSource SRC, typename T>
int launch_n1(const T* x, T* y, const T* verts, const T* lam0, const T* lam1,
              const float* w3, const float* consts, int n_elem, int ncols,
              int helmholtz, int elems_per_block_given, int grid,
              cudaStream_t s) {
  constexpr int EPB = elems_per_block<N1>();
  // the wrapper's launch arithmetic must be this instantiation's
  if (elems_per_block_given != EPB || grid != (n_elem + EPB - 1) / EPB) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ColumnConsts<N1> cc;
  std::memcpy(&cc, consts, sizeof cc);
  cudaError_t opted;
  const size_t smem = opt_in_smem<ColumnShared<N1>>(
      axhelm_column_kernel<N1, SRC, T>, opted);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  axhelm_column_kernel<N1, SRC, T><<<grid, column_threads<N1>(), smem, s>>>(
      x, y, verts, lam0, lam1, w3, cc, n_elem, ncols, helmholtz);
  return static_cast<int>(cudaGetLastError());
}

// The instantiations of one N1: declared here (extern) where another part
// compiles them, defined in that part.
#define AXHELM_COLUMN_ARGS(T)                                                 \
  const T*, T*, const T*, const T*, const T*, const float*, const float*,    \
      int, int, int, int, int, cudaStream_t
#define AXHELM_COLUMN_N1(PREFIX, N1)                                          \
  PREFIX template int launch_n1<N1, kTrilinear, float>(                      \
      AXHELM_COLUMN_ARGS(float));                                             \
  PREFIX template int launch_n1<N1, kPartial, float>(                        \
      AXHELM_COLUMN_ARGS(float));                                             \
  PREFIX template int launch_n1<N1, kTrilinear, __nv_bfloat16>(              \
      AXHELM_COLUMN_ARGS(__nv_bfloat16));                                     \
  PREFIX template int launch_n1<N1, kPartial, __nv_bfloat16>(                \
      AXHELM_COLUMN_ARGS(__nv_bfloat16));
#define AXHELM_COLUMN_EXTERN(N1) AXHELM_COLUMN_N1(extern, N1)
#define AXHELM_COLUMN_DEFINE(N1) AXHELM_COLUMN_N1(, N1)

#if AXHELM_PART == 0
AXHELM_COLUMN_PART1(AXHELM_COLUMN_EXTERN)
AXHELM_COLUMN_PART2(AXHELM_COLUMN_EXTERN)
AXHELM_COLUMN_PART3(AXHELM_COLUMN_EXTERN)
AXHELM_COLUMN_PART4(AXHELM_COLUMN_EXTERN)
#elif AXHELM_PART == 1
AXHELM_COLUMN_PART1(AXHELM_COLUMN_DEFINE)
#elif AXHELM_PART == 2
AXHELM_COLUMN_PART2(AXHELM_COLUMN_DEFINE)
#elif AXHELM_PART == 3
AXHELM_COLUMN_PART3(AXHELM_COLUMN_DEFINE)
#elif AXHELM_PART == 4
AXHELM_COLUMN_PART4(AXHELM_COLUMN_DEFINE)
#else
#error "axhelm_column.cu has parts 0 to 4"
#endif

#if AXHELM_PART == 0
template <GeomSource SRC, typename T>
int launch_column(const T* x, T* y, const T* verts, const T* lam0,
                  const T* lam1, const float* w3, const float* consts, int n1,
                  int n_elem, int ncols, int helmholtz, int elems_per_block,
                  int grid, void* stream) {
  if (n_elem <= 0 || ncols <= 0 || consts == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AXHELM_COLUMN_CASE(N1)                                                \
  case N1:                                                                    \
    return launch_n1<N1, SRC, T>(x, y, verts, lam0, lam1, w3, consts,         \
                                 n_elem, ncols, helmholtz, elems_per_block,   \
                                 grid, s);
  switch (n1) {
    AXHELM_COLUMN_PART0(AXHELM_COLUMN_CASE)
    AXHELM_COLUMN_PART1(AXHELM_COLUMN_CASE)
    AXHELM_COLUMN_PART2(AXHELM_COLUMN_CASE)
    AXHELM_COLUMN_PART3(AXHELM_COLUMN_CASE)
    AXHELM_COLUMN_PART4(AXHELM_COLUMN_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef AXHELM_COLUMN_CASE
}
#endif

}  // namespace column_body

#if AXHELM_PART == 0
// The K2 and K5 entry points for storage type T.  trilinear takes w3 on the
// device; partial is Poisson always (gscale must be given).  consts is the
// host pointer to D-hat and xi; elems_per_block and grid are the wrapper's
// (ops.column_launch), checked against this build.
#define AXHELM_COLUMN_ENTRY_POINTS(T, SUFFIX)                                 \
  extern "C" int axhelm_trilinear_##SUFFIX(                                   \
      const T* x, T* y, const T* verts, const T* lam0, const T* lam1,        \
      const float* w3, const float* consts, int n1, int n_elem, int ncols,    \
      int helmholtz, int elems_per_block, int grid, void* stream) {           \
    if (w3 == nullptr) return static_cast<int>(cudaErrorInvalidValue);        \
    return column_body::launch_column<axhelm_detail::kTrilinear, T>(          \
        x, y, verts, lam0, lam1, w3, consts, n1, n_elem, ncols, helmholtz,    \
        elems_per_block, grid, stream);                                       \
  }                                                                           \
  extern "C" int axhelm_partial_##SUFFIX(                                     \
      const T* x, T* y, const T* verts, const T* gscale, const float* consts, \
      int n1, int n_elem, int ncols, int elems_per_block, int grid,           \
      void* stream) {                                                         \
    if (gscale == nullptr) return static_cast<int>(cudaErrorInvalidValue);    \
    return column_body::launch_column<axhelm_detail::kPartial, T>(            \
        x, y, verts, gscale, nullptr, nullptr, consts, n1, n_elem, ncols, 0,  \
        elems_per_block, grid, stream);                                       \
  }

AXHELM_COLUMN_ENTRY_POINTS(float, f32)
AXHELM_COLUMN_ENTRY_POINTS(__nv_bfloat16, bf16)
#endif
