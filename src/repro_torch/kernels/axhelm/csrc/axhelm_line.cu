// axhelm_line.cu -- the one-thread-per-line body of the axhelm kernels K1, K3
// and K4 for Hopper (sm_90a), with a plain C interface (bound from Python
// with ctypes: kernels/axhelm/build.py, ops.py).
//
// Replaces the TPU kernel repro/kernels/axhelm/kernel.py::_kernel (the body of
// the one pl.pallas_call, kernel.py:233) in three of its variants, for both
// storage types (entry points *_f32 and *_bf16), at every N1 from 2 to 16
// (orders 1 to 15; ops.N1_TUNED_MAX; the generic body of axhelm.cu runs N1
// 17 to 24):
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
// axhelm.cu (its timing-only *_rowwise entry points, N1 = 4 and 8) and, at
// N1 up to 16, the generic body (the timing-only *_any entry points there).
//
// What bounds it on the H100 (chip_smoke.py::axhelm_bound; E = 4096, N1 = 8,
// one column, fp32): K1 moves x and y and its 6 factor planes (7 for
// Helmholtz), 8 N1^3 words an element for Poisson: bound by bytes, 20.0 us
// (bf16 10.0 us).  K3 moves x and y and 7 words an element: bound by bytes,
// 5.04 us.  K4 adds Lam2, Lam3 and 24 vertex words an element and ~66 FLOPs a
// node of geometry: bound by bytes, 10.1 us.  With bf16 storage both are
// operation-bound (3.47 and 5.88 us).  The contraction's 12 N1 FLOPs a node
// grow with N1: above N1 = 8 only K1 stays bound by bytes.  What held the
// one-thread-per-node body to 36-48 us, and the column body near its
// shared-memory floor of ~10.7 us, is shared memory: every value a contraction
// reads passes through it N1 times.  Here each passes once per direction; what
// remains is instruction issue (48 FFMA a node, and the loads, stores and
// factors) and the DRAM bytes, floors of about the same size.
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
//     thread reads its column's N1 values into registers once, coalesced
//     (up to N1 = 8; above, where registers are short, it reads each where
//     it is used, as K1 reads its factors).
//     Read from the parameter instead, with an index that differs across a
//     warp, they serialised on the constant cache: K3 took 14.95 us at E =
//     4096 that way, 11.12 us this way (PERF.md).
//   * Per element column and stage, four barriers: at the top, once the
//     stage's x is in shared memory, and after each of (A) the lines compute
//     D_r x and D_s x into s_r and s_s, the owner D_t x in registers; (B) the
//     owner reads its r and s components, applies the factors, writes the
//     weighted r and s components back in place and accumulates D_t^T of the
//     weighted t component and the mass term in registers; (C) the lines apply
//     D_r^T and D_s^T in place.  Then (D) the owner adds the three and stores
//     y, coalesced.  Above N1 = 8 the owner keeps its column's t components in
//     shared memory (s_t) instead of registers: (A) writes D_t x there, (B)
//     walks k rolled and writes the weighted t component back, and (D) applies
//     D_t^T to its own column and adds the mass term, recomputed (unrolled
//     over k, (B) spilled in every instantiation from N1 = 9: with registers
//     indexed by k it cannot stay rolled).  K4's geometry is the column body's
//     hoisted Alg. 3 (axhelm_common.cuh): each thread reads the 24 vertex
//     words of its element into registers at the start of a group (broadcast
//     loads), forms the edge differences and its column's terms, then per node
//     jacobian_at, K and adj(K).  K3's is its 7 words, read the same way and
//     folded into a scale of x_r, x_s, x_t per node.  K1's are its factor
//     planes, (E, 7, N1^3): the element's six G planes are one contiguous span
//     of 6 N1^3 values (12 KB at N1 = 8 in fp32), gwj after them, read only
//     for Helmholtz.  At (B) the owner loads its node's six (seven) factors
//     straight from device memory at fixed k, 32 consecutive words a warp a
//     plane, their latency hidden by the other resident warps.  It loads them
//     again for each column of the element: from the second column on they may
//     come from the cache, not from DRAM.  One 1-D bulk copy an element of its
//     planes into a shared buffer a group ahead (TMA) was slower on the H100
//     (scripts/line_staging_sweep.py holds it; PERF.md).
//   * Staging one stage ahead: persistent blocks (the grid is at most the
//     SMs times the resident blocks, ops.line_launch) walk over groups of
//     elements; a stage is one column of a group's elements (and, with the
//     group's first column, K4's Lam2 and Lam3 up to N1 = 8; above, the
//     owner reads them from device memory at (B), as K1 reads its factors,
//     where the registers that would hold them are short).  Each thread
//     loads its share of the next stage into registers as vectors (Stager)
//     while the current one computes, and stores it to the second buffer at
//     the top of the next stage.  A vector is the widest of 16, 8, 4 bytes
//     and one value that divides a thread's N1 values, and so an element's
//     N1^3 (stage_vec_bytes): 16 bytes at N1 = 4 (fp32) and 8, one value at
//     odd N1, where an element's span of N1^3 values starts wherever the
//     element before ended.  The wrapper raises for an x (and a staged Lam2
//     or Lam3) not aligned to it (ops.staged_alignment), and the entry point
//     refuses it.  Staging
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
//     ways in fp32).  At odd N1 the s lines take k'' = 2q mod N1 (2q mod N1
//     + 2q / N1 at even N1 is no permutation there).  The ways of the worst
//     phase of each access at every N1, over every warp of a block, with
//     the same 16-byte pad (tests/test_torch_axhelm_line.py holds the model:
//     a 16-byte access runs in phases of 8 lanes, an 8-byte one of 16, a
//     phase takes as many wavefronts as the most distinct words in one
//     bank): "stager" its stores, "x row" and "x s" the r and s lines'
//     reads of x, "x col" the owner's, "p row", "p s" and "p col" the same
//     on s_r and s_s (fp32 in both storage types).  No pad frees all of them
//     at once: a search of the slab pads of x and of s_r, s_s and of the s
//     lines' order lowers the sum of the ways by a third at best (N1 = 10,
//     12, 14), one of element pads by a tenth but at N1 = 2; neither is
//     done here.
//       fp32 N1:  2  3  4  5  6  7  8  9 10 11 12 13 14 15 16
//       stager:   2  2  2  2  2  3  2  2  3  2  2  3  2  2  4
//       x row:    2  2  2  2  3  3  1  3  3  2  2  3  4  3  1
//       x s:      4  3  1  2  2  2  1  2  3  2  2  2  2  3  2
//       x col:    4  2  1  2  2  2  1  2  2  1  1  1  1  1  1
//       p row:    2  2  2  2  3  3  1  3  3  2  2  3  4  3  1
//       p s:      4  3  1  2  2  2  1  2  3  2  2  2  2  3  2
//       p col:    4  2  1  2  2  2  1  2  2  1  1  1  1  1  1
//       bf16 N1:  2  3  4  5  6  7  8  9 10 11 12 13 14 15 16
//       stager:   1  3  2  3  2  4  1  2  3  5  2  4  2  3  2
//       x row:    1  3  2  3  2  5  1  3  2  3  2  3  2  3  1
//       x s:      1  2  1  4  2  2  1  2  2  4  1  2  1  2  2
//       x col:    1  1  1  1  2  1  1  1  1  1  1  1  1  1  1
//     (bf16's p rows are fp32's.)
//   * N1^2 threads an element, several elements a block (line_elems): at N1 =
//     4 and 8, 64 threads (4 and 1 elements) and at most 128 registers a
//     thread (__launch_bounds__ with 8 blocks an SM); measured on the H100
//     beside 128-thread blocks and 10 or 12 blocks an SM, this was the fastest
//     setting at which K4 does not spill (PERF.md).  At every other N1 the
//     elements a block leave few lanes of the last warp idle (7 elements of 36
//     threads at N1 = 6: 252 of 256 lanes), one element from N1 = 11.  Up to
//     N1 = 10 the lines' N1 x N1 products are unrolled, D-hat a constant-bank
//     operand of each FFMA, and an SM holds blocks for 16 warps (at most about
//     128 registers).  Above, unrolled products need 150-255 registers: K3
//     keeps them, with one block an SM promised (up to 255 registers), since
//     its lines are most of its work; K1 from N1 = 12 and K4 from 11 roll them
//     over n (rolled_product: one constant load a FFMA, 66-106 registers, 16
//     warps an SM), which measured 1.2-1.7x faster for them and 1.4-1.7x
//     slower for K3 (line_roll_from, line_min_blocks).  Wherever N1 is not 4
//     or 8 the persistent grid takes as many blocks an SM as the card holds at
//     once (axhelm_line_blocks_per_sm, the occupancy calculator), not the one
//     __launch_bounds__ promises.  Up to N1 = 8, K3's w3 column is held in
//     registers and K4's Lam2 and Lam3 staged; above, both are read where they
//     are used.  Shared memory (LineShared) above 48 KB is the launch's
//     dynamic shared memory (block_shared).  The threads of absent elements in
//     the ragged last group compute on the last element's data, reach every
//     barrier and store nothing.
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
//   x, y   (E, ncols, N1^3) in T, node index i + N1*j + N1^2*k; x aligned
//          to stage_vec_bytes
//   gelem  (E, 7) in T (parallelepiped): [adjK/det x6, det], unweighted
//   verts  (E, 8, 3) in T (merged), vertex = br + 2*bs + 4*bt
//   lam0, lam1  (E, N1^3) in T or null (merged: Lam2, Lam3, both given and,
//          up to N1 = 8, aligned to stage_vec_bytes)
//   w3 (N1^3) fp32 on the device (parallelepiped only)
//   consts (N1^2 + N1) fp32 on the host: D-hat row-major, then xi
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).
//
// Build: this file is compiled once for each part, -DAXHELM_PART=p
// (build.PARTS), every part at the same time.  Part p instantiates the N1 of
// AXHELM_LINE_PART<p>; part 0 also holds the entry points, which reach the
// other parts' instantiations through the linker (extern template).

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "axhelm_common.cuh"

#ifndef AXHELM_PART
#define AXHELM_PART 0
#endif

// The N1 of each part: about the same unrolled code in each.
#define AXHELM_LINE_PART0(X) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10)
#define AXHELM_LINE_PART1(X) X(11) X(12)
#define AXHELM_LINE_PART2(X) X(13) X(14)
#define AXHELM_LINE_PART3(X) X(15)
#define AXHELM_LINE_PART4(X) X(16)

namespace line_body {

using namespace axhelm_detail;

// At N1 = 4 and 8: threads a block (ops.LINE_THREADS) and blocks an SM
// (ops.LINE_BLOCKS_PER_SM).
constexpr int kLineThreads = 64;
constexpr int kLineMinBlocks = 8;
constexpr int kStages = 2;  // x buffers: a stage is fetched kStages-1 ahead
// Up to this N1, K3's w3 in registers and K4's Lam2, Lam3 staged.
constexpr int kLineHoldMax = 8;
// From this N1, one block an SM where the lines stay unrolled (registers).
constexpr int kLineOneBlockFrom = 11;

// From which N1 a variant's lines roll their products over n
// (ops.LINE_ROLL_FROM): K1 from 12 and K4 from 11, where unrolled they need
// 150-255 registers and the card holds one or two blocks an SM; K3 never,
// whose lines are most of its work (measured on the H100 beside the
// unrolled products at N1 = 9-16: PERF.md).
__host__ __device__ constexpr int line_roll_from(GeomSource src) {
  return src == kPrecomputed ? 12 : src == kMerged ? 11 : 17;
}

// Elements a block (ops.LINE_ELEMS): at N1 = 4 and 8, kLineThreads / N1^2.
__host__ __device__ constexpr int line_elems(int n1) {
  constexpr int elems[17] = {0, 0, 16, 7, 0, 5, 7, 5, 0,
                             3, 2, 1, 1, 1, 1, 1, 1};
  return n1 == 4 || n1 == 8 ? kLineThreads / (n1 * n1) : elems[n1];
}

template <int N1>
__host__ __device__ constexpr int line_elems_per_block() {
  return line_elems(N1);
}

template <int N1>
__host__ __device__ constexpr int line_threads() {
  return line_elems_per_block<N1>() * N1 * N1;
}

// Blocks an SM for __launch_bounds__ (ops.line_min_blocks): at N1 = 4 and 8
// kLineMinBlocks, also the persistent grid's; one where the lines' products
// stay unrolled from kLineOneBlockFrom (K1 at 11, K3 from 11), so that a
// thread may take up to 255 registers: at about 128 (two blocks of 121-256
// threads) those products spilled; elsewhere as many as give 16 warps (the
// rolled products take 66-106 registers).  At every N1 but 4 and 8 the
// persistent grid takes as many blocks an SM as the card holds at once
// (blocks_n1, the occupancy calculator).
template <int N1, GeomSource SRC>
__host__ __device__ constexpr int line_min_blocks() {
  constexpr int warps = (line_threads<N1>() + 31) / 32;
  constexpr bool unrolled_wide =
      N1 >= kLineOneBlockFrom && N1 < line_roll_from(SRC);
  return N1 == 4 || N1 == 8 ? kLineMinBlocks
         : unrolled_wide    ? 1
                            : (warps >= 16 ? 1 : 16 / warps);
}

// Bytes of the Stager's vectors (ops.staged_alignment): the widest of 16, 8,
// 4 and one value that divides a thread's N1 values, and so an element's
// N1^3 (N1^2 such runs) too.
template <int N1, typename T>
__host__ __device__ constexpr int stage_vec_bytes() {
  constexpr int row = N1 * static_cast<int>(sizeof(T));
  return row % 16 == 0 ? 16
         : row % 8 == 0 ? 8
         : row % 4 == 0 ? 4
                        : static_cast<int>(sizeof(T));
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
  // K4's Lam2 and Lam3, staged per group up to kLineHoldMax, kStages buffers
  static constexpr bool STAGES_LAM = SRC == kMerged && N1 <= kLineHoldMax;
  static constexpr int LAM_BUFS = STAGES_LAM ? kStages : 1;
  static constexpr int LAM_NODES = STAGES_LAM ? NP : 1;
  // the t components in shared memory above kLineHoldMax (else registers)
  static constexpr int T_NODES = N1 > kLineHoldMax ? N1 * SP : 1;
  alignas(16) T x[kStages][EPB][N1 * SX];  // x, a stage's column
  alignas(16) float r[EPB][N1 * SP];  // r components, then D_r^T of them
  alignas(16) float s[EPB][N1 * SP];  // s components, then D_s^T of them
  alignas(16) T lam[LAM_BUFS][EPB][2][LAM_NODES];
  alignas(16) float t[EPB][T_NODES];  // D_t x, then the weighted t component
};

// N1 contiguous values from shared memory, widened to fp32: as float4 where
// N1 % 4 == 0, float2 where N1 is even, else one value a load.
template <int N1>
__device__ __forceinline__ void load_row(const float* p, float* v) {
  if constexpr (N1 % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N1 / 4; ++q) {
      const float4 u = reinterpret_cast<const float4*>(p)[q];
      v[4 * q + 0] = u.x;
      v[4 * q + 1] = u.y;
      v[4 * q + 2] = u.z;
      v[4 * q + 3] = u.w;
    }
  } else if constexpr (N1 % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N1 / 2; ++q) {
      const float2 u = reinterpret_cast<const float2*>(p)[q];
      v[2 * q + 0] = u.x;
      v[2 * q + 1] = u.y;
    }
  } else {
#pragma unroll
    for (int m = 0; m < N1; ++m) v[m] = p[m];
  }
}

// Two bf16 values of a 32-bit word (the first in the low half): exact, the
// 16 bits move to the top of an fp32 word.
__device__ __forceinline__ void widen2(uint32_t w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

// bf16: 16-byte vectors where N1 % 8 == 0, 8-byte where N1 % 4 == 0, 4-byte
// where N1 is even, else one value a load.
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
  } else if constexpr (N1 % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N1 / 4; ++q) {
      const uint2 u = reinterpret_cast<const uint2*>(p)[q];
      widen2(u.x, v + 4 * q);
      widen2(u.y, v + 4 * q + 2);
    }
  } else if constexpr (N1 % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N1 / 2; ++q) {
      widen2(reinterpret_cast<const uint32_t*>(p)[q], v + 2 * q);
    }
  } else {
#pragma unroll
    for (int m = 0; m < N1; ++m) v[m] = load(p + m);
  }
}

template <int N1>
__device__ __forceinline__ void store_row(float* p, const float* o) {
  if constexpr (N1 % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N1 / 4; ++q) {
      reinterpret_cast<float4*>(p)[q] =
          make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
    }
  } else if constexpr (N1 % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N1 / 2; ++q) {
      reinterpret_cast<float2*>(p)[q] = make_float2(o[2 * q], o[2 * q + 1]);
    }
  } else {
#pragma unroll
    for (int m = 0; m < N1; ++m) p[m] = o[m];
  }
}

// A line's product, rolled over its outputs n (line_roll_from): out(n,
// sum_m D(n, m) v[m]), or D(m, n) for the transpose, one n at a time, with
// D-hat from the parameter by the warp-uniform index, one load a value;
// only v and one sum in registers.
template <int N1, bool kTransposed, typename Out>
__device__ __forceinline__ void rolled_product(const LineConsts<N1>& cc,
                                               const float* v, Out out) {
#pragma unroll 2
  for (int n = 0; n < N1; ++n) {
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < N1; ++m) {
      acc = fmaf(cc.d[kTransposed ? m * N1 + n : n * N1 + m], v[m], acc);
    }
    out(n, acc);
  }
}

// The vector type of `bytes` bytes.
template <int bytes>
using VecOf = typename std::conditional<
    bytes == 16, uint4,
    typename std::conditional<
        bytes == 8, uint2,
        typename std::conditional<bytes == 4, uint32_t,
                                  uint16_t>::type>::type>::type;

// How a stage (one column of a group's elements: x, and at the group's first
// column K4's Lam2 and Lam3) reaches shared memory.  At the top of each stage
// the kernel calls land() for it, then fetch() for the stage kStages - 1
// ahead, then __syncthreads().  Here fetch() loads a thread's share of the
// next stage into registers, land() stores it to the stage's buffers: each
// thread moves N1 consecutive values of each array, the values of thread t
// of an element at t N1 .. t N1 + N1 - 1, as vectors of stage_vec_bytes,
// coalesced.  They lie within one k-slab, at offset t N1 % N1^2 in slab
// t N1 / N1^2.
template <int N1, GeomSource SRC, typename T>
struct Stager {
  static_assert(kStages == 2, "registers hold one stage ahead");
  using Smem = LineShared<N1, SRC, T>;
  static constexpr int NC = N1 * N1, NP = Smem::NP, EPB = Smem::EPB;
  static constexpr int kBytes = N1 * static_cast<int>(sizeof(T));
  using Vec = VecOf<stage_vec_bytes<N1, T>()>;
  static constexpr int kVecs = kBytes / static_cast<int>(sizeof(Vec));
  static constexpr int kLamVecs = Smem::STAGES_LAM ? kVecs : 1;
  Vec xv[kVecs];         // the next stage's x
  Vec lv[2][kLamVecs];   // K4: its Lam2 and Lam3

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
    if constexpr (Smem::STAGES_LAM) {
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
    if constexpr (Smem::STAGES_LAM) {
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
__global__ void __launch_bounds__(line_threads<N1>(),
                                  line_min_blocks<N1, SRC>())
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
  using Smem = LineShared<N1, SRC, T>;
  constexpr int NC = N1 * N1;  // threads (node columns) an element
  constexpr int NP = Smem::NP;
  constexpr int EPB = Smem::EPB;
  constexpr int SX = Smem::SX, SP = Smem::SP;
  constexpr bool kHolds = N1 <= kLineHoldMax;
  // Above kLineHoldMax the owner keeps its column's t components in shared
  // memory (s_t) rather than registers, so that (B) walks k rolled, with no
  // register array indexed by k: unrolled there, every instantiation spilled.
  constexpr bool kRoll = N1 >= line_roll_from(SRC);
  static_assert(!kRoll || !kHolds, "rolled lines keep x_t in s_t");
  static_assert(EPB >= 1, "one block holds a whole element");
  Smem& sm = block_shared<Smem>();

  const int le = threadIdx.x / NC;  // element within the block
  const int t = threadIdx.x % NC;   // node column (i, j), t = i + N1 j
  const int i = t % N1, j = t / N1;
  const int rj = t / N1, rk = t % N1;  // r line (., rj, rk)
  const int si = t % N1;               // s line (si, ., sk)
  const int sk = N1 % 2 == 0 ? (2 * (t / N1)) % N1 + (2 * (t / N1)) / N1
                             : (2 * (t / N1)) % N1;
  const int n_groups = (n_elem + EPB - 1) / EPB;

  Stager<N1, SRC, T> stager;
  stager.init(sm);
  __syncthreads();

  float w[kHolds ? N1 : 1];  // K3: w3 along this thread's node column
  if constexpr (SRC == kParallelepiped && kHolds) {
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
      float* pt = sm.t[le];

      // (A) grad: x_r on the r line, x_s on the s line, x_t on the column
      if constexpr (kRoll) {
        float v[N1];
        load_row<N1>(xs + rk * SX + rj * N1, v);
        rolled_product<N1, false>(cc, v, [&](int n, float s) {
          pr[rk * SP + rj * N1 + n] = s;
        });
#pragma unroll
        for (int m = 0; m < N1; ++m) v[m] = load(xs + sk * SX + m * N1 + si);
        rolled_product<N1, false>(cc, v, [&](int n, float s) {
          ps[sk * SP + n * N1 + si] = s;
        });
#pragma unroll
        for (int m = 0; m < N1; ++m) v[m] = load(xs + m * SX + t);
        rolled_product<N1, false>(cc, v, [&](int n, float s) {
          pt[n * SP + t] = s;
        });
      } else {
        {
          float v[N1], o[N1];
          load_row<N1>(xs + rk * SX + rj * N1, v);
#pragma unroll
          for (int n = 0; n < N1; ++n) {
            float acc = 0.f;
#pragma unroll
            for (int m = 0; m < N1; ++m) {
              acc = fmaf(cc.d[n * N1 + m], v[m], acc);
            }
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
            for (int m = 0; m < N1; ++m) {
              acc = fmaf(cc.d[n * N1 + m], v[m], acc);
            }
            ps[sk * SP + n * N1 + si] = acc;
          }
        }
      }
      float xt[kHolds ? N1 : 1];
      if constexpr (!kRoll) {
        {
          float v[N1];
#pragma unroll
          for (int m = 0; m < N1; ++m) v[m] = load(xs + m * SX + t);
#pragma unroll
          for (int n = 0; n < N1; ++n) {
            float acc = 0.f;
#pragma unroll
            for (int m = 0; m < N1; ++m) {
              acc = fmaf(cc.d[n * N1 + m], v[m], acc);
            }
            if constexpr (kHolds) {
              xt[n] = acc;
            } else {
              pt[n * SP + t] = acc;
            }
          }
        }
      }
      __syncthreads();

      // (B) the factors at each node of the column: the weighted r and s
      // components back in place, D_t^T of the t component and the mass
      // term into yv (above kLineHoldMax: the weighted t component back in
      // s_t, and both left to (D))
      float yv[kHolds ? N1 : 1];
#pragma unroll
      for (int n = 0; n < (kHolds ? N1 : 1); ++n) yv[n] = 0.f;
      // K1: the element's factor planes, plane p at fp[p NP]
      const T* fp = nullptr;
      if constexpr (SRC == kPrecomputed) fp = geom + ev * 7 * NP + t;
      // the node at k of this column (walked unrolled up to kLineHoldMax,
      // rolled above)
      auto factors_at = [&](int k) {
        const int o = k * SP + t;
        float gr = pr[o], gs = ps[o], gt;
        if constexpr (kHolds) {
          gt = xt[k];
        } else {
          gt = pt[o];
        }
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
          if constexpr (Smem::STAGES_LAM) {
            scale = load(&sm.lam[fbuf][le][0][k * NC + t]);
            mass = load(&sm.lam[fbuf][le][1][k * NC + t]);
          } else {
            const int64_t node = ev * NP + k * NC + t;
            scale = load(lam0 + node);
            mass = load(lam1 + node);
          }
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
          float wk;
          if constexpr (kHolds) {
            wk = w[k];
          } else {
            wk = w3[k * NC + t];
          }
          scale = wk;
          if (lam0 != nullptr) scale *= load(lam0 + node);
          if (helmholtz) {
            mass = ge[6] * wk;
            if (lam1 != nullptr) mass *= load(lam1 + node);
          }
        }
        gr *= scale;
        gs *= scale;
        gt *= scale;
        pr[o] = g00 * gr + g01 * gs + g02 * gt;
        ps[o] = g01 * gr + g11 * gs + g12 * gt;
        const float wt = g02 * gr + g12 * gs + g22 * gt;
        if constexpr (kHolds) {
#pragma unroll
          for (int n = 0; n < N1; ++n) {
            yv[n] = fmaf(cc.d[k * N1 + n], wt, yv[n]);
          }
          if (helmholtz) yv[k] = fmaf(mass, load(xs + k * SX + t), yv[k]);
        } else {
          pt[o] = wt;  // D_t^T and the mass term follow in (D)
        }
      };
      if constexpr (kHolds) {
#pragma unroll
        for (int k = 0; k < N1; ++k) factors_at(k);
      } else {
#pragma unroll 1
        for (int k = 0; k < N1; ++k) factors_at(k);
      }
      __syncthreads();

      // (C) D_r^T and D_s^T on the lines, in place
      if constexpr (kRoll) {
        float v[N1];
        load_row<N1>(pr + rk * SP + rj * N1, v);
        rolled_product<N1, true>(cc, v, [&](int n, float s) {
          pr[rk * SP + rj * N1 + n] = s;
        });
#pragma unroll
        for (int m = 0; m < N1; ++m) v[m] = ps[sk * SP + m * N1 + si];
        rolled_product<N1, true>(cc, v, [&](int n, float s) {
          ps[sk * SP + n * N1 + si] = s;
        });
      } else {
        {
          float v[N1], o[N1];
          load_row<N1>(pr + rk * SP + rj * N1, v);
#pragma unroll
          for (int n = 0; n < N1; ++n) {
            float acc = 0.f;
#pragma unroll
            for (int m = 0; m < N1; ++m) {
              acc = fmaf(cc.d[m * N1 + n], v[m], acc);
            }
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
            for (int m = 0; m < N1; ++m) {
              acc = fmaf(cc.d[m * N1 + n], v[m], acc);
            }
            ps[sk * SP + n * N1 + si] = acc;
          }
        }
      }
      __syncthreads();

      // (D) y = D_r^T + D_s^T + D_t^T (+ mass x), one coalesced store a k
      if constexpr (kHolds) {
        if (live) {
          T* out = y + (ev * ncols + c) * NP + t;
#pragma unroll
          for (int k = 0; k < N1; ++k) {
            store(out + k * NC, yv[k] + pr[k * SP + t] + ps[k * SP + t]);
          }
        }
      } else {
        // the owner's D_t^T of its column of s_t (its own values: no
        // barrier), and the mass term, recomputed
        float wt[N1];
#pragma unroll
        for (int m = 0; m < N1; ++m) wt[m] = pt[m * SP + t];
        T* out = y + (ev * ncols + c) * NP + t;
#pragma unroll 1
        for (int k = 0; k < N1; ++k) {
          float yk = pr[k * SP + t] + ps[k * SP + t];
#pragma unroll
          for (int m = 0; m < N1; ++m) yk = fmaf(cc.d[m * N1 + k], wt[m], yk);
          if (helmholtz) {
            const int64_t node = ev * NP + k * NC + t;
            float mass;
            if constexpr (SRC == kMerged) {
              mass = load(lam1 + node);  // Lam3
            } else if constexpr (SRC == kPrecomputed) {
              mass = load(fp + k * NC + 6 * NP);
              if (lam1 != nullptr) mass *= load(lam1 + node);
            } else {
              mass = ge[6] * w3[k * NC + t];
              if (lam1 != nullptr) mass *= load(lam1 + node);
            }
            yk = fmaf(mass, load(xs + k * SX + t), yk);
          }
          if (live) store(out + k * NC, yk);
        }
      }
    }
  }
}

inline bool misaligned(const void* p, int bytes) {
  return (reinterpret_cast<std::uintptr_t>(p) % bytes) != 0;
}

template <int N1, GeomSource SRC, typename T>
int launch_n1(const T* x, T* y, const T* geom, const T* lam0, const T* lam1,
              const float* w3, const float* consts, int n_elem, int ncols,
              int helmholtz, int elems_per_block_given, int grid,
              cudaStream_t s) {
  using Smem = LineShared<N1, SRC, T>;
  constexpr int EPB = line_elems_per_block<N1>();
  constexpr int kVec = stage_vec_bytes<N1, T>();
  // the wrapper's launch arithmetic must be this instantiation's; any grid
  // up to one block a group covers every element
  const int n_groups = (n_elem + EPB - 1) / EPB;
  if (elems_per_block_given != EPB || grid < 1 || grid > n_groups) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the Stager's vector loads' sources (the wrapper raises before this)
  if (misaligned(x, kVec) ||
      (Smem::STAGES_LAM && (misaligned(lam0, kVec) ||
                            misaligned(lam1, kVec)))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  LineConsts<N1> cc;
  std::memcpy(&cc, consts, sizeof cc);
  cudaError_t opted;
  const size_t smem =
      opt_in_smem<Smem>(axhelm_line_kernel<N1, SRC, T>, opted);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  axhelm_line_kernel<N1, SRC, T><<<grid, line_threads<N1>(), smem, s>>>(
      x, y, geom, lam0, lam1, w3, cc, n_elem, ncols, helmholtz);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of one instantiation an SM holds at once (the occupancy calculator,
// after the opt-in to its shared memory), or minus the CUDA error.
template <int N1, GeomSource SRC, typename T>
int blocks_n1() {
  cudaError_t err;
  const size_t smem = opt_in_smem<LineShared<N1, SRC, T>>(
      axhelm_line_kernel<N1, SRC, T>, err);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, axhelm_line_kernel<N1, SRC, T>, line_threads<N1>(), smem);
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// The instantiations of one N1: declared here (extern) where another part
// compiles them, defined in that part.
#define AXHELM_LINE_ARGS(T)                                                   \
  const T*, T*, const T*, const T*, const T*, const float*, const float*,    \
      int, int, int, int, int, cudaStream_t
#define AXHELM_LINE_N1_T(PREFIX, N1, T)                                       \
  PREFIX template int launch_n1<N1, kPrecomputed, T>(AXHELM_LINE_ARGS(T));   \
  PREFIX template int launch_n1<N1, kParallelepiped, T>(                     \
      AXHELM_LINE_ARGS(T));                                                   \
  PREFIX template int launch_n1<N1, kMerged, T>(AXHELM_LINE_ARGS(T));        \
  PREFIX template int blocks_n1<N1, kPrecomputed, T>();                      \
  PREFIX template int blocks_n1<N1, kParallelepiped, T>();                   \
  PREFIX template int blocks_n1<N1, kMerged, T>();
#define AXHELM_LINE_N1(PREFIX, N1)                                            \
  AXHELM_LINE_N1_T(PREFIX, N1, float)                                         \
  AXHELM_LINE_N1_T(PREFIX, N1, __nv_bfloat16)
#define AXHELM_LINE_EXTERN(N1) AXHELM_LINE_N1(extern, N1)
#define AXHELM_LINE_DEFINE(N1) AXHELM_LINE_N1(, N1)

#if AXHELM_PART == 0
AXHELM_LINE_PART1(AXHELM_LINE_EXTERN)
AXHELM_LINE_PART2(AXHELM_LINE_EXTERN)
AXHELM_LINE_PART3(AXHELM_LINE_EXTERN)
AXHELM_LINE_PART4(AXHELM_LINE_EXTERN)
#elif AXHELM_PART == 1
AXHELM_LINE_PART1(AXHELM_LINE_DEFINE)
#elif AXHELM_PART == 2
AXHELM_LINE_PART2(AXHELM_LINE_DEFINE)
#elif AXHELM_PART == 3
AXHELM_LINE_PART3(AXHELM_LINE_DEFINE)
#elif AXHELM_PART == 4
AXHELM_LINE_PART4(AXHELM_LINE_DEFINE)
#else
#error "axhelm_line.cu has parts 0 to 4"
#endif

#if AXHELM_PART == 0
template <GeomSource SRC, typename T>
int launch_line(const T* x, T* y, const T* geom, const T* lam0,
                const T* lam1, const float* w3, const float* consts, int n1,
                int n_elem, int ncols, int helmholtz, int elems_per_block,
                int grid, void* stream) {
  if (n_elem <= 0 || ncols <= 0 || consts == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AXHELM_LINE_CASE(N1)                                                  \
  case N1:                                                                    \
    return launch_n1<N1, SRC, T>(x, y, geom, lam0, lam1, w3, consts, n_elem,  \
                                 ncols, helmholtz, elems_per_block, grid, s);
  switch (n1) {
    AXHELM_LINE_PART0(AXHELM_LINE_CASE)
    AXHELM_LINE_PART1(AXHELM_LINE_CASE)
    AXHELM_LINE_PART2(AXHELM_LINE_CASE)
    AXHELM_LINE_PART3(AXHELM_LINE_CASE)
    AXHELM_LINE_PART4(AXHELM_LINE_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef AXHELM_LINE_CASE
}

template <GeomSource SRC, typename T>
int line_blocks(int n1) {
#define AXHELM_LINE_BLOCKS_CASE(N1) \
  case N1:                          \
    return blocks_n1<N1, SRC, T>();
  switch (n1) {
    AXHELM_LINE_PART0(AXHELM_LINE_BLOCKS_CASE)
    AXHELM_LINE_PART1(AXHELM_LINE_BLOCKS_CASE)
    AXHELM_LINE_PART2(AXHELM_LINE_BLOCKS_CASE)
    AXHELM_LINE_PART3(AXHELM_LINE_BLOCKS_CASE)
    AXHELM_LINE_PART4(AXHELM_LINE_BLOCKS_CASE)
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
#undef AXHELM_LINE_BLOCKS_CASE
}

template <GeomSource SRC>
int line_blocks(int bf16, int n1) {
  return bf16 ? line_blocks<SRC, __nv_bfloat16>(n1)
              : line_blocks<SRC, float>(n1);
}
#endif

}  // namespace line_body

#if AXHELM_PART == 0
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
    return line_body::launch_line<axhelm_detail::kPrecomputed, T>(            \
        x, y, geom, lam0, lam1, nullptr, consts, n1, n_elem, ncols,           \
        helmholtz, elems_per_block, grid, stream);                            \
  }                                                                           \
  extern "C" int axhelm_parallelepiped_##SUFFIX(                              \
      const T* x, T* y, const T* gelem, const T* lam0, const T* lam1,        \
      const float* w3, const float* consts, int n1, int n_elem, int ncols,    \
      int helmholtz, int elems_per_block, int grid, void* stream) {           \
    if (w3 == nullptr) return static_cast<int>(cudaErrorInvalidValue);        \
    return line_body::launch_line<axhelm_detail::kParallelepiped, T>(         \
        x, y, gelem, lam0, lam1, w3, consts, n1, n_elem, ncols, helmholtz,    \
        elems_per_block, grid, stream);                                       \
  }                                                                           \
  extern "C" int axhelm_merged_##SUFFIX(                                      \
      const T* x, T* y, const T* verts, const T* lam2, const T* lam3,        \
      const float* consts, int n1, int n_elem, int ncols,                     \
      int elems_per_block, int grid, void* stream) {                          \
    if (lam2 == nullptr || lam3 == nullptr) {                                 \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    }                                                                         \
    return line_body::launch_line<axhelm_detail::kMerged, T>(                 \
        x, y, verts, lam2, lam3, nullptr, consts, n1, n_elem, ncols, 1,       \
        elems_per_block, grid, stream);                                       \
  }

AXHELM_LINE_ENTRY_POINTS(float, f32)
AXHELM_LINE_ENTRY_POINTS(__nv_bfloat16, bf16)

// Blocks of the line body an SM holds at once for geometry source `src`
// (the GeomSource enum: 0 precomputed, 2 parallelepiped, 3 merged), storage
// bf16 (1) or fp32 (0), at n1, on the current device (ops._line_blocks:
// the persistent grid at N1 other than 4 and 8); minus the CUDA error.
extern "C" int axhelm_line_blocks_per_sm(int src, int bf16, int n1) {
  using namespace axhelm_detail;
  switch (src) {
    case kPrecomputed:
      return line_body::line_blocks<kPrecomputed>(bf16, n1);
    case kParallelepiped:
      return line_body::line_blocks<kParallelepiped>(bf16, n1);
    case kMerged:
      return line_body::line_blocks<kMerged>(bf16, n1);
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif
