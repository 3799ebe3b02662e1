// axhelm_staged.cu -- the axhelm element operator for the largest
// elements: every variant at N1 above ops.N1_PLANE_MAX (48), an
// application run as six launches that stage the sum-factorisation
// contractions through fp32 scratch in device memory and L2, each
// contraction on the tensor cores in 3xTF32 (sm_90a), with a plain C
// interface (bound from Python with ctypes).
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
// N1, and _apply_factors (:88) is pointwise.  One application is six
// launches on the given stream, over fp32 scratch S0, S1, S2 of E ncols
// N1^3 words each, and for Helmholtz M of E N1^3 words (allocated by the
// caller):
//   1-2. S0 = D_r x, S1 = D_s x                      (contract, MODE kGrad)
//   3.   the t gradient D_t x of a tile into shared memory, then per node
//        of the tile its factors and mass (node_factors, from the
//        element's geometry in shared memory), the weighted components
//        S0, S1, S2 = lam0 G (S0, S1, D_t x) and M = the mass
//                                         (axhelm_staged_grad_t_kernel)
//   4.   S0 = D_r^T S0, in place                        (contract, kFirst)
//   5.   S0 = S0 + D_s^T S1                        (contract, kAccumulate)
//   6.   y = S0 + D_t^T S2 (+ M x), rounded once to the storage type
//                                                        (contract, kLast)
// Only launch 3 depends on the geometry source.
//
// Every launch is the same product, out(b, p, q) = sum_m A(p, m) in(b, m,
// q) for each batch row b = e ncols + c: q runs over the N1^2 lines of the
// contracted axis (D_t: q = (j, i); D_s: q = (k, i); D_r: q = (k, j)), m
// along it, A = D-hat (kGrad) or its transpose.  A work item is kLines
// whole lines of one batch row (kNarrow above kWideMax, see below): its
// panel, the whole contracted axis of its lines (M = N1 rows padded to 16,
// K = N1 padded to 8, N = the lines), held in shared memory while the
// block makes every output of those lines.  The grid is persistent (the
// SMs times the blocks an SM the occupancy calculator allows, or fewer),
// each block walking items blockIdx.x, + gridDim.x, ...
//  * Products (step 1): mma.sync.m16n8k8 tf32 with fp32 accumulators, four
//    warps a block, each two m16 tiles (32 output rows) and half the lines
//    of the item (2 n8 tiles, 1 when narrow), so that every B fragment it
//    loads and splits feeds two tiles; a pass of 64 rows at a time over the
//    panel (ceil(N1 / 64) passes).  3xTF32: each operand is split once
//    into hi = tf32_rna(v) and lo = tf32_rna(v - hi), and each product sums
//    lo.hi + hi.lo + hi.hi in that order; the sum over m runs its k-steps
//    upward, nothing is atomic, so a launch repeats bitwise.  D-hat's split
//    is made once a basis by the caller (ops.staged_fragments: hi and lo of
//    D-hat and of its transpose, zero-padded, in the order of the mma's A
//    fragment, one 16-byte load a lane a half), read through L1 (loading
//    the next k-step's fragments ahead cost registers and blocks an SM, and
//    was slower at N1 = 49); the
//    panel's split is made as a fragment is loaded from shared memory (a
//    fragment feeds three products, and split at staging the panel would
//    take twice the shared memory).  At bf16 storage D-hat is rounded
//    to bf16 (ops._constants) and x is bf16, both exact in tf32, so their
//    lo halves are zero: the bf16 entry points skip lo.hi (and the lo
//    fragments' loads) in every launch and hi.lo in the gradients, one
//    product in the gradients and two in the transposed passes.
//  * Staging (step 2): a ring of kStages panel slots.  The next item's
//    panel is copied with cp.async (16 bytes a copy where N1 % 4 == 0 and
//    the operand is 16-byte aligned, 4 bytes else) before the current item
//    is multiplied, so its lines arrive while the products run.  A bf16 x
//    has no 4-byte unit at odd N1: its gradients load and widen it into the
//    slot (8-byte loads of four values where aligned).  The slots' K
//    padding (rows m >= N1) is zeroed once a block and never copied over;
//    lines past the last of a ragged item only feed outputs that are not
//    stored.  D_t and D_s panels are stored row by row (panel[m][line],
//    rows of kLines + 8 floats), D_r's, whose lines are contiguous along m,
//    line by line (panel[line][m], rows of N1 padded to 8, + 4): both give
//    the B fragment's loads distinct banks.
//  * Where it switches: a block holds two slots of a whole panel (4 (N1 +
//    7) / 8 * 8 (lines + 8) bytes each) and the epilogue tile.  At kWide =
//    32 lines an item two such blocks fit an SM (8 warps to hide the
//    fragment loads and the copies) up to N1 = kWideMax (328,
//    ops.N1_STAGED_WIDE_MAX); above it the item narrows to kNarrow = 16
//    lines, two blocks an SM up to N1 = 568 and one up to N1 = 1080 (with
//    the epilogue's operands).  The entry points stop at kStagedMax = 878
//    (ops.N1_STAGED_MAX), the range of the seven-launch body this one
//    replaced and the largest N1 its checks have run; the shared memory
//    is not what bounds it.  The panel is never stepped along m, so a block
//    has read all of an item's lines before it writes any of them, and no
//    other block reads them (the slot being filled holds other lines):
//    launch 4 may write its own operand at every N1, and the scratch stays
//    three fields.
//  * Epilogue (step 3): each pass's 64 x lines outputs go through a tile in
//    shared memory, then the block walks the tile's nodes with the
//    innermost index of global memory fastest (D_t, D_s: along the lines;
//    D_r: along p), so every access to the scratch is a coalesced 128-byte
//    one.  What an epilogue reads besides the products (S0 and S1 in the t
//    gradient, S0 in launch 5, S0 and for Helmholtz the mass and x in
//    launch 6) is copied at the pass's nodes into shared memory with
//    cp.async while the products run (extras_of), so a walk loads nothing
//    from the scratch: the compiler cannot tell the scratch fields apart,
//    and a load there would wait on the stores of the node before.  Launch
//    3's walk is the old pointwise pass on the tile, node by node (the
//    factors' own loads stay behind the previous node's stores: computing
//    them a node ahead, or every node's outputs into shared memory before
//    any store, was slower); its registers hold no accumulator there
//    (recomputing the mass in launch 6's epilogue made ptxas spill in the
//    old body; it is read from M).  With several columns, each column's
//    item recomputes its nodes' factors; column 0 writes the mass.
//
// What bounds it: 12 N1^4 products an element and column at the 3xTF32
// rate (495 / 3 TFLOP/s dense on the H100), the scratch traffic (about 18
// words a node and column through device memory and L2: x three times,
// S0 and S1 each written, read and written again in launch 3, read again in
// launches 4-5, S2 written and read, S0 read and written in 4-5, y; K1
// reads its six factor planes in launch 3) against 2 for x in and y out,
// and six launches, each ending in the tail of its persistent grid.  Step
// 1 moves the products from two FFMAs a shared-memory load to the tensor
// cores; step 2 overlaps an item's copies with the previous item's
// products; step 3 removes the pointwise launch (3 words a node read and
// written back) and keeps the fused walk's factor arithmetic out of the
// products' registers.
//
// Storage, layouts and the lambda slots are those of axhelm.cu's generic
// body (see its note): x, y (E, ncols, N1^3), geom per variant, lam0/lam1
// (E, N1^3) or null, xi (N1), w3 (N1^3), fp32 arithmetic, the scratch fp32,
// one rounding of y to the storage type; in the dhat slot the split
// fragments of ops.staged_fragments.  Offsets are int64 (E ncols N1^3
// passes 2^31 at N1 = 64 with E ncols >= 8192).  Every entry point launches
// on the given stream, allocates nothing, and returns the first launch
// error or cudaGetLastError() (0 on success).

#include <climits>
#include <cstdint>

#include "axhelm_common.cuh"

namespace {

using namespace axhelm_detail;

constexpr int kWarps = 4;
constexpr int kStagedThreads = 32 * kWarps;  // a block
constexpr int kTileP = 16 * kWarps;  // output rows a pass: 2 x 2 m16 tiles
constexpr int kWide = 32;            // lines an item up to kWideMax
constexpr int kNarrow = 16;          // lines an item above it
constexpr int kMaxN8 = kWide / 8;    // n8 tiles an item
constexpr int kStages = 2;           // panel slots in the ring
constexpr int kRowPad = 8;           // a row-major panel row: lines + 8
constexpr int kColPad = 4;           // a line-major panel row: K + 4
constexpr int kGeomWords = 32;       // the element's geometry words
constexpr int kFragFloats = 256;     // an (m16, k8) tile of A: hi, lo
constexpr int kMaxExtras = 3;        // operands of an epilogue in the tile
constexpr int kSmemPerBlock = 232448;
constexpr int kSmemPerSm = 233472;   // of which 1 KB a resident block
constexpr int kWideMax = 328;        // ops.N1_STAGED_WIDE_MAX
constexpr int kStagedMax = 878;      // ops.N1_STAGED_MAX

enum Dir : int { kDirR = 0, kDirS = 1, kDirT = 2 };
enum Mode : int { kGrad = 0, kFirst = 1, kAccumulate = 2, kLast = 3 };

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Floats of one panel slot: the larger of the row-major layout (K rows of
// lines + kRowPad) and the line-major one (lines rows of K + kColPad).
__host__ __device__ constexpr int slot_floats(int n1, int lines) {
  return round_up(n1, 8) * (lines + kRowPad) >
                 lines * (round_up(n1, 8) + kColPad)
             ? round_up(n1, 8) * (lines + kRowPad)
             : lines * (round_up(n1, 8) + kColPad);
}

// Floats of the epilogue tile: kTileP rows of lines + kRowPad (D_t, D_s),
// or lines rows of kTileP + kColPad (D_r).
__host__ __device__ constexpr int tile_floats(int lines) {
  return kTileP * (lines + kRowPad) > lines * (kTileP + kColPad)
             ? kTileP * (lines + kRowPad)
             : lines * (kTileP + kColPad);
}

// Dynamic shared memory of a block (ops.staged_smem_bytes): the ring, the
// epilogue tile, `extras` operands of the epilogue a pass (extras_of) and
// the element's geometry words.
constexpr size_t staged_smem_bytes(int n1, int lines, int extras = 0) {
  return sizeof(float) * (static_cast<size_t>(kStages) * slot_floats(n1, lines) +
                          tile_floats(lines) +
                          static_cast<size_t>(extras) * kTileP * (lines + kRowPad) +
                          kGeomWords);
}

// Lines an item at N1 (ops.staged_lines).
constexpr int staged_lines(int n1) { return n1 <= kWideMax ? kWide : kNarrow; }

static_assert(2 * (staged_smem_bytes(kWideMax, kWide) + 1024) <= kSmemPerSm &&
                  2 * (staged_smem_bytes(kWideMax + 1, kWide) + 1024) >
                      kSmemPerSm,
              "kWideMax is the largest N1 at which two wide blocks fit an SM");
static_assert(staged_lines(kStagedMax) == kNarrow &&
                  staged_smem_bytes(kStagedMax, kNarrow, kMaxExtras) <=
                      kSmemPerBlock,
              "a narrow block fits at kStagedMax");

// The operands of one application, by value in every launch.
template <typename T>
struct StagedArgs {
  const T* x;
  T* y;
  const T* geom;
  const T* lam0;
  const T* lam1;
  const float* frag;  // D-hat's split: A = D, then A = D^T (fragment order)
  const float* xi;
  const float* w3;
  float* s0;    // r component; after launch 4 the running sum of y
  float* s1;    // s component
  float* s2;    // t component
  float* mass;  // per node, Helmholtz only
  int n1, ncols;
  int rows;     // batch rows: E ncols
  int helmholtz;
  int lines;    // lines an item: kWide or kNarrow
  int vec_x;    // x may be staged 16 bytes (fp32) or 8 bytes (bf16) a copy
  int vec_s;    // the scratch may be staged 16 bytes a copy
};

// --- the PTX this body uses -------------------------------------------------

// v rounded to tf32 (10 mantissa bits), to nearest, ties away from zero,
// the low 13 bits zero: what cvt.rna.tf32.f32 gives for every finite v,
// in two integer instructions of the full rate (a conversion issues at a
// quarter of it, and every warp splits the panel values it reads).
__device__ __forceinline__ unsigned tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// acc += A (16 x 8, row) B (8 x 8, col) in tf32, fp32 accumulators:
// a = (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b = (row t,
// col g), (t + 4, g); acc = (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t +
// 1), with g = lane / 4 and t = lane % 4.
__device__ __forceinline__ void mma_tf32(float* acc, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(at),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(at),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Every group but the newest complete (this thread's copies).
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Every group complete (this thread's copies).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// --- staging ----------------------------------------------------------------

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

// One value (or, vec, four) of the operand into the slot: a cp.async from
// fp32, a load and a widening from bf16.
template <typename S>
__device__ __forceinline__ void stage_one(float* dst, const S* src, bool vec) {
  if constexpr (sizeof(S) == 4) {
    if (vec) {
      cp_async16(dst, src);
    } else {
      cp_async4(dst, src);
    }
  } else {
    if (vec) {
      const uint2 raw = *reinterpret_cast<const uint2*>(src);
      float4 v;
      v.x = __uint_as_float(raw.x << 16);
      v.y = __uint_as_float(raw.x & 0xffff0000u);
      v.z = __uint_as_float(raw.y << 16);
      v.w = __uint_as_float(raw.y & 0xffff0000u);
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      *dst = load(src);
    }
  }
}

// Copy rows [m0, m0 + count) of item (b, q0)'s nl lines along D_t or D_s
// (a row of m: the lines along q) into `dst`, rows of lines + kRowPad.
template <int DIR, typename S>
__device__ __forceinline__ void stage_rows(float* dst, const S* src,
                                           int64_t base, int q0, int nl,
                                           int m0, int count, int n1,
                                           int lines, bool vec) {
  static_assert(DIR != kDirR, "D_r's lines are staged line by line");
  const int tid = threadIdx.x;
  const int pitch = lines + kRowPad;
  const int width = vec ? 4 : 1;
  const int per_row = lines / width;  // copies a row; divides the block
  const int ql = (tid % per_row) * width;
  if (ql >= nl) return;  // nl is a multiple of 4 where vec
  const int64_t stride = axis_stride<DIR>(n1);
  const S* line = src + base + line_offset<DIR>(q0 + ql, n1) + m0 * stride;
  for (int m = tid / per_row; m < count; m += kStagedThreads / per_row) {
    stage_one(dst + m * pitch + ql, line + m * stride, vec);
  }
}

// Copy item (b, q0)'s panel, the whole contracted axis of its nl lines,
// into slot `dst`: D_r line by line (contiguous along m), D_t and D_s row by
// row.
template <int DIR, typename S>
__device__ __forceinline__ void stage_panel(float* dst, const S* src,
                                            int64_t base, int q0, int nl,
                                            int n1, int lines, bool vec) {
  if constexpr (DIR == kDirR) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int pitch = round_up(n1, 8) + kColPad;
    const int width = vec ? 4 : 1;
    for (int ql = warp; ql < nl; ql += kWarps) {
      const S* line = src + base + static_cast<int64_t>(q0 + ql) * n1;
      for (int m = lane * width; m < n1; m += 32 * width) {
        stage_one(dst + ql * pitch + m, line + m, vec);
      }
    }
  } else {
    stage_rows<DIR>(dst, src, base, q0, nl, 0, n1, n1, lines, vec);
  }
}

// The operands an epilogue reads besides the products, staged a pass at a
// time beside the tile: S0 and S1 (the t gradient), S0 (kAccumulate), S0
// and, for Helmholtz, the mass and x (kLast).
template <int DIR, int MODE>
__host__ __device__ constexpr int extras_of(int helmholtz) {
  return DIR == kDirT && MODE == kGrad
             ? 2
             : (MODE == kAccumulate ? 1 : (MODE == kLast ? 1 + 2 * helmholtz
                                                         : 0));
}

// --- the contraction --------------------------------------------------------

// The contraction of direction DIR in pass MODE, every item of the launch a
// block walks: kGrad reads x and writes component DIR (DIR = kDirT: the
// three weighted components and the mass, SRC the geometry source), the
// transposed passes read component DIR and write S0 (kFirst, in place), add
// into it (kAccumulate) or end in y (kLast).
template <int DIR, int MODE, GeomSource SRC, typename T>
__device__ __forceinline__ void contract_body(const StagedArgs<T>& a) {
  constexpr bool kTransposed = MODE != kGrad;
  constexpr bool kFactors = DIR == kDirT && MODE == kGrad;
  // a bf16 x is exact in tf32: its lo is zero
  constexpr bool kExactB = MODE == kGrad && sizeof(T) == 2;
  // so is D-hat at bf16 storage (rounded to bf16 by ops._constants)
  constexpr bool kExactA = sizeof(T) == 2;
  constexpr int NG = geometry_words<SRC>();
  extern __shared__ __align__(16) float smem[];
  const int n1 = a.n1, nc = n1 * n1, np = nc * n1;
  const int lines = a.lines;
  const int kp = round_up(n1, 8), k_steps = kp / 8;
  const int m_tiles = round_up(n1, 16) / 16;
  const int passes = (m_tiles + kWarps - 1) / kWarps;
  const int tiles = (nc + lines - 1) / lines;
  const int64_t items = static_cast<int64_t>(a.rows) * tiles;
  const int slot = slot_floats(n1, lines);
  const int row_pitch = lines + kRowPad, col_pitch = kp + kColPad;
  const int extras = extras_of<DIR, MODE>(a.helmholtz);
  float* ring = smem;
  float* tile = smem + kStages * slot;
  float* extra = tile + tile_floats(lines);  // extras x kTileP rows
  float* s_g = extra + extras * kTileP * row_pitch;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // the warp grid of a pass: 2 x 32 rows by 2 halves of the lines
  const int wm = warp >> 1, wn = warp & 1, half = lines / 16;
  const int64_t stride = axis_stride<DIR>(n1);
  float* comp = DIR == kDirR ? a.s0 : (DIR == kDirS ? a.s1 : a.s2);
  const bool vec = (MODE == kGrad ? a.vec_x : a.vec_s) != 0;
  const float4* frag =
      reinterpret_cast<const float4*>(a.frag) +
      (kTransposed ? static_cast<int64_t>(m_tiles) * k_steps * (kFragFloats / 4)
                   : 0);

  auto stage = [&](int64_t item, float* dst) {
    const int64_t b = item / tiles;
    const int q0 = static_cast<int>(item % tiles) * lines;
    const int nl = min(lines, nc - q0);
    if constexpr (MODE == kGrad) {
      stage_panel<DIR>(dst, a.x, b * np, q0, nl, n1, lines, vec);
    } else {
      stage_panel<DIR>(dst, static_cast<const float*>(comp), b * np, q0, nl,
                       n1, lines, vec);
    }
  };

  // the slots' K padding: zero for every item
  for (int i = tid; i < kStages * slot; i += kStagedThreads) ring[i] = 0.f;
  __syncthreads();
  int64_t item = blockIdx.x;
  if (item < items) stage(item, ring);
  cp_async_commit();
  for (int cur = 0; item < items; item += gridDim.x, cur ^= 1) {
    // the next item's lines arrive while this one's products run
    if (item + gridDim.x < items) stage(item + gridDim.x, ring + (cur ^ 1) * slot);
    cp_async_commit();
    cp_async_wait_prior();
    const int64_t b = item / tiles;
    const int q0 = static_cast<int>(item % tiles) * lines;
    const int nl = min(lines, nc - q0);
    const int64_t e = b / a.ncols, base = b * np;
    if constexpr (kFactors) {
      if (tid < NG) s_g[tid] = load(a.geom + e * NG + tid);
    }
    __syncthreads();
    const float* panel = ring + cur * slot;
    for (int pass = 0; pass < passes; ++pass) {
      const int p0 = pass * kTileP, rows = min(kTileP, n1 - p0);
      // the epilogue's operands at the pass's nodes, while the products run
      if constexpr (DIR != kDirR) {
        if (extras > 0) {
          stage_rows<DIR>(extra, a.s0, base, q0, nl, p0, rows, n1, lines,
                          a.vec_s != 0);
        }
        if constexpr (kFactors) {
          stage_rows<DIR>(extra + kTileP * row_pitch, a.s1, base, q0, nl, p0,
                          rows, n1, lines, a.vec_s != 0);
        }
        if constexpr (MODE == kLast) {
          if (a.helmholtz) {
            stage_rows<DIR>(extra + kTileP * row_pitch, a.mass, e * np, q0,
                            nl, p0, rows, n1, lines, a.vec_s != 0);
            stage_rows<DIR>(extra + 2 * kTileP * row_pitch, a.x, base, q0, nl,
                            p0, rows, n1, lines, a.vec_x != 0);
          }
        }
        cp_async_commit();
      }
      // products: this warp's two m16 tiles of the pass (rows 32 wm ..),
      // its half of the item's lines (n8 tiles wn * half ..)
      float acc[2][kMaxN8 / 2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < kMaxN8 / 2; ++j) {
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
        }
      }
      const int mt0 = pass * kWarps + 2 * wm;
      // (scripts/staged_phase_probe.py compiles the products out here)
      if (mt0 < m_tiles) {
        // the second tile of a ragged pass reads the first's fragments; its
        // rows lie past N1 and the walk skips them
        const int64_t frag_tile = static_cast<int64_t>(k_steps) * (kFragFloats / 4);
        const float4* fa0 = frag + mt0 * frag_tile + lane;
        const float4* fa1 = mt0 + 1 < m_tiles ? fa0 + frag_tile : fa0;
        for (int ks = 0; ks < k_steps; ++ks) {
          const int at_ks = ks * (kFragFloats / 4);
          const float4 hi0 = __ldg(fa0 + at_ks), hi1 = __ldg(fa1 + at_ks);
          float4 lo0 = make_float4(0.f, 0.f, 0.f, 0.f), lo1 = lo0;
          if constexpr (!kExactA) {
            lo0 = __ldg(fa0 + at_ks + 32);
            lo1 = __ldg(fa1 + at_ks + 32);
          }
          const unsigned ah[2][4] = {
              {__float_as_uint(hi0.x), __float_as_uint(hi0.y),
               __float_as_uint(hi0.z), __float_as_uint(hi0.w)},
              {__float_as_uint(hi1.x), __float_as_uint(hi1.y),
               __float_as_uint(hi1.z), __float_as_uint(hi1.w)}};
          const unsigned al[2][4] = {
              {__float_as_uint(lo0.x), __float_as_uint(lo0.y),
               __float_as_uint(lo0.z), __float_as_uint(lo0.w)},
              {__float_as_uint(lo1.x), __float_as_uint(lo1.y),
               __float_as_uint(lo1.z), __float_as_uint(lo1.w)}};
          const int k = ks * 8 + t4;
#pragma unroll
          for (int j = 0; j < kMaxN8 / 2; ++j) {
            if (j < half) {
              const int n = (wn * half + j) * 8 + g;
              const float b0 = DIR == kDirR ? panel[n * col_pitch + k]
                                            : panel[k * row_pitch + n];
              const float b1 = DIR == kDirR ? panel[n * col_pitch + k + 4]
                                            : panel[(k + 4) * row_pitch + n];
              const unsigned h0 = tf32_rna(b0), h1 = tf32_rna(b1);
              unsigned l0 = 0, l1 = 0;
              if constexpr (!kExactB) {
                l0 = tf32_rna(b0 - __uint_as_float(h0));
                l1 = tf32_rna(b1 - __uint_as_float(h1));
              }
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                if constexpr (!kExactA) mma_tf32(acc[i][j], al[i], h0, h1);
                if constexpr (!kExactB) mma_tf32(acc[i][j], ah[i], l0, l1);
                mma_tf32(acc[i][j], ah[i], h0, h1);
              }
            }
          }
        }
      }
      // the pass's outputs into the epilogue tile
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 32 * wm + 16 * i + g;
#pragma unroll
        for (int j = 0; j < kMaxN8 / 2; ++j) {
          if (j < half) {
            const int col = (wn * half + j) * 8 + 2 * t4;
            if constexpr (DIR == kDirR) {
              constexpr int tp = kTileP + kColPad;
              tile[col * tp + row] = acc[i][j][0];
              tile[(col + 1) * tp + row] = acc[i][j][1];
              tile[col * tp + row + 8] = acc[i][j][2];
              tile[(col + 1) * tp + row + 8] = acc[i][j][3];
            } else {
              *reinterpret_cast<float2*>(tile + row * row_pitch + col) =
                  make_float2(acc[i][j][0], acc[i][j][1]);
              *reinterpret_cast<float2*>(tile + (row + 8) * row_pitch + col) =
                  make_float2(acc[i][j][2], acc[i][j][3]);
            }
          }
        }
      }
      if (extras > 0) cp_async_wait_all();
      __syncthreads();
      // the walk: every output of the pass that exists, the innermost index
      // of global memory fastest (D_t, D_s: a warp along the lines; D_r:
      // along p); it reads only shared memory (and the t gradient the
      // factors' own operands), so its stores wait on no load
      if constexpr (DIR == kDirR) {
        const int pl = tid % kTileP;
        if (pl < rows) {
          for (int ql = tid / kTileP; ql < nl; ql += kStagedThreads / kTileP) {
            const int64_t at = base + static_cast<int64_t>(q0 + ql) * n1 + p0 + pl;
            const float v = tile[ql * (kTileP + kColPad) + pl];
            if constexpr (MODE == kGrad) {
              comp[at] = v;
            } else {
              a.s0[at] = v;  // kFirst, in place
            }
          }
        }
      } else {
        const int ql = tid % lines;
        if (ql < nl) {
          const int q = q0 + ql;
          const int64_t off = line_offset<DIR>(q, n1);
          const int step = kStagedThreads / lines;
          for (int pl = tid / lines; pl < rows; pl += step) {
            const int na = pl * row_pitch + ql;
            const int64_t node = off + (p0 + pl) * stride, at = base + node;
            const float v = tile[na];
            if constexpr (kFactors) {
              float mass;
              const Factors f = node_factors<SRC, T>(
                  a.geom, s_g, a.lam0, a.lam1, a.xi, a.w3, e, np,
                  static_cast<int>(node), q % n1, q / n1, p0 + pl,
                  a.helmholtz, mass);
              const float xr = extra[na];
              const float xs = extra[kTileP * row_pitch + na];
              a.s0[at] = f.g00 * xr + f.g01 * xs + f.g02 * v;
              a.s1[at] = f.g01 * xr + f.g11 * xs + f.g12 * v;
              a.s2[at] = f.g02 * xr + f.g12 * xs + f.g22 * v;
              if (a.helmholtz && b % a.ncols == 0) a.mass[e * np + node] = mass;
            } else if constexpr (MODE == kGrad) {
              comp[at] = v;
            } else if constexpr (MODE == kAccumulate) {
              a.s0[at] = extra[na] + v;
            } else {  // kLast
              float yv = extra[na] + v;
              if (a.helmholtz) {
                yv = fmaf(extra[kTileP * row_pitch + na],
                          extra[2 * kTileP * row_pitch + na], yv);
              }
              store(a.y + at, yv);
            }
          }
        }
      }
      // the tile and the extras are read, and after the last pass the slot
      __syncthreads();
    }
  }
}

// Launches 1-2 and 4-6, the same for every geometry source.
template <int DIR, int MODE, typename T>
__global__ void __launch_bounds__(kStagedThreads, 4)
    axhelm_staged_contract_kernel(const StagedArgs<T> a) {
  contract_body<DIR, MODE, kTrilinear, T>(a);
}

// Launch 3: the t gradient with the factors.
template <GeomSource SRC, typename T>
__global__ void __launch_bounds__(kStagedThreads, 4)
    axhelm_staged_grad_t_kernel(const StagedArgs<T> a) {
  contract_body<kDirT, kGrad, SRC, T>(a);
}

// One launch: the persistent grid, the SMs times the blocks an SM the
// occupancy calculator allows, or the items if fewer.
template <int DIR, int MODE, GeomSource SRC, typename T>
cudaError_t contract(const StagedArgs<T>& a, int64_t items,
                     cudaStream_t stream) {
  const size_t smem = staged_smem_bytes(a.n1, a.lines,
                                        extras_of<DIR, MODE>(a.helmholtz));
  void (*kernel)(const StagedArgs<T>);
  if constexpr (DIR == kDirT && MODE == kGrad) {
    kernel = axhelm_staged_grad_t_kernel<SRC, T>;
  } else {
    kernel = axhelm_staged_contract_kernel<DIR, MODE, T>;
  }
  // The opt-in to the dynamic size belongs to the current device, so every
  // launch sets it; it and the queries below are host calls that enqueue
  // nothing, allowed while a graph captures.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kStagedThreads, smem);
  }
  if (err != cudaSuccess) return err;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t grid = items < resident ? items : resident;
  kernel<<<static_cast<unsigned>(grid), kStagedThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <GeomSource SRC, typename T>
int launch_staged(const T* x, T* y, const T* geom, const T* lam0,
                  const T* lam1, const float* frag, const float* xi,
                  const float* w3, float* scratch, int n1, int n_elem,
                  int ncols, int helmholtz, void* stream) {
  if (n_elem <= 0 || ncols <= 0 || n1 < 2 || scratch == nullptr ||
      frag == nullptr || n_elem > INT_MAX / ncols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t np = static_cast<int64_t>(n1) * n1 * n1;
  const int lines = staged_lines(n1);
  if (n1 > kStagedMax || np > INT_MAX ||
      staged_smem_bytes(n1, lines, kMaxExtras) > kSmemPerBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = n_elem * ncols;
  const int64_t words = static_cast<int64_t>(rows) * np;
  const int64_t items =
      static_cast<int64_t>(rows) *
      ((static_cast<int64_t>(n1) * n1 + lines - 1) / lines);
  const uintptr_t x_at = reinterpret_cast<uintptr_t>(x);
  const uintptr_t s_at = reinterpret_cast<uintptr_t>(scratch);
  const int vec_x = n1 % 4 == 0 && x_at % (4 * sizeof(T)) == 0;
  const int vec_s = n1 % 4 == 0 && s_at % 16 == 0;
  float* mass = helmholtz ? scratch + 3 * words : nullptr;
  const StagedArgs<T> a{x,     y,      geom,    lam0,   lam1,
                        frag,  xi,     w3,      scratch, scratch + words,
                        scratch + 2 * words,   mass,    n1,     ncols,
                        rows,  helmholtz, lines, vec_x, vec_s};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = contract<kDirR, kGrad, SRC>(a, items, s);
  if (err == cudaSuccess) err = contract<kDirS, kGrad, SRC>(a, items, s);
  if (err == cudaSuccess) err = contract<kDirT, kGrad, SRC>(a, items, s);
  if (err == cudaSuccess) err = contract<kDirR, kFirst, SRC>(a, items, s);
  if (err == cudaSuccess) {
    err = contract<kDirS, kAccumulate, SRC>(a, items, s);
  }
  if (err == cudaSuccess) err = contract<kDirT, kLast, SRC>(a, items, s);
  return static_cast<int>(err);
}

}  // namespace

// The entry points axhelm_<variant>_<SUFFIX>_staged for storage type T: the
// generic body's arguments (axhelm.cu), D-hat's split (ops.staged_fragments)
// in the dhat slot, plus the fp32 scratch of (3 ncols + helmholtz) n_elem
// N1^3 words (ops.staged_launch).  merged is Helmholtz always (lam2 = Lam2
// and lam3 = Lam3 must be given), partial Poisson always (gscale must be
// given).
#define AXHELM_STAGED_ENTRY_POINT(VARIANT, SRC, T, SUFFIX)                   \
  extern "C" int axhelm_##VARIANT##_##SUFFIX##_staged(                        \
      const T* x, T* y, const T* geom, const T* lam0, const T* lam1,         \
      const float* frag, const float* xi, const float* w3, float* scratch,   \
      int n1, int n_elem, int ncols, int helmholtz, void* stream) {          \
    if (SRC == kMerged && (lam0 == nullptr || lam1 == nullptr)) {             \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    }                                                                         \
    if (SRC == kPartial && lam0 == nullptr) {                                 \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    }                                                                         \
    if (SRC == kMerged) helmholtz = 1;                                        \
    if (SRC == kPartial) helmholtz = 0;                                       \
    return launch_staged<SRC, T>(x, y, geom, lam0, lam1, frag, xi, w3,        \
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
