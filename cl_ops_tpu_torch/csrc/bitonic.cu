// Bitonic compare-exchange kernels of the sorters "abitonic" (the fused
// schedule, or whole_sort with single_launch=1) and "sbitonic" (pair_cross
// once per network step), for Hopper (sm_90a). Built with nvcc into a
// shared library with a plain C interface and loaded with ctypes
// (cl_ops_tpu_torch/ops/sort/bitonic_kernels.py, which also holds each
// kernel's plain PyTorch version).
//
// Data: up to MAX_COLS int32 columns of one power-of-two length n. Rows
// order by signed-i32 lexicographic comparison of the first num_keys
// columns; the rest ride as payload. Every compare-exchange is in pair form:
// one thread owns both partners (lo, lo + j), swaps every column of the two
// rows only when they are strictly out of order for the pair's direction,
// and so never duplicates a row on a tied key prefix. The direction of a
// pair in stage K is ascending iff (global index of lo) & K == 0; K = 0
// makes every pair ascending (the final merge of a bitonic sequence).
//
// Five kernels serve five entry points, all in place. Each launch of the
// fused schedule's four (block_sort, multi_stage, pair_cross, block_merge)
// reads and writes every column once, 2 * n_cols * 4 * n bytes of device
// memory, and runs many network steps per such sweep, most of them in
// registers (block_sort_kernel serves block_sort and multi_stage, which
// differ only in their first stage; block_merge_kernel; pair_cross runs a
// run of one stage's cross steps on gathered tiles, pair_cross_tile_kernel,
// or a single step in device memory, pair_cross_kernel). whole_sort runs
// the whole network in one cooperative launch, with most steps in registers.
//
// Each entry point launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

#define MAX_COLS 8
#define MAX_THREADS 1024
#define SMEM_MAX 232448  // dynamic shared memory one Hopper block can use

struct Cols {
  int32_t* p[MAX_COLS];
};

// One compare-exchange of step (k, j) in device memory: pair p is
// (lo, lo + j). The pair_cross kernel runs it.
__device__ __forceinline__ void pair_step(const Cols& cols, int n_cols,
                                          int num_keys, unsigned p,
                                          unsigned k, unsigned j) {
  unsigned lo = ((p & ~(j - 1)) << 1) | (p & (j - 1));
  unsigned hi = lo + j;
  bool asc = (lo & k) == 0;
  int ord = 0;
#pragma unroll
  for (int c = 0; c < MAX_COLS; ++c) {
    if (c >= num_keys) break;
    int32_t x = cols.p[c][lo], y = cols.p[c][hi];
    if (x != y) {
      ord = x < y ? -1 : 1;
      break;
    }
  }
  if (asc ? ord > 0 : ord < 0) {
#pragma unroll
    for (int c = 0; c < MAX_COLS; ++c) {
      if (c >= n_cols) break;
      int32_t x = cols.p[c][lo];
      cols.p[c][lo] = cols.p[c][hi];
      cols.p[c][hi] = x;
    }
  }
}

// pair_cross: replaces bitonic_kernels.py _pair_cross_kernel, and serves
// the one-launch-per-step sorter ("sbitonic") in place of _cross_kernel
// (steps J >= its block) and _single_step_kernel (steps J < its block):
// the TPU splits one step at its block size only because a Pallas kernel
// sees a block at a time; here one entry point runs any run of steps
// J = j .. j_last of a stage k, j >= j_last >= 1, in one sweep. A single
// step (j_last == j) runs here, in device memory: thread p owns the pair
// (lo, lo + j). Bound: one sweep of every column (here, a read of the key
// columns of every row and a write of the rows that swap). Neighbouring
// threads touch neighbouring addresses on both sides of the pair (at j < 32
// a warp's lo and hi interleave within the same lines), so each warp's
// loads and stores coalesce. A longer run takes pair_cross_tile_kernel
// (below block_merge).
__global__ void pair_cross_kernel(Cols cols, int n_cols, int num_keys,
                                  unsigned half, unsigned k, unsigned j) {
  unsigned p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= half) return;
  pair_step(cols, n_cols, num_keys, p, k, j);
}

// whole_sort: replaces bitonic_kernels.py _vmem_sort_kernel, the whole
// network in one cooperative launch of n / slice co-resident blocks. It runs
// the fused schedule's network in the fused schedule's order (every step
// (K, J), J = K/2 .. 1, of every stage K = 2 .. n), in pair form with the
// global-index direction rule, so its output equals bitonic_sort_2d's bit
// for bit; only the memory a step runs in differs. Bound: one read and one
// write of every column, or, where larger, the network's compares; the
// array (at most 8 MB) stays in the 50 MB L2 between its passes.
//
// Geometry (chosen by the caller, bitonic_kernels.whole_geometry): the
// slice is a power of two of about n / 128 rows, so that the slices spread
// over the card's 132 SMs, with slice^2 >= n and at most 512 threads a
// block (the largest arrays take 256 blocks, two per SM). Each of its
// slice / R threads holds R consecutive rows of every column in registers
// (R = 16 at one column, fewer at more columns, 1 for slices under 32 R
// rows). A step at local distance d runs
//   * d < R:        inside each thread, on its registers;
//   * R <= d < 32R: between the lanes of a warp, by __shfl_xor_sync;
//   * d >= 32R:     through shared memory (column-major, one pad word per
//                   32 so that the blocked register loads are free of bank
//                   conflicts): the steps at d >= T (the block's threads)
//                   all in registers, each thread taking the R rows T
//                   apart (one warp per register at one column and 8192
//                   rows, so every such step), any below T one
//                   __syncthreads per step.
// A single column's compare-exchange is a min and a max (equal values:
// the same bits either way); wider rows compare the key prefix and swap.
// Stages K <= slice run on each block's own slice. A later stage K takes two
// grid barriers, not one per step: phase A gathers into each block the rows
// whose indices differ only in the bits K/2 .. slice that the steps
// J >= slice touch (runs of L = slice^2 / K rows, one run per group member),
// runs those steps there at local distances slice/2 .. L, and scatters them
// back; after a barrier, phase B reloads the block's own slice and runs
// J = slice/2 .. 1; a barrier follows before the next stage's gather.

template <int NC>
__device__ __forceinline__ int order_regs(const int32_t (&a)[NC],
                                          const int32_t (&b)[NC],
                                          int num_keys) {
  int ord = 0;
#pragma unroll
  for (int c = NC - 1; c >= 0; --c)  // the first differing key decides
    if (c < num_keys && a[c] != b[c]) ord = a[c] < b[c] ? -1 : 1;
  return ord;
}

// Compare-exchange of rows a (the lower index) and b in pair form: they
// swap, all columns together, only when strictly out of order for the
// pair's direction. A single column gives the same values by min and max.
template <int NC>
__device__ __forceinline__ void cx(int32_t (&a)[NC], int32_t (&b)[NC],
                                   bool asc, int num_keys) {
  if constexpr (NC == 1) {
    const int32_t lo = min(a[0], b[0]), hi = max(a[0], b[0]);
    a[0] = asc ? lo : hi;
    b[0] = asc ? hi : lo;
  } else {
    const int ord = order_regs<NC>(a, b, num_keys);
    if (asc ? ord > 0 : ord < 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int32_t t = a[c];
        a[c] = b[c];
        b[c] = t;
      }
    }
  }
}

// Shared-memory position of local row i: one pad word after every 2^SH
// rows (SH = 5: one per 32, so that the blocked register loads are free of
// bank conflicts; SH = 31: no pad).
template <int SH = 5>
__device__ __forceinline__ unsigned pad(unsigned i) { return i + (i >> SH); }

// A block-uniform x, read back through a volatile shared-memory word so
// that the compiler cannot prove it equal to x: addresses derived from it
// are computed anew, not kept in registers since an earlier use across a
// run of network steps (where the registers hold rows). Every thread
// writes the same value.
__device__ __forceinline__ unsigned fresh(unsigned x) {
  __shared__ unsigned box;
  box = x;
  return *static_cast<volatile unsigned*>(&box);
}

// Registers <-> the padded shared-memory slice (thread t: rows t*R .. +R-1).
// R divides 32, so a thread's rows lie in one 32-row line: row t*R + r is
// at pad(t*R) + r.
template <int NC, int R, int SH = 5>
__device__ __forceinline__ void regs_to_smem(const int32_t (&v)[NC][R],
                                             int32_t* s, unsigned P) {
  static_assert(32 % R == 0, "rows per thread must divide 32");
  int32_t* q = s + pad<SH>(threadIdx.x * R);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int r = 0; r < R; ++r) q[c * P + r] = v[c][r];
}

template <int NC, int R, int SH = 5>
__device__ __forceinline__ void smem_to_regs(int32_t (&v)[NC][R],
                                             const int32_t* s, unsigned P) {
  static_assert(32 % R == 0, "rows per thread must divide 32");
  const int32_t* q = s + pad<SH>(threadIdx.x * R);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int r = 0; r < R; ++r) v[c][r] = q[c * P + r];
}

// Registers in the transposed layout (thread t: rows t + m * T, T the
// block's threads) <-> the padded shared-memory slice. Where R > 1, T is a
// multiple of 32 (the slice holds a warp of R-row threads or more), so row
// t + m * T is at pad(t) + m * pad(T).
template <int NC, int R, int SH = 5>
__device__ __forceinline__ void trans_to_smem(const int32_t (&v)[NC][R],
                                              int32_t* s, unsigned P) {
  int32_t* q = s + pad<SH>(threadIdx.x);
  const unsigned pt = pad<SH>(fresh(blockDim.x));
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int m = 0; m < R; ++m) q[c * P + m * pt] = v[c][m];
}

template <int NC, int R, int SH = 5>
__device__ __forceinline__ void smem_to_trans(int32_t (&v)[NC][R],
                                              const int32_t* s, unsigned P) {
  const int32_t* q = s + pad<SH>(threadIdx.x);
  const unsigned pt = pad<SH>(fresh(blockDim.x));
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int m = 0; m < R; ++m) v[c][m] = q[c * P + m * pt];
}

// One step at register distance D < R. Register r of this thread holds the
// row whose direction bit (bit k of its index) is set iff fk | (r & kr)
// (reg_steps).
template <int D, int NC, int R>
__device__ __forceinline__ void reg_step(int32_t (&v)[NC][R], int num_keys,
                                         unsigned fk, unsigned kr) {
  if constexpr (D < R) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r & D) continue;
      int32_t a[NC], b[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        a[c] = v[c][r];
        b[c] = v[c][r + D];
      }
      cx<NC>(a, b, (fk | (r & kr)) == 0, num_keys);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        v[c][r] = a[c];
        v[c][r + D] = b[c];
      }
    }
  }
}

// The register steps at distances (D = R/2 .. 1) * stride that lie in
// [d_last, d], where register r of this thread is the row
// base + first + r * stride (stride 1: the blocked layout, first a multiple
// of R; stride T: the transposed one, first < T). The two terms have
// disjoint bits, and stride divides k (or k = 0), so bit k of the row is
// that of base + first or bit k / stride of r.
template <int NC, int R>
__device__ __forceinline__ void reg_steps(int32_t (&v)[NC][R], int num_keys,
                                          unsigned base, unsigned k,
                                          unsigned first, unsigned stride,
                                          unsigned d, unsigned d_last) {
  const unsigned fk = (base + first) & k;
  const unsigned kr = k >> (__ffs(stride) - 1);
#define CLO_REG_STEP(D)                                              \
  if ((D) * stride <= d && (D) * stride >= d_last)                   \
    reg_step<D>(v, num_keys, fk, kr);
  CLO_REG_STEP(16)
  CLO_REG_STEP(8)
  CLO_REG_STEP(4)
  CLO_REG_STEP(2)
  CLO_REG_STEP(1)
#undef CLO_REG_STEP
}

// One step at distance R <= d < 32R between lanes d / R apart. Both lanes of
// a pair compare (lower row, upper row) alike, so they agree on the swap.
// The direction is the thread's: k > d >= R.
template <int NC, int R>
__device__ __forceinline__ void shfl_step(int32_t (&v)[NC][R], int num_keys,
                                          unsigned base, unsigned k,
                                          unsigned d, unsigned mask) {
  const unsigned lx = d / R;
  const bool upper = (threadIdx.x & lx) != 0;
  const bool asc = ((base + (threadIdx.x & ~lx) * R) & k) == 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if constexpr (NC == 1) {
      const int32_t o = __shfl_xor_sync(mask, v[0][r], lx);
      v[0][r] = asc != upper ? min(v[0][r], o) : max(v[0][r], o);
    } else {
      int32_t o[NC], a[NC], b[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        o[c] = __shfl_xor_sync(mask, v[c][r], lx);
        a[c] = upper ? o[c] : v[c][r];
        b[c] = upper ? v[c][r] : o[c];
      }
      const int ord = order_regs<NC>(a, b, num_keys);
      if (asc ? ord > 0 : ord < 0) {
#pragma unroll
        for (int c = 0; c < NC; ++c) v[c][r] = o[c];
      }
    }
  }
}

// Steps at distances d .. d_last (halving), all under 32R, of stage k on the
// rows in registers (blocked layout): by shuffles, then inside each thread.
template <int NC, int R>
__device__ __forceinline__ void warp_steps(int32_t (&v)[NC][R], int num_keys,
                                           unsigned base, unsigned k,
                                           unsigned d, unsigned d_last,
                                           unsigned mask) {
  for (; d >= (unsigned)R && d >= d_last; d >>= 1)
    shfl_step<NC, R>(v, num_keys, base, k, d, mask);
  reg_steps<NC, R>(v, num_keys, base, k, threadIdx.x * R, 1, d, d_last);
}

// Steps at local distances d = d_first .. d_last (halving) of stage k over
// the block's `S` rows; the local row i has global direction index
// base + i. The rows come in registers (blocked layout), or in shared
// memory when from_smem (after a __syncthreads), and leave in shared memory
// when to_smem (the caller synchronises before reading other threads'
// rows), else in registers. Steps at d >= 32R run in shared memory: those
// at d >= T (the block's threads) in registers, each thread loading the R
// rows t + m * T, between two __syncthreads; any at 32R <= d < T one
// step per __syncthreads, or with QUADS two (while two are left). The
// smaller distances run by shuffles, then inside each thread.
template <int NC, int R, int SH = 5, bool QUADS = false>
__device__ void local_steps(int32_t (&v)[NC][R], int32_t* s, unsigned P,
                            unsigned S, int num_keys, unsigned base,
                            unsigned k, unsigned d_first, unsigned d_last,
                            unsigned mask, bool from_smem, bool to_smem) {
  const unsigned t = threadIdx.x;
  unsigned d = d_first;
  bool in_smem = from_smem;
  if (d >= 32u * R && d >= d_last) {
    if (!in_smem) {
      __syncthreads();
      regs_to_smem<NC, R, SH>(v, s, P);
      __syncthreads();
    }
    const unsigned T = blockDim.x;
    if (d >= T && d >= d_last) {
      smem_to_trans<NC, R, SH>(v, s, P);
      reg_steps<NC, R>(v, num_keys, base, k, t, T, d, d_last);
      trans_to_smem<NC, R, SH>(v, s, P);
      __syncthreads();
      d = T / 2;
    }
    // two steps (d, d/2) per pass: each thread takes quads of rows
    // lo + j * d/2, j < 4, all in one direction (k >= 2d)
    for (; QUADS && d >= 64u * R && d / 2 >= d_last; d >>= 2) {
      const unsigned h = d >> 1;
      for (unsigned q = t; q < S / 4; q += T) {
        const unsigned lo = ((q & ~(h - 1)) << 2) | (q & (h - 1));
        const bool asc = ((base + lo) & k) == 0;
        int32_t x[4][NC];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < NC; ++c) x[j][c] = s[c * P + pad<SH>(lo + j * h)];
        cx<NC>(x[0], x[2], asc, num_keys);
        cx<NC>(x[1], x[3], asc, num_keys);
        cx<NC>(x[0], x[1], asc, num_keys);
        cx<NC>(x[2], x[3], asc, num_keys);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < NC; ++c) s[c * P + pad<SH>(lo + j * h)] = x[j][c];
      }
      __syncthreads();
    }
    for (; d >= 32u * R && d >= d_last; d >>= 1) {
      for (unsigned p = t; p < S / 2; p += T) {
        const unsigned lo = ((p & ~(d - 1)) << 1) | (p & (d - 1));
        const unsigned hi = lo + d;
        int32_t a[NC], b[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          a[c] = s[c * P + pad<SH>(lo)];
          b[c] = s[c * P + pad<SH>(hi)];
        }
        cx<NC>(a, b, ((base + lo) & k) == 0, num_keys);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          s[c * P + pad<SH>(lo)] = a[c];
          s[c * P + pad<SH>(hi)] = b[c];
        }
      }
      __syncthreads();
    }
    in_smem = true;
  }
  if (d >= d_last) {  // steps below 32R remain: in registers
    if (in_smem) smem_to_regs<NC, R, SH>(v, s, P);
    in_smem = false;
    warp_steps<NC, R>(v, num_keys, base, k, d, d_last, mask);
  }
  // each thread moves only its own rows here
  if (to_smem && !in_smem) regs_to_smem<NC, R, SH>(v, s, P);
  if (!to_smem && in_smem) smem_to_regs<NC, R, SH>(v, s, P);
}

// Global rows <-> the padded slice: local row g is global row
// at + (g / run) * stride + g % run (run, stride powers of two). Runs of 4
// rows or more move as 16-byte vectors where the columns are 16-byte
// aligned (vec; at and stride are then multiples of 4).
template <int NC, bool STORE>
__device__ __forceinline__ void move_rows(const Cols& cols, int vec,
                                          int32_t* s, unsigned P, unsigned S,
                                          unsigned at, unsigned run,
                                          unsigned stride) {
  const unsigned lg = __ffs(run) - 1;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    int32_t* g_col = cols.p[c] + at;
    int32_t* s_col = s + c * P;
    if (vec && run >= 4) {
      for (unsigned g = 4 * threadIdx.x; g < S; g += 4 * blockDim.x) {
        int4* q = reinterpret_cast<int4*>(g_col + (g >> lg) * stride +
                                          (g & (run - 1)));
        const unsigned w = pad(g);  // 4 rows of one 32-row line
        if (STORE) {
          *q = make_int4(s_col[w], s_col[w + 1], s_col[w + 2], s_col[w + 3]);
        } else {
          const int4 x = *q;
          s_col[w] = x.x;
          s_col[w + 1] = x.y;
          s_col[w + 2] = x.z;
          s_col[w + 3] = x.w;
        }
      }
    } else {
      for (unsigned g = threadIdx.x; g < S; g += blockDim.x) {
        int32_t* q = g_col + (g >> lg) * stride + (g & (run - 1));
        if (STORE)
          *q = s_col[pad(g)];
        else
          s_col[pad(g)] = *q;
      }
    }
  }
}

template <int NC>
__device__ __forceinline__ void gather(const Cols& cols, int vec, int32_t* s,
                                       unsigned P, unsigned S, unsigned at,
                                       unsigned run, unsigned stride) {
  move_rows<NC, false>(cols, vec, s, P, S, at, run, stride);
}

template <int NC>
__device__ __forceinline__ void scatter(const Cols& cols, int vec,
                                        int32_t* s, unsigned P, unsigned S,
                                        unsigned at, unsigned run,
                                        unsigned stride) {
  move_rows<NC, true>(cols, vec, s, P, S, at, run, stride);
}

template <int NC, int R>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    whole_sort_kernel(Cols cols, int vec, int num_keys, unsigned n,
                      unsigned S) {
  extern __shared__ int32_t smem[];
  cg::grid_group grid = cg::this_grid();
  const unsigned P = S + (S >> 5);  // padded column length
  const unsigned mask =
      blockDim.x >= 32 ? 0xFFFFFFFFu : (1u << blockDim.x) - 1;
  const unsigned base = blockIdx.x * S;
  int32_t v[NC][R];

  gather<NC>(cols, vec, smem, P, S, base, S, S);
  __syncthreads();
  for (unsigned k = 2; k <= S; k <<= 1)
    local_steps<NC, R>(v, smem, P, S, num_keys, base, k, k >> 1, 1, mask,
                       k == 2, k == S);
  // from here on the rows rest in shared memory between phases
  for (unsigned k = 2 * S; k <= n; k <<= 1) {
    __syncthreads();
    scatter<NC>(cols, vec, smem, P, S, base, S, S);
    grid.sync();
    // phase A: pairs (h, l) of high bits (>= k) and low bits (< S), q =
    // h * S + l; this block takes q in [blockIdx.x * L, + L), one h
    const unsigned L = S / (k / S);
    const unsigned q0 = blockIdx.x * L;
    const unsigned at = (q0 / S) * k + q0 % S;
    gather<NC>(cols, vec, smem, P, S, at, L, S);
    __syncthreads();
    local_steps<NC, R>(v, smem, P, S, num_keys, (q0 / S) * k, k, S >> 1, L,
                       mask, true, true);
    __syncthreads();
    scatter<NC>(cols, vec, smem, P, S, at, L, S);
    grid.sync();
    // phase B: steps J = S/2 .. 1 on the block's own slice
    gather<NC>(cols, vec, smem, P, S, base, S, S);
    __syncthreads();
    local_steps<NC, R>(v, smem, P, S, num_keys, base, k, S >> 1, 1, mask,
                       true, true);
  }
  __syncthreads();
  scatter<NC>(cols, vec, smem, P, S, base, S, S);
}

// block_sort, multi_stage and block_merge: replace bitonic_kernels.py
// _block_sort_kernel, _multi_stage_kernel and _block_merge_kernel. Each
// block holds one tile of S rows (the sort block B, or the merge block M)
// and runs on it
//   block_sort   every stage K = 2 .. S, steps K/2 .. 1 (with several
//                tiles the top stage alternates by tile parity: a pair's
//                direction comes from its global index, base + i);
//   multi_stage  the same kernel from stage K = 2B: stages 2B .. M of each
//                M-row tile, whose runs of B rows come in sorted in
//                alternating directions (unlike the TPU kernel it compares
//                only the key prefix);
//   block_merge  the steps S/2 .. 1 of one stage k (k = 0: all ascending),
// each step placed as in whole_sort (local_steps). Bound: one read and one
// write of every column. Each of the T = S / R threads holds R rows of
// every column (block_rows: 32 at 1-3 columns, 16 at 4, 8 at more, 1 in
// tiles under 32 of those R-row threads). A step runs in registers
// (d < R), by __shfl_xor_sync (R <= d < 32R) or, at d >= T, in registers
// after a transpose through shared memory. At 1-4 columns T <= 32 R at
// every tile that fits the shared-memory budget, so no step costs a
// shared-memory pass of its own. At 5-8 columns 16 rows a thread spilled
// registers (80-128 data registers of the 128-255 a thread may have), so
// threads hold 8 and the steps at 32R <= d < T run two per pass over
// shared memory, as do R = 1 tiles (at most 512 rows). The tile moves
// between device memory and registers in the transposed layout (thread t:
// rows t + m T), so each warp access is one 128-byte line of a column, a
// thread has all its loads in flight at once, and no column needs more than
// 4-byte alignment. block_merge runs its steps at d >= T on the rows as
// they arrive, before the first transpose (in multi_stage's first stage
// that made the 3-column instance spill registers, so multi_stage takes
// them from shared memory, like every later stage).
// At 7 columns and 8192 rows the tile (56 data registers of 64) still
// spills.

// One pad word per 32 rows, but none at 7 columns: their padded
// 8192-row tile would not fit the 227 KB a block may use.
__host__ __device__ constexpr int block_pad_shift(int nc) {
  return nc == 7 ? 31 : 5;
}

// Rows per thread of the block kernels' tiles of a warp's worth or more.
__host__ __device__ constexpr int block_rows_full(int nc) {
  return nc <= 3 ? 32 : nc == 4 ? 16 : 8;
}

// The largest tile (a power of two) whose nc columns fit SMEM_MAX unpadded,
// the bound that the callers check.
__host__ __device__ constexpr unsigned block_max_len(int nc) {
  unsigned s = 1;
  while (2ull * s * nc * sizeof(int32_t) <= SMEM_MAX) s *= 2;
  return s;
}

__host__ __device__ constexpr size_t block_smem(int nc, unsigned len) {
  return (size_t)nc * (len + (len >> block_pad_shift(nc))) * sizeof(int32_t);
}

template <int NC, int R>
struct BlockTile {
  // threads of the largest tile this instance runs
  static constexpr int kMaxThreads =
      R == 1 ? 32 * block_rows_full(NC) / 2 : block_max_len(NC) / R;
};

// Every admitted tile fits padded, in at most 1024 threads (and at 1-4
// columns with T <= 32 R: no step in shared-memory passes).
constexpr bool block_tiles_fit() {
  for (int nc = 1; nc <= MAX_COLS; ++nc) {
    const unsigned len = block_max_len(nc), r = block_rows_full(nc);
    if (block_smem(nc, len) > SMEM_MAX || len / r > MAX_THREADS ||
        (nc <= 4 && len / r > 32 * r))
      return false;
  }
  return true;
}
static_assert(block_tiles_fit(), "a block_sort/block_merge tile overflows");

// The tile's rows at global row `base` <-> registers in the transposed
// layout.
template <int NC, int R>
__device__ __forceinline__ void load_tile(const Cols& cols,
                                          int32_t (&v)[NC][R],
                                          unsigned base) {
  const unsigned T = fresh(blockDim.x);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int32_t* g = cols.p[c] + base + threadIdx.x;
#pragma unroll
    for (int m = 0; m < R; ++m) v[c][m] = g[m * T];
  }
}

template <int NC, int R>
__device__ __forceinline__ void store_tile(const Cols& cols,
                                           const int32_t (&v)[NC][R],
                                           unsigned base) {
  const unsigned T = fresh(blockDim.x);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    int32_t* g = cols.p[c] + base + threadIdx.x;
#pragma unroll
    for (int m = 0; m < R; ++m) g[m * T] = v[c][m];
  }
}

// Stages k0 .. S of each tile: block_sort passes k0 = 2, multi_stage 2B
// (k0 > S: the tile goes back as it came).
template <int NC, int R>
__global__ void __launch_bounds__(BlockTile<NC, R>::kMaxThreads)
    block_sort_kernel(Cols cols, int num_keys, unsigned S, unsigned k0) {
  constexpr int SH = block_pad_shift(NC);
  extern __shared__ int32_t smem[];
  const unsigned P = S + (S >> SH);
  const unsigned mask =
      blockDim.x >= 32 ? 0xFFFFFFFFu : (1u << blockDim.x) - 1;
  const unsigned base = blockIdx.x * S;
  const unsigned kw = S < 32u * R ? S : 32u * R;
  int32_t v[NC][R];
  load_tile<NC, R>(cols, v, base);
  trans_to_smem<NC, R, SH>(v, smem, P);
  __syncthreads();
  unsigned k = k0;
  if (k <= kw) {
    // the stages whose steps stay within a warp's rows, on the registers
    smem_to_regs<NC, R, SH>(v, smem, P);
    for (; k <= kw; k <<= 1)
      warp_steps<NC, R>(v, num_keys, base, k, k >> 1, 1, mask);
    regs_to_smem<NC, R, SH>(v, smem, P);
  }
  // each later stage from and to shared memory
  for (; k <= S; k <<= 1) {
    __syncthreads();
    local_steps<NC, R, SH, true>(v, smem, P, S, num_keys, base, k, k >> 1,
                                 1, mask, true, true);
  }
  __syncthreads();
  smem_to_trans<NC, R, SH>(v, smem, P);
  store_tile<NC, R>(cols, v, base);
}

template <int NC, int R>
__global__ void __launch_bounds__(BlockTile<NC, R>::kMaxThreads)
    block_merge_kernel(Cols cols, int num_keys, unsigned S, unsigned k) {
  constexpr int SH = block_pad_shift(NC);
  extern __shared__ int32_t smem[];
  const unsigned P = S + (S >> SH);
  const unsigned T = blockDim.x;
  const unsigned mask = T >= 32 ? 0xFFFFFFFFu : (1u << T) - 1;
  const unsigned base = blockIdx.x * S;
  int32_t v[NC][R];
  load_tile<NC, R>(cols, v, base);
  unsigned d = S >> 1;
  if (d >= T) {  // register distances D < R are row distances D * T
    reg_steps<NC, R>(v, num_keys, base, k, threadIdx.x, T, d, T);
    d = T >> 1;
  }
  trans_to_smem<NC, R, SH>(v, smem, P);
  __syncthreads();
  local_steps<NC, R, SH, true>(v, smem, P, S, num_keys, base, k, d, 1, mask,
                               true, true);
  __syncthreads();
  smem_to_trans<NC, R, SH>(v, smem, P);
  store_tile<NC, R>(cols, v, base);
}

// pair_cross_tile_kernel: a run of s > 1 cross steps J = j .. j_last of one
// stage k in one sweep (the fused schedule's stages K > M take
// ceil(steps / cross_span) such launches, not one per step). Bound: one read
// and one write of every column. The rows whose indices differ only in the
// bits log2(j_last) .. log2(j) form groups of 2^s that those steps close,
// so a block can run all of them on chip. It gathers, as whole_sort's phase
// A does, 2^s runs of L contiguous rows, one run per group member (j_last
// apart): L = rows / 2^s >= 32 (s <= cross_span), so every load and store
// of a run covers full 128-byte lines of each column. The tile's local
// distances are then L .. rows/2; where 2j fits the tile (short distances,
// or an array under a tile), the tile is instead `rows` contiguous rows at
// local distances j .. j_last. The direction is (global index of lo) & k:
// k lies above every J bit, so a gathered tile has one direction, that of
// its group base. The block holds the tile in its T = rows / R threads'
// registers, R = block_rows_full rows each (1 in tiles under 32 R rows), in
// the transposed layout (thread t: local rows t + m T), loaded and stored
// straight from device memory with a warp on 32 rows of a run. The steps at
// local distance >= T run there, in registers: at R = 32 that is every step
// of a run of up to 5, which then needs no shared memory and no barrier.
// The smaller distances run as in block_merge (local_steps) through the
// padded tile in shared memory, allocated only for such runs. No step of a
// run depends on another block, so the grid is a plain one of n / rows
// independent blocks.
//
// Tile rows: the largest power of two whose columns fit 96 KB, so that two
// padded tiles share an SM (16384 rows at one column, 8192 at 2-3, 4096 at
// 4-6, 2048 at 7-8); cross_span = log2(rows / 32): 9, 8, 8, 7, 7, 7, 6, 6.
// Half that tile (one step less a pass, more blocks an SM) ran faster
// passes at 3 columns but no faster sorts at 1-3 columns on the H100. The
// launch bounds ask for two blocks an SM: at one column (512 threads, 64
// registers) and at 6 ptxas spills a few words a thread.
#define CROSS_TILE_BYTES 98304

__host__ __device__ constexpr unsigned cross_rows(int nc) {
  unsigned s = 1;
  while (2ull * s * nc * sizeof(int32_t) <= CROSS_TILE_BYTES) s *= 2;
  return s;
}

__host__ __device__ constexpr int ilog2(unsigned x) {
  int l = 0;
  while (x >>= 1) ++l;
  return l;
}

__host__ __device__ constexpr int cross_span(int nc) {
  return ilog2(cross_rows(nc) / 32);
}

template <int NC, int R>
struct CrossTile {
  static constexpr int kMaxThreads =
      R == 1 ? 32 * block_rows_full(NC) / 2 : cross_rows(NC) / R;
};

// The tile's local row g is global row at + (g >> lg) * stride + g % 2^lg
// (runs of 2^lg rows, stride apart) <-> registers in the transposed layout.
template <int NC, int R, bool STORE>
__device__ __forceinline__ void move_runs(const Cols& cols,
                                          int32_t (&v)[NC][R], unsigned at,
                                          unsigned lg, unsigned stride) {
  const unsigned T = fresh(blockDim.x);
  const unsigned low = (1u << lg) - 1;
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const unsigned g = threadIdx.x + m * T;
    const unsigned i = at + (g >> lg) * stride + (g & low);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if constexpr (STORE)
        cols.p[c][i] = v[c][m];
      else
        v[c][m] = cols.p[c][i];
    }
  }
}

// Block b takes chunk b % 2^chunks_lg of group b >> chunks_lg: the group's
// rows start at base = (b >> chunks_lg) * group_rows, the chunk's runs at
// base + (b % 2^chunks_lg) * 2^run_lg. Steps at local distances d_first ..
// d_last (halving).
template <int NC, int R>
__global__ void __launch_bounds__(CrossTile<NC, R>::kMaxThreads, 2)
    pair_cross_tile_kernel(Cols cols, int num_keys, unsigned k,
                           unsigned run_lg, unsigned stride,
                           unsigned chunks_lg, unsigned group_rows,
                           unsigned d_first, unsigned d_last) {
  extern __shared__ int32_t smem[];
  const unsigned T = blockDim.x;
  const unsigned S = T * R;
  const unsigned P = S + (S >> 5);
  const unsigned mask = T >= 32 ? 0xFFFFFFFFu : (1u << T) - 1;
  const unsigned b = blockIdx.x;
  const unsigned base = (b >> chunks_lg) * group_rows;
  const unsigned at = base + ((b & ((1u << chunks_lg) - 1)) << run_lg);
  int32_t v[NC][R];
  move_runs<NC, R, false>(cols, v, at, run_lg, stride);
  unsigned d = d_first;
  if (d >= T) {  // register distances D < R are local distances D * T
    reg_steps<NC, R>(v, num_keys, base, k, threadIdx.x, T, d,
                     d_last > T ? d_last : T);
    d = T >> 1;
  }
  if (d >= d_last) {
    trans_to_smem<NC, R>(v, smem, P);
    __syncthreads();
    local_steps<NC, R, 5, true>(v, smem, P, S, num_keys, base, k, d, d_last,
                                mask, true, true);
    __syncthreads();
    smem_to_trans<NC, R>(v, smem, P);
  }
  move_runs<NC, R, true>(cols, v, at, run_lg, stride);
}

// Rows per thread of whole_sort at nc columns (1 for small slices).
static constexpr int whole_rows(int nc) {
  return nc == 1 ? 16 : nc == 2 ? 8 : nc <= 4 ? 4 : 2;
}

static Cols make_cols(void* const* ptrs, int n_cols) {
  Cols c;
  for (int i = 0; i < MAX_COLS; ++i)
    c.p[i] = i < n_cols ? static_cast<int32_t*>(ptrs[i]) : nullptr;
  return c;
}

template <typename Kernel>
static int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Rows per thread of the block kernels at nc columns in tiles of len rows.
static int block_rows(int nc, unsigned len) {
  return len >= 32u * block_rows_full(nc) ? block_rows_full(nc) : 1;
}

// One pair_cross_tile_kernel launch over n rows in tiles of `rows`: steps
// j .. j_last (2j <= n, at most cross_span(NC) of them) of stage k.
template <int NC, int R>
static int launch_cross(Cols cols, int num_keys, unsigned n, unsigned rows,
                        unsigned k, unsigned j, unsigned j_last,
                        cudaStream_t stream) {
  auto kernel = pair_cross_tile_kernel<NC, R>;
  const unsigned threads = rows / R;
  unsigned run_lg, stride, chunks_lg, group_rows, d_first, d_last;
  if (2 * j <= rows) {  // one contiguous tile holds whole groups
    run_lg = ilog2(rows);
    stride = rows;
    chunks_lg = 0;
    group_rows = rows;
    d_first = j;
    d_last = j_last;
  } else {  // 2^s runs of rows / 2^s, j_last apart
    const unsigned run = rows / (2 * j / j_last);
    run_lg = ilog2(run);
    stride = j_last;
    chunks_lg = ilog2(j_last / run);
    group_rows = 2 * j;
    d_first = rows / 2;
    d_last = run;
  }
  if (threads > (unsigned)CrossTile<NC, R>::kMaxThreads || d_last < 1)
    return (int)cudaErrorInvalidValue;
  // shared memory only for the steps below the block's threads
  const size_t smem =
      d_last < threads ? (size_t)NC * (rows + rows / 32) * sizeof(int32_t)
                       : 0;
  int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<n / rows, threads, smem, stream>>>(cols, num_keys, k, run_lg,
                                               stride, chunks_lg, group_rows,
                                               d_first, d_last);
  return (int)cudaGetLastError();
}

template <int NC>
static int launch_cross_rows(Cols cols, int num_keys, unsigned n, unsigned k,
                             unsigned j, unsigned j_last,
                             cudaStream_t stream) {
  constexpr int R = block_rows_full(NC);
  const unsigned rows = n < cross_rows(NC) ? n : cross_rows(NC);
  if (ilog2(j / j_last) >= cross_span(NC)) return (int)cudaErrorInvalidValue;
  if (block_rows(NC, rows) == R)
    return launch_cross<NC, R>(cols, num_keys, n, rows, k, j, j_last, stream);
  return launch_cross<NC, 1>(cols, num_keys, n, rows, k, j, j_last, stream);
}

// Steps j .. j_last of stage k: one step in device memory
// (pair_cross_kernel), a longer run on gathered tiles.
extern "C" int clo_pair_cross(void* const* ptrs, int n_cols, int num_keys,
                              int n, int k, int j, int j_last, void* stream) {
  const unsigned un = (unsigned)n, uk = (unsigned)k, uj = (unsigned)j,
                 ul = (unsigned)j_last;
  cudaStream_t st = (cudaStream_t)stream;
  Cols c = make_cols(ptrs, n_cols);
  if (ul < 1 || ul > uj || 2ull * uj > un) return (int)cudaErrorInvalidValue;
  if (ul == uj) {
    unsigned half = un / 2;
    unsigned threads = 256;
    pair_cross_kernel<<<(half + threads - 1) / threads, threads, 0, st>>>(
        c, n_cols, num_keys, half, uk, uj);
    return (int)cudaGetLastError();
  }
  switch (n_cols) {
    case 1: return launch_cross_rows<1>(c, num_keys, un, uk, uj, ul, st);
    case 2: return launch_cross_rows<2>(c, num_keys, un, uk, uj, ul, st);
    case 3: return launch_cross_rows<3>(c, num_keys, un, uk, uj, ul, st);
    case 4: return launch_cross_rows<4>(c, num_keys, un, uk, uj, ul, st);
    case 5: return launch_cross_rows<5>(c, num_keys, un, uk, uj, ul, st);
    case 6: return launch_cross_rows<6>(c, num_keys, un, uk, uj, ul, st);
    case 7: return launch_cross_rows<7>(c, num_keys, un, uk, uj, ul, st);
    case 8: return launch_cross_rows<8>(c, num_keys, un, uk, uj, ul, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Steps one pair_cross launch may take at nc columns, for
// bitonic_kernels.cross_span to check.
extern "C" int clo_cross_span(int n_cols) { return cross_span(n_cols); }

template <int NC, int R>
static int launch_block(bool merge, Cols cols, int num_keys, unsigned n,
                        unsigned len, unsigned k, cudaStream_t stream) {
  const unsigned threads = len / R;
  const size_t smem = block_smem(NC, len);
  if (len < (unsigned)R || len > n ||
      threads > (unsigned)BlockTile<NC, R>::kMaxThreads || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  int err;
  if (merge) {
    err = set_smem(block_merge_kernel<NC, R>, smem);
    if (err) return err;
    block_merge_kernel<NC, R><<<n / len, threads, smem, stream>>>(
        cols, num_keys, len, k);
  } else {
    err = set_smem(block_sort_kernel<NC, R>, smem);
    if (err) return err;
    block_sort_kernel<NC, R><<<n / len, threads, smem, stream>>>(
        cols, num_keys, len, k);
  }
  return (int)cudaGetLastError();
}

template <int NC>
static int launch_block_rows(bool merge, Cols cols, int num_keys, unsigned n,
                             unsigned len, unsigned k, cudaStream_t stream) {
  constexpr int R = block_rows_full(NC);
  if (block_rows(NC, len) == R)
    return launch_block<NC, R>(merge, cols, num_keys, n, len, k, stream);
  return launch_block<NC, 1>(merge, cols, num_keys, n, len, k, stream);
}

// k: block_merge's stage, or block_sort_kernel's first stage.
static int launch_block_cols(bool merge, void* const* ptrs, int n_cols,
                             int num_keys, int n, int len, unsigned uk,
                             void* stream) {
  Cols c = make_cols(ptrs, n_cols);
  unsigned un = (unsigned)n, ul = (unsigned)len;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n_cols) {
    case 1: return launch_block_rows<1>(merge, c, num_keys, un, ul, uk, st);
    case 2: return launch_block_rows<2>(merge, c, num_keys, un, ul, uk, st);
    case 3: return launch_block_rows<3>(merge, c, num_keys, un, ul, uk, st);
    case 4: return launch_block_rows<4>(merge, c, num_keys, un, ul, uk, st);
    case 5: return launch_block_rows<5>(merge, c, num_keys, un, ul, uk, st);
    case 6: return launch_block_rows<6>(merge, c, num_keys, un, ul, uk, st);
    case 7: return launch_block_rows<7>(merge, c, num_keys, un, ul, uk, st);
    case 8: return launch_block_rows<8>(merge, c, num_keys, un, ul, uk, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int clo_block_sort(void* const* ptrs, int n_cols, int num_keys,
                              int n, int block, void* stream) {
  return launch_block_cols(false, ptrs, n_cols, num_keys, n, block, 2,
                           stream);
}

extern "C" int clo_multi_stage(void* const* ptrs, int n_cols, int num_keys,
                               int n, int block, int merge, void* stream) {
  return launch_block_cols(false, ptrs, n_cols, num_keys, n, merge,
                           2u * (unsigned)block, stream);
}

extern "C" int clo_block_merge(void* const* ptrs, int n_cols, int num_keys,
                               int n, int merge, int k, void* stream) {
  return launch_block_cols(true, ptrs, n_cols, num_keys, n, merge,
                           (unsigned)k, stream);
}

// The block kernels' geometry, for bitonic_kernels.block_geometry to check.
extern "C" int clo_block_rows(int n_cols, int len) {
  return block_rows(n_cols, (unsigned)len);
}

extern "C" long long clo_block_smem(int n_cols, int len) {
  return (long long)block_smem(n_cols, (unsigned)len);
}

// The grid of n / slice blocks must be co-resident, or it would deadlock at
// its first barrier instead of failing: checked here, on the host, before
// the launch, against the occupancy of this geometry on the current device.
// Returns cudaErrorCooperativeLaunchTooLarge when it is not. The device's
// facts, the kernel's shared-memory attribute and its occupancy are looked
// up once per (kernel, device, geometry), not on every call: each lookup
// costs microseconds of host time that the card would spend idle.
template <int NC, int R>
static int launch_whole(Cols cols, int num_keys, unsigned n, unsigned slice,
                        cudaStream_t stream) {
  auto kernel = whole_sort_kernel<NC, R>;
  unsigned threads = slice / R;
  if (slice < (unsigned)R || threads > MAX_THREADS || slice > n ||
      (unsigned long long)slice * slice < n)
    return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)NC * (slice + slice / 32) * sizeof(int32_t);
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  static std::mutex mu;
  static int c_dev = -1, c_blocks = 0;
  static unsigned c_threads = 0;
  static size_t c_smem = 0;
  int capacity;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (dev != c_dev || threads != c_threads || smem != c_smem) {
      int coop = 0, sms = 0, per_sm = 0;
      err = set_smem(kernel, smem);
      if (!err)
        err = (int)cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                          dev);
      if (!err)
        err = (int)cudaDeviceGetAttribute(
            &sms, cudaDevAttrMultiProcessorCount, dev);
      if (!err)
        err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, (int)threads, smem);
      if (err) return err;
      c_dev = dev;
      c_threads = threads;
      c_smem = smem;
      c_blocks = coop ? per_sm * sms : 0;
    }
    capacity = c_blocks;
  }
  unsigned blocks = n / slice;
  if (blocks > (unsigned)capacity)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  int vec = 1;  // every column 16-byte aligned
  for (int c = 0; c < NC; ++c)
    vec &= reinterpret_cast<uintptr_t>(cols.p[c]) % 16 == 0;
  void* args[] = {&cols, &vec, &num_keys, &n, &slice};
  err = (int)cudaLaunchCooperativeKernel((void*)kernel, blocks, threads, args,
                                         smem, stream);
  if (err) return err;
  return (int)cudaGetLastError();
}

template <int NC>
static int launch_whole_rows(Cols cols, int num_keys, unsigned n,
                             unsigned slice, int rows, cudaStream_t stream) {
  if (rows == whole_rows(NC))
    return launch_whole<NC, whole_rows(NC)>(cols, num_keys, n, slice, stream);
  if (rows == 1) return launch_whole<NC, 1>(cols, num_keys, n, slice, stream);
  return (int)cudaErrorInvalidValue;
}

// Rows per thread of the whole_sort kernels at n_cols columns.
extern "C" int clo_whole_rows(int n_cols) { return whole_rows(n_cols); }

extern "C" int clo_whole_sort(void* const* ptrs, int n_cols, int num_keys,
                              int n, int slice, int rows, void* stream) {
  Cols c = make_cols(ptrs, n_cols);
  unsigned un = (unsigned)n, us = (unsigned)slice;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n_cols) {
    case 1: return launch_whole_rows<1>(c, num_keys, un, us, rows, st);
    case 2: return launch_whole_rows<2>(c, num_keys, un, us, rows, st);
    case 3: return launch_whole_rows<3>(c, num_keys, un, us, rows, st);
    case 4: return launch_whole_rows<4>(c, num_keys, un, us, rows, st);
    case 5: return launch_whole_rows<5>(c, num_keys, un, us, rows, st);
    case 6: return launch_whole_rows<6>(c, num_keys, un, us, rows, st);
    case 7: return launch_whole_rows<7>(c, num_keys, un, us, rows, st);
    case 8: return launch_whole_rows<8>(c, num_keys, un, us, rows, st);
  }
  return (int)cudaErrorInvalidValue;
}
