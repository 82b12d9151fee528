// Bitonic compare-exchange kernels of the sorters "abitonic" (the fused
// schedule, or whole_sort with single_launch=1) and "sbitonic" (pair_cross
// once per network step), for Hopper (sm_90a). Built with nvcc into a shared library with a plain C
// interface and loaded with ctypes (cl_ops_tpu_torch/ops/sort/
// bitonic_kernels.py, which also holds each kernel's plain PyTorch version).
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
// All five kernels work in place. Each launch of the fused schedule's four
// reads and writes every column once, 2 * n_cols * 4 * n bytes of device
// memory: the kernels that keep a block in shared memory run many network
// steps per such sweep, and the one that works in device memory
// (pair_cross) runs one step per sweep with neighbouring threads on
// neighbouring addresses. whole_sort runs the whole network in one
// cooperative launch.
//
// Each entry point launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define MAX_COLS 8
#define MAX_THREADS 1024

struct Cols {
  int32_t* p[MAX_COLS];
};

// Strict order of rows a and b over the key prefix: -1 a<b, 1 a>b, 0 tied.
// `s` is a column-major block of `len` rows (column c at s + c * len).
__device__ __forceinline__ int order_smem(const int32_t* s, int len, int a,
                                          int b, int num_keys) {
#pragma unroll
  for (int c = 0; c < MAX_COLS; ++c) {
    if (c >= num_keys) break;
    int32_t x = s[c * len + a], y = s[c * len + b];
    if (x != y) return x < y ? -1 : 1;
  }
  return 0;
}

// Steps j = j_first .. 1 of stage `k` over one block held in shared memory;
// `base` is the block's first global index (it sets each pair's direction).
__device__ void smem_steps(int32_t* s, int len, unsigned base, unsigned k,
                           int j_first, int n_cols, int num_keys) {
  for (int j = j_first; j > 0; j >>= 1) {
    for (int p = threadIdx.x; p < len / 2; p += blockDim.x) {
      int lo = ((p & ~(j - 1)) << 1) | (p & (j - 1));
      int hi = lo + j;
      bool asc = ((base + (unsigned)lo) & k) == 0;
      int ord = order_smem(s, len, lo, hi, num_keys);
      if (asc ? ord > 0 : ord < 0) {
#pragma unroll
        for (int c = 0; c < MAX_COLS; ++c) {
          if (c >= n_cols) break;
          int32_t t = s[c * len + lo];
          s[c * len + lo] = s[c * len + hi];
          s[c * len + hi] = t;
        }
      }
    }
    __syncthreads();
  }
}

__device__ void load_block(const Cols& cols, int32_t* s, int len,
                           unsigned base, int n_cols) {
#pragma unroll
  for (int c = 0; c < MAX_COLS; ++c) {
    if (c >= n_cols) break;
    const int32_t* src = cols.p[c] + base;
    for (int i = threadIdx.x; i < len; i += blockDim.x) s[c * len + i] = src[i];
  }
  __syncthreads();
}

__device__ void store_block(const Cols& cols, const int32_t* s, int len,
                            unsigned base, int n_cols) {
#pragma unroll
  for (int c = 0; c < MAX_COLS; ++c) {
    if (c >= n_cols) break;
    int32_t* dst = cols.p[c] + base;
    for (int i = threadIdx.x; i < len; i += blockDim.x) dst[i] = s[c * len + i];
  }
}

// block_sort: replaces cl_ops_tpu/ops/sort/bitonic_kernels.py
// _block_sort_kernel. Full bitonic sort of each block of `block` rows, stages
// K = 2 .. block; with several blocks the top stage alternates direction by
// block parity (the global-index rule gives that). Bound on this card: one
// read and one write of every column; the design keeps the whole block in
// shared memory so that all log2(B)(log2(B)+1)/2 steps cost one sweep.
__global__ void block_sort_kernel(Cols cols, int n_cols, int num_keys,
                                  int block) {
  extern __shared__ int32_t smem[];
  unsigned base = blockIdx.x * (unsigned)block;
  load_block(cols, smem, block, base, n_cols);
  for (unsigned k = 2; k <= (unsigned)block; k <<= 1)
    smem_steps(smem, block, base, k, (int)(k >> 1), n_cols, num_keys);
  store_block(cols, smem, block, base, n_cols);
}

// multi_stage: replaces bitonic_kernels.py _multi_stage_kernel. Stages
// K = 2 * block .. merge inside blocks of `merge` rows (sorted runs of
// `block` rows in alternating directions come in). Unlike the TPU kernel it
// compares only the key prefix. Bound: one sweep of every column; a merge
// block as large as shared memory allows absorbs log2(merge/block) stages
// into that sweep.
__global__ void multi_stage_kernel(Cols cols, int n_cols, int num_keys,
                                   int block, int merge) {
  extern __shared__ int32_t smem[];
  unsigned base = blockIdx.x * (unsigned)merge;
  load_block(cols, smem, merge, base, n_cols);
  for (unsigned k = 2u * block; k <= (unsigned)merge; k <<= 1)
    smem_steps(smem, merge, base, k, (int)(k >> 1), n_cols, num_keys);
  store_block(cols, smem, merge, base, n_cols);
}

// One compare-exchange of step (k, j) in device memory: pair p is
// (lo, lo + j). The pair_cross kernel and the device-memory steps of
// whole_sort run it.
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
// sees a block at a time; here one kernel runs any step (k, j), j >= 1. One
// step in device memory: thread p owns the pair (lo, lo + j). Bound: one
// sweep of every column (here, a read of the key columns of every row and a
// write of the rows that swap). Neighbouring threads touch neighbouring
// addresses on both sides of the pair (at j < 32 a warp's lo and hi
// interleave within the same lines), so each warp's loads and stores
// coalesce.
__global__ void pair_cross_kernel(Cols cols, int n_cols, int num_keys,
                                  unsigned half, unsigned k, unsigned j) {
  unsigned p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= half) return;
  pair_step(cols, n_cols, num_keys, p, k, j);
}

// block_merge: replaces bitonic_kernels.py _block_merge_kernel. Steps
// j = merge/2 .. 1 of one stage k inside blocks of `merge` rows; the
// direction is uniform per block ((block index * merge) & k == 0), and k = 0
// serves the ascending merge of a whole bitonic sequence. Bound: one sweep
// of every column; shared memory holds the block for all log2(merge) steps.
__global__ void block_merge_kernel(Cols cols, int n_cols, int num_keys,
                                   int merge, unsigned k) {
  extern __shared__ int32_t smem[];
  unsigned base = blockIdx.x * (unsigned)merge;
  load_block(cols, smem, merge, base, n_cols);
  smem_steps(smem, merge, base, k, merge >> 1, n_cols, num_keys);
  store_block(cols, smem, merge, base, n_cols);
}

// whole_sort: replaces bitonic_kernels.py _vmem_sort_kernel, the whole
// network in one launch. One Hopper block's shared memory holds far less
// than the TPU kernel's 8 MB, so this is a cooperative launch of
// n / slice co-resident blocks, each holding a `slice`-row slice of every
// column in shared memory. Stages K <= slice run there (block_sort's
// global-index direction rule); each later stage K stores the slices, runs
// its steps J >= slice in device memory (each block takes its slice/2
// pairs) between grid-wide barriers, reloads its slice and runs the steps
// J < slice in shared memory. So it is the fused schedule's network in the
// fused schedule's order, and its output equals bitonic_sort_2d's bit for
// bit. Bound: one read and one write of every column; the device-memory
// steps stay in the 50 MB L2 (the problem is at most 8 MB), and at small n
// grid-barrier latency, not bytes, sets the time.
__global__ void __launch_bounds__(MAX_THREADS)
    whole_sort_kernel(Cols cols, int n_cols, int num_keys, unsigned n,
                      int slice) {
  extern __shared__ int32_t smem[];
  cg::grid_group grid = cg::this_grid();
  unsigned base = blockIdx.x * (unsigned)slice;
  unsigned half = (unsigned)slice / 2;
  load_block(cols, smem, slice, base, n_cols);
  for (unsigned k = 2; k <= (unsigned)slice; k <<= 1)
    smem_steps(smem, slice, base, k, (int)(k >> 1), n_cols, num_keys);
  for (unsigned k = 2u * slice; k <= n; k <<= 1) {
    store_block(cols, smem, slice, base, n_cols);
    grid.sync();
    for (unsigned j = k >> 1; j >= (unsigned)slice; j >>= 1) {
      for (unsigned t = threadIdx.x; t < half; t += blockDim.x)
        pair_step(cols, n_cols, num_keys, blockIdx.x * half + t, k, j);
      grid.sync();
    }
    load_block(cols, smem, slice, base, n_cols);
    smem_steps(smem, slice, base, k, slice >> 1, n_cols, num_keys);
  }
  store_block(cols, smem, slice, base, n_cols);
}

static Cols make_cols(void* const* ptrs, int n_cols) {
  Cols c;
  for (int i = 0; i < MAX_COLS; ++i)
    c.p[i] = i < n_cols ? static_cast<int32_t*>(ptrs[i]) : nullptr;
  return c;
}

// One thread per compare-exchange of a block, at least one (a 1-row block
// has no exchanges but still launches) and at most MAX_THREADS.
static int threads_for(int len) {
  int t = len / 2 < MAX_THREADS ? len / 2 : MAX_THREADS;
  return t > 0 ? t : 1;
}

template <typename Kernel>
static int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

extern "C" int clo_block_sort(void* const* ptrs, int n_cols, int num_keys,
                              int n, int block, void* stream) {
  size_t smem = (size_t)n_cols * block * sizeof(int32_t);
  int err = set_smem(block_sort_kernel, smem);
  if (err) return err;
  block_sort_kernel<<<n / block, threads_for(block), smem,
                      (cudaStream_t)stream>>>(make_cols(ptrs, n_cols), n_cols,
                                              num_keys, block);
  return (int)cudaGetLastError();
}

extern "C" int clo_multi_stage(void* const* ptrs, int n_cols, int num_keys,
                               int n, int block, int merge, void* stream) {
  size_t smem = (size_t)n_cols * merge * sizeof(int32_t);
  int err = set_smem(multi_stage_kernel, smem);
  if (err) return err;
  multi_stage_kernel<<<n / merge, threads_for(merge), smem,
                       (cudaStream_t)stream>>>(make_cols(ptrs, n_cols), n_cols,
                                               num_keys, block, merge);
  return (int)cudaGetLastError();
}

extern "C" int clo_pair_cross(void* const* ptrs, int n_cols, int num_keys,
                              int n, int k, int j, void* stream) {
  unsigned half = (unsigned)n / 2;
  unsigned threads = 256;
  pair_cross_kernel<<<(half + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(make_cols(ptrs, n_cols), n_cols,
                                              num_keys, half, (unsigned)k,
                                              (unsigned)j);
  return (int)cudaGetLastError();
}

extern "C" int clo_block_merge(void* const* ptrs, int n_cols, int num_keys,
                               int n, int merge, int k, void* stream) {
  size_t smem = (size_t)n_cols * merge * sizeof(int32_t);
  int err = set_smem(block_merge_kernel, smem);
  if (err) return err;
  block_merge_kernel<<<n / merge, threads_for(merge), smem,
                       (cudaStream_t)stream>>>(make_cols(ptrs, n_cols), n_cols,
                                               num_keys, merge, (unsigned)k);
  return (int)cudaGetLastError();
}

// The grid of n / slice blocks must be co-resident, or it would deadlock at
// its first barrier instead of failing: checked here, on the host, before
// the launch, against the occupancy of this geometry on the current device.
// Returns cudaErrorCooperativeLaunchTooLarge when it is not.
extern "C" int clo_whole_sort(void* const* ptrs, int n_cols, int num_keys,
                              int n, int slice, void* stream) {
  size_t smem = (size_t)n_cols * slice * sizeof(int32_t);
  int threads = threads_for(slice);
  int err = set_smem(whole_sort_kernel, smem);
  if (err) return err;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  err = (int)cudaGetDevice(&dev);
  if (err) return err;
  err = (int)cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err) return err;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
  if (err) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, whole_sort_kernel, threads, smem);
  if (err) return err;
  int blocks = n / slice;
  if (!coop || blocks > per_sm * sms)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  Cols cols = make_cols(ptrs, n_cols);
  unsigned un = (unsigned)n;
  void* args[] = {&cols, &n_cols, &num_keys, &un, &slice};
  err = (int)cudaLaunchCooperativeKernel((void*)whole_sort_kernel, blocks,
                                         threads, args, smem,
                                         (cudaStream_t)stream);
  if (err) return err;
  return (int)cudaGetLastError();
}
