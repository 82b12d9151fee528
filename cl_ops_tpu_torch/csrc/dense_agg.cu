// Dense GROUP BY accumulation for Hopper (sm_90a). Built with nvcc into a
// shared library with a plain C interface and loaded with ctypes
// (cl_ops_tpu_torch/ops/exec/dense_agg.py, which also holds the kernel's
// plain PyTorch version).
//
// dense_agg: replaces cl_ops_tpu/ops/exec/dense_agg.py _dense_kernel and
// its lane combine. For each reduction r and group g < G it computes
// out[r * G + g] over the rows i with 0 <= gid[i] < G (and mask[i] != 0
// where a mask is given):
//   COUNT  the number of such rows,
//   SUM    the sum of src_r[i] mod 2^32,
//   MIN    the least src_r[i] (flip_r: of src_r[i] ^ 0x80000000),
//   MAX    the greatest.
// The caller fills `out` with each reduction's identity (0, INT32_MAX,
// INT32_MIN) before the launch. With flip_r the table is left in the
// flipped domain, as the TPU kernel leaves its lane partials; the caller
// flips it back, where JAX does after its lane combine.
//
// Bound on this card: one read of every input (4 bytes of gid, 1 of mask,
// 4 per distinct source column) per row; the tables are KBs. The TPU kernel
// routes rows by comparing every row with every group (G x n lane
// operations). Here a grid of as many blocks as the SMs hold strides over
// the rows, four rows a thread at a time: one 16-byte load of ids, the four
// mask bytes as one word, and one 16-byte load of each distinct column
// (the plan lists columns apart from reductions, so a column that feeds a
// sum, a min and a max is read once). Rows before the id column's first
// 16-byte boundary, and the ragged tail, go one at a time; so do all rows
// when the columns do not share the ids' alignment. Each row goes to its
// group's slot with one shared-memory atomic per reduction (unsigned adds
// for SUM and COUNT, which wrap as the TPU's int32 adds do; signed min and
// max). Integer adds, mins and maxes are associative and commutative, so
// any order of the atomics gives the same bits. Each block holds up to
// MAX_COPIES copies of the table within COPY_BYTES, thread t using copy
// t % copies, with an odd pitch between copies: with few groups the 32
// lanes of a warp then hit 32 different copies in different banks, where
// one copy would serialise them (8 ways at G = 4); at the end each block
// folds its copies and adds them into `out` with global atomics, skipping
// identities. One launch per call.
//
// On the H100 this one form held about the same time at 16M masked rows
// and 6 reductions from G = 1 to G = 1024. A form holding the table in
// registers (a predicated update of every slot per row) was no faster at
// G <= 2 and slower from G = 4, its work growing with G x reductions;
// combining a warp's lanes of one group first (__match_any_sync, then
// __reduce_*_sync over the peer mask) made the atomics several times
// slower. Neither is kept.
//
// Each entry point launches on the stream it is given, allocates nothing
// and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 512
#define MAX_RED 32
#define MAX_COPIES 64
#define COPY_BYTES (48 * 1024)

enum { K_COUNT = 0, K_SUM = 1, K_MIN = 2, K_MAX = 3 };

// The reductions in plan order: the counts first, then those of each
// distinct column in turn (column c feeds plan positions
// [col_start[c], col_start[c + 1])). out_row maps a plan position to the
// caller's reduction, the row of `out` it fills.
struct Plan {
  const int32_t* col[MAX_RED];
  int col_start[MAX_RED + 1];
  int kind[MAX_RED];
  int flip[MAX_RED];   // 0 or INT32_MIN, xored into the value
  int out_row[MAX_RED];
  int n_red, n_col;
};

__device__ __forceinline__ int32_t identity(int kind) {
  return kind == K_MIN ? INT32_MAX : kind == K_MAX ? INT32_MIN : 0;
}

__device__ __forceinline__ int32_t combine(int kind, int32_t a, int32_t b) {
  if (kind == K_MIN) return min(a, b);
  if (kind == K_MAX) return max(a, b);
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ void atomic_combine(int kind, int32_t* slot,
                                               int32_t v) {
  if (kind == K_MIN)
    atomicMin(slot, v);
  else if (kind == K_MAX)
    atomicMax(slot, v);
  else
    atomicAdd((unsigned*)slot, (unsigned)v);
}

// The row index of a thread's i-th scalar row: the rows before `head`,
// then the tail from `body_end`.
__device__ __forceinline__ long long scalar_row(long long i, long long head,
                                                long long body_end) {
  return i < head ? i : body_end + (i - head);
}

// Combine K rows (ids ge, -1 for a dropped row; row i of the first, K = 4:
// a 16-byte aligned run of 4 rows) into the thread's copy of the table.
template <int K>
__device__ __forceinline__ void add_rows(int32_t* tab, const Plan& plan,
                                         int G, const int (&ge)[K],
                                         long long i) {
  for (int r = 0; r < plan.col_start[0]; ++r)  // the counts
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (ge[k] >= 0) atomicAdd((unsigned*)(tab + r * G + ge[k]), 1u);
  for (int c = 0; c < plan.n_col; ++c) {
    int32_t x[K];
    if constexpr (K == 4) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(plan.col[c] + i));
      x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
    } else {
      x[0] = plan.col[c][i];
    }
    for (int r = plan.col_start[c]; r < plan.col_start[c + 1]; ++r) {
      const int kind = plan.kind[r], flip = plan.flip[r];
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (ge[k] >= 0) atomic_combine(kind, tab + r * G + ge[k], x[k] ^ flip);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    dense_agg_kernel(const int32_t* __restrict__ gid,
                     const uint8_t* __restrict__ mask,
                     const __grid_constant__ Plan plan, long long n,
                     long long head, int G, int copies,
                     int32_t* __restrict__ out) {
  extern __shared__ int32_t tab[];  // [copies][pitch], pitch = words | 1
  const int words = plan.n_red * G, pitch = words | 1;
  for (int i = threadIdx.x; i < copies * pitch; i += THREADS)
    tab[i] = identity(plan.kind[min(i % pitch, words - 1) / G]);
  __syncthreads();

  int32_t* mine = tab + (threadIdx.x % copies) * pitch;
  const long long nvec = (n - head) >> 2, body_end = head + 4 * nvec;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long t0 = (long long)blockIdx.x * THREADS + threadIdx.x;
  for (long long q = t0; q < nvec; q += stride) {
    const long long i = head + 4 * q;
    const int4 g4 = __ldg(reinterpret_cast<const int4*>(gid + i));
    const uint32_t m4 =
        mask ? __ldg(reinterpret_cast<const uint32_t*>(mask + i))
             : 0x01010101u;
    int ge[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if ((unsigned)ge[k] >= (unsigned)G || !((m4 >> (8 * k)) & 0xFFu))
        ge[k] = -1;
    add_rows<4>(mine, plan, G, ge, i);
  }
  for (long long s = t0; s < head + (n - body_end); s += stride) {
    const long long i = scalar_row(s, head, body_end);
    int ge[1] = {gid[i]};
    if ((unsigned)ge[0] >= (unsigned)G || (mask && !mask[i])) ge[0] = -1;
    add_rows<1>(mine, plan, G, ge, i);
  }
  __syncthreads();

  for (int w = threadIdx.x; w < words; w += THREADS) {
    const int r = w / G, kind = plan.kind[r];
    int32_t v = tab[w];
    for (int c = 1; c < copies; ++c) v = combine(kind, v, tab[c * pitch + w]);
    if (v != identity(kind))
      atomic_combine(kind, out + plan.out_row[r] * G + w % G, v);
  }
}

// ---- host side ----------------------------------------------------------------

extern "C" int clo_dense_agg_max_red() { return MAX_RED; }

// src: n_red column pointers (null for count); kind, flip: n_red ints;
// mask: null or n bytes; out: n_red x G int32, filled with identities.
extern "C" int clo_dense_agg(const void* gid, const void* mask,
                             const void* const* src, const int* kind,
                             const int* flip, int n_red, long long n, int G,
                             void* out, void* stream) {
  if (n_red < 1 || n_red > MAX_RED || G < 1)
    return (int)cudaErrorInvalidValue;
  // the plan: counts first, then each distinct column's reductions
  Plan plan = {};
  for (int r = 0; r < n_red; ++r) {
    if (kind[r] < K_COUNT || kind[r] > K_MAX ||
        (kind[r] == K_COUNT) != (src[r] == nullptr))
      return (int)cudaErrorInvalidValue;
    if (kind[r] == K_COUNT) {
      plan.out_row[plan.n_red] = r;
      plan.kind[plan.n_red++] = K_COUNT;
    }
  }
  for (int r = 0; r < n_red; ++r) {
    if (kind[r] == K_COUNT) continue;
    int c = 0;
    while (c < plan.n_col && plan.col[c] != src[r]) ++c;
    if (c < plan.n_col) continue;  // placed with its column's first use
    plan.col[plan.n_col] = static_cast<const int32_t*>(src[r]);
    plan.col_start[plan.n_col] = plan.n_red;
    for (int t = r; t < n_red; ++t) {
      if (src[t] != src[r]) continue;
      plan.out_row[plan.n_red] = t;
      plan.kind[plan.n_red] = kind[t];
      plan.flip[plan.n_red++] = flip[t] ? INT32_MIN : 0;
    }
    ++plan.n_col;
  }
  // col_start[c] for c = n_col closes the last column; with no column,
  // col_start[0] is the count of counts
  plan.col_start[plan.n_col] = plan.n_red;
  if (plan.n_col == 0) plan.col_start[0] = plan.n_red;
  if (n == 0) return 0;

  // vector rows start where the ids reach a 16-byte boundary; they need
  // every column there too, and the mask at a 4-byte boundary
  long long head = ((16 - ((uintptr_t)gid & 15)) & 15) / 4;
  bool vec = head <= n;
  for (int c = 0; c < plan.n_col; ++c)
    vec = vec && (((uintptr_t)plan.col[c] + 4 * head) & 15) == 0;
  if (mask) vec = vec && (((uintptr_t)mask + head) & 3) == 0;
  if (!vec) head = n;
  const long long work = (n - head) / 4 + head + (n - head) % 4;

  // as many copies of the table as fit, and as many blocks as the card
  // holds at once, or fewer for little work
  const size_t pitch = (size_t)n_red * G | 1;
  long long copies = COPY_BYTES / (pitch * sizeof(int32_t));
  if (copies > MAX_COPIES) copies = MAX_COPIES;
  if (copies < 1) copies = 1;
  const size_t smem = copies * pitch * sizeof(int32_t);
  static int sms = 0;
  int err = 0, per_sm = 0;
  if (!sms) {
    int dev = 0;
    if ((err = (int)cudaGetDevice(&dev))) return err;
    if ((err = (int)cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)))
      return err;
  }
  if ((err = (int)cudaFuncSetAttribute(
           dense_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           (int)smem)))
    return err;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, dense_agg_kernel, THREADS, smem)))
    return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  dense_agg_kernel<<<(unsigned)blocks, THREADS, smem,
                     (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(gid), static_cast<const uint8_t*>(mask),
      plan, n, head, G, (int)copies, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
