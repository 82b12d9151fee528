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
// operations). Here a grid of a few blocks per SM strides over the rows and
// sends each row to its group by index: shared-memory atomics into the
// block's table (unsigned adds for SUM and COUNT, which wrap as the TPU's
// int32 adds do; signed min/max). Integer adds, mins and maxes are
// associative and commutative, so any order of the atomics gives the same
// bits. With few groups the 32 lanes of a warp hit few words, so each warp
// gets its own copy of the table where the copies fit COPY_BYTES of shared
// memory; at the end each block folds its copies and adds them into `out`
// with global atomics, skipping identities. One launch per call.
//
// Each entry point launches on the stream it is given, allocates nothing
// and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 512
#define WARPS (THREADS / 32)
#define MAX_RED 32
#define COPY_BYTES (48 * 1024)

enum { K_COUNT = 0, K_SUM = 1, K_MIN = 2, K_MAX = 3 };

struct Plan {
  const int32_t* src[MAX_RED];  // each reduction's column (count: none)
  int kind[MAX_RED];
  int flip[MAX_RED];
  int n_red;
};

__device__ __forceinline__ int32_t identity(int kind) {
  return kind == K_MIN ? INT32_MAX : kind == K_MAX ? INT32_MIN : 0;
}

__device__ __forceinline__ int32_t combine(int kind, int32_t a, int32_t b) {
  if (kind == K_MIN) return min(a, b);
  if (kind == K_MAX) return max(a, b);
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__global__ void __launch_bounds__(THREADS)
    dense_agg_kernel(const int32_t* __restrict__ gid,
                     const uint8_t* __restrict__ mask, const Plan plan,
                     long long n, int G, int copies,
                     int32_t* __restrict__ out) {
  extern __shared__ int32_t acc[];  // [copies][n_red][G]
  __shared__ int s_kind[MAX_RED];     // kinds by a runtime index
  if (threadIdx.x == 0) {
#pragma unroll
    for (int r = 0; r < MAX_RED; ++r) s_kind[r] = plan.kind[r];
  }
  __syncthreads();
  const int words = plan.n_red * G;
  for (int i = threadIdx.x; i < copies * words; i += blockDim.x)
    acc[i] = identity(s_kind[(i % words) / G]);
  __syncthreads();

  int32_t* mine = acc + ((threadIdx.x >> 5) % copies) * words;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int g = gid[i];
    if ((unsigned)g >= (unsigned)G || (mask != nullptr && mask[i] == 0))
      continue;
#pragma unroll
    for (int r = 0; r < MAX_RED; ++r) {  // unrolled: plan reads stay static
      if (r == plan.n_red) break;
      int32_t* slot = mine + r * G + g;
      const int kind = plan.kind[r];
      if (kind == K_COUNT) {
        atomicAdd((unsigned*)slot, 1u);
        continue;
      }
      int32_t v = __ldg(plan.src[r] + i);
      if (plan.flip[r]) v ^= INT32_MIN;
      if (kind == K_SUM)
        atomicAdd((unsigned*)slot, (unsigned)v);
      else if (kind == K_MIN)
        atomicMin(slot, v);
      else
        atomicMax(slot, v);
    }
  }
  __syncthreads();

  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    const int kind = s_kind[w / G];
    int32_t v = acc[w];
    for (int c = 1; c < copies; ++c) v = combine(kind, v, acc[c * words + w]);
    if (v == identity(kind)) continue;
    if (kind == K_COUNT || kind == K_SUM)
      atomicAdd((unsigned*)(out + w), (unsigned)v);
    else if (kind == K_MIN)
      atomicMin(out + w, v);
    else
      atomicMax(out + w, v);
  }
}

extern "C" int clo_dense_agg_max_red() { return MAX_RED; }

// src: n_red column pointers (null for count); kind, flip: n_red ints;
// mask: null or n bytes; out: n_red x G int32, filled with identities.
extern "C" int clo_dense_agg(const void* gid, const void* mask,
                             const void* const* src, const int* kind,
                             const int* flip, int n_red, long long n, int G,
                             void* out, void* stream) {
  if (n_red < 1 || n_red > MAX_RED || G < 1)
    return (int)cudaErrorInvalidValue;
  Plan plan = {};
  for (int r = 0; r < n_red; ++r) {
    plan.src[r] = static_cast<const int32_t*>(src[r]);
    plan.kind[r] = kind[r];
    plan.flip[r] = flip[r];
  }
  plan.n_red = n_red;
  if (n == 0) return 0;
  const size_t words = (size_t)n_red * G;
  int copies = WARPS;
  while (copies > 1 && copies * words * sizeof(int32_t) > COPY_BYTES)
    copies >>= 1;
  const size_t smem = copies * words * sizeof(int32_t);
  int err = (int)cudaFuncSetAttribute(
      dense_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if ((err = (int)cudaDeviceGetAttribute(
           &sms, cudaDevAttrMultiProcessorCount, dev)))
    return err;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, dense_agg_kernel, THREADS, smem)))
    return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  dense_agg_kernel<<<(unsigned)blocks, THREADS, smem,
                     (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(gid), static_cast<const uint8_t*>(mask),
      plan, n, G, copies, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
