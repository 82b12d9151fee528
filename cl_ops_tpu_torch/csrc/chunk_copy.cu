// Blocked run copy for Hopper (sm_90a). Built with nvcc into a shared
// library with a plain C interface and loaded with ctypes
// (cl_ops_tpu_torch/ops/sort/dma_scatter.py, which also holds the kernel's
// plain PyTorch version).
//
// chunk_copy: replaces cl_ops_tpu/ops/sort/dma_scatter.py
// _chunk_copy_kernel. Chunk c of a (5, n_chunks) int32 table
// [src block, row roll, lane shift, rem, dst block] copies
//   out[dst * CHUNK + t] = t < rem ? src[src_elem + t] : 0x7FFFFFFF
// for t < CHUNK, with src_elem = block * CHUNK + roll * 128 + shift, for up
// to MAX_ARRAYS int32 arrays at once. A read past the end of the source
// gives the sentinel, and a chunk whose dst lies outside [0, n_chunks)
// writes nothing.
//
// Bound on this card: the bytes copied, rem * 4 read and CHUNK * 4 written
// per chunk and array. The TPU kernel gets the table through scalar
// prefetch and reads two aligned source blocks per chunk, realigning them
// with a row roll and a lane gather, because its DMA moves aligned tiles.
// Here one block of 256 threads per chunk reads its own table row from
// device memory and copies 4 elements a thread: neighbouring threads read
// neighbouring words, so the unaligned reads coalesce with no realignment.
//
// Each entry point launches on the stream it is given, allocates nothing
// and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#define CHUNK 1024
#define LANES 128
#define THREADS 256
#define MAX_ARRAYS 8
#define SENTINEL 0x7FFFFFFF

struct Arrays {
  const int32_t* src[MAX_ARRAYS];
  int32_t* out[MAX_ARRAYS];
  int n;
};

__global__ void __launch_bounds__(THREADS)
    chunk_copy_kernel(const int32_t* __restrict__ params, Arrays arrs,
                      long long n_chunks, long long n_src) {
  const long long c = blockIdx.x;
  const long long blk = params[c];
  const long long roll = params[n_chunks + c];
  const long long shift = params[2 * n_chunks + c];
  const int rem = params[3 * n_chunks + c];
  const long long dst = params[4 * n_chunks + c];
  if (dst < 0 || dst >= n_chunks) return;
  const long long src_elem = blk * CHUNK + roll * LANES + shift;
#pragma unroll
  for (int a = 0; a < MAX_ARRAYS; ++a) {  // unrolled: pointer reads static
    if (a == arrs.n) break;
    const int32_t* __restrict__ src = arrs.src[a];
    int32_t* __restrict__ out = arrs.out[a] + dst * CHUNK;
#pragma unroll
    for (int k = 0; k < CHUNK / THREADS; ++k) {
      const int t = threadIdx.x + k * THREADS;
      const long long s = src_elem + t;
      out[t] = (t < rem && s >= 0 && s < n_src) ? src[s] : SENTINEL;
    }
  }
}

extern "C" int clo_chunk_copy_max_arrays() { return MAX_ARRAYS; }

// src, out: n_arrays pointers (each source n_src int32, each output
// n_chunks * CHUNK int32); params: the (5, n_chunks) int32 table on the
// device.
extern "C" int clo_chunk_copy(const void* const* src, void* const* out,
                              int n_arrays, const void* params,
                              long long n_chunks, long long n_src,
                              void* stream) {
  if (n_arrays < 1 || n_arrays > MAX_ARRAYS) return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return 0;
  Arrays arrs = {};
  for (int a = 0; a < n_arrays; ++a) {
    arrs.src[a] = static_cast<const int32_t*>(src[a]);
    arrs.out[a] = static_cast<int32_t*>(out[a]);
  }
  arrs.n = n_arrays;
  chunk_copy_kernel<<<(unsigned)n_chunks, THREADS, 0,
                      (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(params), arrs, n_chunks, n_src);
  return (int)cudaGetLastError();
}
