// The rank/histogram phase of the LSD radix sorter ("satradix"), for Hopper
// (sm_90a). Built with nvcc into a shared library with a plain C interface
// and loaded with ctypes (cl_ops_tpu_torch/ops/sort/radix_kernels.py, which
// also holds the kernel's plain PyTorch version).
//
// rank_hist: replaces cl_ops_tpu/ops/sort/satradix.py _rank_hist_kernel.
// The digits are cut into tiles of `tile` elements (the last one may be
// short). For each element: its rank, the count of earlier elements of its
// tile with the same digit; for each tile: its count per digit bin,
// hist[tile * radix + bin]. A digit outside [0, radix) matches no bin: it
// gets rank 0 and is not counted (the TPU kernel's padding digit).
//
// Bound on this card: a read of 4 bytes and a write of 4 bytes per element
// (the histogram is radix / tile of that). The design reads each digit once
// and keeps everything else in shared memory: each of the block's WARPS
// warps walks its own contiguous run of the tile in order, 32 digits at a
// time; __match_any_sync gives the lanes that share a digit, the count of
// lower peers is the rank inside the 32, and the lowest peer adds the
// peers to the warp's running count of that bin. Those per-warp counts are
// then scanned across the warps in order, so that a rank counts every
// earlier element of the tile; ranks are staged in shared memory and
// written with the warp offsets added, coalesced.
//
// Each entry point launches on the stream it is given, allocates nothing
// and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#define WARPS 16
#define NO_BIN 0xFFFFu

__global__ void __launch_bounds__(WARPS * 32)
    rank_hist_kernel(const int32_t* __restrict__ digits,
                     int32_t* __restrict__ rank, int32_t* __restrict__ hist,
                     long long n, int tile, int radix) {
  extern __shared__ int32_t smem[];
  int32_t* cnt = smem;                                    // [WARPS][radix]
  int32_t* s_rank = smem + WARPS * radix;                 // [tile]
  uint16_t* s_bin = (uint16_t*)(s_rank + tile);           // [tile]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = (long long)blockIdx.x * tile;
  const int len = (int)(n - base < tile ? n - base : tile);
  for (int i = threadIdx.x; i < WARPS * radix; i += blockDim.x) cnt[i] = 0;
  __syncthreads();

  const int run = tile / WARPS;  // contiguous elements per warp
  const unsigned lower = (1u << lane) - 1u;
  int32_t* mine = cnt + warp * radix;
  for (int off = warp * run; off < (warp + 1) * run && off < len; off += 32) {
    const int i = off + lane;
    int d = i < len ? digits[base + i] : -1;
    const bool valid = (unsigned)d < (unsigned)radix;
    if (!valid) d = -1;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    const int below = __popc(peers & lower);
    const int before = valid ? mine[d] : 0;
    __syncwarp();
    if (valid && below == 0) mine[d] = before + __popc(peers);
    __syncwarp();
    if (i < len) {
      s_rank[i] = before + below;
      s_bin[i] = valid ? (uint16_t)d : (uint16_t)NO_BIN;
    }
  }
  __syncthreads();

  // Exclusive scan of each bin's per-warp counts, in warp order; the total
  // is the tile's histogram entry.
  for (int b = threadIdx.x; b < radix; b += blockDim.x) {
    int sum = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int c = cnt[w * radix + b];
      cnt[w * radix + b] = sum;
      sum += c;
    }
    hist[(long long)blockIdx.x * radix + b] = sum;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const unsigned b = s_bin[i];
    rank[base + i] = b == NO_BIN ? 0 : s_rank[i] + cnt[(i / run) * radix + b];
  }
}

extern "C" int clo_rank_hist(const void* digits, void* rank, void* hist,
                             long long n, int tile, int radix, void* stream) {
  size_t smem = (size_t)WARPS * radix * sizeof(int32_t) +
                (size_t)tile * (sizeof(int32_t) + sizeof(uint16_t));
  int err = (int)cudaFuncSetAttribute(
      rank_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err) return err;
  long long blocks = (n + tile - 1) / tile;
  if (blocks == 0) return 0;
  rank_hist_kernel<<<(unsigned)blocks, WARPS * 32, smem,
                     (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(digits), static_cast<int32_t*>(rank),
      static_cast<int32_t*>(hist), n, tile, radix);
  return (int)cudaGetLastError();
}
