// The rank/histogram phase of the LSD radix sorter ("satradix"), for Hopper
// (sm_90a). Built with nvcc into a shared library with a plain C interface
// and loaded with ctypes (cl_ops_tpu_torch/ops/sort/radix_kernels.py, which
// also holds the kernel's plain PyTorch version).
//
// rank_hist: replaces cl_ops_tpu/ops/sort/satradix.py _rank_hist_kernel.
// The digits are cut into tiles of `tile` elements (the last one may be
// short). For each element: its rank, the count of earlier elements of its
// tile with the same digit; for each tile: its count per digit bin,
// hist[tile * radix + bin]. Two entry points run the same kernel body:
//   clo_rank_hist       reads int32 digits; a digit outside [0, radix)
//                       matches no bin: it gets rank 0 and is not counted
//                       (the TPU kernel's padding digit);
//   clo_rank_hist_limb  reads an int32 key limb and cuts the digit itself,
//                       ((limb ^ 0x80000000) >> shift) & (radix - 1) (the
//                       sorter's digit of the key's unsigned bits), and
//                       also writes each element's bucket,
//                       digit * n_blocks + tile, the index of its counter
//                       in the sorter's digit-major scan.
//
// Bound on this card: a read of 4 bytes and a write of 4 bytes per element
// (8 with the bucket); the histogram is radix / tile of that. The design
// keeps everything but the per-warp bin counts in registers: each of the
// block's WARPS warps owns a contiguous run of the tile, which its lanes
// hold in striped order (element 32 j + lane of the run in round j), all of
// it loaded before the first compare, so a warp has up to 32 coalesced
// loads in flight. In each round the lanes that share a digit are found by
// one ballot per digit bit, ANDed as the bit or its complement
// (__match_any_sync was slower on the H100 at radix 16 and 256); the
// lowest of them adds the peer count to the warp's count of that bin in
// shared memory, and the rank inside the run is that count before the
// add plus the lower peers. The WARPS x radix counts are then scanned
// per bin in warp order by the whole block (16 lanes a bin, a shuffle
// scan), and each rank is written from registers with its warp's offset
// added, coalesced. Shared memory is the counts alone: 1 KB at radix 16,
// 16 KB at radix 256.
//
// Each entry point launches on the stream it is given, allocates nothing
// and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#define WARPS 16
#define THREADS (WARPS * 32)
#define FULL 0xFFFFFFFFu
#define NO_BIN 0x100u     // packed digit field of an element in no bin
#define DIGIT_MASK 0x1FFu
#define RANK_SHIFT 9      // packed: rank in the warp's run << 9 | digit

// RMAX: rounds a lane holds (>= tile / THREADS); LIMB: cut the digit from
// a key limb and write the bucket.
template <int RMAX, bool LIMB>
__global__ void __launch_bounds__(THREADS, RMAX > 16 ? 2 : 3)
    rank_hist_kernel(const int32_t* __restrict__ in,
                     int32_t* __restrict__ rank, int32_t* __restrict__ hist,
                     int32_t* __restrict__ bucket, long long n, int tile,
                     int radix, int shift, int n_blocks) {
  extern __shared__ int32_t cnt[];  // [WARPS][radix]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rounds = tile / THREADS;
  const long long first = (long long)blockIdx.x * tile +
                          (long long)warp * rounds * 32 + lane;
  int32_t v[RMAX];
#pragma unroll
  for (int j = 0; j < RMAX; ++j)
    v[j] = j < rounds && first + 32 * j < n ? __ldg(in + first + 32 * j) : 0;
  uint32_t p[RMAX];
#pragma unroll
  for (int j = 0; j < RMAX; ++j) {
    const bool here = j < rounds && first + 32 * j < n;
    if (LIMB)
      p[j] = here ? (((uint32_t)v[j] ^ 0x80000000u) >> shift) & (radix - 1)
                  : NO_BIN;
    else
      p[j] = here && (uint32_t)v[j] < (uint32_t)radix ? (uint32_t)v[j]
                                                      : NO_BIN;
  }
  for (int i = threadIdx.x; i < WARPS * radix; i += THREADS) cnt[i] = 0;
  __syncthreads();

  const int bits = __ffs(radix) - 1;
  const unsigned lower = (1u << lane) - 1u;
  int32_t* mine = cnt + warp * radix;
#pragma unroll
  for (int j = 0; j < RMAX; ++j) {
    if (j == rounds) break;
    const uint32_t d = p[j];
    const bool valid = d != NO_BIN;
    unsigned peers = __ballot_sync(FULL, valid);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k == bits) break;
      const bool bit = (d >> k) & 1u;
      const unsigned b = __ballot_sync(FULL, bit);
      peers &= bit ? b : ~b;
    }
    const int leader = __ffs(peers) - 1;
    int before = 0;
    if (valid && leader == lane) before = atomicAdd(mine + d, __popc(peers));
    // the atomics of a round complete before the next round's: every lane
    // waits here for its leader's
    before = __shfl_sync(FULL, before, valid ? leader : lane);
    if (valid)
      p[j] = (uint32_t)(before + __popc(peers & lower)) << RANK_SHIFT | d;
  }
  __syncthreads();

  // Exclusive scan of each bin's per-warp counts in warp order, 16 lanes a
  // bin; the total is the tile's histogram entry. WARPS * radix is a
  // multiple of 32, so a warp is active or idle as a whole.
  for (int e = threadIdx.x; e < WARPS * radix; e += THREADS) {
    const int b = e / WARPS, w = e % WARPS;
    const int c = cnt[w * radix + b];
    int s = c;
#pragma unroll
    for (int o = 1; o < WARPS; o <<= 1) {
      const int t = __shfl_up_sync(FULL, s, o, WARPS);
      if (w >= o) s += t;
    }
    cnt[w * radix + b] = s - c;
    if (w == WARPS - 1) hist[(long long)blockIdx.x * radix + b] = s;
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < RMAX; ++j) {
    if (j == rounds) break;
    const long long i = first + 32 * j;
    if (i >= n) break;
    const uint32_t d = p[j] & DIGIT_MASK;
    rank[i] = d == NO_BIN ? 0 : (int32_t)(p[j] >> RANK_SHIFT) + mine[d];
    if (LIMB) bucket[i] = (int32_t)d * n_blocks + (int32_t)blockIdx.x;
  }
}

// Rounds a lane holds, rounded up to the instance that holds them.
template <bool LIMB>
static int launch(const void* in, void* rank, void* hist, void* bucket,
                  long long n, int tile, int radix, int shift, void* stream) {
  if (tile <= 0 || tile % THREADS || radix < 2 || radix > 256 ||
      (radix & (radix - 1)))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + tile - 1) / tile;
  if (blocks == 0) return 0;
  const int rounds = tile / THREADS;
  const size_t smem = (size_t)WARPS * radix * sizeof(int32_t);
  const int32_t* i = static_cast<const int32_t*>(in);
  int32_t* r = static_cast<int32_t*>(rank);
  int32_t* h = static_cast<int32_t*>(hist);
  int32_t* b = static_cast<int32_t*>(bucket);
  const int nb = (int)blocks;
#define CLO_RANK_HIST(RM)                                                  \
  rank_hist_kernel<RM, LIMB><<<(unsigned)blocks, THREADS, smem,            \
                               (cudaStream_t)stream>>>(i, r, h, b, n, tile,  \
                                                       radix, shift, nb)
  if (rounds <= 1) CLO_RANK_HIST(1);
  else if (rounds <= 2) CLO_RANK_HIST(2);
  else if (rounds <= 4) CLO_RANK_HIST(4);
  else if (rounds <= 8) CLO_RANK_HIST(8);
  else if (rounds <= 16) CLO_RANK_HIST(16);
  else if (rounds <= 32) CLO_RANK_HIST(32);
  else return (int)cudaErrorInvalidValue;
#undef CLO_RANK_HIST
  return (int)cudaGetLastError();
}

// digits, rank: n int32; hist: ceil(n / tile) x radix int32.
extern "C" int clo_rank_hist(const void* digits, void* rank, void* hist,
                             long long n, int tile, int radix, void* stream) {
  return launch<false>(digits, rank, hist, nullptr, n, tile, radix, 0,
                       stream);
}

// limb, rank, bucket: n int32; hist: ceil(n / tile) x radix int32.
extern "C" int clo_rank_hist_limb(const void* limb, int shift, void* rank,
                                  void* bucket, void* hist, long long n,
                                  int tile, int radix, void* stream) {
  if (shift < 0 || shift > 31) return (int)cudaErrorInvalidValue;
  return launch<true>(limb, rank, hist, bucket, n, tile, radix, shift,
                      stream);
}
