// Band probe of the join for Hopper (sm_90a): per probe key, a
// searchsorted-right count inside a window of the sorted build side, the
// match flag and the neighbouring build values. Built with nvcc into a
// shared library with a plain C interface and loaded with ctypes
// (cl_ops_tpu_torch/ops/exec/bandprobe.py, which also holds the plain
// PyTorch version and computes the window starts).
//
// Replaces cl_ops_tpu/ops/exec/bandprobe.py _probe_band_kernel. On the TPU
// a vreg cannot gather across its 128 lanes, so that kernel transposed the
// band through exact 16-bit MXU matmuls and ran a 7-step row search plus a
// 128-lane sweep. None of that carries over: here a thread binary-searches
// its probe in shared memory and gathers the values from device memory.
//
// What it computes, for probe p (1 or 2 int32 limbs, signed lexicographic
// order) of probe block i, with offs = starts[i] * BUILD_BLOCK and the
// window [offs, min(offs + WINDOW, nb)) of the sorted build side:
//   count       = offs + #{window rows <= p}
//   eq          = count > 0 && build[count - 1] == p
//   val_prev[k] = vals_k[max(count - 1, 0)]
//   val_next[k] = vals_k[min(count, nb - 1)]
// (all zero when nb == 0). Probe blocks are `probe_block` consecutive
// probes; every probe of block i is searched in block i's window.
//
// Design: a CUDA block takes CHUNK probes of one probe block, loads that
// block's window of key limbs into dynamic shared memory (16384 rows x 4
// bytes = 64 KB per limb), and each thread runs a branch-free 15-step
// search for each of its PER_THREAD probes (warp-striped, so loads and
// stores of a warp are contiguous). The value columns stay in device memory
// and L2: three of them with one limb would not fit shared memory, and
// sorted probes gather them nearly in order.
//
// Bound: bytes. Each probe's limbs are read once and its 5 + 8 * n_vals
// output bytes written once (count int32, eq one byte, two int32 values per
// column); each probe block reads its window of limbs and values once. The
// window loads of the other CHUNKs of a probe block come from L2. About 30
// compares per probe are far under the operation bound.
//
// The entry point launches on the stream it is given, allocates nothing
// and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 512
#define PER_THREAD 16
#define CHUNK (THREADS * PER_THREAD)
#define BUILD_BLOCK 4096
#define WINDOW 16384
#define MAX_VALS 3

struct BandArgs {
  const int32_t* probe[2];
  const int32_t* build[2];
  const int32_t* vals[MAX_VALS];
  const int32_t* starts;
  int32_t* count;
  uint8_t* eq;
  int32_t* vprev[MAX_VALS];
  int32_t* vnext[MAX_VALS];
  long long m;
  long long nb;
  long long probe_block;
  long long chunks_per_block;
};

// a <= b in signed lexicographic order of NL limbs.
template <int NL>
__device__ __forceinline__ bool lex_le(const int32_t* a, const int32_t* b) {
  if (NL == 1) return a[0] <= b[0];
  return a[0] < b[0] || (a[0] == b[0] && a[1] <= b[1]);
}

template <int NL, int NV>
__global__ void __launch_bounds__(THREADS) probe_band_kernel(BandArgs a) {
  extern __shared__ int32_t s_keys[];  // NL windows of WINDOW rows
  const long long pb = blockIdx.x / a.chunks_per_block;
  const long long chunk = blockIdx.x % a.chunks_per_block;
  const long long offs = (long long)a.starts[pb] * BUILD_BLOCK;
  long long wend = offs + WINDOW;
  if (wend > a.nb) wend = a.nb;
  const int wl = wend > offs ? (int)(wend - offs) : 0;
  for (int l = 0; l < NL; ++l)
    for (int j = threadIdx.x; j < wl; j += THREADS)
      s_keys[l * WINDOW + j] = a.build[l][offs + j];
  __syncthreads();

  long long lim = (pb + 1) * a.probe_block;
  if (lim > a.m) lim = a.m;
  const long long first = pb * a.probe_block + chunk * CHUNK;
#pragma unroll 4
  for (int k = 0; k < PER_THREAD; ++k) {
    const long long i = first + (long long)k * THREADS + threadIdx.x;
    if (i >= lim) break;
    int32_t p[2], key[2];
#pragma unroll
    for (int l = 0; l < NL; ++l) p[l] = a.probe[l][i];
    // pos = #{window rows <= p}: the largest prefix whose last row is <= p
    int pos = 0;
#pragma unroll
    for (int step = WINDOW; step >= 1; step >>= 1) {
      const int cand = pos + step;
      if (cand <= wl) {
#pragma unroll
        for (int l = 0; l < NL; ++l) key[l] = s_keys[l * WINDOW + cand - 1];
        if (lex_le<NL>(key, p)) pos = cand;
      }
    }
    const long long cnt = offs + pos;
    bool eq = cnt > 0;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      // the last row <= p: in the window, or the row before it
      const int32_t b = pos > 0 ? s_keys[l * WINDOW + pos - 1]
                                : (cnt > 0 ? a.build[l][cnt - 1] : 0);
      eq = eq && b == p[l];
    }
    a.count[i] = (int32_t)cnt;
    a.eq[i] = eq ? 1 : 0;
    const long long ip = cnt > 0 ? cnt - 1 : 0;
    const long long in = cnt < a.nb ? cnt : a.nb - 1;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      a.vprev[v][i] = a.nb > 0 ? a.vals[v][ip] : 0;
      a.vnext[v][i] = a.nb > 0 ? a.vals[v][in] : 0;
    }
  }
}

template <int NL, int NV>
static int launch(const BandArgs& a, long long n_blocks, cudaStream_t stream) {
  const int smem = NL * WINDOW * (int)sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      probe_band_kernel<NL, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  probe_band_kernel<NL, NV><<<(unsigned)n_blocks, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int clo_band_window() { return WINDOW; }

// probe_band over m probes in blocks of probe_block (starts: one int32 per
// probe block, in BUILD_BLOCK units), against nb sorted build rows of
// n_limbs int32 limb columns with n_vals int32 value columns. Outputs:
// count (int32), eq (uint8), val_prev and val_next (n_vals int32 each).
extern "C" int clo_probe_band(const void* const* probe, const void* const* build,
                              int n_limbs, const void* const* vals, int n_vals,
                              const void* starts, long long m, long long nb,
                              long long probe_block, void* count, void* eq,
                              void* const* vprev, void* const* vnext,
                              void* stream) {
  if (n_limbs < 1 || n_limbs > 2 || n_vals < 1 || n_vals > MAX_VALS ||
      probe_block < 1)
    return (int)cudaErrorInvalidValue;
  if (m <= 0) return 0;
  BandArgs a = {};
  for (int l = 0; l < n_limbs; ++l) {
    a.probe[l] = static_cast<const int32_t*>(probe[l]);
    a.build[l] = static_cast<const int32_t*>(build[l]);
  }
  for (int v = 0; v < n_vals; ++v) {
    a.vals[v] = static_cast<const int32_t*>(vals[v]);
    a.vprev[v] = static_cast<int32_t*>(vprev[v]);
    a.vnext[v] = static_cast<int32_t*>(vnext[v]);
  }
  a.starts = static_cast<const int32_t*>(starts);
  a.count = static_cast<int32_t*>(count);
  a.eq = static_cast<uint8_t*>(eq);
  a.m = m;
  a.nb = nb;
  a.probe_block = probe_block;
  a.chunks_per_block = (probe_block + CHUNK - 1) / CHUNK;
  const long long n_pblocks = (m + probe_block - 1) / probe_block;
  const long long n_blocks = n_pblocks * a.chunks_per_block;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_limbs * 10 + n_vals) {
    case 11: return launch<1, 1>(a, n_blocks, s);
    case 12: return launch<1, 2>(a, n_blocks, s);
    case 13: return launch<1, 3>(a, n_blocks, s);
    case 21: return launch<2, 1>(a, n_blocks, s);
    case 22: return launch<2, 2>(a, n_blocks, s);
    case 23: return launch<2, 3>(a, n_blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}
