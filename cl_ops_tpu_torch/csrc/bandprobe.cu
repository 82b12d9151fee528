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
// 128-lane sweep. None of that carries over: here each thread
// binary-searches its probes, in shared memory or in device memory.
//
// What it computes, for probe p (1 or 2 int32 limbs, signed lexicographic
// order) of probe block i, with offs = starts[i] * BUILD_BLOCK and the
// window [offs, min(offs + WINDOW, nb)) of the sorted build side:
//   count       = offs + #{window rows <= p}
//   eq          = count > 0 && build[count - 1] == p
//   val_prev[k] = vals_k[max(count - 1, 0)]
//   val_next[k] = vals_k[min(count, nb - 1)]
// (values zero when nb == 0). Probe blocks are `probe_block` consecutive
// probes; every probe of block i is searched in block i's window. Exact for
// probes in any order; sorted probes only make it faster.
//
// Bound: bytes. Each probe's limbs are read once and its 5 + 8 * n_vals
// output bytes written once (count int32, eq one byte, two int32 values per
// column), and the build rows the probes reach are read once. The compares
// (about 2 per search step) are far under the operation bound.
//
// Design: two forms, chosen on the host by the build side's size
// (band_geometry). Each thread holds its probes in registers and searches
// them in lock step (step outer, probes inner), so it has all their loads
// in flight at once.
//   * Sub-window (nb > WINDOW: the banded join, sorted probes). A warp
//     takes a run of 32 x run_per_lane probes of one probe block. A warp
//     reduction gives the run's smallest and largest probe, and 32-ary
//     searches of the window in device memory (three rounds of one load a
//     lane, both probes side by side) give their counts: every count of
//     the run lies between them, so each lane searches only that range, a
//     few rows for sorted probes, and reads eq and the values beside it;
//     the run's rows reach L1 with its first loads. Warps share nothing:
//     no shared memory and no barrier, so an SM keeps as many warps in
//     flight as its registers allow. (Staging each 8192-probe chunk's
//     sub-window in shared memory, behind a block reduction and window
//     searches, ran two such blocks an SM and was no faster than staging
//     the whole window per chunk.)
//   * Whole side (nb <= WINDOW: the direct form, unsorted probes). The
//     blocks are persistent, one wave, and each stages the whole build side
//     (keys, and values where keys and values fit one block's shared
//     memory) once, then takes chunks of probes in turn. Rows are swizzled
//     within their 32-row line (sw): a binary search step reads row
//     pos + 2^j - 1 with pos a multiple of 2^(j+1), one bank for every
//     lane of a warp of unsorted probes without it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#define WHOLE_THREADS 512  // a whole-side block
#define WHOLE_PER_THREAD 8
#define SUB_THREADS 256    // a block of the sub-window form
#define MIN_BLOCKS 2       // 512-thread blocks an SM holds: 64 registers
#define BUILD_BLOCK 4096
#define WINDOW 16384
#define MAX_VALS 3
#define SMEM_MAX 232448    // dynamic shared memory one Hopper block can use

// Probes a lane takes in a warp's run: 16 at one limb; 8 at two, which
// spill registers at 16.
__host__ __device__ constexpr int run_per_lane(int nl) {
  return nl == 1 ? 16 : 8;
}

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
  long long parts_per_block;  // chunks (whole side) or runs of a probe block
  long long n_parts;
  int whole;       // the whole build side is staged once per block
  int cap;         // rows of each staged column
  int stage_vals;  // the value columns are staged beside the keys
};

// Host geometry: bandprobe.band_geometry mirrors it (checked at load).
struct Geometry {
  int whole, threads, cap, stage_vals;
  long long smem;
};

static Geometry band_geometry(long long nb, int nl, int nv) {
  Geometry g;
  g.whole = nb <= WINDOW;
  g.threads = g.whole ? WHOLE_THREADS : SUB_THREADS;
  g.cap = g.whole ? ((int)nb + 31) & ~31 : 0;
  g.stage_vals = (long long)(nl + nv) * g.cap * 4 <= SMEM_MAX;
  g.smem = (long long)(nl + (g.stage_vals ? nv : 0)) * g.cap * 4;
  return g;
}

template <int NL>
__device__ __forceinline__ bool lex_le(const int32_t (&a)[NL],
                                       const int32_t (&b)[NL]) {
  if (NL == 1) return a[0] <= b[0];
  return a[0] < b[0] || (a[0] == b[0] && a[NL - 1] <= b[NL - 1]);
}

template <int NL>
__device__ __forceinline__ bool lex_lt(const int32_t (&a)[NL],
                                       const int32_t (&b)[NL]) {
  return !lex_le<NL>(b, a);
}

template <int NL>
__device__ __forceinline__ void build_key(const BandArgs& a, long long g,
                                          int32_t (&key)[NL]) {
#pragma unroll
  for (int l = 0; l < NL; ++l) key[l] = __ldg(a.build[l] + g);
}

// Stage position of staged row i: its 32-row line, the row within it
// XOR-ed with higher bits. A binary search step reads row pos + 2^j - 1
// with pos a multiple of 2^(j+1), the same bank for every lane without
// the swizzle; with it, lanes whose pos differs in bits 6 .. 15 spread
// over the banks. Lines are whole (cap is a multiple of 32), so every
// position stays inside its column.
__device__ __forceinline__ int sw(int i) {
  return i ^ (((i >> 5) ^ (i >> 10)) & 31);
}

// PT probes a thread, probe k at first + k * stride + lane, searched in
// window rows [lo, hi) and their outputs written (those below lim). Keys
// (SK) and values (SV) come from the stage, whose row g is build row g, or
// from device memory.
template <int NL, int NV, int PT, bool SK, bool SV>
__device__ __forceinline__ void probe_rows(
    const BandArgs& a, const int32_t (&p)[PT][NL], long long first,
    int stride, int lane, long long lim, long long offs, int lo, int hi,
    const int32_t* stage) {
  const int cap = a.cap;
  auto key = [&](int l, long long g) -> int32_t {
    return SK ? stage[l * cap + sw((int)g)] : __ldg(a.build[l] + g);
  };
  auto val = [&](int v, long long g) -> int32_t {
    return SV ? stage[(NL + v) * cap + sw((int)g)] : __ldg(a.vals[v] + g);
  };
  int pos[PT];  // window rows [0, pos) are <= the probe
#pragma unroll
  for (int k = 0; k < PT; ++k) pos[k] = lo;
  // binary lifting: steps top .. 1 sum to 2 top - 1 >= hi - lo
  const int len = hi - lo;
  for (int step = len > 0 ? 1 << (31 - __clz(len)) : 0; step > 0;
       step >>= 1) {
#pragma unroll
    for (int k = 0; k < PT; ++k) {
      const int cand = pos[k] + step;
      const long long g = offs + min(cand, hi) - 1;  // a row in [lo, hi)
      int32_t kk[NL];
#pragma unroll
      for (int l = 0; l < NL; ++l) kk[l] = key(l, g);
      if (cand <= hi && lex_le<NL>(kk, p[k])) pos[k] = cand;
    }
  }
#pragma unroll
  for (int k = 0; k < PT; ++k) {
    const long long i = first + (long long)k * stride + lane;
    if (i < lim) {
      const long long cnt = offs + pos[k];
      const long long ip = cnt > 0 ? cnt - 1 : 0;
      const long long in = cnt < a.nb ? cnt : a.nb - 1;
      bool eq = cnt > 0;
#pragma unroll
      for (int l = 0; l < NL; ++l) eq = eq && key(l, ip) == p[k][l];
      a.count[i] = (int32_t)cnt;
      a.eq[i] = eq ? 1 : 0;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        a.vprev[v][i] = val(v, ip);
        a.vnext[v][i] = val(v, in);
      }
    }
  }
}

// The whole-side form: the block stages build rows [0, nb) once, then
// takes chunks of WHOLE_THREADS * WHOLE_PER_THREAD probes in turn and
// searches each probe in its whole window, in shared memory.
template <int NL, int NV>
__device__ __forceinline__ void whole_side(const BandArgs& a,
                                           int32_t* stage) {
  const int t = threadIdx.x, T = blockDim.x, cap = a.cap;
  for (int j = t; j < (int)a.nb; j += T) {
#pragma unroll
    for (int l = 0; l < NL; ++l) stage[l * cap + sw(j)] = a.build[l][j];
    if (a.stage_vals)
#pragma unroll
      for (int v = 0; v < NV; ++v)
        stage[(NL + v) * cap + sw(j)] = a.vals[v][j];
  }
  __syncthreads();
  const long long chunk = (long long)T * WHOLE_PER_THREAD;
  for (long long c = blockIdx.x; c < a.n_parts; c += gridDim.x) {
    const long long pb = c / a.parts_per_block;
    const long long first = pb * a.probe_block + c % a.parts_per_block * chunk;
    const long long lim = min((pb + 1) * a.probe_block, a.m);
    if (first >= lim) continue;  // the short last probe block's tail
    const long long offs = (long long)a.starts[pb] * BUILD_BLOCK;
    const int wl = (int)max(min(offs + WINDOW, a.nb) - offs, 0LL);
    int32_t p[WHOLE_PER_THREAD][NL];
#pragma unroll
    for (int k = 0; k < WHOLE_PER_THREAD; ++k) {
      const long long i = min(first + (long long)k * T + t, lim - 1);
#pragma unroll
      for (int l = 0; l < NL; ++l) p[k][l] = a.probe[l][i];
    }
    if (a.stage_vals)
      probe_rows<NL, NV, WHOLE_PER_THREAD, true, true>(
          a, p, first, T, t, lim, offs, 0, wl, stage);
    else
      probe_rows<NL, NV, WHOLE_PER_THREAD, true, false>(
          a, p, first, T, t, lim, offs, 0, wl, stage);
  }
}

// #{window rows <= q} for the warp's two queries q[0] <= q[1] (the same in
// every lane), side by side: 32-ary rounds over device memory, each lane
// testing the last row of one of 32 slices of each range, three rounds
// for a full window.
template <int NL>
__device__ __forceinline__ void warp_counts(const BandArgs& a, long long offs,
                                            int wl, const int32_t (&q)[2][NL],
                                            int lane, int (&count)[2]) {
  int base[2] = {0, 0}, width[2] = {wl, wl};  // count in [base, base + width]
  while (width[0] > 0 || width[1] > 0) {
    int s[2];
    bool f[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[j] = (width[j] + 31) >> 5;  // rows a slice
      const int r = base[j] + lane * s[j];  // the slice's first row
      f[j] = false;
      if (r < base[j] + width[j]) {
        int32_t key[NL];
        build_key<NL>(a, offs + min(r + s[j], base[j] + width[j]) - 1, key);
        f[j] = lex_le<NL>(key, q[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = __popc(__ballot_sync(0xFFFFFFFFu, f[j]));
      const int next = base[j] + c * s[j];  // the rows before it are <= q
      if (next >= base[j] + width[j]) {
        base[j] += width[j];
        width[j] = 0;
      } else {  // slice c's last row is above q
        width[j] = min(s[j], base[j] + width[j] - next) - 1;
        base[j] = next;
      }
    }
  }
  count[0] = base[0];
  count[1] = base[1];
}

// The sub-window form: each warp takes a run of 32 * PT probes of one
// probe block, PT a lane. Its smallest and largest probe (a warp
// reduction) bound the rows every count of the run lies in; the lanes
// search that range, a few rows for sorted probes, in device memory,
// where the run's rows are in L1 after the first lane reads them.
template <int NL, int NV>
__device__ __forceinline__ void sub_window(const BandArgs& a) {
  constexpr int PT = run_per_lane(NL);
  const long long run = ((long long)blockIdx.x * blockDim.x + threadIdx.x)
                        >> 5;
  const int lane = threadIdx.x & 31;
  if (run >= a.n_parts) return;  // whole warps
  const long long pb = run / a.parts_per_block;
  const long long first =
      pb * a.probe_block + run % a.parts_per_block * (32 * PT);
  const long long lim =
      min(min((pb + 1) * a.probe_block, a.m), first + 32 * PT);
  if (first >= lim) return;
  int32_t p[PT][NL], q[2][NL];  // the run's probes, min and max
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    q[0][l] = INT32_MAX;
    q[1][l] = INT32_MIN;
  }
#pragma unroll
  for (int k = 0; k < PT; ++k) {
    const long long i = first + k * 32 + lane;
#pragma unroll
    for (int l = 0; l < NL; ++l) p[k][l] = a.probe[l][min(i, lim - 1)];
    if (i < lim) {
      if (lex_lt<NL>(p[k], q[0]))
#pragma unroll
        for (int l = 0; l < NL; ++l) q[0][l] = p[k][l];
      if (lex_lt<NL>(q[1], p[k]))
#pragma unroll
        for (int l = 0; l < NL; ++l) q[1][l] = p[k][l];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    int32_t o[2][NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      o[0][l] = __shfl_xor_sync(0xFFFFFFFFu, q[0][l], off);
      o[1][l] = __shfl_xor_sync(0xFFFFFFFFu, q[1][l], off);
    }
    if (lex_lt<NL>(o[0], q[0]))
#pragma unroll
      for (int l = 0; l < NL; ++l) q[0][l] = o[0][l];
    if (lex_lt<NL>(q[1], o[1]))
#pragma unroll
      for (int l = 0; l < NL; ++l) q[1][l] = o[1][l];
  }
  const long long offs = (long long)a.starts[pb] * BUILD_BLOCK;
  const int wl = (int)max(min(offs + WINDOW, a.nb) - offs, 0LL);
  int range[2];  // every count of the run lies in [range[0], range[1]]
  warp_counts<NL>(a, offs, wl, q, lane, range);
  const int lo = range[0], hi = range[1];
  probe_rows<NL, NV, PT, false, false>(a, p, first, 32, lane, lim, offs, lo,
                                       hi, nullptr);
}

template <int NL, int NV>
__global__ void __launch_bounds__(WHOLE_THREADS, MIN_BLOCKS)
    probe_band_kernel(BandArgs a) {
  // the whole-side form: NL key columns of cap rows, then NV value
  // columns when stage_vals
  extern __shared__ int32_t stage[];
  if (a.nb == 0) {  // no window rows: count = offs
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < a.m; i += (long long)gridDim.x * blockDim.x) {
      const long long cnt =
          (long long)a.starts[i / a.probe_block] * BUILD_BLOCK;
      a.count[i] = (int32_t)cnt;
      a.eq[i] = cnt > 0 ? 1 : 0;
#pragma unroll
      for (int v = 0; v < NV; ++v) a.vprev[v][i] = a.vnext[v][i] = 0;
    }
  } else if (a.whole) {
    whole_side<NL, NV>(a, stage);
  } else {
    sub_window<NL, NV>(a);
  }
}

// Persistent blocks (the whole-side form, and nb == 0): as many as the card
// holds at once. The device's SM count and this geometry's occupancy are
// looked up once per (instance, device, shared memory), not on every call.
template <int NL, int NV>
static int resident_blocks(size_t smem, int* blocks) {
  static std::mutex mu;
  static int c_dev = -1, c_blocks = 0;
  static size_t c_smem = 0;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev != c_dev || smem != c_smem) {
    int sms = 0, per_sm = 0;
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
    if (!err)
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, probe_band_kernel<NL, NV>, WHOLE_THREADS, smem);
    if (err) return err;
    c_dev = dev;
    c_smem = smem;
    c_blocks = (per_sm > 0 ? per_sm : 1) * sms;
  }
  *blocks = c_blocks;
  return 0;
}

template <int NL, int NV>
static int launch(BandArgs& a, cudaStream_t stream) {
  const Geometry g = band_geometry(a.nb, NL, NV);
  a.whole = g.whole;
  a.cap = g.cap;
  a.stage_vals = g.stage_vals;
  const long long part = g.whole ? WHOLE_THREADS * WHOLE_PER_THREAD
                                : 32 * run_per_lane(NL);
  a.parts_per_block = (a.probe_block + part - 1) / part;
  a.n_parts = (a.m + a.probe_block - 1) / a.probe_block * a.parts_per_block;
  int err = (int)cudaFuncSetAttribute(
      probe_band_kernel<NL, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)g.smem);
  if (err) return err;
  long long grid;
  if (g.whole) {
    int blocks = 0;
    err = resident_blocks<NL, NV>((size_t)g.smem, &blocks);
    if (err) return err;
    grid = a.n_parts < blocks ? a.n_parts : blocks;
  } else {  // a warp a run
    grid = (a.n_parts * 32 + SUB_THREADS - 1) / SUB_THREADS;
  }
  probe_band_kernel<NL, NV><<<(unsigned)grid, g.threads, (size_t)g.smem,
                              stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int clo_band_window() { return WINDOW; }

// The launch geometry against nb build rows (whole-side form, threads a
// block, staged rows per column, shared-memory bytes), for
// bandprobe.band_geometry to check.
extern "C" int clo_band_geometry(long long nb, int n_limbs, int n_vals,
                                 long long* out) {
  const Geometry g = band_geometry(nb, n_limbs, n_vals);
  out[0] = g.whole;
  out[1] = g.threads;
  out[2] = g.cap;
  out[3] = g.smem;
  return 0;
}

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
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_limbs * 10 + n_vals) {
    case 11: return launch<1, 1>(a, s);
    case 12: return launch<1, 2>(a, s);
    case 13: return launch<1, 3>(a, s);
    case 21: return launch<2, 1>(a, s);
    case 22: return launch<2, 2>(a, s);
    case 23: return launch<2, 3>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}
