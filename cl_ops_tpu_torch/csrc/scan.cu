// Single-pass prefix scans for Hopper (sm_90a): the plain integer sum
// (scan_carry, mod 2^32 or mod 2^64) and the segmented add/min/max scan
// (seg_scan_carry), and the filter's stable partition on the same look-back
// (partition, its own section below). Built with nvcc into a shared library
// with a plain C interface and loaded with ctypes
// (cl_ops_tpu_torch/ops/scan/kernels.py and segmented.py, which also hold
// each kernel's plain PyTorch version).
//
// Replaces cl_ops_tpu/ops/scan/kernels.py _scan_carry_kernel (32-bit sums),
// _wide_scan_carry_kernel (64-bit sums) and cl_ops_tpu/ops/scan/segmented.py
// _seg_carry_kernel. Those carried a running total from one grid step to the
// next, which works only because a TPU core runs its grid in order. Here
// blocks run in any order, so the carry becomes a decoupled look-back:
// each block takes its tile index from an atomic ticket, not from blockIdx,
// so every tile before it has already started and a block that waits on a
// predecessor can never wait on one that is not running.
//
// Both kernels share one design:
//
//   * 16-byte loads of whole tiles (64 KB for scan_carry, 32 KB of values
//     and 32 KB of flags for seg_scan_carry) through a swizzled
//     shared-memory transpose, so that each thread scans its own
//     contiguous items serially and only the thread and warp totals take
//     shuffles;
//   * one status word per tile (two for 64-bit sums) that packs the state
//     and the value, so that one load reads a predecessor and no fence is
//     needed;
//   * a look-back over 128 predecessors a round trip with __nanosleep
//     backoff, and a status buffer that each call's last block clears for
//     the next call on the stream.
//
// The segmented scan runs the pair operator
//   (v1, f1) (x) (v2, f2) = (f2 ? v2 : v1 (+) v2,  f1 | f2),
// which is associative; a tile that holds a segment flag knows its
// inclusive prefix (its value since its last flag) before it looks back.
//
// Bound: each input element is read once and each output written once:
// 8n bytes for the 32-bit sum, 16n for the 64-bit sum, and 12n for the
// segmented scan of 4-byte values with int32 flags. The status words add
// 8 bytes per tile (16 per 8192-element tile of 64-bit sums), zeroed once
// and cleared by each call's last block.
//
// Integer sums are taken in uint32_t/uint64_t, where wrapping is defined.
// f32 min/max propagate NaN, as torch.minimum/maximum do; +0 and -0 compare
// equal. Each entry point launches on the stream it is given, allocates
// nothing and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#define THREADS 512
#define WARPS (THREADS / 32)
#define ITEMS 8
#define TILE (THREADS * ITEMS)
#define WARP_ELEMS (32 * ITEMS)
#define FULL 0xFFFFFFFFu

enum { ST_NONE = 0, ST_AGG = 1, ST_PREFIX = 2 };

static long long n_tiles_of(long long n) { return (n + TILE - 1) / TILE; }

// Lets `kernel` take `bytes` of dynamic shared memory, once per device
// (`mu` and `set_on` belong to the caller, one pair per kernel).
static int allow_smem(const void* kernel, int bytes, std::mutex& mu,
                      bool* set_on) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev < 64 && set_on[dev]) return 0;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (!err && dev < 64) set_on[dev] = true;
  return err;
}

// --- operators ---------------------------------------------------------------

__device__ __forceinline__ int32_t v_min(int32_t a, int32_t b) {
  return b < a ? b : a;
}
__device__ __forceinline__ int32_t v_max(int32_t a, int32_t b) {
  return b > a ? b : a;
}
__device__ __forceinline__ float v_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}
__device__ __forceinline__ float v_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b > a ? b : a;
}

template <class V> struct Lim;
template <> struct Lim<int32_t> {
  static __device__ int32_t lo() { return INT32_MIN; }
  static __device__ int32_t hi() { return INT32_MAX; }
};
template <> struct Lim<float> {
  static __device__ float lo() { return __int_as_float(0xff800000); }
  static __device__ float hi() { return __int_as_float(0x7f800000); }
};

struct OpAdd {
  static constexpr bool is_add = true;
  template <class V> static __device__ V id() { return V(0); }
  template <class V> static __device__ V f(V a, V b) { return a + b; }
};
struct OpMin {
  static constexpr bool is_add = false;
  template <class V> static __device__ V id() { return Lim<V>::hi(); }
  template <class V> static __device__ V f(V a, V b) { return v_min(a, b); }
};
struct OpMax {
  static constexpr bool is_add = false;
  template <class V> static __device__ V id() { return Lim<V>::lo(); }
  template <class V> static __device__ V f(V a, V b) { return v_max(a, b); }
};

template <class V>
struct Pair {
  V v;
  unsigned f;
};

// a comes before b.
template <class Op, class V>
__device__ __forceinline__ Pair<V> comb(Pair<V> a, Pair<V> b) {
  Pair<V> r;
  r.v = b.f ? b.v : Op::f(a.v, b.v);
  r.f = a.f | b.f;
  return r;
}

template <class Op, class V>
__device__ __forceinline__ Pair<V> ident() {
  Pair<V> r;
  r.v = Op::template id<V>();
  r.f = 0u;
  return r;
}

template <class V>
__device__ __forceinline__ Pair<V> shfl_up(Pair<V> p, int d) {
  Pair<V> r;
  r.v = __shfl_up_sync(FULL, p.v, d);
  r.f = __shfl_up_sync(FULL, p.f, d);
  return r;
}

template <class V>
__device__ __forceinline__ Pair<V> shfl(Pair<V> p, int lane) {
  Pair<V> r;
  r.v = __shfl_sync(FULL, p.v, lane);
  r.f = __shfl_sync(FULL, p.f, lane);
  return r;
}

// A 4-byte value's bits and back (the low half of a status word).
__device__ __forceinline__ unsigned to_bits(unsigned v) { return v; }
__device__ __forceinline__ unsigned to_bits(int32_t v) { return (unsigned)v; }
__device__ __forceinline__ unsigned to_bits(float v) {
  return __float_as_uint(v);
}
template <class V> __device__ __forceinline__ V from_bits(unsigned b);
template <> __device__ __forceinline__ unsigned from_bits<unsigned>(unsigned b) {
  return b;
}
template <> __device__ __forceinline__ int32_t from_bits<int32_t>(unsigned b) {
  return (int32_t)b;
}
template <> __device__ __forceinline__ float from_bits<float>(unsigned b) {
  return __uint_as_float(b);
}

// --- scan_carry: the plain sum -------------------------------------------------
//
// A tile is C_THREADS threads x C_VEC 16-byte vectors: 64 KB, so 16384
// 32-bit or 8192 64-bit elements. Each warp loads its 4 KB with uint4 loads,
// lane j taking vector k * 32 + j (each instruction reads 512 contiguous
// bytes), into shared memory, and reads it back blocked: thread `lane`
// takes vectors lane * C_VEC .. + C_VEC - 1, so its items are contiguous.
// The 16-byte slots are XOR-swizzled (swz) so that both the striped and the
// blocked accesses are free of bank conflicts. Each thread sums its items,
// the warp scans the 32 thread totals (5 shuffles), warp 0 scans the 16
// warp totals, publishes the tile's aggregate, looks back and hands every
// warp its base; each thread then runs its items once more and the tile
// leaves the way it came, through shared memory, as uint4 stores. A warp
// whose 4 KB runs past n, or a call whose pointers are not 16-byte aligned,
// loads and stores element by element through the same slots.
//
// Status: per tile Carry<V>::WORDS 64-bit words, each the 32-bit flag (NONE,
// AGG, PREFIX) in its high half and a 32-bit part of the value in its low
// half. A publish is one store (v2 for 64-bit sums) and a read one load;
// every 64-bit word is single-copy atomic, so a 32-bit sum's flag and value
// always arrive together. A 64-bit sum's two words may arrive from two
// publishes (its AGG and later its PREFIX); each flag value is published
// once per tile, so a read whose two flags agree holds both halves of one
// publish, and one whose flags differ is read again. Hence no fence: the
// only data a tile hands on is in its status words. The look-back runs in
// warp 0: each lane loads C_LOOKAHEAD predecessors at once (128 in all, one
// round trip to L2), the warp sums them 32 at a time back to the nearest
// PREFIX, waiting with __nanosleep backoff (32 ns doubling to C_SLEEP_MAX)
// while one of the 32 has published nothing.

#define C_THREADS 512
#define C_VEC 8        // uint4 per thread
#define C_LOOKAHEAD 4  // windows of 32 predecessors read per round trip
#define C_SLEEP_MAX 128  // ns, the longest backoff of the look-back spin
#define C_WARPS (C_THREADS / 32)
#define C_TILE_BYTES (C_THREADS * C_VEC * 16)

template <class V>
struct Carry {
  static constexpr int PER_VEC = 16 / (int)sizeof(V);
  static constexpr int items = C_VEC * PER_VEC;  // per thread
  static constexpr int tile = C_THREADS * items;
  static constexpr int WORDS = (int)sizeof(V) / 4;  // status words per tile
};

static long long carry_tiles_of(long long n, int value_bytes) {
  long long tile = (long long)C_TILE_BYTES / value_bytes;
  return (n + tile - 1) / tile;
}

// the tile ticket and the count of finished tiles (padded to 16 bytes),
// then WORDS 64-bit words per tile
static long long carry_status_bytes(long long n, int value_bytes) {
  return 16 + 2LL * value_bytes * carry_tiles_of(n, value_bytes);
}

// The physical 16-byte slot of logical slot s in a warp's region of 32 x 4
// or 32 x 8 slots: with 4 or 8 slots a thread, lanes 8q .. 8q + 7 of a
// striped access (slot k * 32 + lane) or a blocked one (slot lane * vec + k)
// land in 8 different bank groups.
__device__ __forceinline__ int swz(int s) { return s ^ ((s >> 3) & 7); }

__device__ __forceinline__ unsigned long long pack_word(unsigned flag,
                                                        unsigned part) {
  return ((unsigned long long)flag << 32) | part;
}

__device__ __forceinline__ void publish(unsigned long long* w, unsigned flag,
                                        unsigned v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(w), "l"(pack_word(flag, v)) : "memory");
}

__device__ __forceinline__ void publish(unsigned long long* w, unsigned flag,
                                        unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};"
               :: "l"(w), "l"(pack_word(flag, (unsigned)v)),
                  "l"(pack_word(flag, (unsigned)(v >> 32))) : "memory");
}

// The flag a tile's status holds (ST_NONE while it is torn), and its value.
__device__ __forceinline__ unsigned peek(const unsigned long long* w,
                                         unsigned& v) {
  unsigned long long a;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(a) : "l"(w) : "memory");
  v = (unsigned)a;
  return (unsigned)(a >> 32);
}

__device__ __forceinline__ unsigned peek(const unsigned long long* w,
                                         unsigned long long& v) {
  unsigned long long a, b;
  asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(a), "=l"(b) : "l"(w) : "memory");
  v = ((b & 0xFFFFFFFFull) << 32) | (a & 0xFFFFFFFFull);
  unsigned fa = (unsigned)(a >> 32), fb = (unsigned)(b >> 32);
  return fa == fb ? fa : (unsigned)ST_NONE;
}

// Run by all 32 lanes of one warp: the sum of every element before `tile`
// (> 0), from its predecessors' statuses back to the nearest PREFIX.
template <class V>
__device__ V carry_sum_back(const unsigned long long* st, long long tile,
                            int lane) {
  constexpr int W = Carry<V>::WORDS;
  V acc = V(0);
  for (long long w = tile - 1;; w -= 32 * C_LOOKAHEAD) {
    V v[C_LOOKAHEAD];
    unsigned f[C_LOOKAHEAD];
#pragma unroll
    for (int u = 0; u < C_LOOKAHEAD; ++u) {
      const long long j = w - 32 * u - lane;  // lane 0 is the nearest
      v[u] = V(0);
      f[u] = ST_PREFIX;  // before tile 0: nothing, and stop
      if (j >= 0) f[u] = peek(st + j * W, v[u]);
    }
    bool done = false;
#pragma unroll
    for (int u = 0; u < C_LOOKAHEAD; ++u) {
      if (done) continue;  // warp-uniform
      const long long j = w - 32 * u - lane;
      for (unsigned ns = 32; __any_sync(FULL, f[u] == ST_NONE);
           ns = ns < C_SLEEP_MAX ? 2 * ns : ns) {
        __nanosleep(ns);
        if (f[u] == ST_NONE) f[u] = peek(st + j * W, v[u]);
      }
      const unsigned pre = __ballot_sync(FULL, f[u] == ST_PREFIX);
      const int stop = pre ? __ffs(pre) - 1 : 31;
      V part = lane <= stop ? v[u] : V(0);
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) part += __shfl_xor_sync(FULL, part, d);
      acc += part;
      done = pre != 0;
    }
    if (done) return acc;
  }
}

// Run by all 32 lanes of warp 0. Publishes the tile's aggregate, sums its
// predecessors back to the nearest PREFIX, publishes the tile's inclusive
// prefix, and returns the sum of every element before the tile.
template <class V>
__device__ V carry_look_back(unsigned long long* st, long long tile, V agg,
                             int lane) {
  constexpr int W = Carry<V>::WORDS;
  if (tile == 0) {
    if (lane == 0) publish(st, (unsigned)ST_PREFIX, agg);
    return V(0);
  }
  if (lane == 0) publish(st + tile * W, (unsigned)ST_AGG, agg);
  const V acc = carry_sum_back<V>(st, tile, lane);
  if (lane == 0) publish(st + tile * W, (unsigned)ST_PREFIX, acc + agg);
  return acc;
}

// Run by every thread of a block after its tile is written: the last block
// to finish clears `words` status words and the ticket (every other block
// is past its look-back), so the next call on the stream finds them zeroed.
__device__ __forceinline__ void clear_status(unsigned* ticket,
                                             unsigned long long* st,
                                             long long words) {
  __shared__ bool s_last;
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(ticket + 1, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    for (long long i = threadIdx.x; i < words; i += blockDim.x) st[i] = 0ull;
    if (threadIdx.x == 0) {
      ticket[0] = 0u;
      ticket[1] = 0u;
    }
  }
}

template <class V>
__global__ void __launch_bounds__(C_THREADS, 2)
    carry_tiles(const V* __restrict__ x, V* __restrict__ out, long long n,
                int exclusive, int aligned, unsigned* ticket,
                unsigned long long* st) {
  constexpr int PV = Carry<V>::PER_VEC;
  constexpr int IT = Carry<V>::items;
  constexpr int WARP_ITEMS = 32 * IT;
  extern __shared__ uint4 s_vec[];  // C_WARPS regions of 32 * C_VEC slots
  __shared__ unsigned s_tile;
  __shared__ V s_w[C_WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long wbase =
      tile * Carry<V>::tile + (long long)warp * WARP_ITEMS;
  uint4* sw = s_vec + warp * (32 * C_VEC);
  V* se = reinterpret_cast<V*>(sw);
  const bool whole = aligned && wbase + WARP_ITEMS <= n;  // warp-uniform

  if (whole) {
    const uint4* src = reinterpret_cast<const uint4*>(x + wbase);
#pragma unroll
    for (int k = 0; k < C_VEC; ++k) sw[swz(k * 32 + lane)] = src[k * 32 + lane];
  } else {
    for (int e = lane; e < WARP_ITEMS; e += 32) {
      const long long i = wbase + e;
      se[swz(e / PV) * PV + e % PV] = i < n ? x[i] : V(0);
    }
  }
  __syncwarp();
  V a[IT];
#pragma unroll
  for (int k = 0; k < C_VEC; ++k) {
    const uint4 q = sw[swz(lane * C_VEC + k)];
    const V* qv = reinterpret_cast<const V*>(&q);
#pragma unroll
    for (int m = 0; m < PV; ++m) a[k * PV + m] = qv[m];
  }

  V t = V(0);  // the thread's total
#pragma unroll
  for (int i = 0; i < IT; ++i) t += a[i];
  V inc = t;  // inclusive scan of the warp's thread totals
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const V o = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) s_w[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const V wv = lane < C_WARPS ? s_w[lane] : V(0);
    V winc = wv;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const V o = __shfl_up_sync(FULL, winc, d);
      if (lane >= d) winc += o;
    }
    const V agg = __shfl_sync(FULL, winc, C_WARPS - 1);
    const V before = carry_look_back<V>(st, tile, agg, lane);
    if (lane < C_WARPS) s_w[lane] = before + (winc - wv);
  }
  __syncthreads();

  V run = s_w[warp] + (inc - t);  // the sum of everything before a[0]
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const V xi = a[i];
    if (exclusive) {
      a[i] = run;
      run += xi;
    } else {
      run += xi;
      a[i] = run;
    }
  }
#pragma unroll
  for (int k = 0; k < C_VEC; ++k) {
    uint4 q;
    V* qv = reinterpret_cast<V*>(&q);
#pragma unroll
    for (int m = 0; m < PV; ++m) qv[m] = a[k * PV + m];
    sw[swz(lane * C_VEC + k)] = q;
  }
  __syncwarp();
  if (whole) {
    uint4* dst = reinterpret_cast<uint4*>(out + wbase);
#pragma unroll
    for (int k = 0; k < C_VEC; ++k) dst[k * 32 + lane] = sw[swz(k * 32 + lane)];
  } else {
    for (int e = lane; e < WARP_ITEMS; e += 32) {
      const long long i = wbase + e;
      if (i < n) out[i] = se[swz(e / PV) * PV + e % PV];
    }
  }
  clear_status(ticket, st, (long long)gridDim.x * Carry<V>::WORDS);
}

template <class V>
static int launch_carry(const void* x, void* out, long long n, int exclusive,
                        void* status, void* stream) {
  long long tiles = carry_tiles_of(n, (int)sizeof(V));
  if (tiles == 0) return 0;
  static std::mutex mu;
  static bool set_on[64] = {};
  int err = allow_smem((const void*)carry_tiles<V>, C_TILE_BYTES, mu, set_on);
  if (err) return err;
  int aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  char* p = static_cast<char*>(status);
  carry_tiles<V><<<(unsigned)tiles, C_THREADS, C_TILE_BYTES,
                   (cudaStream_t)stream>>>(
      static_cast<const V*>(x), static_cast<V*>(out), n, exclusive, aligned,
      reinterpret_cast<unsigned*>(p),
      reinterpret_cast<unsigned long long*>(p + 16));
  return (int)cudaGetLastError();
}

// --- seg_scan_carry: the segmented scan, on scan_carry's design ----------------
//
// A tile is S_THREADS threads x SEG_VEC 16-byte vectors of values and as
// many of flags (S_TILE elements). Both arrays go through swizzled shared
// memory as carry_tiles' values do, into two regions, so that each thread
// holds S_ITEMS contiguous values and their flags as one bitmask. Each
// thread folds its items with the pair operator, the warp scans the 32
// thread pairs (5 shuffle rounds of value and flag), warp 0 scans the 8
// warp pairs and looks back, and each thread replays its items once from
// its base; the tile leaves through shared memory as uint4 stores. A warp
// past n or a call whose pointers are not all 16-byte aligned goes element
// by element through the same slots; elements past n enter as the op's
// identity without a flag.
//
// Status: one 64-bit word per tile. High half: the state (NONE, AGG,
// PREFIX) and ST_FLAG when the tile holds a segment flag; low half: the
// value's 32 bits (a float's bits for float32). A tile whose aggregate
// holds a flag publishes PREFIX at once, before its own look-back, since
// its inclusive prefix is its value since its last flag; at one flag in a
// few hundred rows nearly every tile does, and its successors stop at it.
// The look-back (seg_back) reads predecessors as carry_sum_back does and
// stops at the nearest one that is PREFIX or flagged; every tile nearer
// than that one is an AGG without a flag, so a window combines with the
// plain op over the lanes up to the stop. Add and min/max do not depend on
// the combine's order, except for float32 add (within the callers'
// tolerance) and the sign of a zero or a NaN's payload for float min/max.

#define SEG_VEC 8   // uint4 of values, and of flags, per thread
#define SEG_MINB 3  // blocks an SM, for the register budget
#define S_THREADS 256
#define S_WARPS (S_THREADS / 32)
#define S_ITEMS (4 * SEG_VEC)                 // elements per thread
#define S_TILE (S_THREADS * S_ITEMS)
#define S_SMEM (2 * S_THREADS * SEG_VEC * 16)  // values, then flags
#define ST_FLAG 4u  // in a status word's state: the tile holds a flag

static long long seg_tiles_of(long long n) { return (n + S_TILE - 1) / S_TILE; }

// Run by all 32 lanes of one warp: the op over every element of the tiles
// between `tile` (> 0) and the nearest PREFIX or flagged predecessor, that
// one included: the value the tile's first segment continues.
template <class Op, class V>
__device__ V seg_back(const unsigned long long* st, long long tile, int lane) {
  V acc = Op::template id<V>();
  for (long long w = tile - 1;; w -= 32 * C_LOOKAHEAD) {
    unsigned v[C_LOOKAHEAD], s[C_LOOKAHEAD];
#pragma unroll
    for (int u = 0; u < C_LOOKAHEAD; ++u) {
      const long long j = w - 32 * u - lane;  // lane 0 is the nearest
      v[u] = 0u;
      s[u] = ST_PREFIX;  // before tile 0: nothing, and stop
      if (j >= 0) s[u] = peek(st + j, v[u]);
    }
    bool done = false;
#pragma unroll
    for (int u = 0; u < C_LOOKAHEAD; ++u) {
      if (done) continue;  // warp-uniform
      const long long j = w - 32 * u - lane;
      for (unsigned ns = 32; __any_sync(FULL, s[u] == ST_NONE);
           ns = ns < C_SLEEP_MAX ? 2 * ns : ns) {
        __nanosleep(ns);
        if (s[u] == ST_NONE) s[u] = peek(st + j, v[u]);
      }
      const unsigned end = __ballot_sync(
          FULL, (s[u] & 3u) == ST_PREFIX || (s[u] & ST_FLAG));
      const int stop = end ? __ffs(end) - 1 : 31;
      V part = lane <= stop ? from_bits<V>(v[u]) : Op::template id<V>();
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        part = Op::f(part, __shfl_xor_sync(FULL, part, d));
      acc = Op::f(part, acc);  // the window comes before acc
      done = end != 0;
    }
    if (done) return acc;
  }
}

// Run by all 32 lanes of warp 0. Publishes the tile's status, looks back,
// and returns the value the tile's first segment continues (the identity
// for tile 0).
template <class Op, class V>
__device__ V seg_look_back(unsigned long long* st, long long tile, Pair<V> agg,
                           int lane) {
  if (tile == 0 || agg.f) {  // its inclusive prefix is its own value
    if (lane == 0)
      publish(st + tile, ST_PREFIX | (agg.f ? ST_FLAG : 0u), to_bits(agg.v));
    return tile == 0 ? Op::template id<V>() : seg_back<Op, V>(st, tile, lane);
  }
  if (lane == 0) publish(st + tile, (unsigned)ST_AGG, to_bits(agg.v));
  const V acc = seg_back<Op, V>(st, tile, lane);
  if (lane == 0)
    publish(st + tile, (unsigned)ST_PREFIX, to_bits(Op::f(acc, agg.v)));
  return acc;
}

template <class V, class Op>
__global__ void __launch_bounds__(S_THREADS, SEG_MINB)
    seg_tiles(const V* __restrict__ x, const int32_t* __restrict__ flags,
              V* __restrict__ out, long long n, int exclusive, int aligned,
              unsigned* ticket, unsigned long long* st) {
  constexpr int WARP_ITEMS = 32 * S_ITEMS;
  // S_WARPS regions of 32 * SEG_VEC slots of values, then as many of flags
  extern __shared__ uint4 s_vec[];
  __shared__ unsigned s_tile;
  __shared__ V s_wv[S_WARPS];
  __shared__ unsigned s_wf[S_WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long wbase = tile * S_TILE + (long long)warp * WARP_ITEMS;
  uint4* sv = s_vec + warp * (32 * SEG_VEC);
  uint4* sf = sv + S_WARPS * (32 * SEG_VEC);
  V* ev = reinterpret_cast<V*>(sv);
  int32_t* ef = reinterpret_cast<int32_t*>(sf);
  const bool whole = aligned && wbase + WARP_ITEMS <= n;  // warp-uniform

  if (whole) {
    const uint4* xs = reinterpret_cast<const uint4*>(x + wbase);
    const uint4* fs = reinterpret_cast<const uint4*>(flags + wbase);
#pragma unroll
    for (int k = 0; k < SEG_VEC; ++k) {
      const int s = swz(k * 32 + lane);
      sv[s] = xs[k * 32 + lane];
      sf[s] = fs[k * 32 + lane];
    }
  } else {
    for (int e = lane; e < WARP_ITEMS; e += 32) {
      const long long i = wbase + e;
      const int s = swz(e / 4) * 4 + e % 4;
      ev[s] = i < n ? x[i] : Op::template id<V>();
      ef[s] = i < n ? flags[i] : 0;
    }
  }
  __syncwarp();
  V a[S_ITEMS];
  unsigned fm = 0u;  // bit i: item i starts a segment
#pragma unroll
  for (int k = 0; k < SEG_VEC; ++k) {
    const int s = swz(lane * SEG_VEC + k);
    const uint4 q = sv[s];
    const uint4 g = sf[s];
    const V* qv = reinterpret_cast<const V*>(&q);
#pragma unroll
    for (int m = 0; m < 4; ++m) a[4 * k + m] = qv[m];
    fm |= ((unsigned)(g.x != 0) | (unsigned)(g.y != 0) << 1 |
           (unsigned)(g.z != 0) << 2 | (unsigned)(g.w != 0) << 3) << (4 * k);
  }

  Pair<V> t = ident<Op, V>();  // the thread's items as one pair
#pragma unroll
  for (int i = 0; i < S_ITEMS; ++i)
    t.v = (fm >> i) & 1u ? a[i] : Op::f(t.v, a[i]);
  t.f = fm != 0u;
  Pair<V> inc = t;  // inclusive scan of the warp's thread pairs
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Pair<V> o = shfl_up(inc, d);
    if (lane >= d) inc = comb<Op>(o, inc);
  }
  Pair<V> lex = shfl_up(inc, 1);  // the lanes before this one
  if (lane == 0) lex = ident<Op, V>();
  if (lane == 31) {
    s_wv[warp] = inc.v;
    s_wf[warp] = inc.f;
  }
  __syncthreads();
  if (warp == 0) {
    Pair<V> w = ident<Op, V>();
    if (lane < S_WARPS) {
      w.v = s_wv[lane];
      w.f = s_wf[lane];
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Pair<V> o = shfl_up(w, d);
      if (lane >= d) w = comb<Op>(o, w);
    }
    const Pair<V> agg = shfl(w, S_WARPS - 1);
    Pair<V> ex = shfl_up(w, 1);  // the warps before this one
    if (lane == 0) ex = ident<Op, V>();
    const V before = seg_look_back<Op, V>(st, tile, agg, lane);
    if (lane < S_WARPS) s_wv[lane] = ex.f ? ex.v : Op::f(before, ex.v);
  }
  __syncthreads();

  V run = lex.f ? lex.v : Op::f(s_wv[warp], lex.v);  // before a[0]
#pragma unroll
  for (int i = 0; i < S_ITEMS; ++i) {
    const V xi = a[i];
    run = (fm >> i) & 1u ? xi : Op::f(run, xi);
    if constexpr (Op::is_add)
      a[i] = exclusive ? run - xi : run;
    else
      a[i] = run;
  }
#pragma unroll
  for (int k = 0; k < SEG_VEC; ++k) {
    uint4 q;
    V* qv = reinterpret_cast<V*>(&q);
#pragma unroll
    for (int m = 0; m < 4; ++m) qv[m] = a[4 * k + m];
    sv[swz(lane * SEG_VEC + k)] = q;
  }
  __syncwarp();
  if (whole) {
    uint4* dst = reinterpret_cast<uint4*>(out + wbase);
#pragma unroll
    for (int k = 0; k < SEG_VEC; ++k)
      dst[k * 32 + lane] = sv[swz(k * 32 + lane)];
  } else {
    for (int e = lane; e < WARP_ITEMS; e += 32) {
      const long long i = wbase + e;
      if (i < n) out[i] = ev[swz(e / 4) * 4 + e % 4];
    }
  }
  clear_status(ticket, st, (long long)gridDim.x);
}

template <class V, class Op>
static int launch_seg(const void* x, const void* flags, void* out, long long n,
                      int exclusive, void* status, void* stream) {
  long long tiles = seg_tiles_of(n);
  if (tiles == 0) return 0;
  static std::mutex mu;
  static bool set_on[64] = {};
  int err = allow_smem((const void*)seg_tiles<V, Op>, S_SMEM, mu, set_on);
  if (err) return err;
  int aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                (reinterpret_cast<uintptr_t>(flags) % 16 == 0) &&
                (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  char* p = static_cast<char*>(status);
  seg_tiles<V, Op><<<(unsigned)tiles, S_THREADS, S_SMEM,
                     (cudaStream_t)stream>>>(
      static_cast<const V*>(x), static_cast<const int32_t*>(flags),
      static_cast<V*>(out), n, exclusive, aligned,
      reinterpret_cast<unsigned*>(p),
      reinterpret_cast<unsigned long long*>(p + 16));
  return (int)cudaGetLastError();
}

// --- the base-fed block scan (3-phase scan, phase 3) ------------------------------
//
// Replaces cl_ops_tpu/ops/scan/kernels.py _scan_block_kernel (32-bit integer
// sums mod 2^32 and float32 sums) and _wide_scan_block_kernel (64-bit sums,
// there as two u32 limbs, here on native uint64_t). The caller computes
// every tile's base (the sum of all elements before the tile) in two small
// passes, so tiles are independent: no ticket and no look-back. A tile of
// TILE elements is scanned in registers with warp-striped loads and a
// two-level shuffle scan, then base[tile] is added:
// out = (in-tile inclusive sum + base) [- x when exclusive], the JAX
// kernel's form. Bound: bytes, one read of x and one write of out per
// element (the caller's block sums read x once more). Inputs narrower than
// the sum widen on load (In -> V): int32 sign-extends and uint32
// zero-extends into uint64_t, so a 64-bit scan of 32-bit data reads 4
// bytes per element.

template <class V, class In>
__device__ __forceinline__ V widen(In x) {
  return (V)x;
}
template <>
__device__ __forceinline__ unsigned long long
widen<unsigned long long, int32_t>(int32_t x) {
  return (unsigned long long)(long long)x;
}

template <class In, class V>
__global__ void __launch_bounds__(THREADS)
    scan_block_tiles(const In* __restrict__ x, const V* __restrict__ base,
                     V* __restrict__ out, long long n, int exclusive) {
  __shared__ V s_w[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile = blockIdx.x;
  const long long start = tile * TILE + (long long)warp * WARP_ELEMS;

  V xv[ITEMS], p[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    long long i = start + k * 32 + lane;
    xv[k] = i < n ? widen<V>(x[i]) : V(0);
  }
  V run = V(0);  // the warp's total so far
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    V q = xv[k];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      V o = __shfl_up_sync(FULL, q, d);
      if (lane >= d) q = o + q;
    }
    p[k] = run + q;
    run = __shfl_sync(FULL, p[k], 31);
  }
  if (lane == 0) s_w[warp] = run;
  __syncthreads();
  if (warp == 0) {
    V w = lane < WARPS ? s_w[lane] : V(0);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      V o = __shfl_up_sync(FULL, w, d);
      if (lane >= d) w = o + w;
    }
    V ex = __shfl_up_sync(FULL, w, 1);  // total of the warps before
    if (lane < WARPS) s_w[lane] = lane == 0 ? V(0) : ex;
  }
  __syncthreads();
  const V wp = s_w[warp];
  const V b = base[tile];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    long long i = start + k * 32 + lane;
    if (i < n) {
      V r = (wp + p[k]) + b;
      out[i] = exclusive ? r - xv[k] : r;
    }
  }
}

template <class In, class V>
static int launch_block(const void* x, const void* base, void* out,
                        long long n, int exclusive, void* stream) {
  long long tiles = n_tiles_of(n);
  if (tiles == 0) return 0;
  scan_block_tiles<In, V><<<(unsigned)tiles, THREADS, 0,
                            (cudaStream_t)stream>>>(
      static_cast<const In*>(x), static_cast<const V*>(base),
      static_cast<V*>(out), n, exclusive);
  return (int)cudaGetLastError();
}

// --- partition: the filter's stable partition ---------------------------------
//
// Replaces no Pallas kernel. cl_ops_tpu/ops/exec/filter.py compacts by
// sorting the unique key (!keep) * n + position with every column as
// payload, because XLA's scatter is element-serialized on a TPU; that
// workaround costs a whole bitonic sort padded to a power of two, whatever
// the number of kept rows. Here the partition is what it is: kept row i
// goes to kept_before(i), dropped row i to count + i - kept_before(i), so
// both halves keep their original order (the sort's output, bit for bit).
//
// Bound: bytes, n * (2 + 2 * width) for columns of `width` bytes in all:
// the mask read twice, each column read once and written once. The design
// meets it with two launches for up to P_MAX_COLS columns (one more per
// further P_MAX_COLS columns, which reads the mask again):
//
//   * partition_count_tiles reads the mask with 16-byte loads, P_GROUP tiles
//     of P_TILE rows a block, counts the kept rows of each tile (nonzero
//     bytes), and takes the exclusive prefix of the block's total by
//     scan_carry's decoupled look-back on the same per-stream status buffer.
//     It writes each tile's kept-before (base) and, in the last block, the
//     kept count (int64) on the card: O(n / P_TILE) bytes of scratch and no
//     host read.
//   * partition_move_tiles ranks a tile's rows in the block (a warp ballot
//     and popcount for each 32 rows, then one scan of the P_ITEMS x P_WARPS
//     ballot counts), keeps each row's slot in the partitioned tile in
//     registers, and for each column stages the tile in shared memory
//     already partitioned, then writes it out as two contiguous runs, the
//     kept rows at base and the dropped rows at count + tile start - base.
//     Loads and stores are warp-striped at each column's own width, so a
//     warp's accesses are contiguous.

#define P_THREADS 512
#define P_WARPS (P_THREADS / 32)
#define P_ITEMS 16                       // rows a thread, warp-striped
#define P_TILE (P_THREADS * P_ITEMS)     // rows a tile: 8192
#define P_GROUP 8                        // tiles one count block reads
#define P_MAX_COLS 8                     // columns one move launch takes
#define P_MAX_SMEM (P_TILE * 8)          // one tile of an 8-byte column

static_assert(P_ITEMS == 16, "a count thread reads one 16-byte vector a tile");

struct PartCols {
  const void* in[P_MAX_COLS];
  void* out[P_MAX_COLS];
  int width[P_MAX_COLS];
  int n;
};

__host__ __device__ static long long part_tiles_of(long long n) {
  return (n + P_TILE - 1) / P_TILE;
}
static long long part_groups_of(long long n) {
  return (part_tiles_of(n) + P_GROUP - 1) / P_GROUP;
}

// The number of nonzero bytes of w.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  return __popc((((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u);
}

__global__ void __launch_bounds__(P_THREADS)
    partition_count_tiles(const uint8_t* __restrict__ mask, long long n,
                          int aligned, unsigned* __restrict__ base,
                          long long* __restrict__ count, unsigned* ticket,
                          unsigned long long* st) {
  __shared__ unsigned s_group;
  __shared__ unsigned s_c[P_GROUP][P_WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_group = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long group = s_group;
#pragma unroll
  for (int g = 0; g < P_GROUP; ++g) {
    const long long at = (group * P_GROUP + g) * P_TILE + threadIdx.x * 16LL;
    unsigned c = 0;
    if (aligned && at + 16 <= n) {
      const uint4 q = *reinterpret_cast<const uint4*>(mask + at);
      c = nonzero_bytes(q.x) + nonzero_bytes(q.y) + nonzero_bytes(q.z) +
          nonzero_bytes(q.w);
    } else {
      for (int i = 0; i < 16 && at + i < n; ++i) c += mask[at + i] != 0;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) c += __shfl_xor_sync(FULL, c, d);
    if (lane == 0) s_c[g][warp] = c;
  }
  __syncthreads();
  if (warp == 0) {
    unsigned t = 0;  // lane g < P_GROUP: tile g's kept rows
    if (lane < P_GROUP)
      for (int w = 0; w < P_WARPS; ++w) t += s_c[lane][w];
    unsigned inc = t;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned o = __shfl_up_sync(FULL, inc, d);
      if (lane >= d) inc += o;
    }
    const unsigned agg = __shfl_sync(FULL, inc, 31);
    const unsigned before = carry_look_back<unsigned>(st, group, agg, lane);
    const long long tile = group * P_GROUP + lane;
    if (lane < P_GROUP && tile < part_tiles_of(n)) base[tile] = before + inc - t;
    if (lane == 0 && group == gridDim.x - 1) *count = (long long)(before + agg);
  }
  clear_status(ticket, st, (long long)gridDim.x);
}

// One column of a tile: staged in shared memory at each row's slot (pk:
// two 16-bit slots a word), then written out as the kept run and the
// dropped run.
template <class T>
__device__ __forceinline__ void move_col(const void* in_v, void* out_v,
                                         long long t0, int valid,
                                         const unsigned (&pk)[P_ITEMS / 2],
                                         int kept, long long kb, long long db,
                                         void* stage) {
  const T* __restrict__ in = static_cast<const T*>(in_v) + t0;
  T* __restrict__ out = static_cast<T*>(out_v);
  T* s = static_cast<T*>(stage);
  T v[P_ITEMS];
#pragma unroll
  for (int k = 0; k < P_ITEMS; ++k) {
    const int r = k * P_THREADS + threadIdx.x;
    v[k] = r < valid ? in[r] : T(0);
  }
#pragma unroll
  for (int k = 0; k < P_ITEMS; ++k) {
    const int r = k * P_THREADS + threadIdx.x;
    if (r < valid) s[(pk[k >> 1] >> (16 * (k & 1))) & 0xFFFFu] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < P_ITEMS; ++k) {
    const int e = k * P_THREADS + threadIdx.x;
    if (e < valid) {
      if (e < kept)
        out[kb + e] = s[e];
      else
        out[db + (e - kept)] = s[e];
    }
  }
  __syncthreads();  // the stage is free for the next column
}

__global__ void __launch_bounds__(P_THREADS, 2)
    partition_move_tiles(const uint8_t* __restrict__ mask, long long n,
                         const unsigned* __restrict__ base,
                         const long long* __restrict__ count, PartCols cols) {
  extern __shared__ uint4 s_stage[];
  __shared__ unsigned s_pre[P_ITEMS * P_WARPS];
  __shared__ unsigned s_kept;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile = blockIdx.x;
  const long long t0 = tile * P_TILE;
  const int valid = (int)(n - t0 < P_TILE ? n - t0 : P_TILE);
  unsigned ball[P_ITEMS];
#pragma unroll
  for (int k = 0; k < P_ITEMS; ++k) {
    const int r = k * P_THREADS + threadIdx.x;
    ball[k] = __ballot_sync(FULL, r < valid && mask[t0 + r] != 0);
    if (lane == 0) s_pre[k * P_WARPS + warp] = __popc(ball[k]);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the counts in row order (k, warp)
    constexpr int PER = P_ITEMS * P_WARPS / 32;
    unsigned c[PER], t = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      c[j] = s_pre[lane * PER + j];
      t += c[j];
    }
    unsigned inc = t;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned o = __shfl_up_sync(FULL, inc, d);
      if (lane >= d) inc += o;
    }
    unsigned ex = inc - t;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      s_pre[lane * PER + j] = ex;
      ex += c[j];
    }
    if (lane == 31) s_kept = inc;
  }
  __syncthreads();
  const int kept = (int)s_kept;
  const unsigned below = (1u << lane) - 1u;
  unsigned pk[P_ITEMS / 2] = {};
#pragma unroll
  for (int k = 0; k < P_ITEMS; ++k) {
    const int r = k * P_THREADS + threadIdx.x;
    const int rank = (int)(s_pre[k * P_WARPS + warp] + __popc(ball[k] & below));
    const int slot = (ball[k] >> lane) & 1u ? rank : kept + r - rank;
    pk[k >> 1] |= (unsigned)slot << (16 * (k & 1));
  }
  const long long kb = base[tile];
  const long long db = *count + t0 - kb;
  for (int c = 0; c < cols.n; ++c) {
    switch (cols.width[c]) {
      case 1:
        move_col<uint8_t>(cols.in[c], cols.out[c], t0, valid, pk, kept, kb, db, s_stage);
        break;
      case 2:
        move_col<uint16_t>(cols.in[c], cols.out[c], t0, valid, pk, kept, kb, db, s_stage);
        break;
      case 4:
        move_col<uint32_t>(cols.in[c], cols.out[c], t0, valid, pk, kept, kb, db, s_stage);
        break;
      default:
        move_col<unsigned long long>(cols.in[c], cols.out[c], t0, valid, pk, kept, kb, db, s_stage);
    }
  }
}

// Bytes of the status buffer scan_carry of n elements of value_bytes needs
// (zeroed before its first use; each call leaves it zeroed), and its
// elements per tile.
extern "C" long long clo_scan_carry_status_bytes(long long n,
                                                 int value_bytes) {
  return carry_status_bytes(n, value_bytes);
}

extern "C" int clo_scan_carry_tile(int value_bytes) {
  return C_TILE_BYTES / value_bytes;
}

// scan_carry: inclusive (exclusive != 0: exclusive) prefix sum of n integers
// of value_bytes (4: mod 2^32, 8: mod 2^64).
extern "C" int clo_scan_carry(const void* x, void* out, long long n,
                              int value_bytes, int exclusive, void* status,
                              void* stream) {
  if (value_bytes == 4)
    return launch_carry<unsigned>(x, out, n, exclusive, status, stream);
  if (value_bytes == 8)
    return launch_carry<unsigned long long>(x, out, n, exclusive, status,
                                            stream);
  return (int)cudaErrorInvalidValue;
}

// Elements per tile of scan_block (one base per tile).
extern "C" int clo_scan_tile() { return TILE; }

// scan_block: per-tile inclusive (exclusive != 0: exclusive) scan of n
// elements plus base[tile]. kind 0: 32-bit integers mod 2^32 (x, base and
// out 4 bytes); 1: float32; 2, 3, 4: 64-bit sums mod 2^64 (base and out
// 8 bytes) of int32 (sign-extended), uint32 (zero-extended) or 64-bit x.
extern "C" int clo_scan_block(const void* x, const void* base, void* out,
                              long long n, int kind, int exclusive,
                              void* stream) {
  switch (kind) {
    case 0: return launch_block<unsigned, unsigned>(x, base, out, n, exclusive, stream);
    case 1: return launch_block<float, float>(x, base, out, n, exclusive, stream);
    case 2: return launch_block<int32_t, unsigned long long>(x, base, out, n, exclusive, stream);
    case 3: return launch_block<unsigned, unsigned long long>(x, base, out, n, exclusive, stream);
    case 4: return launch_block<unsigned long long, unsigned long long>(x, base, out, n, exclusive, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Elements per tile of seg_scan_carry, and the bytes of its status buffer
// for n elements: the ticket and the count of finished tiles (padded to 16
// bytes), then one 64-bit word per tile (zeroed before its first use; each
// call leaves it zeroed).
extern "C" int clo_seg_scan_tile() { return S_TILE; }

extern "C" long long clo_seg_scan_status_bytes(long long n) {
  return 16 + 8 * seg_tiles_of(n);
}

// seg_scan_carry: inclusive segmented scan of n int32 (is_float = 0) or
// float32 (is_float = 1) values under op 0 add, 1 min, 2 max, restarting at
// every nonzero int32 flag; exclusive != 0 (add only) gives the exclusive form.
extern "C" int clo_seg_scan_carry(const void* x, const void* flags, void* out,
                                  long long n, int is_float, int op,
                                  int exclusive, void* status, void* stream) {
  if (op != 0 && exclusive) return (int)cudaErrorInvalidValue;
  if (is_float) {
    switch (op) {
      case 0: return launch_seg<float, OpAdd>(x, flags, out, n, exclusive, status, stream);
      case 1: return launch_seg<float, OpMin>(x, flags, out, n, 0, status, stream);
      case 2: return launch_seg<float, OpMax>(x, flags, out, n, 0, status, stream);
    }
  } else {
    switch (op) {
      // int32 sums wrap: add as uint32_t, same bits
      case 0: return launch_seg<unsigned, OpAdd>(x, flags, out, n, exclusive, status, stream);
      case 1: return launch_seg<int32_t, OpMin>(x, flags, out, n, 0, status, stream);
      case 2: return launch_seg<int32_t, OpMax>(x, flags, out, n, 0, status, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// Rows a partition tile holds, the columns one move launch takes, and the
// bytes of partition_count_tiles' status buffer for n rows: the ticket and
// the count of finished blocks (padded to 16 bytes), then one 64-bit word
// per block of P_GROUP tiles (zeroed before its first use; each call leaves
// it zeroed).
extern "C" int clo_partition_tile() { return P_TILE; }
extern "C" int clo_partition_group() { return P_GROUP; }
extern "C" int clo_partition_max_cols() { return P_MAX_COLS; }

extern "C" long long clo_partition_status_bytes(long long n) {
  return 16 + 8 * part_groups_of(n);
}

// partition, launch 1: each tile's kept rows before it into base (one
// uint32 per P_TILE rows) and the kept count into *count (int64), from a
// mask of n bytes (nonzero: kept).
extern "C" int clo_partition_count(const void* mask, long long n, void* base,
                                   void* count, void* status, void* stream) {
  const long long groups = part_groups_of(n);
  if (groups == 0) return 0;
  const int aligned = reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  char* p = static_cast<char*>(status);
  partition_count_tiles<<<(unsigned)groups, P_THREADS, 0,
                          (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(mask), n, aligned,
      static_cast<unsigned*>(base), static_cast<long long*>(count),
      reinterpret_cast<unsigned*>(p),
      reinterpret_cast<unsigned long long*>(p + 16));
  return (int)cudaGetLastError();
}

// partition, launch 2 (and one more for each further P_MAX_COLS columns):
// n_cols columns of widths[c] bytes (1, 2, 4 or 8) from ins[c] to outs[c],
// the kept rows first and the dropped rows after them, each in their
// original order, from the mask and clo_partition_count's base and count.
extern "C" int clo_partition_move(const void* mask, long long n,
                                  const void* base, const void* count,
                                  const void* const* ins, void* const* outs,
                                  const int* widths, int n_cols,
                                  void* stream) {
  if (n_cols < 1 || n_cols > P_MAX_COLS) return (int)cudaErrorInvalidValue;
  PartCols cols = {};
  int widest = 1;
  for (int c = 0; c < n_cols; ++c) {
    const int w = widths[c];
    if (w != 1 && w != 2 && w != 4 && w != 8) return (int)cudaErrorInvalidValue;
    cols.in[c] = ins[c];
    cols.out[c] = outs[c];
    cols.width[c] = w;
    widest = w > widest ? w : widest;
  }
  cols.n = n_cols;
  const long long tiles = part_tiles_of(n);
  if (tiles == 0) return 0;
  static std::mutex mu;
  static bool set_on[64] = {};
  int err = allow_smem((const void*)partition_move_tiles, P_MAX_SMEM, mu,
                       set_on);
  if (err) return err;
  partition_move_tiles<<<(unsigned)tiles, P_THREADS, P_TILE * widest,
                         (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(mask), n, static_cast<const unsigned*>(base),
      static_cast<const long long*>(count), cols);
  return (int)cudaGetLastError();
}
