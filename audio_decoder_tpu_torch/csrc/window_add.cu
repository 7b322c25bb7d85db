// Contiguous-window scatter-add over one lane set:
//   out[starts[l] + i] += upd[l, i]
// truncated to n_out, every output element written once, int32 or float32.
//
// Replaces the TPU kernel audio_decoder_tpu/ops/window_add.py window_add
// (body _kernel, K3).  The plain torch twin is
// ops/window_add.window_add_plain.  FLAC assembles its PCM with it: f32
// frame rows [2048, 8192] into 16,785,408 outputs at the 16-file group.
//
// Contract (the caller's, as for the TPU kernel): starts are non-decreasing
// over the live lanes; padding lanes carry zero updates and may sit at the
// tail with start 0.  Every start is re-pointed through a running maximum,
// so the starts the later kernels see are sorted and the lanes that touch
// an output range form one contiguous run, found by binary search.  A
// re-pointed lane is added like any other, whatever its updates.
//
// What bounds it: bytes.  Each update is read once and each output written
// once (67 MB in, 67 MB out at the 16-file group: 40 us at 3.35 TB/s).  At
// that shape most of the output is one row copied: every live frame starts
// at a multiple of 8192 and covers two tiles alone, 642 tiles get no lane,
// and the 320 padding rows pile onto the last live start (two tiles of 321
// rows, 10.5 MB of zeros to add).  So the design keeps the sums in
// registers, moves 16 bytes per access and keeps many blocks' loads in
// flight:
//   * The plan, for at most kSmemStarts starts (FLAC's frame rows): a
//     4-byte memset zeroes the heavy-unit counter, then every block of
//     window_add_plan takes the running maximum of the starts into shared
//     memory itself and block 0 writes them to the workspace.  For more
//     starts, window_add_runmax takes the running maximum of each chunk of
//     run_chunk starts and each chunk's maximum, and the plan blocks apply
//     the prefix maximum of those (the carries) to the starts in place.
//     Two plan threads per output tile of kTile elements find the tile's
//     lane run by binary search (one search each, in shared memory when
//     the starts are there).  The first of the two writes the tile's record
//     (its lanes, its first lane's start, its unit slot or -1) and, for a
//     tile of more than one unit of about kUnitWork lane-elements (heavy),
//     takes a contiguous range of unit slots with one atomicAdd.
//   * window_add_main: blocks [0, heavy_blocks) walk the heavy units (unit
//     i, i + heavy_blocks, ...), so the pile-ups start first; block
//     heavy_blocks + t takes tile t if it is light.  Thread k of kThreads
//     owns the kVecs runs of 4 consecutive elements at 4 * (k + v *
//     kThreads) and keeps their sums in registers: it adds the tile's rows
//     in lane order with 16-byte loads, all of a row's loads issued before
//     their adds, and writes each run with one 16-byte store.  No shared
//     memory, no barrier outside the heavy tiles' hand-over.  A light tile
//     of one lane needs one dependent load (its record) before its row's
//     loads; at 40 registers, three blocks of 512 threads fit on an SM, and
//     the one-row tiles run at the card's copy rate.
//   * A row whose start is not a multiple of 4 is read with the same
//     aligned 16-byte loads, two per run, and shifted into place in
//     registers (the shift is the same for every run of the row).  A row
//     that is not 16-byte aligned in memory (W % 4 != 0, or an update array
//     that starts off 16 bytes) is read 4 bytes at a time.
//   * A heavy tile's units each write their partial tile to scratch.  The
//     last unit of each group of kGroup units to finish (an atomic counter
//     per group) adds the group's partials in unit order; the last group
//     of the tile adds the groups' sums in group order and writes the tile.
//     The order is fixed, so float32 gives the same bits on every run.
// No zero-fill pass: a tile with no lanes writes its zeros directly.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 4096;                     // output elements per tile
constexpr int kThreads = 512;                   // the main kernel's blocks
constexpr int kMinBlocks = 3;                   // its blocks per SM, at least
constexpr int kPlanThreads = 256;               // the running max's and plan's
constexpr int kVecs = kTile / 4 / kThreads;     // runs of 4 per thread
constexpr int kElems = 4 * kVecs;               // a thread's elements
constexpr long long kUnitWork = 32768;          // lane-elements one block adds
constexpr int kRowWork = kTile / 4;             // the least a row costs
constexpr int kGroup = 16;                      // partials per combine step
constexpr int kPartsInFlight = 2;               // partials loaded at a time
constexpr int kRunChunk = 2048;                 // starts per running-max step
constexpr int kMaxChunks = 4096;                // chunk maxima the plan scans
constexpr int kSmemStarts = 4096;               // starts a plan block scans
constexpr int kHeavyBlocks = 264;               // blocks that walk heavy units

static_assert(kTile % (4 * kThreads) == 0, "a tile is whole runs per thread");

// 16 bytes as four T, through int4 (T is int32_t or float).
template <typename T>
__device__ __forceinline__ T from_bits(int x) {
  if constexpr (std::is_same_v<T, float>) return __int_as_float(x);
  else return x;
}
template <typename T>
__device__ __forceinline__ int to_bits(T x) {
  if constexpr (std::is_same_v<T, float>) return __float_as_int(x);
  else return x;
}
template <typename T>
__device__ __forceinline__ void unpack(int4 v, T* r) {
  r[0] = from_bits<T>(v.x);
  r[1] = from_bits<T>(v.y);
  r[2] = from_bits<T>(v.z);
  r[3] = from_bits<T>(v.w);
}
template <typename T>
__device__ __forceinline__ int4 pack(const T* r) {
  return make_int4(to_bits(r[0]), to_bits(r[1]), to_bits(r[2]), to_bits(r[3]));
}

// Units of a tile of n lanes of width W: its work is counted as lanes times
// min(W, kTile) elements, and at least kRowWork per lane, since every
// thread steps through every row of its tile.
__device__ __forceinline__ int tile_units(int n, int W) {
  const long long work = (long long)n * max(min(W, kTile), kRowWork);
  long long u = (work + kUnitWork - 1) / kUnitWork;
  u = min(u, (long long)max(n, 1));
  return (int)max(u, 1LL);
}

// A tile's record from the plan: its lanes [lo, hi), the start of lane lo
// (0 without lanes) and its first unit slot (-1 for a light tile).
struct Rec {
  int lo, hi, start, off;
};

template <typename T>
struct Args {
  const int* starts;  // sorted (re-pointed) starts
  const T* upd;
  int W;
  bool vec;           // rows are 16-byte aligned: W % 4 == 0, upd aligned
  long long n_out;
  T* out;
  const int4* recs;
  unsigned* tcnt;
  const int* heavy_total;
  const int* unit_tile;
  unsigned* gcnt;
  T* scratch;
  int heavy, heavy_blocks;
};

// acc += row[q .. q + 4) for each run, q = qb + 4 * (tid + v * kThreads)
// (qb: the row element at tile element 0, qb & 3 == SH), through the
// aligned 16-byte chunks that hold them; elements outside [0, W) add 0.
template <int SH, typename T>
__device__ __forceinline__ void add_row_vec(T (&acc)[kElems], const T* row,
                                            long long qb, int W) {
  int4 a[kVecs], b[kVecs];
  const int4 zero = make_int4(0, 0, 0, 0);
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    const long long q0 = qb - SH + 4 * (threadIdx.x + v * kThreads);
    a[v] = q0 >= 0 && q0 < W ? __ldg(reinterpret_cast<const int4*>(row + q0))
                             : zero;
    if (SH) {
      b[v] = q0 + 4 >= 0 && q0 + 4 < W
                 ? __ldg(reinterpret_cast<const int4*>(row + q0 + 4))
                 : zero;
    }
  }
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    T x[8];
    unpack(a[v], x);
    if (SH) unpack(b[v], x + 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[4 * v + i] += x[SH + i];
  }
}

// The same, 4 bytes at a time (a row that is not 16-byte aligned).
template <typename T>
__device__ __forceinline__ void add_row_scalar(T (&acc)[kElems], const T* row,
                                               long long qb, int W) {
  T x[kElems];
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long q = qb + 4 * (threadIdx.x + v * kThreads) + i;
      x[4 * v + i] = q >= 0 && q < W ? __ldg(row + q) : T(0);
    }
  }
#pragma unroll
  for (int k = 0; k < kElems; ++k) acc[k] += x[k];
}

// Adds lanes [j0, j1) in order into this thread's elements of the tile at
// t0 (start0: the start of lane j0).
template <typename T>
__device__ __forceinline__ void add_rows(T (&acc)[kElems], const Args<T>& p,
                                         int j0, int j1, int start0,
                                         long long t0) {
  for (int j = j0; j < j1; ++j) {
    const long long qb = t0 - (j == j0 ? start0 : p.starts[j]);
    if (qb >= p.W || qb + kTile <= 0) continue;
    const T* row = p.upd + (long long)j * p.W;
    if (!p.vec) {
      add_row_scalar(acc, row, qb, p.W);
      continue;
    }
    switch ((int)(qb & 3)) {
      case 0: add_row_vec<0>(acc, row, qb, p.W); break;
      case 1: add_row_vec<1>(acc, row, qb, p.W); break;
      case 2: add_row_vec<2>(acc, row, qb, p.W); break;
      default: add_row_vec<3>(acc, row, qb, p.W); break;
    }
  }
}

// This thread's runs of the tile at t0 into out, cut at n_out.
template <typename T>
__device__ __forceinline__ void store_tile(const Args<T>& p, long long t0,
                                           const T (&acc)[kElems]) {
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    const long long g = t0 + 4 * (threadIdx.x + v * kThreads);
    if (g + 4 <= p.n_out) {
      __stwb(reinterpret_cast<int4*>(p.out + g), pack(acc + 4 * v));
    } else {
      for (int i = 0; i < 4 && g + i < p.n_out; ++i) p.out[g + i] = acc[4 * v + i];
    }
  }
}

// acc = the sum, in order, of the `count` partial tiles at slots slot0 +
// k * stride, kPartsInFlight partials' loads in flight at a time.
template <typename T>
__device__ __forceinline__ void sum_partials(T (&acc)[kElems],
                                             const T* scratch, int slot0,
                                             int stride, int count) {
#pragma unroll
  for (int k = 0; k < kElems; ++k) acc[k] = T(0);
  for (int k0 = 0; k0 < count; k0 += kPartsInFlight) {
    int4 x[kPartsInFlight][kVecs];
#pragma unroll
    for (int k = 0; k < kPartsInFlight; ++k) {
      const T* part = scratch + (long long)(slot0 + (k0 + k) * stride) * kTile;
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        x[k][v] = k0 + k < count
                      ? __ldcg(reinterpret_cast<const int4*>(
                            part + 4 * (threadIdx.x + v * kThreads)))
                      : make_int4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int k = 0; k < kPartsInFlight; ++k) {
      if (k0 + k >= count) break;
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        T y[4];
        unpack(x[k][v], y);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[4 * v + i] += y[i];
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_partial(T* part, const T (&acc)[kElems]) {
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    __stcg(reinterpret_cast<int4*>(part + 4 * (threadIdx.x + v * kThreads)),
           pack(acc + 4 * v));
  }
}

// Unit c of tile t (record r).
template <typename T>
__device__ __forceinline__ void run_unit(const Args<T>& p, int t, const Rec& r,
                                         int c) {
  __shared__ int s_last;
  const long long t0 = (long long)t * kTile;
  const int n = r.hi - r.lo;
  const int units = r.off < 0 ? 1 : tile_units(n, p.W);
  const int per = (n + units - 1) / units;
  const int j0 = r.lo + min(c * per, n), j1 = r.lo + min(c * per + per, n);
  T acc[kElems];
#pragma unroll
  for (int k = 0; k < kElems; ++k) acc[k] = T(0);
  // a light tile's first start comes with its record: one load less
  const int start0 = j0 == r.lo ? r.start : j0 < j1 ? p.starts[j0] : 0;
  add_rows(acc, p, j0, j1, start0, t0);
  if (units == 1) {
    store_tile(p, t0, acc);
    return;
  }

  // heavy tile: this unit's partial, then the fixed-order combine
  store_partial(p.scratch + (long long)(r.off + c) * kTile, acc);
  __threadfence();
  __syncthreads();
  const int g = c / kGroup, groups = (units + kGroup - 1) / kGroup;
  const int in_group = min(kGroup, units - g * kGroup);
  if (threadIdx.x == 0) {
    s_last = atomicAdd(&p.gcnt[r.off + g * kGroup], 1u) ==
             (unsigned)(in_group - 1);
  }
  __syncthreads();
  const bool last_of_group = s_last;
  __syncthreads();  // s_last is read
  if (!last_of_group) return;
  __threadfence();

  // level 1: the group's partials in unit order
  sum_partials(acc, p.scratch, r.off + g * kGroup, 1, in_group);
  if (groups == 1) {
    store_tile(p, t0, acc);
    return;
  }
  store_partial(p.scratch + (long long)(r.off + g * kGroup) * kTile, acc);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(&p.tcnt[t], 1u) == (unsigned)(groups - 1);
  }
  __syncthreads();
  const bool last_of_tile = s_last;
  __syncthreads();
  if (!last_of_tile) return;
  __threadfence();

  // level 2: the groups' sums in group order
  sum_partials(acc, p.scratch, r.off, kGroup, groups);
  store_tile(p, t0, acc);
}

__device__ __forceinline__ Rec rec_of(int4 v) { return {v.x, v.y, v.z, v.w}; }

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks) window_add_main(
    const Args<T> p) {
  const int b = blockIdx.x;
  if (b < p.heavy_blocks) {
    const int total = min(*p.heavy_total, p.heavy);
    for (int i = b; i < total; i += p.heavy_blocks) {
      const int t = p.unit_tile[i];
      const Rec r = rec_of(p.recs[t]);
      run_unit(p, t, r, i - r.off);
    }
    return;
  }
  const int t = b - p.heavy_blocks;
  const Rec r = rec_of(p.recs[t]);
  if (r.off >= 0) return;  // heavy: its units ran above
  run_unit(p, t, r, 0);
}

// In place: v[k] = max(v[0..k)) (INT_MIN for k = 0), n <= kMaxChunks;
// warp 0 scans, each lane a contiguous segment.
__device__ void exclusive_max(int* v, int n) {
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (n + 31) / 32, i0 = min(lane * per, n), i1 = min(i0 + per, n);
    int m = INT_MIN;
    for (int i = i0; i < i1; ++i) m = max(m, v[i]);
    int x = m;  // inclusive scan of the segment maxima
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x = max(x, y);
    }
    int run = __shfl_up_sync(0xffffffffu, x, 1);
    if (lane == 0) run = INT_MIN;
    for (int i = i0; i < i1; ++i) {
      const int w = v[i];
      v[i] = run;
      run = max(run, w);
    }
  }
  __syncthreads();
}

// out[i] = max(carry, s[0..i]) for i < n <= kRunChunk, by every thread of a
// kPlanThreads block (out may be shared or global memory); returns
// max(carry, s[0..n)).  Ends with a barrier.
__device__ int block_runmax(const int* s, int n, int carry, int* out,
                            int* warp_max) {
  constexpr int kPer = kRunChunk / kPlanThreads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = tid * kPer;
  int v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) v[k] = i0 + k < n ? s[i0 + k] : INT_MIN;
  int run = INT_MIN;
#pragma unroll
  for (int k = 0; k < kPer; ++k) v[k] = run = max(run, v[k]);
  int x = run;  // inclusive scan of the thread maxima within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x = max(x, y);
  }
  int before = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) before = INT_MIN;
  if (lane == 31) warp_max[warp] = x;
  __syncthreads();
  int prefix = max(carry, before), all = carry;
  for (int w = 0; w < kPlanThreads / 32; ++w) {
    if (w < warp) prefix = max(prefix, warp_max[w]);
    all = max(all, warp_max[w]);
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (i0 + k < n) out[i0 + k] = max(prefix, v[k]);
  }
  __syncthreads();  // warp_max is read, out is written
  return all;
}

// sorted[i] = the running maximum of s within its chunk of `chunk` starts;
// cmax[k] = chunk k's maximum.  Block 0 also zeroes heavy_total.
__global__ void __launch_bounds__(kPlanThreads) window_add_runmax(
    const int* __restrict__ s, int L, int chunk, int* __restrict__ sorted,
    int* __restrict__ cmax, int* __restrict__ heavy_total) {
  __shared__ int warp_max[kPlanThreads / 32];
  if (blockIdx.x == 0 && threadIdx.x == 0) *heavy_total = 0;
  const long long base = (long long)blockIdx.x * chunk;
  if (base >= L) return;
  const long long end = min(base + chunk, (long long)L);
  int carry = INT_MIN;
  for (long long sub = base; sub < end; sub += kRunChunk) {
    carry = block_runmax(s + sub, (int)min((long long)kRunChunk, end - sub),
                         carry, sorted + sub, warp_max);
  }
  if (threadIdx.x == 0) cmax[blockIdx.x] = carry;
}

// Lower bound of v among at(0), ..., at(n - 1) (non-decreasing).
template <typename At>
__device__ __forceinline__ int lower_bound(At at, int n, long long v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)at(mid) < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The sorted starts, then the tiles' records.  `fused` (L <= kSmemStarts):
// every block takes the running maximum of the raw starts into shared
// memory itself, searches there, and block 0 writes them to `sorted` (no
// running-max launch).  Else every block takes the prefix maximum of the
// chunk maxima (the carries) and applies them to window_add_runmax's
// starts in place (a start read before or after its fix gives the same
// maximum).  Two threads per tile t, one binary search each (lo, hi),
// joined by a shuffle; the first of the two writes the tile's record and,
// for a heavy tile, takes its unit slots.
__global__ void __launch_bounds__(kPlanThreads) window_add_plan(
    const int* __restrict__ raw, int* sorted, int L, int W, int fused,
    const int* __restrict__ cmax, int log_chunk, int chunks, int nt,
    int4* __restrict__ recs, unsigned* __restrict__ tcnt,
    int* __restrict__ heavy_total, int* __restrict__ unit_tile,
    unsigned* __restrict__ gcnt, int heavy) {
  __shared__ int carry[kMaxChunks];
  __shared__ int s_st[kSmemStarts];
  __shared__ int warp_max[kPlanThreads / 32];
  const long long g = (long long)blockIdx.x * kPlanThreads + threadIdx.x;
  if (fused) {
    int c = INT_MIN;
    for (int base = 0; base < L; base += kRunChunk) {
      c = block_runmax(raw + base, min(kRunChunk, L - base), c, s_st + base,
                       warp_max);
    }
    if (blockIdx.x == 0) {
      for (int i = threadIdx.x; i < L; i += kPlanThreads) sorted[i] = s_st[i];
    }
  } else {
    for (int k = threadIdx.x; k < chunks; k += kPlanThreads) carry[k] = cmax[k];
    exclusive_max(carry, chunks);
    const long long stride = (long long)gridDim.x * kPlanThreads;
    for (long long i = g; i < L; i += stride) {
      const int c = carry[i >> log_chunk];
      if (c > sorted[i]) sorted[i] = c;
    }
  }
  auto start = [&](int i) {
    return fused ? s_st[i] : max(sorted[i], carry[i >> log_chunk]);
  };

  const int t = (int)min(g >> 1, (long long)nt), q = (int)(g & 1);
  const int n = W > 0 ? L : 0;
  const long long t0 = (long long)t * kTile;
  int b = 0;
  if (t < nt && n > 0) b = lower_bound(start, n, q ? t0 + kTile : t0 - W + 1);
  const int lane0 = threadIdx.x & 30;
  const int lo = __shfl_sync(0xffffffffu, b, lane0);
  const int hi = __shfl_sync(0xffffffffu, b, lane0 + 1);
  if (t >= nt || q != 0) return;
  const int units = tile_units(hi - lo, W);
  const int4 rec = make_int4(lo, hi, hi > lo ? start(lo) : 0, -1);
  if (units == 1) {
    recs[t] = rec;
    return;
  }
  const int off = atomicAdd(heavy_total, units);
  if (off + units > heavy) __trap();  // the host's bound is wrong
  recs[t] = make_int4(rec.x, rec.y, rec.z, off);
  tcnt[t] = 0;
  for (int c = 0; c < units; ++c) unit_tile[off + c] = t;
  for (int c = 0; c < units; c += kGroup) gcnt[off + c] = 0;
}

template <typename T>
int launch(const void* starts, int L, const void* upd, int W, long long n_out,
           void* out, void* const* ws, int run_chunk, int heavy,
           cudaStream_t stream) {
  int log_chunk = 0;
  while ((1LL << log_chunk) < run_chunk && log_chunk < 30) ++log_chunk;
  if (run_chunk < kRunChunk || (1 << log_chunk) != run_chunk || heavy < 0 ||
      L < 0 || W < 0 || n_out < 0 || ((uintptr_t)out & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long nt = (n_out + kTile - 1) / kTile;
  const int chunks = (int)(((long long)L + run_chunk - 1) / run_chunk);
  if (chunks > kMaxChunks || nt + kHeavyBlocks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (nt == 0) return (int)cudaGetLastError();
  int* sorted = (int*)ws[0];
  int* cmax = (int*)ws[1];
  int* heavy_total = (int*)ws[4];
  const bool fused = L <= kSmemStarts;
  if (fused) {
    const cudaError_t e = cudaMemsetAsync(heavy_total, 0, sizeof(int), stream);
    if (e != cudaSuccess) return (int)e;
  } else {
    window_add_runmax<<<std::max(chunks, 1), kPlanThreads, 0, stream>>>(
        (const int*)starts, L, run_chunk, sorted, cmax, heavy_total);
  }
  const long long fix_blocks =
      ((long long)L + 16 * kPlanThreads - 1) / (16 * kPlanThreads);
  const long long plan_blocks = std::max(
      (2 * nt + kPlanThreads - 1) / kPlanThreads, std::max(fix_blocks, 1LL));
  window_add_plan<<<(unsigned)plan_blocks, kPlanThreads, 0, stream>>>(
      (const int*)starts, sorted, L, W, (int)fused, cmax, log_chunk, chunks,
      (int)nt, (int4*)ws[2], (unsigned*)ws[3], heavy_total, (int*)ws[5],
      (unsigned*)ws[6], heavy);
  Args<T> p{sorted, (const T*)upd, W,
            (W & 3) == 0 && ((uintptr_t)upd & 15) == 0, n_out, (T*)out,
            (const int4*)ws[2], (unsigned*)ws[3], heavy_total,
            (const int*)ws[5], (unsigned*)ws[6], (T*)ws[7], heavy,
            std::min(heavy, kHeavyBlocks)};
  window_add_main<T><<<(unsigned)(nt + p.heavy_blocks), kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int window_add_tile() { return kTile; }
extern "C" long long window_add_unit_work() { return kUnitWork; }

extern "C" int window_add_blocks_per_sm() {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, window_add_main<float>, kThreads, 0);
  return e == cudaSuccess ? n : -(int)e;
}

// Three launches on `stream`: the running maximum, the plan, the main
// kernel.  ws: the workspace's parts (sorted starts [L], chunk maxima,
// recs [nt] int4, tcnt [nt], heavy_total [1], unit_tile [heavy], gcnt
// [heavy], scratch [heavy, kTile]), each 16-byte aligned; out 16-byte
// aligned.  Returns a CUDA error code.
extern "C" int window_add_launch(const void* starts, int L, const void* upd,
                                 int W, long long n_out, int is_f32, void* out,
                                 void* sorted, void* cmax, void* recs,
                                 void* tcnt, void* heavy_total,
                                 void* unit_tile, void* gcnt, void* scratch,
                                 int run_chunk, int heavy, void* stream) {
  void* const ws[8] = {sorted, cmax, recs, tcnt, heavy_total, unit_tile, gcnt,
                       scratch};
  if (is_f32) {
    return launch<float>(starts, L, upd, W, n_out, out, ws, run_chunk, heavy,
                         (cudaStream_t)stream);
  }
  return launch<int32_t>(starts, L, upd, W, n_out, out, ws, run_chunk, heavy,
                         (cudaStream_t)stream);
}
