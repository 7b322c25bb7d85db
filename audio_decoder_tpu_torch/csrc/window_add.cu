// Contiguous-window scatter-add over one or several lane sets:
//   out[starts_s[l] + i] += upd_s[l, i]   (every set s, lane l, i < W)
// truncated to n_out, every output element written once, int32 or float32.
//
// Two entry points share one implementation:
//   * window_add_launch (K3), one lane set.  Replaces the TPU kernel
//     audio_decoder_tpu/ops/window_add.py window_add (body _kernel); the
//     plain torch twin is ops/window_add.window_add_plain.  FLAC assembles
//     its PCM with it: f32 frame rows [2048, 8192] into 16,785,408 outputs
//     at the 16-file group.
//   * window_add_spmd_launch (K5 on one card), the lane sets of every data
//     shard on the card, each in its own allocation, summed into one
//     output.  Replaces audio_decoder_tpu/ops/window_add.py window_add_spmd
//     (K3 per shard inside a shard_map, then a psum of full-size partials);
//     the plain twin is ops/window_add.window_add_spmd_plain.  The sharded
//     FLAC decode assembles its values (i32 [16384, 256] and [1024, 8] per
//     shard) and its PCM (f32 [512, 8192] per shard at the 16-file group
//     over 4 shards) with it.
//
// Contract (the caller's, as for the TPU kernel), per set: starts are
// non-decreasing over the live lanes; padding lanes carry zero updates and
// may sit at the tail with start 0.  Nothing is assumed across sets: a set
// may start below the one before it.  Every start is re-pointed through its
// own set's running maximum, so within a set the lanes that touch an output
// range form one contiguous run, found by binary search.  A re-pointed lane
// is added like any other, whatever its updates.  A tile adds its sets'
// runs in set order, each in lane order: int32 is exact on any input, and
// float32 equals the plain twins bit for bit whenever each output element
// gets at most one nonzero term (FLAC's windows tile the output).
//
// What bounds it: bytes.  Each update is read once and each output written
// once (67 MB in, 67 MB out at the 16-file group: 40 us at 3.35 TB/s).  At
// that shape most of the output is one row copied: every live frame starts
// at a multiple of 8192 and covers two tiles alone, 642 tiles get no lane,
// and the 320 padding rows pile onto the last live start (two tiles of 321
// rows, 10.5 MB of zeros to add).  So the design keeps the sums in
// registers, moves 16 bytes per access and keeps many blocks' loads in
// flight; K5 adds no partial outputs, no zero-fill and no add pass:
//   * The sets come as a table passed by value in the launch parameters
//     (at most kMaxSets): set s's raw starts and updates, and its lanes'
//     place in the joint lane space of the sorted starts and the records.
//   * The plan, for at most kSmemStarts starts in all (FLAC's frame rows):
//     a 4-byte memset zeroes the heavy-unit counter, then every block of
//     window_add_plan takes each set's running maximum of the starts into
//     shared memory itself and block 0 writes them to the workspace.  For
//     more starts, window_add_runmax takes the running maximum of each
//     chunk of run_chunk starts of a set and each chunk's maximum, and the
//     plan blocks apply each set's prefix maximum of those (the carries) to
//     its starts in place.  Two plan threads per output tile and set find
//     the set's lane run in the tile by binary search (one search each, in
//     shared memory when the starts are there).  The first thread of the
//     tile writes its record: its first lane (joint index), its lanes (all
//     sets; bitwise-negated when they come from more than one set, whose
//     runs K5 also writes), that lane's start, and its unit slot or -1; for
//     a tile of more than one unit of about kUnitWork lane-elements
//     (heavy), it takes a contiguous range of unit slots with one
//     atomicAdd.
//   * window_add_main: blocks [0, heavy_blocks) walk the heavy units (unit
//     i, i + heavy_blocks, ...), so the pile-ups start first; block
//     heavy_blocks + t takes tile t if it is light.  Thread k of kThreads
//     owns the kVecs runs of 4 consecutive elements at 4 * (k + v *
//     kThreads) and keeps their sums in registers: it adds the tile's rows
//     in order with 16-byte loads, all of a row's loads issued before their
//     adds, and writes each run with one 16-byte store.  No shared memory,
//     no barrier outside the heavy tiles' hand-over.  A light tile of one
//     set needs one dependent load (its record) before its rows' loads; at
//     40 registers, three blocks of 512 threads fit on an SM, and the
//     one-row tiles run at the card's copy rate.
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
constexpr int kMaxSets = 64;                    // lane sets of one K5 launch

static_assert(kTile % (4 * kThreads) == 0, "a tile is whole runs per thread");
static_assert(2 * kMaxSets <= kPlanThreads, "a tile's searches fit a block");

// The lane sets (K3: one; K5: up to kMaxSets), passed by value.  Set s has
// raw starts starts[s] and updates upd[s] ([lanes, W]); its lanes are
// [base[s], base[s + 1]) of the joint lane space (the sorted starts) and
// its running-max chunks [cbase[s], cbase[s + 1]).
template <int kCap>
struct Sets {
  int n;
  unsigned long long vec;  // bit s: set s's rows are 16-byte aligned
  const int* starts[kCap];
  const void* upd[kCap];
  int base[kCap + 1];
  int cbase[kCap + 1];
};

// The set whose range [edge[s], edge[s + 1]) holds x (empty sets skipped).
template <int kCap>
__device__ __forceinline__ int set_of(const int (&edge)[kCap + 1], int n,
                                      int x) {
  if constexpr (kCap == 1) {
    return 0;
  } else {
    int s = 0;
    for (int k = 1; k < n; ++k) s += edge[k] <= x;
    return s;
  }
}

// Set s's first lane in the joint lane space: 0 for set 0, so that K3's
// one set reads its sorted starts from the parameters as they are.
template <int kCap>
__device__ __forceinline__ int first_lane(const Sets<kCap>& sets, int s) {
  return s == 0 ? 0 : sets.base[s];
}

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

// A tile's record from the plan (int4): its first lane in the joint lane
// space (0 without lanes); its lanes n, or ~n when they come from more than
// one set (then its per-set runs are in `runs`); the start of its first
// lane (0 without lanes); its first unit slot (-1 for a light tile).
template <typename T, int kCap>
struct Args {
  Sets<kCap> sets;
  const int* sorted;  // the re-pointed starts, joint lane space
  int W;
  long long n_out;
  T* out;
  const int4* recs;
  const int2* runs;   // [nt, sets.n]: each set's run (lo, hi), K5 only
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

// Adds lanes [j0, j1) of set s in order into this thread's elements of the
// tile at t0 (start0: the start of lane j0).
template <typename T, int kCap>
__device__ __forceinline__ void add_rows(T (&acc)[kElems],
                                         const Args<T, kCap>& p, int s, int j0,
                                         int j1, int start0, long long t0) {
  for (int j = j0; j < j1; ++j) {
    const long long qb =
        t0 - (j == j0 ? start0 : p.sorted[first_lane(p.sets, s) + j]);
    if (qb >= p.W || qb + kTile <= 0) continue;
    const T* row = static_cast<const T*>(p.sets.upd[s]) + (long long)j * p.W;
    if (!((p.sets.vec >> s) & 1)) {
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
template <typename T, int kCap>
__device__ __forceinline__ void store_tile(const Args<T, kCap>& p, long long t0,
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

// Unit c of tile t (record rec): its share of the tile's lanes, the k-th
// to the (k1 - 1)-th in tile order (each set's run in set order, each run
// in lane order), then for a heavy tile the fixed-order combine.
template <typename T, int kCap>
__device__ __forceinline__ void run_unit(const Args<T, kCap>& p, int t,
                                         const int4 rec, int c) {
  __shared__ int s_last;
  const long long t0 = (long long)t * kTile;
  const bool spans = kCap > 1 && rec.y < 0;  // lanes of more than one set
  const int n = spans ? ~rec.y : rec.y;
  const int units = rec.w < 0 ? 1 : tile_units(n, p.W);
  const int per = (n + units - 1) / units;
  const int k0 = min(c * per, n), k1 = min(c * per + per, n);
  const int s0 = set_of<kCap>(p.sets.base, p.sets.n, rec.x);
  T acc[kElems];
#pragma unroll
  for (int k = 0; k < kElems; ++k) acc[k] = T(0);
  if (!spans) {
    // one run, lanes [lo, lo + n) of set s0; the tile's first start comes
    // with its record: one load less
    const int lo = rec.x - first_lane(p.sets, s0);
    const int j0 = lo + k0, j1 = lo + k1;
    const int start0 =
        k0 == 0 ? rec.z : j0 < j1 ? p.sorted[first_lane(p.sets, s0) + j0] : 0;
    add_rows(acc, p, s0, j0, j1, start0, t0);
  } else {
    // the sets' runs in order from s0, the set of the tile's first lane
    int at = 0;
    for (int s = s0; s < p.sets.n && at < k1; ++s) {
      const int2 run = p.runs[(long long)t * p.sets.n + s];
      const int a = max(k0 - at, 0), e = min(k1 - at, run.y - run.x);
      if (a < e) {
        const int j0 = run.x + a;
        add_rows(acc, p, s, j0, run.x + e,
                 at + a == 0 ? rec.z : p.sorted[first_lane(p.sets, s) + j0],
                 t0);
      }
      at += run.y - run.x;
    }
  }
  if (units == 1) {
    store_tile(p, t0, acc);
    return;
  }

  // heavy tile: this unit's partial, then the fixed-order combine
  const int off = rec.w;
  store_partial(p.scratch + (long long)(off + c) * kTile, acc);
  __threadfence();
  __syncthreads();
  const int g = c / kGroup, groups = (units + kGroup - 1) / kGroup;
  const int in_group = min(kGroup, units - g * kGroup);
  if (threadIdx.x == 0) {
    s_last = atomicAdd(&p.gcnt[off + g * kGroup], 1u) ==
             (unsigned)(in_group - 1);
  }
  __syncthreads();
  const bool last_of_group = s_last;
  __syncthreads();  // s_last is read
  if (!last_of_group) return;
  __threadfence();

  // level 1: the group's partials in unit order
  sum_partials(acc, p.scratch, off + g * kGroup, 1, in_group);
  if (groups == 1) {
    store_tile(p, t0, acc);
    return;
  }
  store_partial(p.scratch + (long long)(off + g * kGroup) * kTile, acc);
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
  sum_partials(acc, p.scratch, off, kGroup, groups);
  store_tile(p, t0, acc);
}

template <typename T, int kCap>
__global__ void __launch_bounds__(kThreads, kMinBlocks) window_add_main(
    const Args<T, kCap> p) {
  const int b = blockIdx.x;
  if (b < p.heavy_blocks) {
    const int total = min(*p.heavy_total, p.heavy);
    for (int i = b; i < total; i += p.heavy_blocks) {
      const int t = p.unit_tile[i];
      const int4 rec = p.recs[t];
      run_unit(p, t, rec, i - rec.w);
    }
    return;
  }
  const int t = b - p.heavy_blocks;
  const int4 rec = p.recs[t];
  if (rec.w >= 0) return;  // heavy: its units ran above
  run_unit(p, t, rec, 0);
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

// Block k, chunk k (chunks numbered set by set): sorted[g] = the running
// maximum of its set's starts within the chunk of `chunk` starts; cmax[k]
// = the chunk's maximum.  Block 0 also zeroes heavy_total.
template <int kCap>
__global__ void __launch_bounds__(kPlanThreads) window_add_runmax(
    const Sets<kCap> sets, int chunk, int* __restrict__ sorted,
    int* __restrict__ cmax, int* __restrict__ heavy_total) {
  __shared__ int warp_max[kPlanThreads / 32];
  if (blockIdx.x == 0 && threadIdx.x == 0) *heavy_total = 0;
  const int S = kCap == 1 ? 1 : sets.n;  // indices known at compile time
  const int k = blockIdx.x;
  const int s = set_of<kCap>(sets.cbase, S, k);
  const long long begin = (long long)(k - sets.cbase[s]) * chunk;
  const int len = sets.base[s + 1] - sets.base[s];
  if (k >= sets.cbase[S] || begin >= len) return;
  const long long end = min(begin + chunk, (long long)len);
  int carry = INT_MIN;
  for (long long sub = begin; sub < end; sub += kRunChunk) {
    carry = block_runmax(sets.starts[s] + sub,
                         (int)min((long long)kRunChunk, end - sub), carry,
                         sorted + sets.base[s] + sub, warp_max);
  }
  if (threadIdx.x == 0) cmax[k] = carry;
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

// The sorted starts, then the tiles' records.  `fused` (at most
// kSmemStarts starts in all): every block takes each set's running maximum
// of the raw starts into shared memory itself, searches there, and block 0
// writes them to `sorted` (no running-max launch).  Else every block takes
// each set's prefix maximum of its chunk maxima (the carries) and applies
// them to window_add_runmax's starts in place (a start read before or after
// its fix gives the same maximum).  `group` threads per tile t (a power of
// two, at least 2 per set): threads 2s and 2s + 1 find set s's run (lo, hi)
// by one binary search each; after a barrier, thread 0 of the group writes
// the tile's record and, for a heavy tile, takes its unit slots.
template <int kCap>
__global__ void __launch_bounds__(kPlanThreads) window_add_plan(
    const Sets<kCap> sets, int* sorted, int W, int fused, int group,
    const int* __restrict__ cmax, int log_chunk, int nt,
    int4* __restrict__ recs, int2* __restrict__ runs,
    unsigned* __restrict__ tcnt, int* __restrict__ heavy_total,
    int* __restrict__ unit_tile, unsigned* __restrict__ gcnt, int heavy) {
  __shared__ int carry[kMaxChunks];
  __shared__ int s_st[kSmemStarts];
  __shared__ int warp_max[kPlanThreads / 32];
  __shared__ int s_b[kPlanThreads];
  const int S = kCap == 1 ? 1 : sets.n;  // indices known at compile time
  const int tid = threadIdx.x;
  if (fused) {
    for (int s = 0; s < S; ++s) {
      const int len = sets.base[s + 1] - sets.base[s];
      int c = INT_MIN;
      for (int b0 = 0; b0 < len; b0 += kRunChunk) {
        c = block_runmax(sets.starts[s] + b0, min(kRunChunk, len - b0), c,
                         s_st + sets.base[s] + b0, warp_max);
      }
    }
    if (blockIdx.x == 0) {
      for (int i = tid; i < sets.base[S]; i += kPlanThreads) sorted[i] = s_st[i];
    }
  } else {
    for (int k = tid; k < sets.cbase[S]; k += kPlanThreads) carry[k] = cmax[k];
    for (int s = 0; s < S; ++s) {
      exclusive_max(carry + sets.cbase[s], sets.cbase[s + 1] - sets.cbase[s]);
    }
    const long long stride = (long long)gridDim.x * kPlanThreads;
    for (int s = 0; s < S; ++s) {
      const int len = sets.base[s + 1] - sets.base[s];
      const int* cs = carry + sets.cbase[s];
      int* so = sorted + sets.base[s];
      for (long long i = (long long)blockIdx.x * kPlanThreads + tid; i < len;
           i += stride) {
        const int c = cs[i >> log_chunk];
        if (c > so[i]) so[i] = c;
      }
    }
  }
  auto start = [&](int s, int i) {
    return fused ? s_st[first_lane(sets, s) + i]
                 : max(sorted[first_lane(sets, s) + i],
                       carry[sets.cbase[s] + (i >> log_chunk)]);
  };

  const long long tl = (long long)blockIdx.x * (kPlanThreads / group) + tid / group;
  const int t = (int)min(tl, (long long)nt);
  const int k = tid % group, s = kCap == 1 ? 0 : k >> 1, q = k & 1;
  const long long t0 = (long long)t * kTile;
  int b = 0;
  if (t < nt && s < S && W > 0) {
    b = lower_bound([&](int i) { return start(s, i); },
                    sets.base[s + 1] - sets.base[s],
                    q ? t0 + kTile : t0 - W + 1);
  }
  s_b[tid] = b;
  __syncthreads();
  if (t >= nt) return;
  if (kCap > 1 && s < S && q == 0) {
    runs[(long long)t * S + s] = make_int2(b, s_b[tid + 1]);
  }
  if (k != 0) return;
  const int* tb = s_b + tid;  // the tile's (lo, hi) per set
  int n = 0, first = -1, hit = 0;
  for (int r = 0; r < S; ++r) {
    const int m = tb[2 * r + 1] - tb[2 * r];
    if (m > 0) {
      if (first < 0) first = r;
      ++hit;
      n += m;
    }
  }
  const int f = kCap == 1 ? 0 : max(first, 0);
  const int lo = tb[2 * f];
  const int4 rec = make_int4(first < 0 ? 0 : first_lane(sets, f) + lo,
                             hit > 1 ? ~n : n, first < 0 ? 0 : start(f, lo),
                             -1);
  const int units = tile_units(n, W);
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

// The three launches over the workspace ws (sorted, cmax, recs, tcnt,
// heavy_total, unit_tile, gcnt, scratch, runs; runs unused for one set).
template <typename T, int kCap>
int launch(int n_sets, const void* const* starts, const void* const* upd,
           const int* lens, int W, long long n_out, void* out,
           void* const* ws, int run_chunk, int heavy, cudaStream_t stream) {
  int log_chunk = 0;
  while ((1LL << log_chunk) < run_chunk && log_chunk < 30) ++log_chunk;
  if (run_chunk < kRunChunk || (1 << log_chunk) != run_chunk || heavy < 0 ||
      n_sets < 1 || n_sets > kCap || W < 0 || n_out < 0 ||
      ((uintptr_t)out & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Sets<kCap> sets{};
  sets.n = n_sets;
  long long lanes = 0, chunks = 0;
  for (int s = 0; s < n_sets; ++s) {
    if (lens[s] < 0) return (int)cudaErrorInvalidValue;
    sets.starts[s] = (const int*)starts[s];
    sets.upd[s] = upd[s];
    if ((W & 3) == 0 && ((uintptr_t)upd[s] & 15) == 0) sets.vec |= 1ULL << s;
    sets.base[s] = (int)lanes;
    sets.cbase[s] = (int)chunks;
    lanes += lens[s];
    chunks += (lens[s] + run_chunk - 1) / run_chunk;
    if (lanes > INT_MAX) return (int)cudaErrorInvalidValue;
  }
  sets.base[n_sets] = (int)lanes;
  sets.cbase[n_sets] = (int)chunks;
  const long long nt = (n_out + kTile - 1) / kTile;
  if (chunks > kMaxChunks || nt + kHeavyBlocks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (nt == 0) return (int)cudaGetLastError();
  int* sorted = (int*)ws[0];
  int* cmax = (int*)ws[1];
  int* heavy_total = (int*)ws[4];
  const bool fused = lanes <= kSmemStarts;
  if (fused) {
    const cudaError_t e = cudaMemsetAsync(heavy_total, 0, sizeof(int), stream);
    if (e != cudaSuccess) return (int)e;
  } else {
    window_add_runmax<kCap><<<(unsigned)std::max(chunks, 1LL), kPlanThreads, 0,
                              stream>>>(sets, run_chunk, sorted, cmax,
                                        heavy_total);
  }
  int group = 2;
  while (group < 2 * n_sets) group *= 2;
  const long long fix_blocks = (lanes + 16 * kPlanThreads - 1) / (16 * kPlanThreads);
  const long long per_block = kPlanThreads / group;
  const long long plan_blocks = std::max((nt + per_block - 1) / per_block,
                                         std::max(fix_blocks, 1LL));
  window_add_plan<kCap><<<(unsigned)plan_blocks, kPlanThreads, 0, stream>>>(
      sets, sorted, W, (int)fused, group, cmax, log_chunk, (int)nt,
      (int4*)ws[2], (int2*)ws[8], (unsigned*)ws[3], heavy_total, (int*)ws[5],
      (unsigned*)ws[6], heavy);
  const Args<T, kCap> p{sets, sorted, W, n_out, (T*)out, (const int4*)ws[2],
                        (const int2*)ws[8], (unsigned*)ws[3], heavy_total,
                        (const int*)ws[5], (unsigned*)ws[6], (T*)ws[7], heavy,
                        std::min(heavy, kHeavyBlocks)};
  window_add_main<T, kCap>
      <<<(unsigned)(nt + p.heavy_blocks), kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int kCap>
int launch_typed(int is_f32, int n_sets, const void* const* starts,
                 const void* const* upd, const int* lens, int W,
                 long long n_out, void* out, void* const* ws, int run_chunk,
                 int heavy, void* stream) {
  if (is_f32) {
    return launch<float, kCap>(n_sets, starts, upd, lens, W, n_out, out, ws,
                               run_chunk, heavy, (cudaStream_t)stream);
  }
  return launch<int32_t, kCap>(n_sets, starts, upd, lens, W, n_out, out, ws,
                               run_chunk, heavy, (cudaStream_t)stream);
}

}  // namespace

extern "C" int window_add_tile() { return kTile; }
extern "C" long long window_add_unit_work() { return kUnitWork; }
extern "C" int window_add_max_sets() { return kMaxSets; }

extern "C" int window_add_blocks_per_sm() {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, window_add_main<float, 1>, kThreads, 0);
  return e == cudaSuccess ? n : -(int)e;
}

// K3, one lane set: three launches on `stream` (the running maximum, the
// plan, the main kernel).  ws: the workspace's parts (sorted starts [L],
// chunk maxima, recs [nt] int4, tcnt [nt], heavy_total [1], unit_tile
// [heavy], gcnt [heavy], scratch [heavy, kTile]), each 16-byte aligned; out
// 16-byte aligned.  Returns a CUDA error code.
extern "C" int window_add_launch(const void* starts, int L, const void* upd,
                                 int W, long long n_out, int is_f32, void* out,
                                 void* sorted, void* cmax, void* recs,
                                 void* tcnt, void* heavy_total,
                                 void* unit_tile, void* gcnt, void* scratch,
                                 int run_chunk, int heavy, void* stream) {
  void* const ws[8] = {sorted, cmax, recs, tcnt, heavy_total, unit_tile, gcnt,
                       scratch};
  void* const parts[9] = {ws[0], ws[1], ws[2], ws[3], ws[4], ws[5], ws[6],
                          ws[7], nullptr};
  return launch_typed<1>(is_f32, 1, &starts, &upd, &L, W, n_out, out, parts,
                         run_chunk, heavy, stream);
}

// K5 on one card: the n_sets lane sets (starts[s], upd[s] of lens[s] lanes,
// one width W and type) into one output, with K3's three launches.  ws as
// K3's, then runs [nt * n_sets] int2.  Returns a CUDA error code.
extern "C" int window_add_spmd_launch(int n_sets, const void* const* starts,
                                      const void* const* upd, const int* lens,
                                      int W, long long n_out, int is_f32,
                                      void* out, void* sorted, void* cmax,
                                      void* recs, void* tcnt,
                                      void* heavy_total, void* unit_tile,
                                      void* gcnt, void* scratch, void* runs,
                                      int run_chunk, int heavy, void* stream) {
  void* const ws[9] = {sorted, cmax, recs, tcnt, heavy_total, unit_tile, gcnt,
                       scratch, runs};
  return launch_typed<kMaxSets>(is_f32, n_sets, starts, upd, lens, W, n_out,
                                out, ws, run_chunk, heavy, stream);
}
