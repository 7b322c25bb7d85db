// Contiguous-window scatter-add: out[starts[l] + i] += upd[l, i] for one or
// two lane sets, truncated to n_out, every output element written once.
//
// Replaces the TPU kernels audio_decoder_tpu/ops/window_add.py window_add
// (body _kernel, K3) and window_add2 (body _kernel2, K4).  The plain torch
// twins are ops/window_add.window_add_plain and window_add2_plain.  FLAC
// assembles its values (K4: int32 rice lanes [65536, 256] + fixed-width
// lanes [4096, 8] at the 16-file main path) and its PCM (K3: f32 frames
// [2048, 8192]) with them.
//
// Contract (the caller's, as for the TPU kernel): starts are non-decreasing
// over the live lanes; padding lanes carry zero updates and may sit at the
// tail with start 0.  Every start is re-pointed through a running maximum
// first (window_add_runmax), so the starts the other kernels see are sorted
// and the lanes that touch any output range form one contiguous run, found
// by binary search.
//
// What bounds it: bytes.  Each update is read once and each output written
// once (K4 at the main path: ~67 MB in, ~67 MB out; ~40 us at 3.35 TB/s).
// Design:
//   * window_add_runmax: the running maximum of each set's starts, one block
//     per chunk of starts.
//   * window_add_plan: one thread per output tile of kTile elements finds
//     the tile's lane run of each set by binary search on the sorted starts
//     and splits it into units of about kUnitWork lane-elements.
//   * window_add_main: one block per unit.  The units of heavy tiles come
//     first in the grid, so they start early instead of trailing, mapped
//     back to their tile through an exclusive scan of the tiles' unit
//     counts; block heavy_blocks + t takes tile t if it has one unit.
//     Thread k of
//     a block owns the tile elements e with e % kThreads == k and keeps
//     their sums in shared memory; it walks the unit's lanes in lane order
//     (set a, then set b; their starts staged in shared memory) and adds the
//     part of each lane that falls on its elements, so neighbouring threads
//     read neighbouring updates and no two threads touch one element.  A
//     lane at most kThreads wide gives each thread at most one element, so
//     such lanes go kBatch at a time, their loads in flight together.
//   * A tile with more work than one unit (the FLAC packers' padding lanes
//     all land on the last live start: ~10,400 lanes on one 256-wide window
//     in K4 and ~320 frames on one 8192-wide window in K3 at the main path)
//     is spread over several blocks, so it does not become a serial tail.
//     Each writes the range of its partial tile that its lanes cover to
//     scratch; the last one to finish (an atomic counter per tile) adds the
//     partials in unit order and writes the tile once.  No zero-fill pass: a
//     tile with no lanes writes its zeros directly.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 4096;             // output elements per tile
constexpr int kThreads = 256;
constexpr long long kUnitWork = 65536;  // lane-elements one block adds
constexpr int kBatch = 8;               // narrow rows whose loads go together
constexpr int kStage = 1024;            // lane starts staged at a time
constexpr int kScanThreads = 1024;
constexpr int kScanPer = 16;            // starts per scan thread
constexpr int kScanChunk = kScanThreads * kScanPer;

__device__ __forceinline__ int lower_bound(const int* __restrict__ s, int n,
                                           long long v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)s[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Units of a tile whose lane runs are r = (lo_a, hi_a, lo_b, hi_b): its
// work is counted as lanes times min(W, kTile) elements.
__device__ __forceinline__ int tile_units(int4 r, int Wa, int Wb) {
  const int na = r.y - r.x, nb = r.w - r.z;
  const long long work = (long long)na * min(Wa, kTile) +
                         (long long)nb * min(Wb, kTile);
  long long u = (work + kUnitWork - 1) / kUnitWork;
  u = min(u, (long long)max(na + nb, 1));
  return (int)max(u, 1LL);
}

// The lanes of unit c of a tile: a[a0, a1) then b[b0, b1).
struct Unit {
  int a0, a1, b0, b1;
};

__device__ __forceinline__ Unit unit_lanes(int4 r, int units, int c) {
  const int na = r.y - r.x, n = na + (r.w - r.z);
  const int per = (n + units - 1) / units;
  const int g0 = min(c * per, n), g1 = min(g0 + per, n);
  return {r.x + min(g0, na), r.x + min(g1, na), r.z + max(g0 - na, 0),
          r.z + max(g1 - na, 0)};
}

// Load through L2 (kCg: values another block wrote during this launch).
template <bool kCg, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kCg) return __ldcg(p); else return *p;
}

// Adds rows [0, n) in order into this thread's elements of the tile that
// starts at t0 (acc: the tile, in shared memory).  Row j covers elements
// [start(j), start(j) + width(j)); its value at element x is
// base(j)[x - start(j)].  `narrow`: every row is at most kThreads wide.
template <bool kCg, typename T, typename Rows>
__device__ void add_rows(T* acc, long long t0, int n, const Rows& rows,
                         bool narrow) {
  const int tid = threadIdx.x;
  const long long t1 = t0 + kTile;
  if (narrow) {
    // at most one element of each row is this thread's, so a batch of
    // rows issues its loads together (rows are the same for every thread)
    for (int j = 0; j < n; j += kBatch) {
      int el[kBatch];
      T v[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        el[i] = -1;
        v[i] = T(0);
        if (j + i < n) {
          const long long s = rows.start(j + i);
          const long long lo = max(s, t0), hi = min(s + rows.width(j + i), t1);
          const int off = (int)(lo - t0);
          const int e = off + ((tid - off) & (kThreads - 1));
          if (lo < hi && t0 + e < hi) {
            el[i] = e;
            v[i] = load<kCg>(rows.base(j + i) + (t0 + e - s));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (el[i] >= 0) acc[el[i]] += v[i];
      }
    }
    return;
  }
  for (int j = 0; j < n; ++j) {
    const long long s = rows.start(j);
    const long long lo = max(s, t0), hi = min(s + rows.width(j), t1);
    if (lo >= hi) continue;
    const int off = (int)(lo - t0), end = (int)(hi - t0);
    const T* src = rows.base(j) + (t0 - s);  // src[e]: the value at t0 + e
#pragma unroll 8
    for (int e = off + ((tid - off) & (kThreads - 1)); e < end; e += kThreads) {
      acc[e] += load<kCg>(src + e);
    }
  }
}

template <typename T>
struct LaneRows {  // lanes lane0 + j of a set; starts staged in shared memory
  const int* st;
  const T* __restrict__ upd;
  long long lane0;
  int W;
  __device__ long long start(int j) const { return st[j]; }
  __device__ long long width(int) const { return W; }
  __device__ const T* base(int j) const { return upd + (lane0 + j) * W; }
};

template <typename T>
struct PartRows {  // partial tiles of a heavy tile, over their ranges
  const int2* __restrict__ range;  // tile-relative [x, y) per unit
  const T* parts;
  long long t0;
  __device__ long long start(int k) const { return t0 + __ldcg(&range[k].x); }
  __device__ long long width(int k) const {
    const int2 r = __ldcg(&range[k]);
    return r.y - r.x;
  }
  __device__ const T* base(int k) const {
    return parts + (long long)k * kTile + __ldcg(&range[k].x);
  }
};

// Adds lanes [l0, l1) of one set, staging their starts in shared memory.
template <typename T>
__device__ void add_lanes(T* acc, int* s_st, long long t0,
                          const int* __restrict__ st,
                          const T* __restrict__ upd, int W, int l0, int l1) {
  for (int c0 = l0; c0 < l1; c0 += kStage) {
    const int n = min(kStage, l1 - c0);
    __syncthreads();  // the previous chunk's starts are no longer read
    for (int i = threadIdx.x; i < n; i += kThreads) s_st[i] = st[c0 + i];
    __syncthreads();
    add_rows<false>(acc, t0, n, LaneRows<T>{s_st, upd, c0, W}, W <= kThreads);
  }
}

// m = running maximum of s.  Blocks [0, a_blocks) scan set a, the rest set
// b, one chunk of kScanChunk starts each; a block first takes the maximum of
// every start before its chunk (reading them all keeps the blocks
// independent: one launch, no pass over chunk totals).
__global__ void __launch_bounds__(kScanThreads) window_add_runmax(
    const int* __restrict__ sa, int La, int* __restrict__ ma,
    const int* __restrict__ sb, int Lb, int* __restrict__ mb, int a_blocks) {
  const bool in_a = (int)blockIdx.x < a_blocks;
  const int* s = in_a ? sa : sb;
  int* m = in_a ? ma : mb;
  const int L = in_a ? La : Lb;
  const int base = (in_a ? blockIdx.x : blockIdx.x - a_blocks) * kScanChunk;
  __shared__ int warp_max[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  int pre = INT_MIN;
  for (int i = threadIdx.x; i < base; i += kScanThreads) pre = max(pre, s[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    pre = max(pre, __shfl_xor_sync(0xffffffffu, pre, off));
  }
  if (lane == 0) warp_max[warp] = pre;
  __syncthreads();
  int carry = warp_max[lane];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    carry = max(carry, __shfl_xor_sync(0xffffffffu, carry, off));
  }
  __syncthreads();  // every warp has read warp_max

  const int i0 = base + threadIdx.x * kScanPer;
  int v[kScanPer];
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) v[k] = i0 + k < L ? s[i0 + k] : INT_MIN;
  int run = INT_MIN;
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) v[k] = run = max(run, v[k]);
  int x = run;  // inclusive scan of the thread maxima within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x = max(x, y);
  }
  const int before = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 31) warp_max[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_max[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w = max(w, y);
    }
    warp_max[lane] = w;
  }
  __syncthreads();
  int prefix = carry;
  if (warp > 0) prefix = max(prefix, warp_max[warp - 1]);
  if (lane > 0) prefix = max(prefix, before);
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) {
    if (i0 + k < L) m[i0 + k] = max(prefix, v[k]);
  }
}

// ranges[t] = (lo_a, hi_a, lo_b, hi_b); counts[t+1] = the units of tile t
// if it has more than one (its blocks and scratch slots), counts[0] = 0, so
// an inclusive scan gives the exclusive offsets; counters[t] = 0.
__global__ void window_add_plan(const int* __restrict__ sa, int La, int Wa,
                                const int* __restrict__ sb, int Lb, int Wb,
                                int nt, int4* __restrict__ ranges,
                                int* __restrict__ counts,
                                unsigned* __restrict__ counters) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t == 0) counts[0] = 0;
  if (t >= nt) return;
  const long long t0 = (long long)t * kTile, t1 = t0 + kTile;
  int4 r = make_int4(0, 0, 0, 0);
  if (La > 0 && Wa > 0) {
    r.x = lower_bound(sa, La, t0 - Wa + 1);
    r.y = lower_bound(sa, La, t1);
  }
  if (Lb > 0 && Wb > 0) {
    r.z = lower_bound(sb, Lb, t0 - Wb + 1);
    r.w = lower_bound(sb, Lb, t1);
  }
  ranges[t] = r;
  const int u = tile_units(r, Wa, Wb);
  counts[t + 1] = u > 1 ? u : 0;
  counters[t] = 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4) window_add_main(
    const int* __restrict__ sa, const T* __restrict__ ua, int Wa,
    const int* __restrict__ sb, const T* __restrict__ ub, int Wb,
    const int4* __restrict__ ranges, const int* __restrict__ slot_off, int nt,
    int heavy_blocks, long long n_out, T* __restrict__ out,
    T* __restrict__ scratch, int2* __restrict__ part_range,
    unsigned* __restrict__ counters) {
  __shared__ T acc[kTile];
  __shared__ int s_st[kStage];
  __shared__ int s_tile, s_unit, s_last;

  // slot_off [nt + 1]: exclusive offsets of the heavy tiles' units
  if (threadIdx.x == 0) {
    const int b = blockIdx.x;
    int t = b - heavy_blocks, c = 0;
    if (b < heavy_blocks) {
      if (b >= slot_off[nt]) {
        t = -1;  // spare block of the grid's upper bound
      } else {
        // the last tile whose units start at or before b
        int lo = 0, hi = nt;
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (slot_off[mid] <= b) lo = mid; else hi = mid;
        }
        t = lo;
        c = b - slot_off[t];
      }
    } else if (slot_off[t + 1] > slot_off[t]) {
      t = -1;  // a heavy tile: its units ran in the first part of the grid
    }
    s_tile = t;
    s_unit = c;
  }
  __syncthreads();
  const int t = s_tile, c = s_unit;
  if (t < 0) return;

  // every thread touches only its own elements of acc: no barrier needed
  for (int e = threadIdx.x; e < kTile; e += kThreads) acc[e] = T(0);
  const int4 r = ranges[t];
  const int units = tile_units(r, Wa, Wb);
  const Unit u = unit_lanes(r, units, c);
  const long long t0 = (long long)t * kTile;
  add_lanes(acc, s_st, t0, sa, ua, Wa, u.a0, u.a1);
  add_lanes(acc, s_st, t0, sb, ub, Wb, u.b0, u.b1);

  if (units == 1) {
    for (int e = threadIdx.x; e < kTile && t0 + e < n_out; e += kThreads) {
      out[t0 + e] = acc[e];
    }
    return;
  }

  // heavy tile: write the partial over the range the unit's lanes cover;
  // the last of the tile's units to finish adds the partials in unit order
  // and writes the tile
  long long lo = t0 + kTile, hi = t0;
  if (u.a1 > u.a0) {
    lo = min(lo, (long long)sa[u.a0]);
    hi = max(hi, (long long)sa[u.a1 - 1] + Wa);
  }
  if (u.b1 > u.b0) {
    lo = min(lo, (long long)sb[u.b0]);
    hi = max(hi, (long long)sb[u.b1 - 1] + Wb);
  }
  const int x0 = (int)(max(lo, t0) - t0), x1 = (int)(min(hi, t0 + kTile) - t0);
  T* parts = scratch + (long long)slot_off[t] * kTile;
  int2* ranges_t = part_range + slot_off[t];
  for (int e = x0 + ((threadIdx.x - x0) & (kThreads - 1)); e < x1; e += kThreads) {
    parts[(long long)c * kTile + e] = acc[e];
  }
  if (threadIdx.x == 0) ranges_t[c] = make_int2(x0, max(x0, x1));
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(&counters[t], 1u) == (unsigned)(units - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int e = threadIdx.x; e < kTile; e += kThreads) acc[e] = T(0);
  const PartRows<T> partials{ranges_t, parts, t0};
  int narrow = 1;
  for (int k = threadIdx.x; k < units; k += kThreads) {
    narrow &= partials.width(k) <= kThreads;
  }
  add_rows<true>(acc, t0, units, partials, __syncthreads_and(narrow) != 0);
  for (int e = threadIdx.x; e < kTile && t0 + e < n_out; e += kThreads) {
    out[t0 + e] = acc[e];
  }
}

template <typename T>
int launch_main(const void* sa, const void* ua, int Wa, const void* sb,
                const void* ub, int Wb, const void* ranges,
                const void* slot_off, int nt, long long n_out,
                int heavy_blocks, void* out, void* scratch, void* part_range,
                void* counters, void* stream) {
  const long long blocks = (long long)nt + heavy_blocks;
  if (nt > 0) {
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    window_add_main<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)sa, (const T*)ua, Wa, (const int*)sb, (const T*)ub, Wb,
        (const int4*)ranges, (const int*)slot_off, nt, heavy_blocks, n_out,
        (T*)out, (T*)scratch, (int2*)part_range, (unsigned*)counters);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int window_add_tile() { return kTile; }
extern "C" long long window_add_unit_work() { return kUnitWork; }

// Running maximum of both sets' starts into sorted_a / sorted_b, then the
// plan over them.
extern "C" int window_add_plan_launch(const void* sa, int La, int Wa,
                                      const void* sb, int Lb, int Wb, int nt,
                                      void* sorted_a, void* sorted_b,
                                      void* ranges, void* counts,
                                      void* counters, void* stream) {
  const int a_blocks = (La + kScanChunk - 1) / kScanChunk;
  const int b_blocks = (Lb + kScanChunk - 1) / kScanChunk;
  if (a_blocks + b_blocks > 0) {
    window_add_runmax<<<a_blocks + b_blocks, kScanThreads, 0,
                        (cudaStream_t)stream>>>(
        (const int*)sa, La, (int*)sorted_a, (const int*)sb, Lb, (int*)sorted_b,
        a_blocks);
  }
  if (nt > 0) {
    window_add_plan<<<(nt + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(
        (const int*)sorted_a, La, Wa, (const int*)sorted_b, Lb, Wb, nt,
        (int4*)ranges, (int*)counts, (unsigned*)counters);
  }
  return (int)cudaGetLastError();
}

extern "C" int window_add_i32(const void* sa, const void* ua, int Wa,
                              const void* sb, const void* ub, int Wb,
                              const void* ranges, const void* slot_off, int nt,
                              long long n_out, int heavy_blocks, void* out,
                              void* scratch, void* part_range, void* counters,
                              void* stream) {
  return launch_main<int32_t>(sa, ua, Wa, sb, ub, Wb, ranges, slot_off, nt,
                              n_out, heavy_blocks, out, scratch, part_range,
                              counters, stream);
}

extern "C" int window_add_f32(const void* sa, const void* ua, int Wa,
                              const void* sb, const void* ub, int Wb,
                              const void* ranges, const void* slot_off, int nt,
                              long long n_out, int heavy_blocks, void* out,
                              void* scratch, void* part_range, void* counters,
                              void* stream) {
  return launch_main<float>(sa, ua, Wa, sb, ub, Wb, ranges, slot_off, nt,
                            n_out, heavy_blocks, out, scratch, part_range,
                            counters, stream);
}
