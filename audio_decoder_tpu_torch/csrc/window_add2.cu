// Contiguous-window scatter-add over two lane sets:
//   out[starts_a[l] + i] += upd_a[l, i];  out[starts_b[l] + i] += upd_b[l, i]
// truncated to n_out, every output element written once, int32 or float32.
//
// Replaces the TPU kernel audio_decoder_tpu/ops/window_add.py window_add2
// (body _kernel2, K4).  The plain torch twin is
// ops/window_add.window_add2_plain.  FLAC assembles its values with it:
// int32 rice lanes [65536, 256] + fixed-width lanes [4096, 8] into
// 16,781,568 outputs at the 16-file main path.
//
// Contract (the caller's, as for the TPU kernel): starts are non-decreasing
// over the live lanes; padding lanes carry zero updates and may sit at the
// tail with start 0.  Every start is re-pointed through a running maximum,
// so the starts the later kernels see are sorted and the lanes that touch
// an output range form one contiguous run, found by binary search.
//
// What bounds it: bytes.  Each update is read once and each output written
// once (~67 MB in, ~67 MB out at the main path; 40 us at 3.35 TB/s).  The
// design keeps many bytes in flight per SM and spreads the one heavy tile
// (the FLAC packers re-point ~10,400 zero rice lanes onto the last live
// start: 10.6 MB on one 256-wide window) over the whole card:
//   * window_add2_runmax: the running maximum of each chunk of run_chunk
//     starts, written in place of the sorted starts, and each chunk's
//     maximum.  Many independent blocks; the carry between chunks is left
//     to the plan.
//   * window_add2_plan: every block takes the prefix maximum of the chunk
//     maxima (the carries), applies them to the starts in place (a start
//     read before or after its fix gives the same maximum, so the race is
//     benign), and four threads per output tile of kTile elements find the
//     tile's lane run of each set by binary search (one search each) and
//     count its units of about kUnitWork lane-elements, a lane counting at
//     least kRowWork.  A tile of more than one unit (heavy)
//     takes a contiguous range of unit slots with one atomicAdd, maps its
//     slots back to itself and zeroes its counters.
//   * window_add2_main: blocks [0, heavy_blocks) walk the heavy units
//     (unit i, i + heavy_blocks, ...), so the pile-ups start first, spread
//     over up to two waves; block heavy_blocks + t takes tile t if it is
//     light.  Three blocks per SM (68.7 KB of shared memory each, with the
//     largest carveout).  A block stages its lanes' rows and starts in
//     shared memory with cp.async, in chunks of up to kStageBytes on a ring
//     of kStages buffers, so every row of a light tile is in flight at once
//     and a heavy unit keeps two chunks in flight while it adds a third.  Thread
//     k owns the tile elements e with e % kThreads == k and keeps their
//     sums in shared memory; it adds the rows in lane order (set a, then
//     set b), so no two threads touch one element and float32 sums run in
//     one fixed order.  Rows are copied 16 bytes at a time when a row and
//     the update array are 16-byte aligned, else 4 bytes at a time; a row
//     wider than a tile is cut to the tile first.
//   * A heavy tile's units write their partial tiles (over the range their
//     lanes cover) to scratch.  The last unit of each group of kGroup units
//     to finish (an atomic counter per group) adds the group's partials in
//     unit order; the last group of the tile adds the groups' sums in group
//     order and writes the tile.  Each level stages its partials with
//     cp.async, kSlice elements of all of them at once.
// No zero-fill pass: a tile with no lanes writes its zeros directly.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 4096;               // output elements per tile
constexpr int kThreads = 256;
constexpr long long kUnitWork = 16384;    // lane-elements one block adds
constexpr int kRowWork = kThreads;        // the least a row costs a block
constexpr int kStages = 3;                // staging ring depth
constexpr int kStageElems = kTile + 8;    // a cut row of a wide lane fits
constexpr int kStageBytes = kStageElems * 4;
constexpr int kMaxRows = 256;             // rows of one staged chunk
constexpr int kGroup = 16;                // partials added per combine step
constexpr int kSlice = kStages * kStageElems / kGroup / 4 * 4;  // 768
constexpr int kRunChunk = 2048;           // starts per running-max step
constexpr int kMaxChunks = 4096;          // chunk maxima the plan scans
constexpr int kHeavyBlocks = 264;         // blocks that walk heavy units
constexpr int kSmemBytes = kTile * 4 + kStages * kStageBytes +
                           kStages * kMaxRows * 4 + kStages * 4;

#ifndef CUDA_CPU_SHIM
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
#endif

// Units of a tile whose lane runs are r = (lo_a, hi_a, lo_b, hi_b): its
// work is counted as lanes times min(W, kTile) elements, and at least
// kRowWork per lane, since every thread of a block steps through every
// row (a pile-up of narrow rows is spread like one of wide rows).
__device__ __forceinline__ int tile_units(int4 r, int Wa, int Wb) {
  const int na = r.y - r.x, nb = r.w - r.z;
  const long long work = (long long)na * max(min(Wa, kTile), kRowWork) +
                         (long long)nb * max(min(Wb, kTile), kRowWork);
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

// Elements of one row's slot in a staging buffer: the whole row, or for a
// row wider than a tile, its cut to the tile widened to 16-byte chunks.
__device__ __forceinline__ int slot_elems(int W) {
  return W > kTile ? kStageElems : (W + 3) & ~3;
}

__device__ __forceinline__ int chunk_rows(int W) {
  return W > 0 ? min(kMaxRows, kStageElems / slot_elems(W)) : 1;
}

template <typename T>
struct Args {
  const int* sa;  // sorted starts of set a (then set b at sa + La)
  const T* ua;
  int La, Wa;
  const int* sb;
  const T* ub;
  int Lb, Wb;
  long long n_out;
  int nt;
  T* out;
  const int4* ranges;
  const int* tile_off;
  unsigned* tcnt;
  const int* heavy_total;
  const int* unit_tile;
  unsigned* gcnt;
  int2* part_range;
  T* scratch;
  int heavy, heavy_blocks;
};

// One lane set's part of a unit: lanes [l0, l1) in chunks of `rows`.
template <typename T>
struct Lanes {
  const int* st;
  const T* upd;
  int W, l0, l1, rows;
  bool wide, vec;  // rows cut to the tile; 16-byte copies
  __device__ int chunks() const {
    return l1 > l0 && W > 0 ? (l1 - l0 + rows - 1) / rows : 0;
  }
};

template <typename T>
__device__ Lanes<T> lanes_of(const int* st, const T* upd, int W, int l0,
                             int l1) {
  Lanes<T> s{st, upd, W, l0, l1, chunk_rows(W), W > kTile,
             (W & 3) == 0 && ((uintptr_t)upd & 15) == 0};
  return s;
}

// Issues the copies of rows [j0, j0 + n) of a set into one staging buffer
// (rows at buf + j * slot_elems(W), starts at st_buf, for a cut row the
// row element its slot begins at in *org).
template <typename T>
__device__ void issue_rows(const Lanes<T>& s, int j0, int n, long long t0,
                           T* buf, int* st_buf, int* org) {
  const int tid = threadIdx.x;
  for (int i = tid; i < n; i += kThreads) cp_async4(st_buf + i, s.st + j0 + i);
  if (s.wide) {  // one row per chunk; cut it to the tile
    const long long st = s.st[j0];
    const int a = (int)min(max(t0 - st, 0LL), (long long)s.W);
    const int b = (int)min(max(t0 + kTile - st, 0LL), (long long)s.W);
    const T* row = s.upd + (long long)j0 * s.W;
    if (s.vec) {
      const int a4 = a & ~3;
      for (int q = a4 + 4 * tid; q < b; q += 4 * kThreads) {
        cp_async16(buf + (q - a4), row + q);
      }
      if (tid == 0) *org = a4;
    } else {
      for (int q = a + tid; q < b; q += kThreads) cp_async4(buf + (q - a), row + q);
      if (tid == 0) *org = a;
    }
    return;
  }
  const int slot = slot_elems(s.W);
  const T* rows = s.upd + (long long)j0 * s.W;
  if (s.vec) {
    const int cpr = s.W >> 2;  // 16-byte chunks per row
    for (int q = tid; q < n * cpr; q += kThreads) {
      const int j = q / cpr, m = q - j * cpr;
      cp_async16(buf + j * slot + 4 * m, rows + (long long)j * s.W + 4 * m);
    }
  } else {
    for (int q = tid; q < n * s.W; q += kThreads) {
      const int j = q / s.W, e = q - j * s.W;
      cp_async4(buf + j * slot + e, rows + (long long)j * s.W + e);
    }
  }
  if (tid == 0) *org = 0;
}

// Adds n staged rows, in order, into this thread's elements of the tile
// that starts at t0.
template <typename T>
__device__ void add_rows(T* acc, const Lanes<T>& s, int n, long long t0,
                         const T* buf, const int* st_buf, int org) {
  const int tid = threadIdx.x;
  const int slot = slot_elems(s.W);
  for (int j = 0; j < n; ++j) {
    const long long st = st_buf[j];
    const long long lo = max(st, t0), hi = min(st + s.W, t0 + kTile);
    if (lo >= hi) continue;
    const int off = (int)(lo - t0), end = (int)(hi - t0);
    const T* row = buf + j * slot - org + (t0 - st);  // row[e]: element t0 + e
    for (int e = off + ((tid - off) & (kThreads - 1)); e < end; e += kThreads) {
      acc[e] += row[e];
    }
  }
}

// Adds a unit's lanes (set a, then set b) into acc through the staging
// ring: chunk c goes to buffer c % kStages, kStages - 1 chunks ahead of the
// one being added.
template <typename T>
__device__ void add_unit(T* acc, T* stage, int* st_ring, int* org,
                         const Lanes<T>& A, const Lanes<T>& B, long long t0) {
  const int na = A.chunks(), n = na + B.chunks();
  auto issue = [&](int c) {
    const int k = c % kStages;
    T* buf = stage + k * kStageElems;
    if (c < na) {
      const int j0 = A.l0 + c * A.rows;
      issue_rows(A, j0, min(A.rows, A.l1 - j0), t0, buf, st_ring + k * kMaxRows,
                 org + k);
    } else {
      const int j0 = B.l0 + (c - na) * B.rows;
      issue_rows(B, j0, min(B.rows, B.l1 - j0), t0, buf, st_ring + k * kMaxRows,
                 org + k);
    }
  };
  __syncthreads();  // the ring is free
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n) issue(c);
    cp_async_commit();
  }
  for (int c = 0; c < n; ++c) {
    if (c + kStages - 1 < n) issue(c + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int k = c % kStages;
    const T* buf = stage + k * kStageElems;
    if (c < na) {
      const int j0 = A.l0 + c * A.rows;
      add_rows(acc, A, min(A.rows, A.l1 - j0), t0, buf, st_ring + k * kMaxRows,
               org[k]);
    } else {
      const int j0 = B.l0 + (c - na) * B.rows;
      add_rows(acc, B, min(B.rows, B.l1 - j0), t0, buf, st_ring + k * kMaxRows,
               org[k]);
    }
    __syncthreads();  // buffer k is free again
  }
}

// acc[e] += partial k over its range, for the `count` partials at slots
// slot0 + k * stride (k in order), kGroup of them staged at a time.
// Returns the union of their ranges as [x0, x1).
template <typename T>
__device__ int2 add_partials(T* acc, T* stage, int2* s_rng, const T* scratch,
                             const int2* part_range, int slot0, int stride,
                             int count) {
  const int tid = threadIdx.x;
  int2 all = make_int2(kTile, 0);
  for (int k0 = 0; k0 < count; k0 += kGroup) {
    const int n = min(kGroup, count - k0);
    __syncthreads();  // s_rng and the stage are free
    if (tid < n) s_rng[tid] = __ldcg(&part_range[slot0 + (k0 + tid) * stride]);
    __syncthreads();
    int x0 = kTile, x1 = 0;
    for (int k = 0; k < n; ++k) {
      const int2 r = s_rng[k];
      if (r.y > r.x) {
        x0 = min(x0, r.x);
        x1 = max(x1, r.y);
      }
    }
    all = make_int2(min(all.x, x0), max(all.y, x1));
    for (int lo = x0 & ~3; lo < x1; lo += kSlice) {
      const int hi = min(lo + kSlice, x1);
      for (int k = 0; k < n; ++k) {
        const int2 r = s_rng[k];
        const int a = max(lo, r.x) & ~3, b = min(hi, r.y);
        const T* part = scratch + (long long)(slot0 + (k0 + k) * stride) * kTile;
        for (int q = a + 4 * tid; q < b; q += 4 * kThreads) {
          cp_async16(stage + k * kSlice + (q - lo), part + q);
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int e = lo + ((tid - lo) & (kThreads - 1)); e < hi; e += kThreads) {
        T v = acc[e];
        for (int k = 0; k < n; ++k) {
          const int2 r = s_rng[k];
          if (r.x <= e && e < r.y) v += stage[k * kSlice + (e - lo)];
        }
        acc[e] = v;
      }
      __syncthreads();  // the stage is free
    }
  }
  if (all.y < all.x) all = make_int2(0, 0);
  return all;
}

template <typename T>
__device__ void write_tile(const Args<T>& p, const T* acc, long long t0) {
  for (int e = threadIdx.x; e < kTile && t0 + e < p.n_out; e += kThreads) {
    p.out[t0 + e] = acc[e];
  }
}

// Unit c of tile t (off: the tile's first unit slot, -1 for a light tile).
template <typename T>
__device__ void run_unit(const Args<T>& p, unsigned char* smem, int t, int c,
                         int off) {
  T* acc = reinterpret_cast<T*>(smem);
  T* stage = reinterpret_cast<T*>(smem + kTile * 4);
  int* st_ring = reinterpret_cast<int*>(smem + kTile * 4 + kStages * kStageBytes);
  int* org = st_ring + kStages * kMaxRows;
  __shared__ int2 s_rng[kGroup];
  __shared__ int s_last;
  const int tid = threadIdx.x;

  const int4 r = p.ranges[t];
  const int units = off < 0 ? 1 : tile_units(r, p.Wa, p.Wb);
  const Unit u = unit_lanes(r, units, c);
  const long long t0 = (long long)t * kTile;
  // every thread touches only its own elements of acc: no barrier needed
  for (int e = tid; e < kTile; e += kThreads) acc[e] = T(0);
  add_unit(acc, stage, st_ring, org, lanes_of(p.sa, p.ua, p.Wa, u.a0, u.a1),
           lanes_of(p.sb, p.ub, p.Wb, u.b0, u.b1), t0);
  if (units == 1) {
    write_tile(p, acc, t0);
    return;
  }

  // heavy tile: this unit's partial over the range its lanes cover
  long long lo = t0 + kTile, hi = t0;
  if (u.a1 > u.a0) {
    lo = min(lo, (long long)p.sa[u.a0]);
    hi = max(hi, (long long)p.sa[u.a1 - 1] + p.Wa);
  }
  if (u.b1 > u.b0) {
    lo = min(lo, (long long)p.sb[u.b0]);
    hi = max(hi, (long long)p.sb[u.b1 - 1] + p.Wb);
  }
  const int x0 = (int)(max(lo, t0) - t0);
  const int x1 = max(x0, (int)(min(hi, t0 + kTile) - t0));
  T* part = p.scratch + (long long)(off + c) * kTile;
  for (int e = x0 + ((tid - x0) & (kThreads - 1)); e < x1; e += kThreads) {
    part[e] = acc[e];
  }
  if (tid == 0) p.part_range[off + c] = make_int2(x0, x1);
  __threadfence();
  __syncthreads();
  const int g = c / kGroup, groups = (units + kGroup - 1) / kGroup;
  const int in_group = min(kGroup, units - g * kGroup);
  if (tid == 0) {
    s_last = atomicAdd(&p.gcnt[off + g * kGroup], 1u) == (unsigned)(in_group - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // level 1: the group's partials in unit order
  for (int e = tid; e < kTile; e += kThreads) acc[e] = T(0);
  const int2 span = add_partials(acc, stage, s_rng, p.scratch, p.part_range,
                                 off + g * kGroup, 1, in_group);
  if (groups == 1) {
    __syncthreads();
    write_tile(p, acc, t0);
    return;
  }
  T* gpart = p.scratch + (long long)(off + g * kGroup) * kTile;
  for (int e = span.x + ((tid - span.x) & (kThreads - 1)); e < span.y;
       e += kThreads) {
    gpart[e] = acc[e];
  }
  if (tid == 0) p.part_range[off + g * kGroup] = span;
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&p.tcnt[t], 1u) == (unsigned)(groups - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // level 2: the groups' sums in group order
  for (int e = tid; e < kTile; e += kThreads) acc[e] = T(0);
  add_partials(acc, stage, s_rng, p.scratch, p.part_range, off, kGroup, groups);
  __syncthreads();
  write_tile(p, acc, t0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3) window_add2_main(const Args<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  if (b < p.heavy_blocks) {
    const int total = min(*p.heavy_total, p.heavy);
    for (int i = b; i < total; i += p.heavy_blocks) {
      const int t = p.unit_tile[i];
      const int off = p.tile_off[t];
      run_unit(p, smem, t, i - off, off);
    }
    return;
  }
  const int t = b - p.heavy_blocks;
  if (p.tile_off[t] >= 0) return;  // heavy: its units ran above
  run_unit(p, smem, t, 0, -1);
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

// sorted[i] = the running maximum of s within its chunk of `chunk` starts;
// cmax[k] = chunk k's maximum.  Blocks [0, ca) take set a, the rest set b.
__global__ void __launch_bounds__(kThreads) window_add2_runmax(
    const int* __restrict__ sa, int La, const int* __restrict__ sb, int Lb,
    int chunk, int ca, int* __restrict__ sorted, int* __restrict__ cmax,
    int* __restrict__ heavy_total) {
  constexpr int kPer = kRunChunk / kThreads;
  __shared__ int warp_max[kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (blockIdx.x == 0 && tid == 0) *heavy_total = 0;
  const bool in_a = (int)blockIdx.x < ca;
  const int* s = in_a ? sa : sb;
  const int L = in_a ? La : Lb;
  int* m = in_a ? sorted : sorted + La;
  const long long base = (long long)(in_a ? blockIdx.x : blockIdx.x - ca) * chunk;
  if (base >= L) return;
  const long long end = min(base + chunk, (long long)L);
  int carry = INT_MIN;
  for (long long sub = base; sub < end; sub += kRunChunk) {
    const long long i0 = sub + (long long)tid * kPer;
    int v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[k] = i0 + k < end ? s[i0 + k] : INT_MIN;
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
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) prefix = max(prefix, warp_max[w]);
      all = max(all, warp_max[w]);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (i0 + k < end) m[i0 + k] = max(prefix, v[k]);
    }
    carry = all;
    __syncthreads();  // warp_max is read
  }
  if (tid == 0) cmax[blockIdx.x] = carry;
}

// Lower bound of v among the starts max(s[i], carry[i >> log_chunk]),
// i in [0, n).
__device__ __forceinline__ int lower_bound(const int* s, const int* carry,
                                           int log_chunk, int n, long long v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)max(s[mid], carry[mid >> log_chunk]) < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Four threads per tile t, one binary search each (lo_a, hi_a, lo_b,
// hi_b), gathered by shuffles into ranges[t]; the first of the four counts
// the tile's units and, for a heavy tile, takes its unit slots.
__global__ void __launch_bounds__(kThreads) window_add2_plan(
    int* sorted, int La, int Wa, int Lb, int Wb, const int* __restrict__ cmax,
    int log_chunk, int ca, int cb, int nt, int4* __restrict__ ranges,
    int* __restrict__ tile_off, unsigned* __restrict__ tcnt,
    int* __restrict__ heavy_total, int* __restrict__ unit_tile,
    unsigned* __restrict__ gcnt, int heavy) {
  __shared__ int carry[kMaxChunks];
  for (int k = threadIdx.x; k < ca + cb; k += kThreads) carry[k] = cmax[k];
  exclusive_max(carry, ca);
  exclusive_max(carry + ca, cb);

  // the carries into the starts, in place
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = g; i < (long long)La + Lb; i += stride) {
    const int c = i < La ? carry[i >> log_chunk] : carry[ca + ((i - La) >> log_chunk)];
    if (c > sorted[i]) sorted[i] = c;
  }

  const int t = (int)min(g >> 2, (long long)nt), q = (int)(g & 3);
  const bool in_a = q < 2;
  const int W = in_a ? Wa : Wb, n = W > 0 ? (in_a ? La : Lb) : 0;
  const long long t0 = (long long)t * kTile;
  int b = 0;
  if (t < nt && n > 0) {
    b = lower_bound(in_a ? sorted : sorted + La, in_a ? carry : carry + ca,
                    log_chunk, n, (q & 1) ? t0 + kTile : t0 - W + 1);
  }
  const int lane0 = threadIdx.x & 28;
  const int4 r = make_int4(__shfl_sync(0xffffffffu, b, lane0),
                           __shfl_sync(0xffffffffu, b, lane0 + 1),
                           __shfl_sync(0xffffffffu, b, lane0 + 2),
                           __shfl_sync(0xffffffffu, b, lane0 + 3));
  if (t >= nt || q != 0) return;
  ranges[t] = r;
  const int units = tile_units(r, Wa, Wb);
  if (units == 1) {
    tile_off[t] = -1;
    return;
  }
  const int off = atomicAdd(heavy_total, units);
  if (off + units > heavy) __trap();  // the host's bound is wrong
  tile_off[t] = off;
  tcnt[t] = 0;
  for (int c = 0; c < units; ++c) unit_tile[off + c] = t;
  for (int c = 0; c < units; c += kGroup) gcnt[off + c] = 0;
}

// Sets window_add2_main<T>'s shared memory (once per process): its dynamic
// size and the largest carveout, so three blocks fit on an SM.
template <typename T>
cudaError_t prepare_main() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      window_add2_main<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(window_add2_main<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  }
  done = e == cudaSuccess;
  return e;
}

template <typename T>
int launch(const void* sa, int La, const void* ua, int Wa, const void* sb,
           int Lb, const void* ub, int Wb, long long n_out, void* out,
           void* const* ws, int run_chunk, int heavy, cudaStream_t stream) {
  int log_chunk = 0;
  while ((1LL << log_chunk) < run_chunk && log_chunk < 30) ++log_chunk;
  if (run_chunk < kRunChunk || (1 << log_chunk) != run_chunk || heavy < 0 ||
      La < 0 || Lb < 0 || Wa < 0 || Wb < 0 || n_out < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long nt = (n_out + kTile - 1) / kTile;
  const int ca = (int)(((long long)La + run_chunk - 1) / run_chunk);
  const int cb = (int)(((long long)Lb + run_chunk - 1) / run_chunk);
  if (ca + cb > kMaxChunks || nt + kHeavyBlocks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (nt == 0) return (int)cudaGetLastError();
  int* sorted = (int*)ws[0];
  int* cmax = (int*)ws[1];
  int* heavy_total = (int*)ws[5];
  window_add2_runmax<<<std::max(ca + cb, 1), kThreads, 0, stream>>>(
      (const int*)sa, La, (const int*)sb, Lb, run_chunk, ca, sorted, cmax,
      heavy_total);
  const long long fix_blocks = ((long long)La + Lb + 16 * kThreads - 1) / (16 * kThreads);
  const long long plan_blocks =
      std::max((4 * nt + kThreads - 1) / kThreads, std::max(fix_blocks, 1LL));
  window_add2_plan<<<(unsigned)plan_blocks, kThreads, 0, stream>>>(
      sorted, La, Wa, Lb, Wb, cmax, log_chunk, ca, cb, (int)nt, (int4*)ws[2],
      (int*)ws[3], (unsigned*)ws[4], heavy_total, (int*)ws[6],
      (unsigned*)ws[7], heavy);
  const cudaError_t e = prepare_main<T>();
  if (e != cudaSuccess) return (int)e;
  Args<T> p{sorted, (const T*)ua, La, Wa, sorted + La, (const T*)ub, Lb, Wb,
            n_out, (int)nt, (T*)out, (const int4*)ws[2], (const int*)ws[3],
            (unsigned*)ws[4], heavy_total, (const int*)ws[6], (unsigned*)ws[7],
            (int2*)ws[8], (T*)ws[9], heavy, std::min(heavy, kHeavyBlocks)};
  window_add2_main<T><<<(unsigned)(nt + p.heavy_blocks), kThreads, kSmemBytes,
                        stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int window_add2_tile() { return kTile; }
extern "C" long long window_add2_unit_work() { return kUnitWork; }

extern "C" int window_add2_blocks_per_sm() {
  int n = 0;
  cudaError_t e = prepare_main<int32_t>();
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, window_add2_main<int32_t>, kThreads, kSmemBytes);
  }
  return e == cudaSuccess ? n : -(int)e;
}

// Three launches on `stream`: the running maximum, the plan, the main
// kernel.  ws: the workspace's parts (sorted starts [La + Lb], chunk maxima,
// ranges [nt] int4, tile_off [nt], tcnt [nt], heavy_total [1], unit_tile
// [heavy], gcnt [heavy], part_range [heavy] int2, scratch [heavy, kTile]),
// each 16-byte aligned.  Returns a CUDA error code.
extern "C" int window_add2_launch(const void* sa, int La, const void* ua, int Wa,
                                  const void* sb, int Lb, const void* ub, int Wb,
                                  long long n_out, int is_f32, void* out,
                                  void* sorted, void* cmax, void* ranges,
                                  void* tile_off, void* tcnt, void* heavy_total,
                                  void* unit_tile, void* gcnt, void* part_range,
                                  void* scratch, int run_chunk, int heavy,
                                  void* stream) {
  void* const ws[10] = {sorted, cmax, ranges, tile_off, tcnt, heavy_total,
                        unit_tile, gcnt, part_range, scratch};
  if (is_f32) {
    return launch<float>(sa, La, ua, Wa, sb, Lb, ub, Wb, n_out, out, ws,
                         run_chunk, heavy, (cudaStream_t)stream);
  }
  return launch<int32_t>(sa, La, ua, Wa, sb, Lb, ub, Wb, n_out, out, ws,
                         run_chunk, heavy, (cudaStream_t)stream);
}
