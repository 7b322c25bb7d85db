// MPEG Layer III entropy scan (Huffman big-values + count1), one thread
// per granule-channel lane, one warp per block.
//
// Replaces the TPU kernel audio_decoder_tpu/codecs/mpeg/huffman_pallas.py
// (entropy_scan, body _kernel).  That kernel pre-gathers a 160-word slab
// per lane and extracts words by one-hot compares because Mosaic has no
// per-lane gather; none of that is needed here.  Semantics follow the JAX
// package's XLA scan (huffman_device.decode_spectra(impl="xla")) exactly,
// as does the plain torch twin huffman_device.scan_plain:
//   * pairs beyond 288 are decoded for their bits but not stored;
//   * big-values: a bad code, a reserved table or a cursor past end_bit
//     fails the lane; the failing pair is not stored;
//   * count1: a quad is decoded while the cursor is below end_bit and its
//     first line below 576; a quad that would read past limit_bit fails
//     the lane; one that straddles end_bit is dropped;
//   * at most n_quads = min(ceil(n_c1/32)*32, 144) quads (the wrapper
//     computes n_quads).
// Bytes at or past the end of a file row (or before its start) read as 0.
// Outputs are written in full (zeros past the decoded region), so the
// wrapper allocates them with torch.empty.
//
// What bounds it on Hopper: each lane's walk is bit-serial (a code's
// length decides where the next one starts), so a launch takes as long as
// its longest lane's chain of dependent steps, each step costing the
// latency of its dependent instructions.  The bytes bound (inputs read
// once, outputs written once) is out of reach for such a walk.  The main
// path gives 3k-18k lanes per launch, 1-5 warps per SM: far too few to
// hide latency by occupancy, and one warp per scheduler pays every
// dependent instruction's full latency, and every divergent branch of its
// 32 lanes in turn.  So the design shortens the step and keeps the lanes
// of a warp on one path:
//   1. Huffman table in shared memory, two levels (huffman_device.
//      _two_level_big_luts): a first level per table indexed by the top
//      min(width, 10) bits (10,248 entries) and second-level subtables for
//      the codes longer than 10 bits (1,192 entries): kTableEntries u16 =
//      22,880 bytes.  The flat LUT (677k entries, 1.35 MB, an L2 round
//      trip per pair) is left to the plain twin.  A code costs one
//      shared-memory load, two when it is longer than 10 bits.
//   2. Count1 quads by one lookup of the next 10 bits (huffman_device.
//      _count1_lut, 2 x 1024 u16 = 4 KB): length and signs at once.
//      Both tables are copied in with cp.async, all copies in flight at
//      once, beside the lanes' bits (3.).
//   3. Each lane's bits, from its start to 96 bits past its end, are
//      staged in shared memory with cp.async before the walk (up to 544
//      bytes a lane, 17 KB a warp; part2_3 is at most 4,095 bits), the
//      warp copying one lane's 16-byte chunks at a time.  A step then
//      reads its 32-bit window as two shared words and a funnel shift at
//      the cursor: no refill state.  A chunk not wholly inside the row is
//      assembled byte by byte (zeros outside), so any row width and
//      alignment work; a lane whose span outgrows its slot (never in a
//      valid stream) reads its windows from global memory.  The walk is
//      compiled for each case, so a step never branches on where its
//      bits are.
//   4. One warp per block (44.4 KB of shared memory, 5 blocks per SM):
//      the grid spreads a launch's warps evenly over the SMs.  Lanes
//      arrive sorted by descending big_values within a bucket
//      (decoder._plan_buckets), so a warp's lanes walk similar numbers of
//      steps; the kernel keeps that order.
//   5. One big-values loop for all three table regions, whose table
//      parameters change at the region bounds only; linbits escapes take
//      a separate path; pairs and quads are shifted into a 16-byte
//      register (4 pairs or 2 quads) and stored whole.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kL1Bits = 10;             // huffman_device.L1_BITS
constexpr int kLevel1Entries = 10248;   // first levels of the 15 big tables
constexpr int kTableEntries = 11440;    // + second-level subtables
constexpr int kSubFlag = 0x8000;        // huffman_device.SUB_FLAG
constexpr int kC1Entries = 2048;        // count1: 2 selects x 1024 windows
constexpr int kLaneChunks = 34;         // staged 16-byte chunks per lane
constexpr int kTailBits = 96;           // staged past end_bit
static_assert(kTableEntries % 8 == 0 && kC1Entries % 8 == 0,
              "tables load as 16-byte words");

__device__ __forceinline__ uint32_t be32(uint32_t w) {
  return __byte_perm(w, 0, 0x0123);  // memory order -> MSB-first bits
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// a table into shared memory, 16 bytes per copy, all in flight at once
__device__ __forceinline__ void copy16(uint16_t* dst, const uint16_t* src,
                                       int entries) {
  for (int e = threadIdx.x; e < entries / 8; e += kThreads) {
    cp_async16(dst + 8 * e, src + 8 * e);
  }
}

// the 32 bits at bit `pos` of a row (MSB first), bytes outside read as 0
__device__ __forceinline__ uint32_t peek32_global(const uint8_t* row,
                                                  int nbytes, int pos) {
  const int byte = pos >> 3;
  uint64_t v = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int b = byte + k;
    v = (v << 8) | ((b >= 0 && b < nbytes) ? (uint32_t)__ldg(row + b) : 0u);
  }
  return (uint32_t)(v >> (8 - (pos & 7)));
}

// A lane's bits: staged words (memory byte order) starting at row bit
// `base` (kStaged), or, for a lane that outgrew its slot, the row itself.
template <bool kStaged>
struct Bits {
  const uint32_t* words;
  int base;
  const uint8_t* row;
  int nbytes;

  __device__ __forceinline__ uint32_t window(int pos) const {
    if (!kStaged) return peek32_global(row, nbytes, pos);
    const int off = pos - base;
    const uint32_t* w = words + (off >> 5);
    return __funnelshift_l(be32(w[1]), be32(w[0]), off & 31);
  }
};

__device__ __forceinline__ uint32_t pack2(int x, int y) {
  return (uint32_t)(uint16_t)(int16_t)x | ((uint32_t)(uint16_t)(int16_t)y << 16);
}

// the int16 of value k of a count1 entry: 0, +1 or -1
__device__ __forceinline__ uint32_t c1val(int e, int k) {
  const int s = (e >> (2 * k)) & 3;
  return s == 1 ? 1u : (s == 3 ? 0xffffu : 0u);
}

// What one lane's walk reads besides its bits.
struct Lane {
  int start, end, limit, big_pairs, lo, hi, idx0;
  const int* tsel;  // the lane's 3 table selects
};

struct Tables {
  const uint16_t* lut;  // shared
  const uint16_t* c1t;  // shared, the lane's count1 select
  const int *l1_base, *big_width, *ktid, *klin, *kres;
};

// Decode one valid lane into its output rows; returns whether it failed.
template <bool kStaged>
__device__ __forceinline__ bool walk(const Bits<kStaged> bits, const Lane L,
                                     const Tables tb, int n_quads,
                                     uint4* pairs, ulonglong2* quads) {
  // ---- big-values pairs: pair p -> lines (2p, 2p+1).  Region r ends at
  // pair pend: the first pair whose first line reaches the r-th region
  // bound (bounds sorted), the last region at big_pairs.  A reserved
  // table fails the lane at the first pair of its region. ----
  uint4 st = make_uint4(0u, 0u, 0u, 0u);  // the last 4 pairs, newest in w
  int pos = L.start;
  int r = -1, pend = 0, w = 0, sh = 32, base = 0, lb = 0, p = 0;
  for (; p < L.big_pairs; ++p) {
    if (p >= pend) {
      do {
        ++r;
        pend = r == 0 ? (L.lo + 1) >> 1 : (r == 1 ? (L.hi + 1) >> 1 : L.big_pairs);
      } while (p >= pend);
      int t = L.tsel[r];
      t = t < 0 ? 0 : (t > 31 ? 31 : t);
      const int tid = tb.ktid[t];
      w = tb.big_width[tid];
      sh = 32 - (w < kL1Bits ? w : kL1Bits);
      base = tb.l1_base[tid];
      lb = tb.klin[t];
      if (tb.kres[t] > 0) break;
    }
    int x = 0, y = 0, ln = 1;
    if (w > 0) {
      const uint32_t win = bits.window(pos);
      int e = tb.lut[base + (int)(win >> sh)];
      if (e & kSubFlag) {
        e = tb.lut[kLevel1Entries + ((e >> 4) & 0x7ff) +
                   (int)((win << kL1Bits) >> (32 - (e & 15)))];
      }
      ln = e >> 8;
      x = (e >> 4) & 15;
      y = e & 15;
      if (lb > 0 && (x == 15 || y == 15)) {
        // linbits escapes: up to 28 more bits, from a window past the code
        const uint32_t esc = bits.window(pos + ln);
        int o = 0;
        if (x == 15) { x += (int)((esc << o) >> (32 - lb)); o += lb; }
        if (x > 0) { x = (esc << o) >> 31 ? -x : x; o += 1; }
        if (y == 15) { y += (int)((esc << o) >> (32 - lb)); o += lb; }
        if (y > 0) { y = (esc << o) >> 31 ? -y : y; o += 1; }
        pos += ln + o;
      } else {
        // code and at most two sign bits, all in the window's top 21 bits
        const uint32_t sb = win << ln;
        const int sx = x > 0, sy = y > 0;
        x = sb >> 31 ? -x : x;
        y = (sb << sx) >> 31 ? -y : y;
        pos += ln + sx + sy;
      }
    }
    if (ln == 0 || pos > L.end) break;
    if (p < 288) {
      st = make_uint4(st.y, st.z, st.w, pack2(x, y));
      if ((p & 3) == 3) pairs[p >> 2] = st;
    }
  }
  const bool fail = p < L.big_pairs;
  const int stored = p < 288 ? p : 288;  // pairs 0..p-1 decoded
  if (stored & 3) {
    for (int k = stored & 3; k < 4; ++k) st = make_uint4(st.y, st.z, st.w, 0u);
    pairs[stored >> 2] = st;
  }
  for (int k = (stored + 3) >> 2; k < 72; ++k) pairs[k] = make_uint4(0u, 0u, 0u, 0u);
  if (fail) {
    for (int k = 0; k < 72; ++k) quads[k] = make_ulonglong2(0ull, 0ull);
    return true;
  }

  // ---- count1 quads ----
  ulonglong2 qst = make_ulonglong2(0ull, 0ull);  // the last 2 quads
  int q = 0;
  bool over = false;
  for (; q < n_quads; ++q) {
    if (pos >= L.end || L.idx0 + 4 * q >= 576) break;
    const int e = tb.c1t[bits.window(pos) >> 22];
    const int o = e >> 8;
    if (pos + o > L.limit) {
      over = true;
      break;
    }
    // a quad straddling the part2_3 boundary is discarded
    qst = make_ulonglong2(
        qst.y, pos + o <= L.end
                   ? (uint64_t)(c1val(e, 0) | c1val(e, 1) << 16) |
                         (uint64_t)(c1val(e, 2) | c1val(e, 3) << 16) << 32
                   : 0ull);
    if (q & 1) quads[q >> 1] = qst;
    pos += o;
  }
  if (q & 1) quads[q >> 1] = make_ulonglong2(qst.y, 0ull);
  for (int k = (q + 1) >> 1; k < 72; ++k) quads[k] = make_ulonglong2(0ull, 0ull);
  return over;
}

__global__ void __launch_bounds__(kThreads) mp3_entropy_kernel(
    const uint8_t* __restrict__ main_u8, int n_files, int row_bytes,
    const int* __restrict__ file_idx, const int* __restrict__ start_bit,
    const int* __restrict__ end_bit, const int* __restrict__ limit_bit,
    const int* __restrict__ big_values, const int* __restrict__ region1,
    const int* __restrict__ region2, const int* __restrict__ tsel,
    const int* __restrict__ c1sel, const int* __restrict__ valid,
    const uint16_t* __restrict__ lut_g, const int* __restrict__ l1_base,
    const uint16_t* __restrict__ c1lut_g, const int* __restrict__ big_width,
    const int* __restrict__ ktid, const int* __restrict__ klin,
    const int* __restrict__ kres, int n_lanes, int n_big, int n_quads,
    int16_t* __restrict__ big576, int16_t* __restrict__ c1,
    uint8_t* __restrict__ fail_out) {
  __shared__ __align__(16) uint16_t lut[kTableEntries];
  __shared__ __align__(16) uint16_t c1lut[kC1Entries];
  __shared__ __align__(16) uint32_t staged[kThreads][kLaneChunks * 4];
  copy16(lut, lut_g, kTableEntries);
  copy16(c1lut, c1lut_g, kC1Entries);

  const int lane = threadIdx.x;
  const int i = blockIdx.x * kThreads + lane;
  const bool here = i < n_lanes;
  const int ii = here ? i : 0;
  int f = file_idx[ii];
  f = f < 0 ? 0 : (f >= n_files ? n_files - 1 : f);
  const bool ok = here && valid[ii] > 0;
  const int start = ok ? start_bit[ii] : 0;  // invalid lanes stage nothing
  const int end = end_bit[ii];

  // ---- stage: this lane's chunks c0 .. c0 + n16 - 1 (chunk k covers row
  // bytes 16k - delta ..; delta = row address mod 16) ----
  const uint8_t* row = main_u8 + (size_t)f * row_bytes;
  const int delta = (int)(reinterpret_cast<uintptr_t>(row) & 15);
  const int c0 = ((start >> 3) + delta) >> 4;
  const int last = (((end > start ? end : start) + kTailBits) >> 3) + delta;
  const int n16 = (last >> 4) - c0 + 1;
  const bool fits = n16 <= kLaneChunks;
  const int want = ok && fits ? n16 : 0;
  for (int l = 0; l < kThreads; ++l) {
    const int cnt = __shfl_sync(0xffffffffu, want, l);
    if (cnt == 0) continue;
    const int k0 = __shfl_sync(0xffffffffu, c0, l);
    const int d = __shfl_sync(0xffffffffu, delta, l);
    const uint8_t* r = reinterpret_cast<const uint8_t*>(
        __shfl_sync(0xffffffffu, reinterpret_cast<uintptr_t>(row), l));
    for (int c = lane; c < cnt; c += kThreads) {
      const int b0 = 16 * (k0 + c) - d;
      uint32_t* dst = &staged[l][4 * c];
      if (b0 >= 0 && b0 + 16 <= row_bytes) {
        cp_async16(dst, r + b0);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int b = b0 + j;
          const uint32_t x = (b >= 0 && b < row_bytes) ? (uint32_t)__ldg(r + b) : 0u;
          w[j >> 2] |= x << (8 * (j & 3));
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  if (!here) return;

  uint4* pairs = reinterpret_cast<uint4*>(big576 + (size_t)i * 576);
  ulonglong2* quads = reinterpret_cast<ulonglong2*>(c1 + (size_t)i * 576);
  bool fail = true;
  if (!ok) {
    for (int k = 0; k < 72; ++k) {
      pairs[k] = make_uint4(0u, 0u, 0u, 0u);
      quads[k] = make_ulonglong2(0ull, 0ull);
    }
  } else {
    const int bv = big_values[i];
    const int ra = region1[i], rb = region2[i];
    const Lane L{start, end, limit_bit[i], bv < n_big ? bv : n_big,
                 ra < rb ? ra : rb, ra < rb ? rb : ra,
                 2 * bv < 576 ? 2 * bv : 576, tsel + 3 * i};
    const Tables tb{lut, c1lut + (c1sel[i] > 0 ? 1024 : 0), l1_base,
                    big_width, ktid, klin, kres};
    const int base = 8 * (16 * c0 - delta);
    fail = fits ? walk(Bits<true>{staged[lane], base, row, row_bytes}, L, tb,
                       n_quads, pairs, quads)
                : walk(Bits<false>{staged[lane], base, row, row_bytes}, L, tb,
                       n_quads, pairs, quads);
  }
  fail_out[i] = fail ? 1 : 0;
}

}  // namespace

extern "C" int mp3_entropy_scan(
    const void* main_u8, int n_files, int row_bytes, const void* file_idx,
    const void* start_bit, const void* end_bit, const void* limit_bit,
    const void* big_values, const void* region1, const void* region2,
    const void* tsel, const void* c1sel, const void* valid, const void* lut,
    const void* l1_base, const void* c1lut, const void* big_width,
    const void* ktid, const void* klin, const void* kres, int n_lanes,
    int n_big, int n_quads, void* big576, void* c1, void* fail_out,
    void* stream) {
  if (n_lanes > 0) {
    const int blocks = (n_lanes + kThreads - 1) / kThreads;
    mp3_entropy_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)main_u8, n_files, row_bytes, (const int*)file_idx,
        (const int*)start_bit, (const int*)end_bit, (const int*)limit_bit,
        (const int*)big_values, (const int*)region1, (const int*)region2,
        (const int*)tsel, (const int*)c1sel, (const int*)valid,
        (const uint16_t*)lut, (const int*)l1_base, (const uint16_t*)c1lut,
        (const int*)big_width, (const int*)ktid, (const int*)klin,
        (const int*)kres, n_lanes, n_big, n_quads, (int16_t*)big576,
        (int16_t*)c1, (uint8_t*)fail_out);
  }
  return (int)cudaGetLastError();
}
