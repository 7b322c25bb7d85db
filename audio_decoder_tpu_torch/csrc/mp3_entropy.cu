// MPEG Layer III entropy scan (Huffman big-values + count1), one thread
// per granule-channel lane.
//
// Replaces the TPU kernel audio_decoder_tpu/codecs/mpeg/huffman_pallas.py
// (entropy_scan, body _kernel).  That kernel pre-gathers a 160-word slab
// per lane and extracts words by one-hot compares because Mosaic has no
// per-lane gather; none of that is needed here.  Each thread walks its own
// bit cursor through its file's row of main_data and looks codes up in the
// flat big-values prefix LUT (~677k u16 entries, ~1.35 MB: L2-resident on
// Hopper, read through the read-only path); count1 codes decode with the
// canonical ALU rule, no table.  Semantics follow the JAX package's XLA
// scan (huffman_device.decode_spectra(impl="xla")) exactly, as does the
// plain torch twin huffman_device.scan_plain:
//   * pairs beyond 288 are decoded for their bits but not stored;
//   * big-values: a bad code, a reserved table or a cursor past end_bit
//     fails the lane; the failing pair is not stored;
//   * count1: a quad is decoded while the cursor is below end_bit and its
//     first line below 576; a quad that would read past limit_bit fails
//     the lane; one that straddles end_bit is dropped;
//   * at most n_quads = min(ceil(n_c1/32)*32, 144) quads (the wrapper
//     computes n_quads).
// Bytes at or past the end of a file row read as 0.
//
// What bounds it: the walk is bit-serial and data-dependent within a lane,
// so the kernel is bound by the dependent chain of byte loads, LUT loads
// and shifts per code (latency), not by bandwidth: ~24.5k lanes at the
// main path's size give about 190 blocks of 128 threads, under 2 blocks
// per SM.  The design keeps each step short (5 cached byte loads per
// 32-bit window, one LUT load per pair) and writes whole pairs (32 bits)
// and whole quads (64 bits) so a lane's output row goes out in few stores.
// Outputs are written in full (zeros past the decoded region), so the
// wrapper allocates them with torch.empty.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t peek32(const uint8_t* __restrict__ row,
                                           int nbytes, int pos) {
  // the 32 bits starting at bit `pos` (MSB first)
  int byte = pos >> 3;
  uint64_t v = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    int b = byte + k;
    uint32_t x = (b >= 0 && b < nbytes) ? (uint32_t)__ldg(row + b) : 0u;
    v = (v << 8) | x;
  }
  return (uint32_t)(v >> (8 - (pos & 7)));
}

__device__ __forceinline__ int take(uint32_t win, int off, int n) {
  // n bits at offset `off` of a 32-bit window (off + n <= 32)
  return n > 0 ? (int)((win << off) >> (32 - n)) : 0;
}

__global__ void __launch_bounds__(kThreads) mp3_entropy_kernel(
    const uint8_t* __restrict__ main_u8, int n_files, int row_bytes,
    const int* __restrict__ file_idx, const int* __restrict__ start_bit,
    const int* __restrict__ end_bit, const int* __restrict__ limit_bit,
    const int* __restrict__ big_values, const int* __restrict__ region1,
    const int* __restrict__ region2, const int* __restrict__ tsel,
    const int* __restrict__ c1sel, const int* __restrict__ valid,
    const uint16_t* __restrict__ biglut, const int* __restrict__ big_base,
    const int* __restrict__ big_width, const int* __restrict__ ktid,
    const int* __restrict__ klin, const int* __restrict__ kres,
    int n_lanes, int n_big, int n_quads, int c1_lo4, int c1_lo5,
    long long c1_nib4, long long c1_nib5, long long c1_nib6,
    int16_t* __restrict__ big576, int16_t* __restrict__ c1,
    uint8_t* __restrict__ fail_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_lanes) return;

  int f = file_idx[i];
  f = f < 0 ? 0 : (f >= n_files ? n_files - 1 : f);
  const uint8_t* row = main_u8 + (size_t)f * row_bytes;

  const bool ok = valid[i] > 0;
  bool fail = !ok;
  int pos = ok ? start_bit[i] : 0;
  const int end = end_bit[i];
  const int limit = limit_bit[i];
  const int bv = big_values[i];
  const int big_pairs = bv < n_big ? bv : n_big;
  const int r1 = region1[i];
  const int r2 = region2[i];

  int width[3], base[3], linb[3], res[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    int t = tsel[3 * i + r];
    t = t < 0 ? 0 : (t > 31 ? 31 : t);
    const int tid = ktid[t];
    width[r] = big_width[tid];
    base[r] = big_base[tid];
    linb[r] = klin[t];
    res[r] = kres[t];
  }

  // ---- big-values pairs: pair p -> lines (2p, 2p+1) ----
  uint32_t* pairs = reinterpret_cast<uint32_t*>(big576 + (size_t)i * 576);
  int stored = 0;
  for (int p = 0; p < big_pairs && !fail; ++p) {
    const int line = 2 * p;
    const int region = (line >= r1) + (line >= r2);
    const int w = width[region];
    bool bad = res[region] > 0;
    int x = 0, y = 0, consumed = 0;
    if (w > 0) {
      const uint32_t win = peek32(row, row_bytes, pos);
      const int entry = __ldg(biglut + base[region] + (int)(win >> (32 - w)));
      const int ln = entry >> 8;
      bad = bad || ln == 0;
      x = (entry >> 4) & 15;
      y = entry & 15;
      const uint32_t w2 = peek32(row, row_bytes, pos + ln);
      const int lb = linb[region];
      int o = 0;
      if (x == 15 && lb > 0) { x += take(w2, o, lb); o += lb; }
      if (x > 0) { if (take(w2, o, 1)) x = -x; o += 1; }
      if (y == 15 && lb > 0) { y += take(w2, o, lb); o += lb; }
      if (y > 0) { if (take(w2, o, 1)) y = -y; o += 1; }
      consumed = ln + o;
    }
    pos += consumed;
    if (bad || pos > end) {
      fail = true;
    } else if (p < 288) {
      pairs[p] = (uint32_t)(uint16_t)(int16_t)x |
                 ((uint32_t)(uint16_t)(int16_t)y << 16);
      stored = p + 1;
    }
  }
  for (int p = stored; p < 288; ++p) pairs[p] = 0u;

  // ---- count1 quads ----
  uint64_t* quads = reinterpret_cast<uint64_t*>(c1 + (size_t)i * 576);
  const int idx0 = 2 * bv < 576 ? 2 * bv : 576;
  const bool sel_b = c1sel[i] > 0;
  int q = 0;
  for (; q < n_quads; ++q) {
    if (fail || pos >= end || idx0 + 4 * q >= 576) break;
    const int w10 = (int)(peek32(row, row_bytes, pos) >> 22);
    const int top4 = w10 >> 6;
    int v, o;
    if (sel_b) {
      v = (~top4) & 15;
      o = 4;
    } else if ((w10 >> 9) == 1) {
      v = 0;
      o = 1;
    } else if (top4 >= c1_lo4) {
      v = (int)((c1_nib4 >> (4 * (top4 - c1_lo4))) & 15);
      o = 4;
    } else if ((w10 >> 5) >= c1_lo5) {
      v = (int)((c1_nib5 >> (4 * ((w10 >> 5) - c1_lo5))) & 15);
      o = 5;
    } else {
      v = (int)((c1_nib6 >> (4 * (w10 >> 4))) & 15);
      o = 6;
    }
    uint64_t packed = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int val = 0;
      if ((v >> (3 - k)) & 1) {
        val = ((w10 >> (9 - o)) & 1) ? -1 : 1;
        o += 1;
      }
      packed |= (uint64_t)(uint16_t)(int16_t)val << (16 * k);
    }
    if (pos + o > limit) {
      fail = true;
      break;
    }
    // a quad straddling the part2_3 boundary is discarded
    quads[q] = (pos + o <= end) ? packed : 0ull;
    pos += o;
  }
  for (; q < 144; ++q) quads[q] = 0ull;
  fail_out[i] = fail ? 1 : 0;
}

}  // namespace

extern "C" int mp3_entropy_scan(
    const void* main_u8, int n_files, int row_bytes, const void* file_idx,
    const void* start_bit, const void* end_bit, const void* limit_bit,
    const void* big_values, const void* region1, const void* region2,
    const void* tsel, const void* c1sel, const void* valid, const void* biglut,
    const void* big_base, const void* big_width, const void* ktid,
    const void* klin, const void* kres, int n_lanes, int n_big, int n_quads,
    int c1_lo4, int c1_lo5, long long c1_nib4, long long c1_nib5,
    long long c1_nib6, void* big576, void* c1, void* fail_out, void* stream) {
  if (n_lanes > 0) {
    const int blocks = (n_lanes + kThreads - 1) / kThreads;
    mp3_entropy_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)main_u8, n_files, row_bytes, (const int*)file_idx,
        (const int*)start_bit, (const int*)end_bit, (const int*)limit_bit,
        (const int*)big_values, (const int*)region1, (const int*)region2,
        (const int*)tsel, (const int*)c1sel, (const int*)valid,
        (const uint16_t*)biglut, (const int*)big_base, (const int*)big_width,
        (const int*)ktid, (const int*)klin, (const int*)kres, n_lanes, n_big,
        n_quads, c1_lo4, c1_lo5, c1_nib4, c1_nib5, c1_nib6, (int16_t*)big576,
        (int16_t*)c1, (uint8_t*)fail_out);
  }
  return (int)cudaGetLastError();
}
