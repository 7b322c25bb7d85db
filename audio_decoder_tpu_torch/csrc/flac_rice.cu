// FLAC rice lane scan, one thread per rice lane (one residual partition,
// or a RICE_SPLIT-code piece of one), one launch for all the lanes of a
// decode.
//
// No TPU kernel to replace: the JAX package scans the lanes with a
// lax.scan (codecs/flac/device.py::_rice_scan), which XLA fuses into one
// loop on the TPU.  The port's plain twin of it,
// audio_decoder_tpu_torch/codecs/flac/device.py::_rice_scan, issues some
// 70 small torch ops per code position from the host; this kernel
// computes the same values in one launch.  Its output is the twin's
// followed by the mask the decode applies to it,
// torch.where(j < count, values, 0), bit for bit:
//   * a lane's cursor starts at min(bitpos, limit); a step decodes K codes
//     (8 in the narrow variant, 6 in the wide one), their offsets summed
//     from the step's cursor without a clamp, for live codes (j < count)
//     only, and the cursor after the step is min(cursor + offset, limit);
//   * each code reads the 32-bit big-endian window at its bit position
//     straight from the flat byte stream (bytes before its start or at or
//     past its end read as 0, ops/bytes.peek32); the unary quotient is the
//     window's leading zeros; a live code whose window is all zeros, or
//     whose quotient is over the caller's q_cap (frontend.Q_CAP), raises
//     the lane's overflow flag, and the quotient is clamped to q_cap;
//   * the remainder rides the same window after the quotient (narrow:
//     q + 1 + param <= 32 when param <= 16) or a second window read at the
//     remainder's position (wide), shifted right by max(32 - param, 1)
//     (a parameter of 0 shifts the window out whole: the twin's zero);
//     the shifts are taken in 64 bits, since q + 1 and that shift reach 32;
//   * v = ((q << param) & 0xFFFFFFFF) | rem, taken as int32 and
//     unzigzagged with an arithmetic shift, (v >> 1) ^ -(v & 1);
//   * codes at or past count are not decoded: they are written as 0.
// The rice parameters of a stream are 0-30 (a 31 escapes the partition to
// the fixed-width lanes); the kernel clamps a parameter into [0, 63] so
// that no shift is undefined.
//
// What bounds it on Hopper: each lane's walk is serial (a code's length
// decides where the next one starts), at most frontend.RICE_SPLIT = 256
// codes a lane, and every code reads its window as five byte loads
// through the read-only cache whose 32 lanes fall on 32 different lines;
// the launch takes several times its bytes' time at the card's bandwidth,
// a fraction of a millisecond at the loader's shapes (tens of thousands
// of lanes), next to hundreds of milliseconds of host work in the same
// call (PERF.md), so the design stays the simplest that is exact.
// The bytes it must move are the stream (a few MB) and the [L, W] int32
// output (tens of MB), written once.  A thread writing its own row would
// issue stores 4*W bytes apart across a warp, so each warp stages kChunk
// codes of each of its 32 lanes in shared memory and then stores the
// tile row by row: 32 consecutive ints (128 bytes) per store
// instruction.  Outputs are written in full (zeros past count), so the
// wrapper allocates them with torch.empty.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNarrowCodes = 8;      // codecs/flac/device.py K_NARROW
constexpr int kWideCodes = 6;        // codecs/flac/device.py K_WIDE
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 32;           // codes per lane staged at a time

// the 32 bits at bit `pos` of the stream (MSB first), bytes outside read 0
__device__ __forceinline__ uint32_t peek32(const uint8_t* __restrict__ s,
                                           long long n, long long pos) {
  const long long byte = pos >> 3;
  uint64_t win = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const long long b = byte + k;
    win = (win << 8) | ((b >= 0 && b < n) ? (uint32_t)__ldg(s + b) : 0u);
  }
  return (uint32_t)(win >> (8 - (int)(pos & 7)));
}

template <int K, bool kWide>
__global__ void __launch_bounds__(kThreads)
flac_rice_kernel(const uint8_t* __restrict__ stream, long long n_bytes,
                 const int* __restrict__ bitpos, const int* __restrict__ count,
                 const int* __restrict__ param,
                 const long long* __restrict__ limit, int n_lanes, int width,
                 int q_cap, int* __restrict__ out,
                 uint8_t* __restrict__ ovf_out) {
  // +1 column: a lane's writes down its row and the warp's reads along a
  // row both fall in 32 different banks
  __shared__ int tile[kWarps][32][kChunk + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = blockIdx.x * kThreads + warp * 32;  // the warp's lane 0
  const int l = first + lane;
  int cnt = 0, prm = 0;
  long long lim = 0, pos = 0;
  if (l < n_lanes) {  // lanes past the end take part in the stores only
    cnt = count[l];
    prm = min(max(param[l], 0), 63);
    lim = limit[l];
    pos = min((long long)bitpos[l], lim);
  }
  const int pshift = max(32 - prm, 1);
  long long off = 0;  // bits of the step's codes so far
  int kk = 0;         // the code's index within its step
  bool ovf = false;
  int(*rows)[kChunk + 1] = tile[warp];
  for (int c0 = 0; c0 < width; c0 += kChunk) {
    const int hi = min(c0 + kChunk, width);
    const int live_hi = max(min(hi, cnt), c0);
    int j = c0;
    for (; j < live_hi; ++j) {
      const long long p = pos + off;
      const uint32_t w1 = peek32(stream, n_bytes, p);
      int q = __clz((int)w1);  // 32 for an all-zero window
      if (q > q_cap) {
        ovf = true;
        q = q_cap;
      }
      uint64_t rem;
      if (kWide) {
        rem = (uint64_t)peek32(stream, n_bytes, p + q + 1) >> pshift;
      } else {
        rem = (((uint64_t)w1 << (q + 1)) & 0xFFFFFFFFull) >> pshift;
      }
      const int v = (int)(uint32_t)((((uint64_t)q << prm) & 0xFFFFFFFFull) | rem);
      rows[lane][j - c0] = (v >> 1) ^ -(v & 1);
      off += q + 1 + prm;
      if (++kk == K) {
        kk = 0;
        pos = min(pos + off, lim);
        off = 0;
      }
    }
    for (; j < hi; ++j) rows[lane][j - c0] = 0;
    __syncwarp();
    if (c0 + lane < hi) {
      for (int r = 0; r < 32 && first + r < n_lanes; ++r) {
        out[(long long)(first + r) * width + c0 + lane] = rows[r][lane];
      }
    }
    __syncwarp();
  }
  if (l < n_lanes) ovf_out[l] = ovf ? 1 : 0;
}

}  // namespace

// values int32 [n_lanes, width] and ovf bool [n_lanes] for the lanes
// (bitpos, count, param int32, limit int64, all [n_lanes]) over the byte
// stream u8 [n_bytes]; width = steps * codes_per_step.  The variant's
// codes per step are fixed (8 narrow, 6 wide): a caller that counts
// otherwise, or a q_cap outside [0, 32], gets cudaErrorInvalidValue.
extern "C" int flac_rice_scan_launch(const void* stream_u8, long long n_bytes,
                                     const void* bitpos, const void* count,
                                     const void* param, const void* limit,
                                     int n_lanes, int width, int narrow,
                                     int codes_per_step, int q_cap, void* out,
                                     void* ovf, void* stream) {
  const int k = narrow ? kNarrowCodes : kWideCodes;
  if (codes_per_step != k || width % k != 0 || q_cap < 0 || q_cap > 32) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_lanes > 0) {
    const int blocks = (n_lanes + kThreads - 1) / kThreads;
    if (narrow) {
      flac_rice_kernel<kNarrowCodes, false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const uint8_t*)stream_u8, n_bytes, (const int*)bitpos,
          (const int*)count, (const int*)param, (const long long*)limit,
          n_lanes, width, q_cap, (int*)out, (uint8_t*)ovf);
    } else {
      flac_rice_kernel<kWideCodes, true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const uint8_t*)stream_u8, n_bytes, (const int*)bitpos,
          (const int*)count, (const int*)param, (const long long*)limit,
          n_lanes, width, q_cap, (int*)out, (uint8_t*)ovf);
    }
  }
  return (int)cudaGetLastError();
}
