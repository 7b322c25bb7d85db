// FLAC predictor reconstruction, one thread per subframe, one launch for
// all the subframes of a decode.
//
// No TPU kernel to replace: the JAX package runs the recurrence as a
// lax.scan over the sample positions (codecs/flac/device.py::_predict),
// which XLA fuses into one loop on the TPU.  The port's plain twin of it,
// audio_decoder_tpu_torch/codecs/flac/device.py::_predict, issues about
// seven small torch ops per sample position from the host (4,096 positions
// at a 4096-sample blocksize); this kernel computes the same samples in
// one launch, bit for bit:
//   * positions below the subframe's order hold warm-up samples and pass
//     through;
//   * s[i] = res[i] + int32((sum_j c[j] * s[i-1-j]) >> shift), the sum
//     exact in int64 (|c| < 2^15 and 32 taps of int32 samples stay under
//     2^52), the shift arithmetic, the cast to int32 and the add wrapping;
//     history before the subframe's first sample reads 0;
//   * a CONSTANT subframe (kind 1) is its first value broadcast;
//   * every sample is shifted left by the subframe's wasted bits in
//     int32 (a shift outside [0, 31] gives 0, as torch's does), and the
//     shift of the sum is taken as 63 where it is outside [0, 63] (torch's
//     arithmetic shift of an int64).
// The contract the front-end guarantees (codecs/flac/frontend.py): order
// 0-32, shift 0-15, coefficients zero past the order and |c| < 2^15.  A
// warp walks its subframes with the taps of its largest order only, so a
// coefficient past that order is not read; an order outside [0, 32] is
// taken as its nearest end.
//
// What bounds it on Hopper: each subframe's walk is serial (a sample needs
// the one before it), ~4,096 steps at the loader's blocksize, and each
// step issues one 64-bit multiply-add per tap of the warp's order class
// besides its shift, add and stores, for a single warp on its SM; so the
// steps' instructions set the time, which grows with the class, and the
// bytes (the residuals read once and the samples written once, tens of
// MB) take a small part of it at the card's bandwidth.  The design keeps
// the dependent chain short and everything else off it:
//   * the newest sample's product is added last, so the other taps'
//     products for the next sample are formed while the chain waits;
//   * the taps and the history live in registers, fully unrolled for the
//     warp's order class (0, 4, 8, 16 or 32 taps), so no history is
//     loaded or stored;
//   * each warp stages kTile samples of its 32 subframes in shared memory
//     with cp.async, the next tile in flight while the warp walks this
//     one, and writes its output tile back row by row, so loads and stores
//     run 32 consecutive ints per instruction;
//   * blocks are one warp: at the loader's ~1,600 subframes there are
//     only ~50 warps, one per SM.
// The residuals are read through the decode's strided view (a row stride
// of nmax + 1), with no copy; the output is a contiguous [n_rows, nmax]
// int32 array written in full, so the wrapper allocates it with
// torch.empty.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;            // samples of a subframe staged at a time
constexpr int kPitch = kTile + 1;    // +1 column: rows and columns conflict-free
constexpr int kMaxTaps = 32;         // the coefficients' row length

typedef int Tile[32][kPitch];

#ifndef CUDA_CPU_SHIM
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

// the warp's 32 subframes from `first`, samples [c0, c0 + kTile), into
// `tile` (row r = subframe first + r); what lies past the rows or nmax
// reads 0
__device__ __forceinline__ void stage(Tile& tile, const int* __restrict__ vals,
                                      long long row_stride, int n_rows,
                                      int nmax, int first, int c0, int lane) {
  const int col = c0 + lane;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    if (first + r < n_rows && col < nmax) {
      cp_async4(&tile[r][lane], vals + (long long)(first + r) * row_stride + col);
    } else {
      tile[r][lane] = 0;
    }
  }
}

// one tile of the thread's subframe: `row` holds its kTile residuals (or
// warm-up samples) on entry and its output samples on exit; `h` is the
// history, h[j] = s[i-1-j]
template <int H, bool kWarm>
__device__ __forceinline__ void walk_tile(int* row, const int (&c)[H > 0 ? H : 1],
                                          int (&h)[H > 0 ? H : 1], int sh,
                                          int ord, bool constant, int v0,
                                          int wasted) {
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    const int r = row[k];
    long long acc = 0;
#pragma unroll
    for (int j = H - 1; j >= 1; --j) acc += (long long)c[j] * h[j];
    if (H > 0) acc += (long long)c[0] * h[0];
    int s = (int)((unsigned)(acc >> sh) + (unsigned)r);
    if (kWarm && k < ord) s = r;
#pragma unroll
    for (int j = H - 1; j >= 1; --j) h[j] = h[j - 1];
    if (H > 0) h[0] = s;
    const int v = constant ? v0 : s;
    row[k] = (wasted >= 0 && wasted < 32) ? (int)((unsigned)v << wasted) : 0;
  }
}

template <int H>
__device__ __forceinline__ void walk(Tile (&buf)[2], const int* __restrict__ vals,
                                     long long row_stride,
                                     const int* __restrict__ coeffs,
                                     int n_rows, int nmax, int first, int lane,
                                     int sh, int ord, bool constant, int v0,
                                     int wasted, int* __restrict__ out) {
  const int l = first + lane;
  int c[H > 0 ? H : 1];
  int h[H > 0 ? H : 1];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    c[j] = l < n_rows ? coeffs[(long long)l * kMaxTaps + j] : 0;
    h[j] = 0;
  }
  const int n_tiles = (nmax + kTile - 1) / kTile;
  stage(buf[0], vals, row_stride, n_rows, nmax, first, 0, lane);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    Tile& cur = buf[t & 1];
    if (t + 1 < n_tiles) {
      stage(buf[(t + 1) & 1], vals, row_stride, n_rows, nmax, first,
            (t + 1) * kTile, lane);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed, the next's fly
    __syncwarp();
    if (t == 0) {
      walk_tile<H, true>(cur[lane], c, h, sh, ord, constant, v0, wasted);
    } else {
      walk_tile<H, false>(cur[lane], c, h, sh, ord, constant, v0, wasted);
    }
    __syncwarp();
    const int col = t * kTile + lane;
    if (col < nmax) {
      // unrolled, so the 32 shared loads issue back to back before the
      // stores instead of each store waiting on its own load
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        if (first + r < n_rows) {
          out[(long long)(first + r) * nmax + col] = cur[r][lane];
        }
      }
    }
    __syncwarp();  // the tile is read before the stage after next refills it
  }
}

__global__ void __launch_bounds__(32)
flac_predict_kernel(const int* __restrict__ vals, long long row_stride,
                    const int* __restrict__ kind, const int* __restrict__ order,
                    const int* __restrict__ shift,
                    const int* __restrict__ wasted,
                    const int* __restrict__ coeffs, int n_rows, int nmax,
                    int* __restrict__ out) {
  __shared__ Tile buf[2];
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * 32;
  const int l = first + lane;
  int ord = 0, sh = 0, w = 0, v0 = 0;
  bool constant = false;
  if (l < n_rows) {  // rows past the end take part in the staging only
    ord = min(max(order[l], 0), kMaxTaps);
    const int s = shift[l];
    sh = (s < 0 || s > 63) ? 63 : s;
    w = wasted[l];
    constant = kind[l] == 1;
    v0 = vals[(long long)l * row_stride];
  }
  const int taps = __reduce_max_sync(0xffffffffu, ord);
  if (taps == 0) {
    walk<0>(buf, vals, row_stride, coeffs, n_rows, nmax, first, lane, sh, ord,
            constant, v0, w, out);
  } else if (taps <= 4) {
    walk<4>(buf, vals, row_stride, coeffs, n_rows, nmax, first, lane, sh, ord,
            constant, v0, w, out);
  } else if (taps <= 8) {
    walk<8>(buf, vals, row_stride, coeffs, n_rows, nmax, first, lane, sh, ord,
            constant, v0, w, out);
  } else if (taps <= 16) {
    walk<16>(buf, vals, row_stride, coeffs, n_rows, nmax, first, lane, sh,
             ord, constant, v0, w, out);
  } else {
    walk<32>(buf, vals, row_stride, coeffs, n_rows, nmax, first, lane, sh,
             ord, constant, v0, w, out);
  }
}

}  // namespace

// samples int32 [n_rows, nmax] (contiguous) of the subframes whose values
// (residuals behind warm-up samples) are int32 [n_rows, nmax] at `vals`
// with rows `row_stride` elements apart, and whose kind, order, shift and
// wasted bits (int32 [n_rows]) and coefficients (int32 [n_rows, 32],
// contiguous) are given.  Negative sizes, or rows that overlap (a stride
// under nmax), get cudaErrorInvalidValue.
extern "C" int flac_predict_launch(const void* vals, long long row_stride,
                                   const void* kind, const void* order,
                                   const void* shift, const void* wasted,
                                   const void* coeffs, int n_rows, int nmax,
                                   void* out, void* stream) {
  if (n_rows < 0 || nmax < 0 || (n_rows > 1 && row_stride < nmax)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows > 0 && nmax > 0) {
    const int blocks = (n_rows + 31) / 32;
    flac_predict_kernel<<<blocks, 32, 0, (cudaStream_t)stream>>>(
        (const int*)vals, row_stride, (const int*)kind, (const int*)order,
        (const int*)shift, (const int*)wasted, (const int*)coeffs, n_rows,
        nmax, (int*)out);
  }
  return (int)cudaGetLastError();
}
