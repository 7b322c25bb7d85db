// MPEG audio polyphase synthesis filterbank: per row of subband samples,
// a 32 -> 64 matrixing by SYNTH_N, then a 16-tap FIR over the zero-started
// history of matrixed blocks.
//
// Replaces the TPU kernel audio_decoder_tpu/ops/pallas_synth.py
// (polyphase_synthesis_pallas, body _kernel).  Its plain torch twin is
// ops/synth_kernel.synthesis_plain, which is the JAX package's XLA form
// (codecs/mpeg/dsp.polyphase_synthesis off the TPU).
//
//   V[t, n]   = sum_k TS[t, k] * N[n, k]                    (n < 64, k < 32)
//   out[t, j] = sum_{k<16} G2[k, j] * V[t-k, (k&1)*32 + j]   (V[t<0] = 0)
//
// One block per (row, tile of kTile steps).  The block stages its TS tile
// plus a 15-step halo in shared memory (halo rows before t=0 are zero, the
// ISO shift register's initial state), matrixes the kTile+15 rows against
// N in f32 FMAs (no tensor cores: no TF32 rounding), then runs the FIR
// from shared memory and writes its [kTile, 32] block.  The ragged tail of
// the last tile is masked, so T needs no padding.
//
// What bounds it: per output step it reads 128 B and writes 128 B, and
// does 64*32 + 16*32 = 2560 FMAs (plus 15/kTile recompute for the halo):
// ~10 FMAs per byte, near the H100's f32 ridge point, so it is neither
// cleanly memory- nor compute-bound at this size.  The design keeps V out
// of device memory entirely (the plain form writes and re-reads V 16
// times) and pads N's shared rows to 33 floats so the matrixing's strided
// reads of N hit 32 different banks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kHalo = 15;
constexpr int kRows = kTile + kHalo;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) mp3_synth_kernel(
    const float* __restrict__ ts, const float* __restrict__ n_mat,
    const float* __restrict__ g2, float* __restrict__ out, int T,
    int tiles_per_row) {
  __shared__ float xs[kRows][32];
  __shared__ float ns[64][33];
  __shared__ float vs[kRows][64];
  __shared__ float gs[16][32];

  const int row = blockIdx.x / tiles_per_row;
  const int t0 = (blockIdx.x % tiles_per_row) * kTile;
  const float* src = ts + (size_t)row * T * 32;
  float* dst = out + (size_t)row * T * 32;

  for (int e = threadIdx.x; e < kRows * 32; e += kThreads) {
    const int r = e >> 5, k = e & 31;
    const int t = t0 - kHalo + r;
    xs[r][k] = (t >= 0 && t < T) ? src[(size_t)t * 32 + k] : 0.f;
  }
  for (int e = threadIdx.x; e < 64 * 32; e += kThreads) {
    ns[e >> 5][e & 31] = n_mat[e];
  }
  for (int e = threadIdx.x; e < 16 * 32; e += kThreads) {
    gs[e >> 5][e & 31] = g2[e];
  }
  __syncthreads();

  for (int e = threadIdx.x; e < kRows * 64; e += kThreads) {
    const int r = e >> 6, n = e & 63;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 32; ++k) acc = fmaf(xs[r][k], ns[n][k], acc);
    vs[r][n] = acc;
  }
  __syncthreads();

  for (int e = threadIdx.x; e < kTile * 32; e += kThreads) {
    const int r = e >> 5, j = e & 31;
    const int t = t0 + r;
    if (t >= T) continue;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      acc = fmaf(gs[k][j], vs[r + kHalo - k][(k & 1) * 32 + j], acc);
    }
    dst[(size_t)t * 32 + j] = acc;
  }
}

}  // namespace

extern "C" int mp3_synth(const void* ts, const void* n_mat, const void* g2,
                         void* out, int rows, int T, void* stream) {
  if (rows > 0 && T > 0) {
    const int tiles = (T + kTile - 1) / kTile;
    const long long blocks = (long long)rows * tiles;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    mp3_synth_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)ts, (const float*)n_mat, (const float*)g2, (float*)out,
        T, tiles);
  }
  return (int)cudaGetLastError();
}
