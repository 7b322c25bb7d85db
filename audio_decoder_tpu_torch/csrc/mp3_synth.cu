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
// What bounds it on Hopper: per output step it must read 128 B and write
// 128 B; at the main path's size (113 MB in all) that is 0.034 ms at
// 3.35 TB/s, so bytes bound it.  The first design spent its time on
// shared-memory traffic instead: every FMA of its matrixing read two
// shared operands, a 64-step tile recomputed a 15-step halo (23%), and the
// FIR reloaded its 16 taps per output.  This design:
//   1. Folds SYNTH_N's symmetry (ops/synth_kernel.fold_synth_n builds the
//      folded matrix and checks the symmetry): rows 17..31 are -rows
//      15..1, rows 49..63 are rows 47..33, row 48 is all -1, and row 16 is
//      ~1e-14 (8.8e-15 at most in f32) and is DROPPED (V[16] = 0).  Each
//      kept row is symmetric (even rows) or antisymmetric (odd rows) in k
//      about 15.5, so with S = TS[k] + TS[31-k] and D = TS[k] - TS[31-k]
//      (k < 16) a step needs 32 dot products of length 16 (A0..A15 = rows
//      0..15, B0..B15 = rows 32..47) and B16 = -sum(S): 512 FMAs + 48
//      adds, against 2,048 FMAs unfolded.  The FIR's 512 FMAs stay.
//   2. Register-tiles the matrixing: each thread computes 4 steps x 8
//      folded rows from float4 shared reads (8 x 16-byte loads per 128
//      FMAs); a warp shares its 8 rows (broadcast reads) and reads 32
//      consecutive steps (row stride 36 floats: conflict-free).
//   3. Works on 256-step tiles, the TPU kernel's TILE_T, with a 16-step
//      halo (15 are needed): 6% recompute.  41.2 KB of static shared
//      memory (S|D staging, then V reusing it; the folded N) and at most
//      64 registers a thread, so four blocks fit on an SM and one block's
//      loads overlap the others' arithmetic.
//   4. FIR: each thread owns one output column and 16 consecutive steps
//      (twice), so each V value loaded serves up to 8 taps, from 16
//      coefficients held in registers; a warp writes whole 128-byte rows.
//   5. Plain f32 FMAs only: no tensor cores, no TF32.
// The ragged tail of the last tile is masked, so T needs no padding.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;            // output steps per block
constexpr int kHalo = 16;             // history steps recomputed
constexpr int kSteps = kTile + kHalo;
constexpr int kThreads = 256;
constexpr int kSdStride = 36;         // S[16] | D[16] | pad, floats per step
constexpr int kVStride = 33;          // A0..A15 | B0..B16, floats per step
constexpr int kFolded = 32;           // rows of the folded matrix
static_assert(kSteps * kVStride <= kSteps * kSdStride, "V reuses S|D");

// V column of folded row r: rows 0-7 are A0,A2..A14, 8-15 B0,B2..B14,
// 16-23 A1,A3..A15, 24-31 B1,B3..B15 (ops/synth_kernel.FOLD_ROWS);
// A_m sits at column m, B_m at 16 + m.
__device__ __forceinline__ int vcol(int r) {
  return (r & 7) * 2 + ((r >> 3) & 1) * 16 + (r >> 4);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__global__ void __launch_bounds__(kThreads, 4) mp3_synth_kernel(
    const float* __restrict__ ts, const float* __restrict__ nf,
    const float* __restrict__ g2, float* __restrict__ out, int T,
    int tiles_per_row) {
  __shared__ __align__(16) float buf[kSteps * kSdStride];
  __shared__ __align__(16) float nfs[kFolded * 16];

  const int tid = threadIdx.x;
  const int row = blockIdx.x / tiles_per_row;
  const int t0 = (blockIdx.x % tiles_per_row) * kTile;
  const float* src = ts + (size_t)row * T * 32;
  float* dst = out + (size_t)row * T * 32;

  if (tid < kFolded * 4) {
    reinterpret_cast<float4*>(nfs)[tid] =
        __ldg(reinterpret_cast<const float4*>(nf) + tid);
  }
  // stage S and D of local step s (global t0 - kHalo + s); work item q
  // takes k = 4q..4q+3 and their mirrors 31-k
  for (int e = tid; e < kSteps * 4; e += kThreads) {
    const int s = e >> 2, q = e & 3;
    const int t = t0 - kHalo + s;
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (t >= 0 && t < T) {
      const float4* r = reinterpret_cast<const float4*>(src + (size_t)t * 32);
      lo = __ldg(r + q);
      hi = __ldg(r + 7 - q);
    }
    float4* sd = reinterpret_cast<float4*>(buf + s * kSdStride);
    sd[q] = make_float4(lo.x + hi.w, lo.y + hi.z, lo.z + hi.y, lo.w + hi.x);
    sd[4 + q] = make_float4(lo.x - hi.w, lo.y - hi.z, lo.z - hi.y, lo.w - hi.x);
  }
  __syncthreads();

  // ---- matrixing.  Main part: thread (rg, sg) takes local steps
  // kHalo + sg + 64i (i < 4) and folded rows 8rg..8rg+7 (rg < 2: even
  // rows, from S; else odd rows, from D).  rg is uniform in a warp. ----
  const int rg = tid >> 6, sg = tid & 63;
  const int off = rg < 2 ? 0 : 16;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = *reinterpret_cast<const float4*>(
          buf + (kHalo + sg + 64 * i) * kSdStride + off + 4 * kc);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 n =
          *reinterpret_cast<const float4*>(nfs + (8 * rg + j) * 16 + 4 * kc);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = dot4(x[i], n, acc[i][j]);
    }
  }
  // halo steps 0..15: thread takes step hs and folded rows hp (S), 16+hp (D)
  const int hs = tid & 15, hp = tid >> 4;
  float he = 0.f, ho = 0.f;
  // B16 = -sum(S) of local steps tid and kTile + tid
  float b16a = 0.f, b16b = 0.f;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const float4 s = *reinterpret_cast<const float4*>(buf + hs * kSdStride + 4 * kc);
    const float4 d = *reinterpret_cast<const float4*>(buf + hs * kSdStride + 16 + 4 * kc);
    he = dot4(s, *reinterpret_cast<const float4*>(nfs + hp * 16 + 4 * kc), he);
    ho = dot4(d, *reinterpret_cast<const float4*>(nfs + (16 + hp) * 16 + 4 * kc), ho);
    const float4 a = *reinterpret_cast<const float4*>(buf + tid * kSdStride + 4 * kc);
    b16a += (a.x + a.y) + (a.z + a.w);
    if (tid < kSteps - kTile) {
      const float4 b =
          *reinterpret_cast<const float4*>(buf + (kTile + tid) * kSdStride + 4 * kc);
      b16b += (b.x + b.y) + (b.z + b.w);
    }
  }
  __syncthreads();

  // ---- V [kSteps][kVStride] over the S|D staging ----
  float* v = buf;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[(kHalo + sg + 64 * i) * kVStride + vcol(8 * rg + j)] = acc[i][j];
    }
  }
  v[hs * kVStride + vcol(hp)] = he;
  v[hs * kVStride + vcol(16 + hp)] = ho;
  v[tid * kVStride + 32] = -b16a;
  if (tid < kSteps - kTile) v[(kTile + tid) * kVStride + 32] = -b16b;
  __syncthreads();

  // ---- FIR: thread owns output column j and 16 consecutive steps, twice
  // (runs r0 and r0 + 8).  Even taps read A_m, odd taps B_m, where m = j
  // for j <= 16 and 32 - j above; the even taps of j > 16 are negated and
  // those of j = 16 are 0 (row 16 dropped), whose odd taps read B16. ----
  const int j = tid & 31;
  const int mj = j <= 16 ? j : 32 - j;
  const int ca = mj & 15, cb = 16 + mj;
  const float se = j < 16 ? 1.f : (j == 16 ? 0.f : -1.f);
  float c[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float g = __ldg(g2 + k * 32 + j);
    c[k] = (k & 1) ? g : se * g;
  }
  for (int run = tid >> 5; run < kTile / 16; run += kThreads / 32) {
    float o[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) o[u] = 0.f;
    // output u (local 16run + u) tap k reads V local step 16run + u + kHalo - k
#pragma unroll
    for (int d = 1; d < 32; ++d) {
      const float* vr = v + (16 * run + d) * kVStride;
      const float a = vr[ca], b = vr[cb];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int k = u + kHalo - d;
        if (k >= 0 && k < 16) o[u] = fmaf(c[k], (k & 1) ? b : a, o[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int t = t0 + 16 * run + u;
      if (t < T) dst[(size_t)t * 32 + j] = o[u];
    }
  }
}

}  // namespace

extern "C" int mp3_synth(const void* ts, const void* nf, const void* g2,
                         void* out, int rows, int T, void* stream) {
  if (rows > 0 && T > 0) {
    const int tiles = (T + kTile - 1) / kTile;
    const long long blocks = (long long)rows * tiles;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    mp3_synth_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)ts, (const float*)nf, (const float*)g2, (float*)out, T,
        tiles);
  }
  return (int)cudaGetLastError();
}
