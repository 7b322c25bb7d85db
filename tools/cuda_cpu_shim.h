// CPU stand-in for the CUDA runtime, to rehearse a kernel source with g++
// before its first run on a GPU (tools/rehearse_cuda.py rewrites the source
// and force-includes this header; it is never part of a build for the card).
//
// Each block runs on its own set of std::threads, one per CUDA thread, and
// blocks run one after another, so `static` stands in for `__shared__`
// (tools/rehearse_cuda.py turns `extern __shared__` arrays into a static
// array of shim::kDynSmem bytes).  __syncthreads is a barrier over the block,
// __syncwarp one over the warp, a warp shuffle a barrier over the warp
// around a shared slot array, and cp.async a memcpy at issue time (commit
// and wait do nothing), so a kernel that reads a staged buffer before its
// wait still passes here: only the card shows that.  Atomics are the
// compiler's, fences are full fences.  The cache-hinted loads and stores
// (__ldg, __ldcg, __stcg, __stwb) are plain copies that abort on an access
// the card would find misaligned.
// Sources guard their PTX helpers with `#ifndef CUDA_CPU_SHIM`.

#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <type_traits>
#include <vector>

#define CUDA_CPU_SHIM 1
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __shared__ static
#define __align__(n) alignas(n)
#define __launch_bounds__(...)

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() = default;
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct int2 {
  int x, y;
};
struct int4 {
  int x, y, z, w;
};
inline int2 make_int2(int x, int y) { return {x, y}; }
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

template <class A, class B>
inline std::common_type_t<A, B> min(A a, B b) {
  return a < b ? a : b;
}
template <class A, class B>
inline std::common_type_t<A, B> max(A a, B b) {
  return a < b ? b : a;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9
};
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9
};
enum cudaSharedCarveout { cudaSharedmemCarveoutMaxShared = 100 };
inline thread_local int shim_last_error = 0;
inline cudaError_t cudaGetLastError() {
  const int e = shim_last_error;
  shim_last_error = 0;
  return e;
}
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}

template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                                 size_t) {
  *n = 1;  // one block at a time here
  return cudaSuccess;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}

namespace shim {

constexpr size_t kDynSmem = 227 * 1024;

struct Block {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  std::vector<long long> slots;  // one per thread, for the shuffles
};
inline Block* block = nullptr;
inline thread_local int tid = 0;

inline void sync() { block->bar->arrive_and_wait(); }

template <class T>
inline T shfl(T v, int src_lane) {
  static_assert(sizeof(T) <= sizeof(long long), "shuffle of a wide type");
  const int warp = tid / 32, lane0 = warp * 32;
  long long w = 0;
  std::memcpy(&w, &v, sizeof(T));
  block->slots[tid] = w;
  block->warp_bar[warp]->arrive_and_wait();
  const long long r = block->slots[lane0 + (src_lane & 31)];
  block->warp_bar[warp]->arrive_and_wait();
  T out;
  std::memcpy(&out, &r, sizeof(T));
  return out;
}

// Runs grid.x blocks of block.x threads, one block at a time.
inline void launch(dim3 grid, dim3 threads, size_t smem,
                   const std::function<void()>& body) {
  if (smem > kDynSmem || threads.x == 0 || threads.x > 1024 ||
      threads.x % 32 != 0 || threads.y != 1 || grid.y != 1) {
    shim_last_error = cudaErrorInvalidConfiguration;
    return;
  }
  gridDim = grid;
  blockDim = threads;
  for (unsigned b = 0; b < grid.x; ++b) {
    Block blk;
    blk.bar = std::make_unique<std::barrier<>>(threads.x);
    for (unsigned w = 0; w < threads.x / 32; ++w) {
      blk.warp_bar.push_back(std::make_unique<std::barrier<>>(32));
    }
    blk.slots.assign(threads.x, 0);
    block = &blk;
    std::vector<std::thread> pool;
    pool.reserve(threads.x);
    for (unsigned t = 0; t < threads.x; ++t) {
      pool.emplace_back([&, t, b] {
        tid = (int)t;
        threadIdx = dim3(t);
        blockIdx = dim3(b);
        body();
        // an exited thread no longer holds up the block's barriers
        block->bar->arrive_and_drop();
        block->warp_bar[t / 32]->arrive_and_drop();
      });
    }
    for (auto& th : pool) th.join();
    block = nullptr;
  }
}

}  // namespace shim

inline void __syncthreads() { shim::sync(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  shim::block->warp_bar[shim::tid / 32]->arrive_and_wait();
}
inline int __clz(int x) { return x == 0 ? 32 : __builtin_clz((unsigned)x); }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
[[noreturn]] inline void __trap() {
  std::fprintf(stderr, "cuda_cpu_shim: __trap() in block %u thread %u\n",
               blockIdx.x, threadIdx.x);
  std::abort();
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  return shim::shfl(v, src);
}
template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned d) {
  const int lane = shim::tid & 31;
  return shim::shfl(v, lane >= (int)d ? lane - (int)d : lane);
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int m) {
  return shim::shfl(v, (shim::tid & 31) ^ m);
}
// every lane of the warp reads every lane's value (all 32 must call it)
inline int __reduce_max_sync(unsigned, int v) {
  int m = v;
  for (int src = 0; src < 32; ++src) m = std::max(m, shim::shfl(v, src));
  return m;
}
// Loads and stores of a T check the alignment its width needs on the card.
template <class T>
inline void shim_check_aligned(const void* p) {
  static_assert((sizeof(T) & (sizeof(T) - 1)) == 0, "odd-sized access");
  if ((uintptr_t)p & (sizeof(T) - 1)) {
    std::fprintf(stderr, "cuda_cpu_shim: %zu-byte access not aligned (block "
                 "%u thread %u)\n", sizeof(T), blockIdx.x, threadIdx.x);
    std::abort();
  }
}
template <class T>
inline T __ldcg(const T* p) {
  shim_check_aligned<T>(p);
  std::atomic_thread_fence(std::memory_order_acquire);
  T v;
  std::memcpy(&v, (const void*)p, sizeof(T));
  return v;
}
template <class T>
inline T __ldg(const T* p) {
  shim_check_aligned<T>(p);
  T v;
  std::memcpy(&v, (const void*)p, sizeof(T));
  return v;
}
template <class T>
inline void __stcg(T* p, T v) {
  shim_check_aligned<T>(p);
  std::memcpy((void*)p, &v, sizeof(T));
}
template <class T>
inline void __stwb(T* p, T v) {
  shim_check_aligned<T>(p);
  std::memcpy((void*)p, &v, sizeof(T));
}
inline float __int_as_float(int x) {
  float f;
  std::memcpy(&f, &x, 4);
  return f;
}
inline int __float_as_int(float f) {
  int x;
  std::memcpy(&x, &f, 4);
  return x;
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}

inline void cp_async16(void* smem, const void* gmem) {
  if (((uintptr_t)smem | (uintptr_t)gmem) & 15) {
    std::fprintf(stderr, "cuda_cpu_shim: cp.async of 16 bytes not 16-byte "
                 "aligned (block %u thread %u)\n", blockIdx.x, threadIdx.x);
    std::abort();
  }
  std::memcpy(smem, gmem, 16);
}
inline void cp_async4(void* smem, const void* gmem) {
  if (((uintptr_t)smem | (uintptr_t)gmem) & 3) {
    std::fprintf(stderr, "cuda_cpu_shim: cp.async of 4 bytes not aligned\n");
    std::abort();
  }
  std::memcpy(smem, gmem, 4);
}
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}
