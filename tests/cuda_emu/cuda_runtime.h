// A CPU stand-in for the CUDA runtime, for tests: a kernel source of the
// port (csrc/*.cu) compiled with g++ runs its blocks one after another,
// the threads of a block as fibers of one host thread (ucontext), taken in
// turn: each runs to its next __syncthreads or warp collective, then the
// next. That is a barrier of the whole block at each of them, which a
// kernel whose threads all reach the same barriers in the same order (as
// CUDA asks of __syncthreads) cannot tell apart. A warp collective keeps
// its lanes' values in one of two slots by the lane's count of collectives,
// so a lane that runs ahead cannot overwrite what another has yet to read.
// tests/_cuda_emu.py rewrites the source's launch (`k<<<grid, block, smem,
// stream>>>(args)`) and its dynamic shared memory before compiling.
// What it shows: the kernel's arithmetic, indexing and control flow, in
// IEEE single precision as the card computes them (-ffp-contract=off); not
// its speed, and the math library's sinf / cosf / expf round as the host's.
#pragma once
#include <ucontext.h>

#include <cmath>
#include <cstring>
#include <functional>
#include <math.h>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static

struct EmuDim3 { unsigned x = 0, y = 0, z = 0; };
inline EmuDim3 threadIdx, blockIdx, blockDim;  // the running fiber's
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> inline cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }

struct EmuBlock {
  std::vector<ucontext_t> ctx;
  std::vector<std::vector<char>> stacks;
  std::vector<char> done;
  ucontext_t host;
  int cur = 0;
  std::function<void()> body;
};
inline EmuBlock emu;
inline std::vector<char> emu_smem;

struct EmuWarp { float f[2][32]; long long i[2][32]; unsigned count[32]; };
inline std::vector<EmuWarp> emu_warps;

// The running fiber waits for every other to reach the same point.
inline void emu_yield() { swapcontext(&emu.ctx[emu.cur], &emu.host); }
inline void __syncthreads() { emu_yield(); }

inline float __shfl_down_sync(unsigned, float x, int off) {
  const int l = threadIdx.x & 31;
  EmuWarp& w = emu_warps[threadIdx.x / 32];
  const int s = w.count[l]++ & 1;
  w.f[s][l] = x;
  emu_yield();
  return l + off < 32 ? w.f[s][l + off] : x;
}
template <class T> inline T emu_reduce(T x, bool is_or) {
  const int l = threadIdx.x & 31;
  EmuWarp& w = emu_warps[threadIdx.x / 32];
  const int s = w.count[l]++ & 1;
  w.i[s][l] = (long long)x;
  emu_yield();
  long long r = 0;
  for (int k = 0; k < 32; ++k) r = is_or ? (r | w.i[s][k]) : r + w.i[s][k];
  return (T)r;
}
inline int __reduce_add_sync(unsigned, int x) { return emu_reduce<int>(x, false); }
inline unsigned __reduce_or_sync(unsigned, unsigned x) { return emu_reduce<unsigned>(x, true); }
template <class T> inline T* emu_dyn_smem() { return reinterpret_cast<T*>(emu_smem.data()); }

inline void emu_fiber() {
  emu.body();
  emu.done[emu.cur] = 1;  // then back to the host through uc_link
}

template <int THREADS, class F, class A>
inline void emu_launch(F kernel, int grid, int smem, const A& args) {
  constexpr size_t kStack = 256 * 1024;
  emu_smem.assign(smem + 64, 0);
  emu.ctx.assign(THREADS, ucontext_t{});
  emu.stacks.resize(THREADS);
  emu.body = [&] { kernel(args); };
  for (int b = 0; b < grid; ++b) {
    emu_warps.assign(THREADS / 32, EmuWarp{});
    emu.done.assign(THREADS, 0);
    for (int t = 0; t < THREADS; ++t) {
      emu.stacks[t].resize(kStack);
      getcontext(&emu.ctx[t]);
      emu.ctx[t].uc_stack.ss_sp = emu.stacks[t].data();
      emu.ctx[t].uc_stack.ss_size = kStack;
      emu.ctx[t].uc_link = &emu.host;
      makecontext(&emu.ctx[t], emu_fiber, 0);
    }
    for (bool running = true; running;) {
      running = false;
      for (int t = 0; t < THREADS; ++t) {
        if (emu.done[t]) continue;
        emu.cur = t;
        threadIdx.x = t;
        blockIdx.x = b;
        blockDim.x = THREADS;
        swapcontext(&emu.host, &emu.ctx[t]);
        running = true;
      }
    }
  }
}
