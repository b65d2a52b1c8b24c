// A host build of a CUDA source whose kernels talk between threads, for the
// CPU tests: each thread of a block runs as a fiber (its own stack, on one
// OS thread, x86-64), blocks one after another; __syncthreads() is a
// barrier over the block, and the warp intrinsics (__ballot_sync,
// __shfl_sync, __shfl_up_sync, __shfl_xor_sync) exchange values through
// one slot per thread between two barriers over the warp's 32 threads.  A
// fiber that waits at a barrier hands over to the next one, round robin,
// so a barrier costs a few context switches and no system call.  Exact for
// kernels whose 32 lanes reach each warp intrinsic together with the full
// mask, as the card needs anyway (csrc/k1_build.cu).  tests/cuda_host.py
// turns each `kernel<<<grid, block, 0, stream>>>(args)` into
// emu_launch(kernel, grid, block, args).
#pragma once
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
#define __restrict__
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline dim3 threadIdx, blockIdx, blockDim, gridDim;
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return float4{a, b, c, d}; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 132; return cudaSuccess; }

template <class T>
inline T __ldg(const T* p) { return *p; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline int __float2int_rz(float v) { return (int)v; }
inline int __ffs(unsigned v) { return __builtin_ffs((int)v); }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __clz(unsigned v) { return v ? __builtin_clz(v) : 32; }

// emu_switch(from, to): save the callee-saved registers on this stack, store
// its pointer in *from, continue on stack `to`.
extern "C" void emu_switch(void** from, void* to);
asm(R"(
.text
.globl emu_switch
.type emu_switch, @function
emu_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
)");

constexpr size_t kEmuStack = 256 * 1024;

struct EmuBarrier {
  int expected = 0, count = 0;
  unsigned phase = 0;
};

struct EmuBlock {
  std::vector<void*> sp;  // each fiber's saved stack pointer
  std::vector<char> done;
  std::vector<EmuBarrier> warp;
  EmuBarrier block;
  std::vector<uint64_t> slot;
  void* sched = nullptr;  // the scheduler's saved stack pointer
  int cur = 0;
  std::function<void()> body;
};
inline EmuBlock g_emu;
inline std::vector<char> g_emu_stacks;

inline void emu_yield() { emu_switch(&g_emu.sp[g_emu.cur], g_emu.sched); }

inline void emu_wait(EmuBarrier& b) {
  const unsigned phase = b.phase;
  if (++b.count == b.expected) {
    b.count = 0;
    ++b.phase;
    return;
  }
  while (b.phase == phase) emu_yield();
}

inline void __syncthreads() { emu_wait(g_emu.block); }

// Lane `src`'s value of v in the calling thread's warp.
template <class T>
inline T emu_exchange(T v, int src) {
  const int t = (int)threadIdx.x, w0 = t & ~31;
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  g_emu.slot[t] = bits;
  emu_wait(g_emu.warp[t >> 5]);
  bits = g_emu.slot[w0 + src];
  emu_wait(g_emu.warp[t >> 5]);
  T out;
  std::memcpy(&out, &bits, sizeof(T));
  return out;
}

inline unsigned __ballot_sync(unsigned, bool p) {
  const int t = (int)threadIdx.x, w0 = t & ~31;
  g_emu.slot[t] = p ? 1 : 0;
  emu_wait(g_emu.warp[t >> 5]);
  unsigned b = 0;
  for (int i = 0; i < 32 && w0 + i < (int)g_emu.slot.size(); ++i)
    if (g_emu.slot[w0 + i]) b |= 1u << i;
  emu_wait(g_emu.warp[t >> 5]);
  return b;
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src) { return emu_exchange(v, src & 31); }
template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned d) {
  const int lane = (int)threadIdx.x & 31;
  return emu_exchange(v, lane >= (int)d ? lane - (int)d : lane);
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int m) { return emu_exchange(v, ((int)threadIdx.x & 31) ^ m); }

[[noreturn]] inline void emu_fiber_main() {
  g_emu.body();
  g_emu.done[g_emu.cur] = 1;
  emu_yield();
  std::abort();  // a finished fiber is never resumed
}

template <class... P, class... A>
void emu_launch(void (*f)(P...), dim3 grid, int block, A... a) {
  gridDim = grid;
  blockDim = dim3(block);
  g_emu_stacks.resize((size_t)block * kEmuStack);
  g_emu.body = [&] { f(a...); };
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = dim3(bx, by);
      g_emu.sp.assign(block, nullptr);
      g_emu.done.assign(block, 0);
      g_emu.slot.assign(block, 0);
      g_emu.warp.assign((block + 31) / 32, EmuBarrier{});
      for (int w = 0; w < (block + 31) / 32; ++w) g_emu.warp[w].expected = std::min(32, block - 32 * w);
      g_emu.block = EmuBarrier{block, 0, 0};
      for (int t = 0; t < block; ++t) {
        // a fresh stack: six zero registers, then emu_fiber_main as the
        // return address, entered with the stack 8 off 16-byte alignment
        char* top = g_emu_stacks.data() + (size_t)(t + 1) * kEmuStack;
        top = (char*)((uintptr_t)top & ~(uintptr_t)15);
        void** s = (void**)(top - 8);
        *--s = (void*)&emu_fiber_main;
        for (int r = 0; r < 6; ++r) *--s = nullptr;
        g_emu.sp[t] = s;
      }
      for (bool live = true; live;) {
        live = false;
        for (int t = 0; t < block; ++t) {
          if (g_emu.done[t]) continue;
          live = true;
          g_emu.cur = t;
          threadIdx = dim3(t);
          emu_switch(&g_emu.sched, g_emu.sp[t]);
        }
      }
    }
}
