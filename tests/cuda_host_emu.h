// A host build of a CUDA source for the CPU tests: the CUDA keywords as
// plain C++, and a launch that runs every block's threads one after another
// in two passes, the first ending at __syncthreads().  Exact for a kernel
// whose one barrier follows work that repeats its own results
// (csrc/k6_window_tables.cu, csrc/k7_keyframe_tables.cu: the first threads
// build their lane's chain in shared memory, the same values in both
// passes).  Used by tests/cuda_host.py, which turns each `kernel<<<grid,
// block, 0, stream>>>(args)` into emu_launch(kernel, grid, block, args).
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
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
static dim3 threadIdx, blockIdx, blockDim, gridDim;
static bool g_pass2;
#define __syncthreads() do { if (!g_pass2) return; } while (0)
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return float4{a, b, c, d}; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F, class A>
void emu_launch(F f, dim3 grid, int block, A a) {
  gridDim = grid;
  blockDim = dim3(block);
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = dim3(bx, by);
      for (int pass = 0; pass < 2; ++pass) {
        g_pass2 = pass;
        for (int t = 0; t < block; ++t) { threadIdx = dim3(t); f(a); }
      }
    }
}
