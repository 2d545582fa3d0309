"""Build a CUDA source of the port for the host, to rehearse its logic on
the CPU: ``csrc/<name>.cu`` compiled by g++ against a small emulation of the
CUDA features the port's kernels use, one ``std::thread`` per CUDA thread,
the blocks one after another, a barrier per warp for its shuffles and
reductions and one per block for ``__syncthreads``; shared memory is a
static or a host buffer, ``cp.async`` and Hopper's bulk copy plain
copies, their waits and fences no-ops. The ``<<<...>>>`` launch (of a
template instantiation too) and the ``extern __shared__`` array are
rewritten by text.

Used by ``tests/test_torch_search_kernel.py`` (K4),
``tests/test_torch_analysis_kernel.py`` (K3),
``tests/test_torch_granule_kernel.py`` (K2),
``tests/test_torch_huffman_kernel.py`` (the Huffman bit-scan),
``tests/test_torch_cost_grid_kernel.py`` (K5, the cost grid) and
``tests/test_torch_serialize_kernel.py`` (the frame serializer).
"""

import ctypes
import os
import re
import shutil
import subprocess

import pytest

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                    "mp3stego_tpu_torch", "csrc")

HOST_SHIM = r"""#pragma once
#include <atomic>
#include <barrier>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <type_traits>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __grid_constant__

struct alignas(8) int2 { int x, y; };
struct alignas(8) uint2 { unsigned x, y; };
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) double2 { double x, y; };
inline int2 make_int2(int x, int y) { return int2{x, y}; }
struct alignas(16) int4 { int x, y, z, w; };
inline int4 make_int4(int x, int y, int z, int w) { return int4{x, y, z, w}; }
struct dim3 { unsigned x = 0, y = 0, z = 0; };
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

struct ShimWarp {
  std::barrier<> bar{32};
  long long vals[32];
};

struct ShimBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<ShimWarp>> warps;
};

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline thread_local ShimBlock* shim_block = nullptr;
inline unsigned char* shim_dyn = nullptr;
inline int shim_last_error = 0;
inline size_t shim_max_dyn = 48 * 1024;

inline void __syncthreads() { shim_block->bar->arrive_and_wait(); }
inline ShimWarp& shim_warp() { return *shim_block->warps[threadIdx.x >> 5]; }
inline void __syncwarp(unsigned = 0xffffffffu) { shim_warp().bar.arrive_and_wait(); }

template <class T> inline T __reduce_add_sync(unsigned, T v) {
  ShimWarp& w = shim_warp();
  w.vals[threadIdx.x & 31] = static_cast<long long>(v);
  w.bar.arrive_and_wait();
  T s = 0;
  for (int i = 0; i < 32; ++i) s = static_cast<T>(s + static_cast<T>(w.vals[i]));
  w.bar.arrive_and_wait();
  return s;
}
template <class T> inline T __reduce_max_sync(unsigned, T v) {
  ShimWarp& w = shim_warp();
  w.vals[threadIdx.x & 31] = static_cast<long long>(v);
  w.bar.arrive_and_wait();
  T s = static_cast<T>(w.vals[0]);
  for (int i = 1; i < 32; ++i) s = std::max(s, static_cast<T>(w.vals[i]));
  w.bar.arrive_and_wait();
  return s;
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) {
  ShimWarp& w = shim_warp();
  w.vals[threadIdx.x & 31] = static_cast<long long>(v);
  w.bar.arrive_and_wait();
  T s = static_cast<T>(w.vals[src & 31]);
  w.bar.arrive_and_wait();
  return s;
}
template <class T> inline T __shfl_down_sync(unsigned, T v, unsigned d) {
  ShimWarp& w = shim_warp();
  const unsigned l = threadIdx.x & 31;
  w.vals[l] = static_cast<long long>(v);
  w.bar.arrive_and_wait();
  T s = static_cast<T>(w.vals[l + d < 32 ? l + d : l]);
  w.bar.arrive_and_wait();
  return s;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  ShimWarp& w = shim_warp();
  w.vals[threadIdx.x & 31] = pred != 0;
  w.bar.arrive_and_wait();
  unsigned b = 0;
  for (int i = 0; i < 32; ++i) b |= static_cast<unsigned>(w.vals[i] != 0) << i;
  w.bar.arrive_and_wait();
  return b;
}
inline int __any_sync(unsigned m, int pred) { return __ballot_sync(m, pred) != 0; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __mulhi(int a, int b) {
  return static_cast<int>((static_cast<long long>(a) * b) >> 32);
}
// cp.async as a plain copy (zero-filled past src_size), waits as no-ops
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size,
                                    size_t zfill = 0) {
  std::memcpy(dst, src, size - zfill);
  std::memset(static_cast<char*>(dst) + size - zfill, 0, zfill);
}
inline void __pipeline_commit() {}
// the bulk copy (cp.async.bulk) as a plain copy, its waits and fence no-ops
inline void bulk_store(void* dst, const void* src, unsigned bytes) {
  std::memcpy(dst, src, bytes);
}
inline void bulk_commit() {}
inline void bulk_wait_read() {}
inline void bulk_wait() {}
inline void fence_async_shared() {}
inline void __pipeline_wait_prior(size_t) {}
inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v);
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_or(v);
}

template <class A, class B> inline auto min(A a, B b) {
  using C = std::common_type_t<A, B>;
  return static_cast<C>(a) < static_cast<C>(b) ? static_cast<C>(a) : static_cast<C>(b);
}
template <class A, class B> inline auto max(A a, B b) {
  using C = std::common_type_t<A, B>;
  return static_cast<C>(a) > static_cast<C>(b) ? static_cast<C>(a) : static_cast<C>(b);
}

inline double __dmul_rn(double a, double b) {
  volatile double r = a * b;
  return r;
}
inline double __dadd_rn(double a, double b) {
  volatile double r = a + b;
  return r;
}
inline double __dsub_rn(double a, double b) {
  volatile double r = a - b;
  return r;
}
inline double __ddiv_rn(double a, double b) {
  volatile double r = a / b;
  return r;
}
inline float __fmul_rn(float a, float b) {
  volatile float r = a * b;
  return r;
}
inline float __fadd_rn(float a, float b) {
  volatile float r = a + b;
  return r;
}
inline float __fsub_rn(float a, float b) {
  volatile float r = a - b;
  return r;
}
inline float __fdiv_rn(float a, float b) {
  volatile float r = a / b;
  return r;
}
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
}
template <class T> inline T __ldg(const T* p) { return *p; }
inline double __dsqrt_rn(double a) { return std::sqrt(a); }
inline int __double2int_rz(double d) {
  if (d != d) return 0;
  if (d >= 2147483647.0) return INT_MAX;
  if (d <= -2147483648.0) return INT_MIN;
  return static_cast<int>(d);
}

inline cudaError_t cudaGetLastError() {
  int e = shim_last_error;
  shim_last_error = 0;
  return e;
}
template <class F> inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int v) {
  if (v > 227 * 1024) return cudaErrorInvalidValue;
  shim_max_dyn = v;
  return cudaSuccess;
}
inline int shim_occupancy = 3;
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = shim_occupancy;
  return cudaSuccess;
}

inline void shim_launch(int blocks, int threads, size_t smem, std::function<void()> fn) {
  if (smem > shim_max_dyn || threads > 1024 || threads % 32) {
    shim_last_error = cudaErrorInvalidValue;
    return;
  }
  std::vector<unsigned char> dyn(smem + 16, 0xcd);
  for (int b = 0; b < blocks; ++b) {
    ShimBlock blk;
    blk.bar = std::make_unique<std::barrier<>>(threads);
    for (int w = 0; w < threads / 32; ++w) blk.warps.push_back(std::make_unique<ShimWarp>());
    shim_dyn = dyn.data();
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t) {
      ts.emplace_back([&, t, b] {
        threadIdx.x = t; blockIdx.x = b; blockDim.x = threads; gridDim.x = blocks;
        shim_block = &blk;
        fn();
      });
    }
    for (auto& th : ts) th.join();
  }
}
"""


def build(name: str, directory, signatures: dict) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built for the host into ``directory`` with the
    C entry points of ``signatures`` typed; skips the test without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's source for the host")
    with open(os.path.join(CSRC, f"{name}.cu")) as f:
        src = f.read()
    src = src.replace("#include <cuda_runtime.h>", '#include "shim.h"')
    src = src.replace("#include <cuda_pipeline_primitives.h>", "")
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?([\w: ]+?) "
                 r"(\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(shim_dyn);", src)
    src, n = re.subn(r"(\w+(?:<[\w, ]*>)?)<<<([^,]+),\s*([^,]+),\s*([^,]+),"
                     r"\s*(.*?)>>>"
                     r"\((.*?)\);",
                     r"shim_launch(\2, \3, \4, [&] { \1(\6); });", src,
                     flags=re.S)
    assert n >= 1, f"csrc/{name}.cu has no launch to rewrite"
    d = str(directory)
    with open(os.path.join(d, "shim.h"), "w") as f:
        f.write(HOST_SHIM)
    with open(os.path.join(d, f"{name}.cpp"), "w") as f:
        f.write(src)
    so = os.path.join(d, f"lib{name}_host.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-pthread", "-w", "-I", d,
                    "-o", so, os.path.join(d, f"{name}.cpp")], check=True,
                   timeout=300)
    lib = ctypes.CDLL(so)
    for fn, (restype, argtypes) in signatures.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = list(argtypes)
    return lib
