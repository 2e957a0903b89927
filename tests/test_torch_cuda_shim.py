"""A CUDA shim for g++: the kernels of csrc/*.cu compiled for the host.

No card here, so a kernel source is compiled with g++ behind a small CUDA
shim (the header below stands in for cuda_runtime.h) and its C entries are
called through ctypes with CPU pointers.  In the shim the 32 threads of a
warp run as 32 std::threads, each warp collective (ballot, shuffle,
reduce, __syncwarp) is a barrier over an array the warp shares,
__syncthreads is a barrier over the block, dynamic shared memory is one
buffer per block, a static __shared__ array is a function-local static
(shared by the block when blocks run one at a time: one_block=True), and a
<<<grid, block, smem, stream>>> launch runs every thread of the grid.

build_host() is used by tests/test_torch_walk_shim.py (walk.cu) and
tests/test_torch_kernel_shim.py (seedscan.cu, msa.cu); the test below
checks the shim's own collectives.
"""
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest

from longreadselfcorrect_tpu_torch.ops import cuda

SHIM = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <thread>
#include <type_traits>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) double2 { double x, y; };
inline int4 make_int4(int x, int y, int z, int w) { return int4{x, y, z, w}; }
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return uint4{x, y, z, w};
}
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaDevAttrMultiProcessorCount = 16 };
using std::max;
using std::min;

namespace shim {
// a barrier of n threads
struct Bar {
  std::atomic<int> count{0}, gen{0};
  int n = 32;
  void wait() {
    const int g = gen.load(std::memory_order_acquire);
    if (count.fetch_add(1, std::memory_order_acq_rel) == n - 1) {
      count.store(0, std::memory_order_relaxed);
      gen.store(g + 1, std::memory_order_release);
      gen.notify_all();
      return;
    }
    for (int i = 0; i < 100; ++i) {
      if (gen.load(std::memory_order_acquire) != g) return;
      std::this_thread::yield();
    }
    while (gen.load(std::memory_order_acquire) == g) gen.wait(g, std::memory_order_acquire);
  }
};
struct Warp {
  Bar bar;
  uint64_t slot[32];
  void barrier() { bar.wait(); }
};
inline thread_local dim3 tIdx, bIdx, bDim, gDim;
inline thread_local char* smem;
inline thread_local Warp* warp;
inline thread_local Bar* block;

template <class T>
inline uint64_t bits(T v) {
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  return u;
}
template <class T>
inline T unbits(uint64_t u) {
  T v;
  std::memcpy(&v, &u, sizeof(T));
  return v;
}
// every thread posts v, then reads what thread src(lane) posted
template <class T, class F>
inline T exchange(T v, F src) {
  Warp* w = warp;
  const int ln = tIdx.x & 31;
  w->slot[ln] = bits(v);
  w->barrier();
  const T r = unbits<T>(w->slot[src(ln)]);
  w->barrier();
  return r;
}
template <class F>
inline uint64_t fold(uint64_t v, F f) {
  Warp* w = warp;
  w->slot[tIdx.x & 31] = v;
  w->barrier();
  uint64_t r = f(w->slot);
  w->barrier();
  return r;
}

// run every thread of the grid, a few blocks at a time (one at a time
// under SHIM_ONE_BLOCK, where static shared arrays stand for the block's);
// the warps of a block share its shared memory
inline void launch(dim3 grid, dim3 block_dim, size_t smem_bytes,
                   const std::function<void()>& body) {
  const unsigned nw = (block_dim.x + 31) / 32;
#ifdef SHIM_ONE_BLOCK
  const unsigned per = 1;
#else
  const unsigned per = std::max(1u, 256u / block_dim.x);
#endif
  for (unsigned b0 = 0; b0 < grid.x; b0 += per) {
    const unsigned b1 = std::min(grid.x, b0 + per);
    std::vector<std::vector<int4>> mem(b1 - b0, std::vector<int4>(smem_bytes / 16 + 1));
    std::vector<Warp> warps((b1 - b0) * nw);
    std::vector<Bar> bars(b1 - b0);
    for (auto& b : bars) b.n = (int)block_dim.x;
    std::vector<std::thread> th;
    for (unsigned b = b0; b < b1; ++b)
      for (unsigned t = 0; t < block_dim.x; ++t)
        th.emplace_back([&, b, t] {
          tIdx = dim3(t);
          bIdx = dim3(b);
          bDim = block_dim;
          gDim = grid;
          smem = reinterpret_cast<char*>(mem[b - b0].data());
          warp = &warps[(b - b0) * nw + t / 32];
          block = &bars[b - b0];
          body();
        });
    for (auto& x : th) x.join();
  }
}
}  // namespace shim

#define threadIdx (shim::tIdx)
#define blockIdx (shim::bIdx)
#define blockDim (shim::bDim)
#define gridDim (shim::gDim)

inline void __syncthreads() { shim::block->wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { shim::warp->barrier(); }
inline unsigned __ballot_sync(unsigned, bool p) {
  return (unsigned)shim::fold(p, [](const uint64_t* s) {
    uint64_t r = 0;
    for (int i = 0; i < 32; ++i) r |= (s[i] ? 1ull : 0ull) << i;
    return r;
  });
}
inline bool __any_sync(unsigned m, bool p) { return __ballot_sync(m, p) != 0; }
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  return (unsigned)shim::fold(v, [](const uint64_t* s) {
    uint64_t r = 0;
    for (int i = 0; i < 32; ++i) r |= s[i];
    return r;
  });
}
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  return (unsigned)shim::fold(v, [](const uint64_t* s) {
    uint64_t r = 0;
    for (int i = 0; i < 32; ++i) r += s[i];
    return r & 0xffffffffull;
  });
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  return (unsigned)shim::fold(v, [](const uint64_t* s) {
    uint64_t r = 0;
    for (int i = 0; i < 32; ++i) r = std::max(r, s[i]);
    return r;
  });
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  return shim::exchange(v, [src](int) { return src & 31; });
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int o) {
  return shim::exchange(v, [o](int ln) { return (ln ^ o) & 31; });
}
template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned d) {
  return shim::exchange(v, [d](int ln) { return ln >= (int)d ? ln - (int)d : ln; });
}
template <class T>
inline T __shfl_down_sync(unsigned, T v, unsigned d) {
  return shim::exchange(v, [d](int ln) { return ln + (int)d < 32 ? ln + (int)d : ln; });
}

inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
inline unsigned atomicMin(unsigned* p, unsigned v) {
  std::atomic_ref<unsigned> a(*p);
  unsigned o = a.load();
  while (v < o && !a.compare_exchange_weak(o, v)) {
  }
  return o;
}
inline int atomicMax(int* p, int v) {
  std::atomic_ref<int> a(*p);
  int o = a.load();
  while (v > o && !a.compare_exchange_weak(o, v)) {
  }
  return o;
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
// CUDA's __ldg overloads: arithmetic types but bool, and the vector types
template <class T>
inline T __ldg(const T* p) {
  static_assert((std::is_arithmetic_v<T> && !std::is_same_v<T, bool>) ||
                    std::is_same_v<T, int4> || std::is_same_v<T, uint4> ||
                    std::is_same_v<T, float4>,
                "CUDA has no __ldg for this type");
  return *p;
}
inline unsigned __vcmpeq4(unsigned a, unsigned b) {
  unsigned r = 0;
  for (int i = 0; i < 4; ++i)
    if (((a >> (8 * i)) & 0xff) == ((b >> (8 * i)) & 0xff)) r |= 0xffu << (8 * i);
  return r;
}
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline float __int_as_float(int x) { return shim::unbits<float>((uint64_t)(uint32_t)x); }
inline int __float_as_int(float x) { return (int)(uint32_t)shim::bits(x); }

template <class K>
inline cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
template <class K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 2;
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 2; return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
"""


def _split_top(text):
    """Split at the commas outside parentheses."""
    out, depth, cur = [], 0, ""
    for ch in text:
        depth += (ch == "(") - (ch == ")")
        if ch == "," and depth == 0:
            out.append(cur)
            cur = ""
        else:
            cur += ch
    return out + [cur]


def host_source(text):
    """A .cu source with its launches as shim::launch calls and each
    dynamic shared array as the block's buffer."""
    text, n_dyn = re.subn(r"extern __shared__ (\w+) (\w+)\[\];",
                          r"\1* \2 = reinterpret_cast<\1*>(shim::smem);", text)
    pat = re.compile(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);", re.S)
    assert pat.search(text), "no launch found"

    def conv(m):
        g, b, sm, _ = _split_top(m.group(2))
        return (f"shim::launch(dim3({g}), dim3({b}), (size_t)({sm}), "
                f"[&] {{ {m.group(1)}({m.group(3)}); }});")
    return pat.sub(conv, text)


def build_host(source, directory, entries, one_block=False, text=None):
    """csrc/<source> (or `text`, named `source`) compiled with g++ into
    directory; returns the library with the ctypes signatures of `entries`
    (ops/cuda.py's, or given as {name: argtypes}).  Skips the test without
    g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip(f"g++ is missing: the host build of {source} cannot be made")
    if text is None:
        with open(os.path.join(cuda.CSRC, source)) as fh:
            text = fh.read()
    stem = source[:-3]
    (directory / "cuda_runtime.h").write_text(SHIM)
    (directory / f"{stem}_host.cpp").write_text(host_source(text))
    so = directory / f"lib{stem}_host.so"
    subprocess.run([gxx, "-std=c++20", "-O2", "-fPIC", "-shared", "-pthread",
                    "-ffp-contract=off", "-fno-strict-aliasing",
                    *(["-DSHIM_ONE_BLOCK"] if one_block else []), "-I", str(directory),
                    "-I", cuda.CSRC, "-o", str(so), str(directory / f"{stem}_host.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    sigs = entries if isinstance(entries, dict) else {e: cuda._SIGNATURES[e] for e in entries}
    for fn, argtypes in sigs.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


PROBE = r"""
#include <cuda_runtime.h>
namespace {
// per block of 64 threads: an inclusive warp scan (shfl_up), the warp's
// ballot of odd values, a block total through a static shared array, each
// thread's value read back by another thread through dynamic shared
// memory after a barrier, and the value two lanes up (shfl_down; the last
// two lanes keep their own)
__global__ void probe_kernel(const int* in, int* out) {
  __shared__ int tot[2];
  extern __shared__ int probe_smem[];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int g = blockIdx.x * blockDim.x + t;
  int v = in[g];
  probe_smem[t] = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  const unsigned odd = __ballot_sync(0xffffffffu, in[g] & 1);
  if (lane == 31) tot[w] = v;
  __syncthreads();
  out[5 * g] = v;
  out[5 * g + 1] = (int)odd;
  out[5 * g + 2] = tot[0] + tot[1];
  out[5 * g + 3] = probe_smem[blockDim.x - 1 - t];
  out[5 * g + 4] = __shfl_down_sync(0xffffffffu, in[g], 2);
}
}  // namespace
extern "C" int probe(const int* in, int* out, int blocks, void* stream) {
  probe_kernel<<<blocks, 64, 64 * sizeof(int), (cudaStream_t)stream>>>(in, out);
  return (int)cudaGetLastError();
}
"""


def test_shim_collectives(tmp_path):
    P = ctypes.c_void_p
    lib = build_host("probe.cu", tmp_path, {"probe": [P, P, ctypes.c_int, P]},
                     one_block=True, text=PROBE)
    blocks = 3
    x = np.random.default_rng(0).integers(0, 100, size=64 * blocks).astype(np.int32)
    out = np.zeros((64 * blocks, 5), np.int32)
    assert lib.probe(x.ctypes.data, out.ctypes.data, blocks, None) == 0
    for b in range(blocks):
        blk = x[64 * b : 64 * (b + 1)]
        warps = blk.reshape(2, 32)
        scan = np.cumsum(warps, axis=1).reshape(-1)
        odd = [int(sum(1 << i for i in range(32) if wv[i] & 1)) for wv in warps]
        got = out[64 * b : 64 * (b + 1)]
        assert np.array_equal(got[:, 0], scan)
        assert [np.uint32(o) for o in got[::32, 1]] == [np.uint32(o) for o in odd]
        assert (got[:, 2] == blk.sum()).all()
        assert np.array_equal(got[:, 3], blk[::-1])
        down = np.concatenate([np.concatenate([wv[2:], wv[30:]]) for wv in warps])
        assert np.array_equal(got[:, 4], down)
