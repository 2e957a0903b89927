"""The walk kernels of csrc/walk.cu, compiled for the host, equal the plain
versions.

No card here: walk.cu is compiled with g++ behind a small CUDA shim (the
header below stands in for cuda_runtime.h).  In the shim the 32 threads of
a warp run as 32 std::threads, each warp collective (ballot, shuffle,
reduce, __syncwarp) is a barrier over an array the warp shares, shared
memory is one buffer per block, and a <<<grid, block, smem, stream>>>
launch runs every thread of the grid.  The C entries are called through
ctypes with CPU pointers, the arguments built by the same functions the
wrappers use (ops/walk.py steps_args, queue_args).  walk_steps (40
supersteps, then on to completion) and walk_queue are held against
walk_steps_plain / walk_queue_plain, every field, tolerance 0 (ints, bools,
labels and f32 error rates that feed compares).
"""
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from longreadselfcorrect_tpu_torch.ops import cuda
from longreadselfcorrect_tpu_torch.ops import walk as tw

from test_torch_walk_prep import index_pair, make_pair, port_tasks
from test_walk import make_tasks

torch.set_num_threads(1)

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
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(16) float4 { float x, y, z, w; };
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaDevAttrMultiProcessorCount = 16 };
using std::max;
using std::min;

namespace shim {
struct Warp {
  std::atomic<int> count{0}, gen{0};
  uint64_t slot[32];
  void barrier() {
    const int g = gen.load(std::memory_order_acquire);
    if (count.fetch_add(1, std::memory_order_acq_rel) == 31) {
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
inline thread_local dim3 tIdx, bIdx, bDim, gDim;
inline thread_local char* smem;
inline thread_local Warp* warp;

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

// run every thread of the grid, a few blocks at a time; the warps of a
// block share its shared memory
inline void launch(dim3 grid, dim3 block, size_t smem_bytes, const std::function<void()>& body) {
  const unsigned nw = (block.x + 31) / 32, per = std::max(1u, 256u / block.x);
  for (unsigned b0 = 0; b0 < grid.x; b0 += per) {
    const unsigned b1 = std::min(grid.x, b0 + per);
    std::vector<std::vector<int4>> mem(b1 - b0, std::vector<int4>(smem_bytes / 16 + 1));
    std::vector<Warp> warps((b1 - b0) * nw);
    std::vector<std::thread> th;
    for (unsigned b = b0; b < b1; ++b)
      for (unsigned t = 0; t < block.x; ++t)
        th.emplace_back([&, b, t] {
          tIdx = dim3(t);
          bIdx = dim3(b);
          bDim = block;
          gDim = grid;
          smem = reinterpret_cast<char*>(mem[b - b0].data());
          warp = &warps[(b - b0) * nw + t / 32];
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
template <class T>
inline T __ldg(const T* p) { return *p; }
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
    """walk.cu with its launches as shim::launch calls and its dynamic
    shared memory as the block's buffer."""
    decl = "extern __shared__ int4 walk_smem[];"
    assert text.count(decl) == 1
    text = text.replace(decl, "int4* walk_smem = reinterpret_cast<int4*>(shim::smem);")
    pat = re.compile(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);", re.S)
    n_launch = len(pat.findall(text))
    assert n_launch >= 4

    def conv(m):
        g, b, sm, _ = _split_top(m.group(2))
        return (f"shim::launch(dim3({g}), dim3({b}), (size_t)({sm}), "
                f"[&] {{ {m.group(1)}({m.group(3)}); }});")
    return pat.sub(conv, text)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is missing: the host build of csrc/walk.cu cannot be made")
    d = tmp_path_factory.mktemp("walk_shim")
    (d / "cuda_runtime.h").write_text(SHIM)
    with open(os.path.join(cuda.CSRC, "walk.cu")) as fh:
        (d / "walk_host.cpp").write_text(host_source(fh.read()))
    so = d / "libwalk_host.so"
    subprocess.run([gxx, "-std=c++20", "-O2", "-fPIC", "-shared", "-pthread",
                    "-ffp-contract=off", "-fno-strict-aliasing", "-I", str(d),
                    "-I", cuda.CSRC, "-o", str(so), str(d / "walk_host.cpp")],
                   check=True, capture_output=True, text=True)
    out = ctypes.CDLL(str(so))
    for fn in ("lrsc_walk_steps", "lrsc_walk_queue"):
        getattr(out, fn).argtypes = cuda._SIGNATURES[fn]
        getattr(out, fn).restype = ctypes.c_int
    return out


@pytest.fixture(scope="module")
def corpora():
    """test_torch_superstep.py's corpus (exact reads of a random genome:
    the walks keep one leaf) and a two-haplotype one (a SNP every 40
    bases: the walks branch up to 32 leaves, end with several results, or
    overflow L = 4 with -200)."""
    rng = np.random.default_rng(5)
    g1 = "".join(rng.choice(list("ACGT"), size=5000))
    g2 = list(g1)
    for j in range(20, len(g2), 40):
        g2[j] = "ACGT"[("ACGT".index(g2[j]) + 1) % 4]
    g2 = "".join(g2)
    reads = []
    for i in range(240):
        p = int(rng.integers(0, len(g1) - 1000))
        reads.append((g1, g2)[i % 2][p : p + 1000])
    haplo = index_pair(reads)
    haplo["tasks"] = make_tasks(reads[::2], None, 12, noisy=True)
    pair = make_pair(33, 6000, 180)
    pair["tasks"] = make_tasks(pair["reads"], None, 12, noisy=True)
    return {"pair": pair, "haplo": haplo}


def host_steps(lib, wx, consts, state, cfg, n):
    red = tw._reduced_empty(state.code.shape[0], cfg, state.code.device)
    info = cuda.int_array([0] * 4)
    rc = lib.lrsc_walk_steps(*tw.steps_args(wx, consts, state, red, cfg, n, on_card=False),
                             info, None)
    assert rc == 0
    assert list(info)[1:3] == [min(tw.lane_smem_bytes(cfg).warps_per_block, cfg.G),
                               -(-cfg.G // list(info)[1])]
    return red


def host_queue(lib, wx, bank, n, cfg, max_steps):
    T = bank.consts.q_len.shape[0]
    out = tw._reduced_empty(T, cfg, bank.consts.q_len.device)
    head = torch.zeros(1, dtype=torch.int32)
    info = cuda.int_array([0] * 4)
    rc = lib.lrsc_walk_queue(*tw.queue_args(wx, bank, out, head, n, cfg, max_steps,
                                            on_card=False), info, None)
    assert rc == 0
    return out


def assert_equal(got, want, fields, what):
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        assert torch.equal(a, b), (what, f, (a != b).nonzero()[:5].tolist())


# (slab, L, KMAX, corpus): each value of each axis in two cases
CASES = [(True, 4, 24, "pair"), (False, 32, 24, "pair"), (False, 4, 19, "haplo"),
         (True, 32, 19, "haplo"), (True, 4, 24, "haplo")]
# gaps of 80 and 95 bases (and 110, 148 on the branching corpus): walks of
# ~100-190 steps
TASKS = {"pair": [0, 5], "haplo": [0, 5, 10, 6]}


@pytest.mark.parametrize("slab,L,kmax,corpus", CASES)
def test_walk_kernels_match_plain(lib, corpora, slab, L, kmax, corpus):
    c = corpora[corpus]
    tasks = port_tasks([c["tasks"][i] for i in TASKS[corpus]])
    cfg = tw.WalkConfig(G=len(tasks), MAXLEN=512, QMAX=512, SLAB=slab, SB=2, L=L,
                        CAND=4 * L, KMAX=kmax, CK=8)
    wx = tw.WalkIndex.build(c["td"], c["th"], ck=8)
    consts, state = tw.build_batch(wx, tasks, cfg, 0.15, 30)
    # 40 supersteps, then on to completion from there: the loaded state
    # carries labels, rings, chains and results of its own
    got, want = tw.clone(state), tw.clone(state)
    for n in (40, 4096):
        rk = host_steps(lib, wx, consts, got, cfg, n)
        rp = tw.walk_steps_plain(wx, consts, want, cfg, n)
        assert_equal(got, want, tw.STATE_FIELDS, f"state after {n}")
        assert_equal(rk, rp, tw.REDUCED_FIELDS, f"reduction after {n}")
    codes = set(rp.code.tolist())
    assert codes <= {1, -1, -2, -3, -200, -300} and 1 in codes, codes
    # the queue: every task, and a max_steps that cuts the longer walks
    bank = tw.build_bank(wx, tasks, cfg, 0.15, 30)
    for max_steps in (4096, 60):
        got_q = host_queue(lib, wx, bank, len(tasks), cfg, max_steps)
        want_q = tw.walk_queue_plain(wx, bank, len(tasks), cfg, max_steps)
        assert_equal(got_q, want_q, tw.REDUCED_FIELDS, f"queue, max_steps {max_steps}")
    assert -900 in want_q.code.tolist()
