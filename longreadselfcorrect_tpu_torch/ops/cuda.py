"""Build, load and count the package's hand-written CUDA kernels.

The sources live in ``csrc/``.  Each ``.cu`` file compiles with ``nvcc``
into its own shared library with a plain C interface, loaded with ctypes,
at first use, under ``build/torch_kernels/<hash of all sources>/`` at the
repository root, so an edit to any source (``rank.cuh`` included) rebuilds.
``build()`` starts one ``nvcc`` per source, all at once.

Each wrapper in ``ops.scan`` / ``ops.seedscan`` / ``ops.walk`` /
``ops.msa_kernels`` adds one to
its entry of ``LAUNCHES`` where it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

# library -> its source; the kernels each library holds
SOURCES = {"kmer_table": "kmer_table.cu", "seedscan": "seedscan.cu",
           "walk": "walk.cu", "msa": "msa.cu", "planes": "planes.cu"}
KERNELS = {
    "kmer_table_full": "kmer_table",
    "kmer_table_wire": "kmer_table",
    "kmer_freq_scan": "kmer_table",
    "plane_rows": "planes",
    "kmer_table_planes": "planes",
    "attributes": "seedscan",
    "scan_automaton": "seedscan",
    "estimate_best": "seedscan",
    "remove_hitchhiking": "seedscan",
    "wcache_level_up": "walk",
    "walk_prep": "walk",
    "walk_steps": "walk",
    "walk_queue": "walk",
    "lf_extract": "msa",
    "banded_fill": "msa",
}

# Every float in the seed phase feeds a compare that must equal the JAX f32
# result bit for bit: IEEE division, no FMA contraction, denormals kept.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-Xptxas", "-v",   # registers, stack frame and spills per kernel, in BUILD_LOGS
]

LAUNCHES = {name: 0 for name in KERNELS}
# library -> the compiler's output of the build this process made
BUILD_LOGS: dict[str, str] = {}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    p = os.path.join(home, "bin", "nvcc")
    if os.path.exists(p):
        return p
    p = shutil.which("nvcc")
    if p is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return p


def source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(CSRC, name), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()[:16]


def _lib_path(lib: str) -> str:
    return os.path.join(BUILD_ROOT, source_hash(), f"lib{lib}.so")


def build(libs=None) -> dict[str, str]:
    """Compile the missing libraries, one nvcc each, all in parallel.

    Returns {library: path}.  Raises with the compiler's output on failure.
    """
    libs = list(SOURCES) if libs is None else list(libs)
    paths = {lib: _lib_path(lib) for lib in libs}
    todo = [lib for lib in libs if not os.path.exists(paths[lib])]
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = []
    for lib in todo:
        out = paths[lib]
        os.makedirs(os.path.dirname(out), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, SOURCES[lib])]
        procs.append((lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc {SOURCES[lib]} failed:\n{log}")
        else:
            BUILD_LOGS[lib] = log
            os.replace(tmp, paths[lib])  # atomic: concurrent builders agree
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# every C entry's arguments, the stream (last) included: an argument
# beyond the list would pass as a 32-bit int
_SIGNATURES = {
    # ... the pyramid's two tables and ck before the reads (full and wire)
    "lrsc_kmer_table_full": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I,
                             _I, _I, _P, _P, _P],
    "lrsc_kmer_table_wire": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I,
                             _I, _I, _P, _P, _P],
    # ... the pyramid as above; the pool is a host int array
    "lrsc_kmer_freq_scan": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I,
                            _P, _I, _P, _P],
    "lrsc_plane_rows": [_P, _P, _I, _P, _P],
    "lrsc_kmer_table_planes": [_P, _P, _I, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I,
                               _P, _P, _P],
    "lrsc_attributes": [_P, _P, _P, _I, _I, _I, _F, _F, _P, _P, _P],
    "lrsc_scan_automaton": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _F, _F, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "lrsc_estimate_best": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "lrsc_remove_hitchhiking": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P, _P],
    # the walk kernels take (pointer array, int array), both in host memory
    "lrsc_wcache_level_up": [_P, _P, _P],
    "lrsc_walk_prep": [_P, _P, _P],
    # ... and a host int[4] that receives the launch geometry
    "lrsc_walk_steps": [_P, _P, _P, _P],
    "lrsc_walk_queue": [_P, _P, _P, _P],
    # the group table is a host int array
    "lrsc_lf_extract": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _I, _P, _I, _I, _P, _P,
                        _P],
    "lrsc_banded_fill": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
}


def library(lib: str) -> ctypes.CDLL:
    """The loaded library `lib`, built first if needed."""
    with _lock:
        if lib not in _libs:
            path = build([lib])[lib]
            cdll = ctypes.CDLL(path)
            for fn, argtypes in _SIGNATURES.items():
                if hasattr(cdll, fn):
                    getattr(cdll, fn).argtypes = argtypes
                    getattr(cdll, fn).restype = ctypes.c_int
            _libs[lib] = cdll
        return _libs[lib]


def launch(kernel: str, fn: str, *args) -> None:
    """Call C entry `fn` of `kernel`'s library on the current stream; raise
    if the launch failed, else count it."""
    cdll = library(KERNELS[kernel])
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(cdll, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")
    LAUNCHES[kernel] += 1


def ptr_array(ptrs) -> ctypes.Array:
    """Host array of device pointers (an argument of the walk kernels)."""
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def int_array(vals) -> ctypes.Array:
    """Host array of ints (an argument of the walk kernels)."""
    return (ctypes.c_int * len(vals))(*(int(v) for v in vals))


def check(kernel: str, t: torch.Tensor, dtype: torch.dtype, shape=None,
          on_card: bool = True) -> int:
    """Validate a kernel argument; returns its data pointer.  on_card=False
    takes a CPU tensor too (the C entries compiled for the host, in the
    tests)."""
    if on_card and not t.is_cuda:
        raise ValueError(f"{kernel}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: tensor must be contiguous")
    return t.data_ptr()
