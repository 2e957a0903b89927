"""Copies of the port's CUDA sources built side by side on one card: the
helpers the tools/prof_*.py scripts share.

A variant is a directory under build/ holding some of csrc/'s sources (or
another checkout's) after text edits; `build` runs one nvcc per (variant,
source), all at once, prints each build's ptxas line for the kernels asked
for and binds the C entries with the package's ctypes signatures.
"""
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def say(**kw):
    print(json.dumps(kw), flush=True)


def device_ms(fn, reps=7):
    """Median device time of fn's kernels (chip_smoke.device_ms: events
    queued behind a sleep kernel, so no host time is in it)."""
    return round(cs.device_ms(fn, reps=reps), 4)


def variant(out, name, sources, edits, csrc=None):
    """out/<name>/ holding those of `sources` that csrc (default: the
    package's csrc/) has, after the edits ((file, old, new), each old
    present)."""
    if csrc is None:
        from longreadselfcorrect_tpu_torch.ops import cuda

        csrc = cuda.CSRC
    d = os.path.join(out, name)
    os.makedirs(d, exist_ok=True)
    for f in sources:
        if not os.path.exists(os.path.join(csrc, f)):
            assert not any(ef == f for ef, _, _ in edits), (name, f)
            continue
        with open(os.path.join(csrc, f)) as fh:
            text = fh.read()
        for ef, old, new in edits:
            if ef == f:
                assert old in text, (name, f, old)
                text = text.replace(old, new)
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    return d


def build(specs, kernels, entries):
    """{(name, source): CDLL} for specs of (name, directory, source): one
    nvcc each, all at once.  Prints the ptxas line of each build's kernels
    named in `kernels` (template arguments aside) and binds those of the C
    `entries` the library exports."""
    from longreadselfcorrect_tpu_torch.ops import cuda

    procs = []
    for name, d, src in specs:
        out = os.path.join(d, src.replace(".cu", ".so"))
        procs.append((name, src, out, subprocess.Popen(
            [cuda.nvcc_path(), *cuda.NVCC_FLAGS, "-I", d, "-o", out, os.path.join(d, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, src, out, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc {name}/{src} failed:\n{log[-3000:]}")
        say(ptxas=f"{name}/{src}",
            kernels=[r for r in cs.ptxas_report(log) if r[0].split("<")[0] in kernels])
        lib = ctypes.CDLL(out)
        for fn in entries:
            if hasattr(lib, fn):
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = cuda._SIGNATURES[fn]
        libs[(name, src)] = lib
    return libs
