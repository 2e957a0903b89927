"""ops/cuda.py's registry matches the CUDA sources it builds.

Runs without nvcc: the C entries are read from csrc/*.cu.  An entry whose
ctypes signature misses an argument would get it as a 32-bit int (a cut
stream pointer), which only shows on the card.
"""
import os
import re

import pytest

from longreadselfcorrect_tpu_torch.ops import cuda


def c_entries():
    """{entry name: number of parameters} of every extern "C" function."""
    out = {}
    for lib, src in cuda.SOURCES.items():
        with open(os.path.join(cuda.CSRC, src)) as fh:
            text = fh.read()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            out[name] = (lib, len([p for p in params.split(",") if p.strip()]))
    return out


ENTRIES = c_entries()


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_signature_covers_every_argument(entry):
    _, n_params = ENTRIES[entry]
    assert entry in cuda._SIGNATURES
    assert len(cuda._SIGNATURES[entry]) == n_params


@pytest.mark.parametrize("kernel", sorted(cuda.KERNELS))
def test_kernel_entry_is_in_its_library_and_launched_once(kernel):
    """lrsc_<kernel> is a C entry of the kernel's own library (planes.cu
    builds apart from kmer_table.cu), and exactly one wrapper of ops/
    launches it under the kernel's count."""
    entry = f"lrsc_{kernel}"
    assert ENTRIES[entry][0] == cuda.KERNELS[kernel]
    ops = os.path.dirname(cuda.__file__)
    calls = []
    for name in sorted(os.listdir(ops)):
        if name.endswith(".py") and name != "cuda.py":
            with open(os.path.join(ops, name)) as fh:
                calls += [name] * fh.read().count(f'"{entry}"')
    assert len(calls) == 1, calls


def test_every_kernel_has_a_library_and_a_count():
    assert set(cuda.LAUNCHES) == set(cuda.KERNELS)
    assert set(cuda.KERNELS.values()) == set(cuda.SOURCES)
    assert set(cuda._SIGNATURES) == set(ENTRIES)
    for kernel, lib in cuda.KERNELS.items():
        assert any(l == lib for l, _ in ENTRIES.values()), kernel
