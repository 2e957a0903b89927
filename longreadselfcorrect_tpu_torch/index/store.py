"""Native on-disk index format + reference .bwt loader.

Our native format stores the raw BWT symbol streams as an .npz; the packed
device layout is rebuilt at load (cheap).  A loader for the reference's
binary RLBWT format (SuffixTools/BWTReaderBinary, magic 0xCACA) keeps
artifact-level compatibility with `stride index` outputs.
"""
from __future__ import annotations

import struct

import numpy as np

from .build import BWTData

NATIVE_SUFFIX = ".bwt.npz"
RNATIVE_SUFFIX = ".rbwt.npz"

# reference binary format (SuffixTools/BWTReader.h:27-34, BWTWriterBinary.cpp:
# writeHeader): u16 magic, u64 numStrings, u64 numSymbols, u64 numRuns,
# i32 flag; then run bytes (RLUnit: symbol in HIGH 3 bits, count in LOW 5,
# SuffixTools/RLUnit.h:12-23)
RLBWT_FILE_MAGIC = 0xCACA
BWT_FILE_MAGIC = 0xEFEF
_HEADER_FMT = "<HQQQi"
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)  # 2+8+8+8+4 = 30 (packed)


def save_native(path_prefix: str, fwd: BWTData, rev: BWTData) -> None:
    np.savez_compressed(
        path_prefix + NATIVE_SUFFIX, symbols=fwd.symbols, num_strings=fwd.num_strings
    )
    np.savez_compressed(
        path_prefix + RNATIVE_SUFFIX, symbols=rev.symbols, num_strings=rev.num_strings
    )
    # persist SA side-products when the builder had them (python build path;
    # fmbuild writes its own .lex/.ssa) — the reference's .sai/.ssa artifacts
    from . import ssa as ssa_mod
    from .build import SSA_SAMPLE_RATE

    for data, lex_sfx, ssa_sfx in ((fwd, ".lex", ".ssa"), (rev, ".rlex", ".rssa")):
        if data.lex is not None:
            ssa_mod.save_lex(path_prefix + lex_sfx, data.lex)
        if data.ssa is not None:
            ssa_mod.save_ssa_file(
                path_prefix + ssa_sfx, SSA_SAMPLE_RATE, data.num_strings,
                data.num_symbols, data.ssa,
            )


def load_native(path: str) -> BWTData:
    z = np.load(path)
    symbols = z["symbols"]
    return BWTData(
        symbols=symbols, num_strings=int(z["num_strings"]), num_symbols=len(symbols)
    )


def load_reference_bwt(path: str) -> BWTData:
    """Read a `stride index` .bwt/.rbwt file (binary RLBWT runs)."""
    with open(path, "rb") as fh:
        data = fh.read()
    magic, num_strings, num_symbols, num_runs, _flag = struct.unpack_from(_HEADER_FMT, data, 0)
    if magic != RLBWT_FILE_MAGIC:
        raise ValueError(f"{path}: unexpected magic {magic:#x} (want RLBWT 0xCACA)")
    runs = np.frombuffer(data, dtype=np.uint8, offset=_HEADER_SIZE, count=num_runs)
    syms = (runs >> 5).astype(np.int8)
    lens = (runs & 0x1F).astype(np.int64)
    symbols = np.repeat(syms, lens)
    if len(symbols) != num_symbols:
        raise ValueError(
            f"{path}: run expansion produced {len(symbols)} symbols, header says {num_symbols}"
        )
    return BWTData(symbols=symbols, num_strings=int(num_strings), num_symbols=int(num_symbols))


def save_reference_bwt(path: str, bwt: BWTData) -> None:
    """Write the reference's binary RLBWT format (byte-compatible artifact)."""
    symbols = bwt.symbols.astype(np.int8)
    # run-length encode with the 31-count cap (RLUnit RL_FULL_COUNT)
    change = np.flatnonzero(np.diff(symbols)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(symbols)]])
    run_syms = []
    run_lens = []
    for s, e in zip(starts, ends):
        n = e - s
        sym = int(symbols[s])
        while n > 31:
            run_syms.append(sym)
            run_lens.append(31)
            n -= 31
        run_syms.append(sym)
        run_lens.append(n)
    runs = (np.array(run_syms, dtype=np.uint8) << 5) | np.array(run_lens, dtype=np.uint8)
    with open(path, "wb") as fh:
        fh.write(struct.pack(_HEADER_FMT, RLBWT_FILE_MAGIC, bwt.num_strings,
                             bwt.num_symbols, len(runs), 0))
        fh.write(runs.tobytes())


RAW_MAGIC = 0x4253524C  # 'LRSB' — native/fmbuild.cpp raw symbol stream


def load_raw(path: str) -> BWTData:
    """Read a native/fmbuild .bwtraw/.rbwtraw file."""
    with open(path, "rb") as fh:
        data = fh.read()
    magic, = struct.unpack_from("<I", data, 0)
    if magic != RAW_MAGIC:
        raise ValueError(f"{path}: bad magic {magic:#x}")
    ns, nsym = struct.unpack_from("<QQ", data, 4)
    symbols = np.frombuffer(data, dtype=np.int8, offset=20, count=nsym)
    return BWTData(symbols=symbols, num_strings=int(ns), num_symbols=int(nsym))


def fmbuild_path() -> str | None:
    """Locate the compiled native builder (built via native/Makefile)."""
    import os

    p = os.path.join(os.path.dirname(__file__), "..", "..", "native", "fmbuild")
    p = os.path.abspath(p)
    return p if os.path.exists(p) else None


def build_with_fmbuild(reads_file: str, prefix: str) -> tuple[BWTData, BWTData]:
    """Run the native SA-IS builder on a FASTA/FASTQ file."""
    import subprocess

    exe = fmbuild_path()
    if exe is None:
        raise FileNotFoundError("native/fmbuild not built (run make -C native)")
    subprocess.run([exe, reads_file, prefix], check=True)
    return load_raw(prefix + ".bwtraw"), load_raw(prefix + ".rbwtraw")


def load_any(path_prefix: str):
    """Load {bwt, rbwt}: native .npz, fmbuild .bwtraw, or reference binaries."""
    import os

    if os.path.exists(path_prefix + NATIVE_SUFFIX):
        return (
            load_native(path_prefix + NATIVE_SUFFIX),
            load_native(path_prefix + RNATIVE_SUFFIX),
        )
    if os.path.exists(path_prefix + ".bwtraw"):
        return load_raw(path_prefix + ".bwtraw"), load_raw(path_prefix + ".rbwtraw")
    return (
        load_reference_bwt(path_prefix + ".bwt"),
        load_reference_bwt(path_prefix + ".rbwt"),
    )


def load_sampled_sa(path_prefix: str, fm, reverse: bool = False):
    """SampledSA for the forward (or reverse) BWT at this prefix.

    Prefers persisted .lex/.ssa artifacts (fmbuild / python builder); falls
    back to rebuilding the lexico index from the BWT (batched LF walks).
    """
    import os

    from . import ssa as ssa_mod

    lex_p = path_prefix + (".rlex" if reverse else ".lex")
    ssa_p = path_prefix + (".rssa" if reverse else ".ssa")
    if os.path.exists(lex_p):
        lex = ssa_mod.load_lex(lex_p)
        samples = rate = None
        if os.path.exists(ssa_p):
            rate, _, _, samples = ssa_mod.load_ssa_file(ssa_p)
        return ssa_mod.SampledSA(fm, lex, samples, rate or 64)
    return ssa_mod.SampledSA.build(fm)
