"""The reference's own FM-index tables, from fmbuild's raw BWT files.

``pack_symbols`` is the block-128 occurrence layout that ``host.HostFM``
reads: the BWT in rows of 128 symbols and, per row, the count of each
symbol before it.  ``build`` makes both strands' tables from
``<prefix>.bwtraw`` / ``<prefix>.rbwtraw`` and saves them as ``.npy`` files
in a directory of their own; ``load`` maps them back, so that several
processes share one copy through the page cache.
"""
from __future__ import annotations

import json
import os
import struct

import numpy as np

from . import alphabet as ab
from .host import HostFM, HostIndexSet

BLOCK = 128
RAW_MAGIC = 0x4253524C   # 'LRSB', native/fmbuild.cpp's raw symbol stream
_CHUNK_ROWS = 1 << 15


def pack_symbols(symbols: np.ndarray, block: int = BLOCK):
    """(blocks i8 [nb, block], ckpt i32 [nb, 5], C i32 [6]) for one strand.

    ckpt[i] counts each symbol strictly before row i; one padding row so
    that a query at n - 1 can read row n // block."""
    symbols = np.asarray(symbols, dtype=np.int8)
    n = len(symbols)
    nb = n // block + 1
    padded = np.empty(nb * block, dtype=np.int8)
    padded[:n] = symbols
    padded[n:] = ab.PAD_RANK
    blocks = padded.reshape(nb, block)
    per = np.empty((nb, ab.ALPHABET_SIZE), dtype=np.int64)
    for r0 in range(0, nb, _CHUNK_ROWS):
        sub = blocks[r0 : r0 + _CHUNK_ROWS]
        for s in range(ab.ALPHABET_SIZE):
            per[r0 : r0 + _CHUNK_ROWS, s] = np.count_nonzero(sub == s, axis=1)
    csum = per.cumsum(axis=0)
    ckpt = np.zeros((nb, ab.ALPHABET_SIZE), dtype=np.int32)
    ckpt[1:] = csum[:-1]
    C = np.zeros(ab.ALPHABET_SIZE + 1, dtype=np.int32)
    C[1:] = np.cumsum(csum[-1])
    return blocks, ckpt, C


def load_raw(path: str) -> tuple[np.ndarray, int]:
    """(symbols int8, number of strings) of an fmbuild raw BWT file."""
    with open(path, "rb") as fh:
        head = fh.read(20)
        magic, = struct.unpack_from("<I", head, 0)
        if magic != RAW_MAGIC:
            raise ValueError(f"{path}: not an fmbuild raw BWT (magic {magic:#x})")
        ns, nsym = struct.unpack_from("<QQ", head, 4)
        symbols = np.fromfile(fh, dtype=np.int8, count=nsym)
    if len(symbols) != nsym:
        raise ValueError(f"{path}: {len(symbols)} symbols, the header says {nsym}")
    return symbols, int(ns)


def build(prefix: str, out_dir: str) -> None:
    """Both strands' tables of the raw BWT at prefix, into out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    meta = {}
    for tag, ext in (("bwt", ".bwtraw"), ("rbwt", ".rbwtraw")):
        symbols, ns = load_raw(prefix + ext)
        blocks, ckpt, C = pack_symbols(symbols)
        np.save(os.path.join(out_dir, f"{tag}.blocks.npy"), blocks)
        np.save(os.path.join(out_dir, f"{tag}.ckpt.npy"), ckpt)
        np.save(os.path.join(out_dir, f"{tag}.C.npy"), C)
        meta[tag] = {"n": len(symbols), "num_strings": ns}
    with open(os.path.join(out_dir, "meta.json"), "w") as fh:
        json.dump(meta, fh)


def load(out_dir: str) -> HostIndexSet:
    """The HostIndexSet over the tables build wrote (memory-mapped)."""
    with open(os.path.join(out_dir, "meta.json")) as fh:
        meta = json.load(fh)
    fms = []
    for tag in ("bwt", "rbwt"):
        arrs = [np.load(os.path.join(out_dir, f"{tag}.{part}.npy"), mmap_mode="r")
                for part in ("blocks", "ckpt", "C")]
        fms.append(HostFM.from_pack(*arrs, meta[tag]["n"], meta[tag]["num_strings"]))
    return HostIndexSet(*fms)
