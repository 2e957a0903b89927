"""Persisted packed FM-index layout: pack once, mmap forever.

The same on-disk format as the JAX package's index/pack.py (meta.json with
PACK_VERSION, fwd.*/rev.* .npy arrays and the walk's CACHE_K-mer interval
table wcache.npy under <prefix>.pack/), so one pack is read by both
implementations.  The walk engine persists its deeper tables there too,
as wcache{ck}.npy (ops/walk.get_wcache); writing a pack removes them.
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np

from ..core import alphabet as ab

PACK_BLOCK = 128
PACK_VERSION = 3
_CHUNK_ROWS = 1 << 15  # 4M symbols per packing chunk keeps temporaries cache-warm


def pack_symbols(symbols: np.ndarray, block: int = PACK_BLOCK):
    """(blocks i8 [nb,B], ckpt i32 [nb,5], C i32 [6]) for one BWT strand.

    ckpt[i] = per-symbol occ counts strictly before block i; one padding
    block so a query at i == n-1 can gather row (n // B).
    """
    symbols = np.asarray(symbols, dtype=np.int8)
    n = len(symbols)
    assert n < 2**31, "int32 interval space exceeded"
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
    counts = csum[-1]
    C = np.zeros(ab.ALPHABET_SIZE + 1, dtype=np.int32)
    C[1:] = np.cumsum(counts)
    return blocks, ckpt, C


def _dir(prefix: str) -> str:
    return prefix + ".pack"


_SOURCE_EXTS = (".bwt.npz", ".rbwt.npz", ".bwtraw", ".rbwtraw")


def _source_stamp(prefix: str):
    """[(ext, mtime_ns, size)] of the index source artifacts; a rebuilt
    index invalidates the persisted pack."""
    out = []
    for ext in _SOURCE_EXTS:
        p = prefix + ext
        if os.path.exists(p):
            st = os.stat(p)
            out.append([ext, st.st_mtime_ns, st.st_size])
    return out


def save_atomic(path: str, write) -> None:
    """write(fh) into a new file beside path, then rename it over path: a
    process that opens path sees the old file or the whole new one, never
    a part (several processes may pack an index or write its walk tables
    at once on first use)."""
    fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "wb") as fh:
            write(fh)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def save_npy(path: str, a: np.ndarray) -> None:
    save_atomic(path, lambda fh: np.save(fh, a))


def save_pack(prefix: str, fwd_pack, rev_pack, num_strings: tuple[int, int],
              nsyms: tuple[int, int], wcache=None) -> None:
    d = _dir(prefix)
    os.makedirs(d, exist_ok=True)
    # the deeper walk tables (wcache{ck}.npy) belong to the old pack
    for name in os.listdir(d):
        if name.startswith("wcache") and name.endswith(".npy") and name != "wcache.npy":
            os.remove(os.path.join(d, name))
    for tag, (blocks, ckpt, C) in (("fwd", fwd_pack), ("rev", rev_pack)):
        save_npy(os.path.join(d, f"{tag}.blocks.npy"), blocks)
        save_npy(os.path.join(d, f"{tag}.ckpt.npy"), ckpt)
        save_npy(os.path.join(d, f"{tag}.C.npy"), C)
    if wcache is not None:
        save_npy(os.path.join(d, "wcache.npy"), wcache)
    meta = {
        "version": PACK_VERSION,
        "block": PACK_BLOCK,
        "cache_k": None if wcache is None else _cache_k(len(wcache)),
        "num_strings": list(num_strings),
        "num_symbols": list(nsyms),
        "source": _source_stamp(prefix),
    }
    save_atomic(os.path.join(d, "meta.json"),
                lambda fh: fh.write(json.dumps(meta).encode()))


def _cache_k(rows: int) -> int:
    k = 0
    while 4**k < rows:
        k += 1
    return k


def load_pack(prefix: str):
    """mmap-load a persisted pack; None if absent/stale."""
    d = _dir(prefix)
    mp = os.path.join(d, "meta.json")
    if not os.path.exists(mp):
        return None
    with open(mp) as fh:
        meta = json.load(fh)
    if meta.get("version") != PACK_VERSION or meta.get("block") != PACK_BLOCK:
        return None
    if meta.get("source") != _source_stamp(prefix):
        return None  # index was rebuilt since this pack was written
    out = {"meta": meta}
    for tag in ("fwd", "rev"):
        for part in ("blocks", "ckpt", "C"):
            p = os.path.join(d, f"{tag}.{part}.npy")
            if not os.path.exists(p):
                return None
            out[f"{tag}.{part}"] = np.load(p, mmap_mode="r")
    p = os.path.join(d, "wcache.npy")
    out["wcache"] = np.load(p, mmap_mode="r") if os.path.exists(p) else None
    return out


def open_index(prefix: str, device: str | None = "cuda"):
    """(hix, dix) for an index prefix, packing+persisting on first use.

    hix: HostIndexSet over the packed layout, with the pack's CACHE_K-mer
    interval table (``_kmer_cache8``) and its directory (``pack_dir``);
    dix: torch IndexSet on `device`, or None when device is None.
    """
    from . import store
    from .fmindex import FMIndex, IndexSet
    from .host import HostFM, HostIndexSet

    pk = load_pack(prefix)
    if pk is None:
        fwd, rev = store.load_any(prefix)
        fwd_pack = pack_symbols(fwd.symbols)
        rev_pack = pack_symbols(rev.symbols)
        hix = HostIndexSet(
            HostFM.from_pack(*fwd_pack, fwd.num_symbols, fwd.num_strings),
            HostFM.from_pack(*rev_pack, rev.num_symbols, rev.num_strings),
        )
        from ..ops import walk

        hix._kmer_cache8 = walk.build_kmer_caches(hix)
        save_pack(prefix, fwd_pack, rev_pack,
                  (fwd.num_strings, rev.num_strings),
                  (fwd.num_symbols, rev.num_symbols), hix._kmer_cache8)
    else:
        ns = pk["meta"]["num_strings"]
        nsym = pk["meta"]["num_symbols"]
        hix = HostIndexSet(
            HostFM.from_pack(pk["fwd.blocks"], pk["fwd.ckpt"], pk["fwd.C"], nsym[0], ns[0]),
            HostFM.from_pack(pk["rev.blocks"], pk["rev.ckpt"], pk["rev.C"], nsym[1], ns[1]),
        )
        if pk["wcache"] is not None:
            hix._kmer_cache8 = np.asarray(pk["wcache"])
    hix.pack_dir = _dir(prefix)
    dix = None
    if device is not None:
        dix = IndexSet(
            bwt=FMIndex.from_pack(hix.bwt.blocks, hix.bwt.ckpt, hix.bwt.C32,
                                  hix.bwt.n, hix.bwt.num_strings, device),
            rbwt=FMIndex.from_pack(hix.rbwt.blocks, hix.rbwt.ckpt, hix.rbwt.C32,
                                   hix.rbwt.n, hix.rbwt.num_strings, device),
        )
    return hix, dix
