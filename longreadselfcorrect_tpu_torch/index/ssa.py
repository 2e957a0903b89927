"""Sampled suffix array + lexicographic read index.

Host mirror of the reference's SampledSuffixArray (SuffixTools/
SampledSuffixArray.h:27-56): a read-id permutation per lexicographic rank
(the `.sai`) plus an (id, offset) sample at every ``rate``-th BWT row
(SampledSuffixArray.cpp:126, row-sampled).  ``calc_sa`` LF-walks each query
row until it reaches a sampled row or the read's own sentinel, with all
query rows advancing in lockstep as batched numpy rank queries — the
reference walks one row at a time (SampledSuffixArray.cpp:40-66).

On-disk formats are produced by native/fmbuild.cpp ('LRSL' / 'LRSS') or the
pure-python builder (index/build.py BWTData.lex/.ssa).
"""
from __future__ import annotations

import struct

import numpy as np

LEX_MAGIC = 0x4C53524C  # 'LRSL'
SSA_MAGIC = 0x5353524C  # 'LRSS'


def load_lex(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        head = fh.read(12)
        magic, = struct.unpack_from("<I", head, 0)
        if magic != LEX_MAGIC:
            raise ValueError(f"{path}: bad .lex magic {magic:#x}")
        ns, = struct.unpack_from("<Q", head, 4)
        return np.fromfile(fh, dtype=np.uint32, count=ns)


def save_lex(path: str, lex: np.ndarray) -> None:
    with open(path, "wb") as fh:
        fh.write(struct.pack("<IQ", LEX_MAGIC, len(lex)))
        np.asarray(lex, np.uint32).tofile(fh)


def load_ssa_file(path: str) -> tuple[int, int, int, np.ndarray]:
    """-> (rate, num_strings, num_symbols, samples[n,2])."""
    with open(path, "rb") as fh:
        head = fh.read(24)
        magic, rate = struct.unpack_from("<II", head, 0)
        if magic != SSA_MAGIC:
            raise ValueError(f"{path}: bad .ssa magic {magic:#x}")
        ns, nsym = struct.unpack_from("<QQ", head, 8)
        n_samples = nsym // rate + 1
        samples = np.fromfile(fh, dtype=np.uint32, count=2 * n_samples)
        return rate, ns, nsym, samples.reshape(-1, 2)


def save_ssa_file(path: str, rate: int, ns: int, nsym: int, samples: np.ndarray) -> None:
    with open(path, "wb") as fh:
        fh.write(struct.pack("<IIQQ", SSA_MAGIC, rate, ns, nsym))
        np.asarray(samples, np.uint32).tofile(fh)


class SampledSA:
    """Read-id / offset resolution for BWT rows over one HostFM."""

    def __init__(self, fm, lex: np.ndarray, samples: np.ndarray | None = None,
                 rate: int = 64):
        self.fm = fm
        self.lex = np.asarray(lex, np.int64)
        self.samples = None if samples is None else np.asarray(samples, np.int64)
        self.rate = rate

    @staticmethod
    def build(fm) -> "SampledSA":
        """From-BWT fallback (no persisted artifacts): lexico index only;
        lookups walk all the way to the sentinel (still batched)."""
        from .host import build_lexico_index

        return SampledSA(fm, build_lexico_index(fm))

    def lookup_lexo_rank(self, r) -> np.ndarray:
        """Read id of the read with lexicographic rank r (lookupLexoRank)."""
        return self.lex[np.asarray(r, np.int64)]

    def calc_sa(self, rows, max_steps: int = 1 << 20):
        """(read_id, offset) of the suffixes at the given BWT rows.

        Vectorised calcSA (SampledSuffixArray.cpp:40-66): walk LF until a
        non-empty sampled row (answer = sample + steps) or a '$' (answer =
        (lex[occ$-rank], steps)).
        """
        fm = self.fm
        rows = np.atleast_1d(np.asarray(rows, np.int64)).copy()
        steps = np.zeros(len(rows), np.int64)
        ids = np.full(len(rows), -1, np.int64)
        offs = np.zeros(len(rows), np.int64)
        alive = np.ones(len(rows), bool)
        for _ in range(max_steps):
            if not alive.any():
                break
            if self.samples is not None:
                at_sample = alive & (rows % self.rate == 0)
                if at_sample.any():
                    s = self.samples[rows[at_sample] // self.rate]
                    ok = s[:, 0] != 0xFFFFFFFF
                    idx = np.flatnonzero(at_sample)[ok]
                    ids[idx] = s[ok, 0]
                    offs[idx] = s[ok, 1] + steps[idx]
                    alive[idx] = False
            if not alive.any():
                break
            b = fm.symbols[rows].astype(np.int64)
            hit = alive & (b == 0)
            if hit.any():
                lex_rank = fm.occ(np.zeros(hit.sum(), np.int64), rows[hit] - 1)
                ids[hit] = self.lex[lex_rank]
                offs[hit] = steps[hit]
                alive &= ~hit
            step = alive
            if step.any():
                nb = np.where(b == 0, 1, b)
                nrows = fm.pc(nb) + fm.occ(nb, rows - 1)
                rows = np.where(step, nrows, rows)
                steps = np.where(step, steps + 1, steps)
        return ids, offs
