"""Host-side (numpy) FM-index view.

Rank queries over a block-packed BWT, vectorised over arrays of queries.
Semantics mirror SuffixTools/RLBWT.h + BWTAlgorithms.
"""
from __future__ import annotations

import numpy as np

from . import alphabet as ab

class HostFM:
    """One BWT with O(1) vectorised rank queries (numpy).

    Uses the same block-128 packed layout as the device FMIndex (see
    index/pack.py); instances can be built directly from a persisted pack
    without re-scanning the symbol stream.
    """

    def __init__(self, symbols: np.ndarray, num_strings: int):
        from .tables import pack_symbols

        blocks, ckpt, C = pack_symbols(symbols)
        self._init_from(blocks, ckpt, C, len(symbols), num_strings)

    @classmethod
    def from_pack(cls, blocks, ckpt, C, n, num_strings) -> "HostFM":
        self = cls.__new__(cls)
        self._init_from(blocks, ckpt, C, n, num_strings)
        return self

    def _init_from(self, blocks, ckpt, C, n, num_strings):
        self.blocks = blocks
        self.ckpt = ckpt                     # i32 [nb, 5], counts before block
        self.C32 = np.asarray(C, np.int32)   # shared with the device layout
        self.C = self.C32.astype(np.int64)
        self.n = int(n)
        self.num_strings = int(num_strings)
        self.block = blocks.shape[1]
        self.symbols = blocks.reshape(-1)[: self.n]  # view (lazy for mmap)

    # --- rank/LF ---------------------------------------------------------
    def occ(self, sym, idx):
        """occurrences of sym in BWT[0..idx]; vectorised over arrays."""
        sym = np.asarray(sym, dtype=np.int64)
        p = np.asarray(idx, dtype=np.int64) + 1
        q, r = p // self.block, p % self.block
        rows = self.blocks[q]
        hits = (rows == sym[..., None].astype(np.int8)) & (
            np.arange(self.block) < r[..., None]
        )
        return self.ckpt[q, sym].astype(np.int64) + hits.sum(axis=-1, dtype=np.int64)

    def pc(self, sym):
        return self.C[np.asarray(sym, dtype=np.int64)]

    def init_interval(self, sym):
        sym = np.asarray(sym, dtype=np.int64)
        return self.C[sym], self.C[sym + 1] - 1

    def update_interval(self, lower, upper, sym):
        pb = self.pc(sym)
        return pb + self.occ(sym, np.asarray(lower) - 1), pb + self.occ(sym, upper) - 1

    def find_interval(self, word: np.ndarray):
        """Backward search (word processed last char -> first)."""
        word = np.asarray(word, dtype=np.int64)
        lo, hi = self.init_interval(word[..., -1])
        for j in range(word.shape[-1] - 2, -1, -1):
            lo, hi = self.update_interval(lo, hi, word[..., j])
        return lo, hi

    def count_occurrences_both_strands(self, word: np.ndarray) -> int:
        lo1, hi1 = self.find_interval(word)
        lo2, hi2 = self.find_interval(ab.reverse_complement(np.asarray(word, np.int8)))
        return int(np.maximum(hi1 - lo1 + 1, 0) + np.maximum(hi2 - lo2 + 1, 0))


class HostIndexSet:
    """{BWT, RBWT} pair with bi-interval helpers (BWTIndexSet analog)."""

    def __init__(self, bwt: HostFM, rbwt: HostFM):
        self.bwt = bwt
        self.rbwt = rbwt

    def init_bi(self, sym):
        f_lo, f_hi = self.rbwt.init_interval(sym)
        c = np.where(np.asarray(sym) == 0, 0, 5 - np.asarray(sym))
        r_lo, r_hi = self.bwt.init_interval(c)
        return f_lo, f_hi, r_lo, r_hi

    def extend_bi(self, state, sym):
        f_lo, f_hi, r_lo, r_hi = state
        f_lo, f_hi = self.rbwt.update_interval(f_lo, f_hi, sym)
        c = np.where(np.asarray(sym) == 0, 0, 5 - np.asarray(sym))
        r_lo, r_hi = self.bwt.update_interval(r_lo, r_hi, c)
        return f_lo, f_hi, r_lo, r_hi

    @staticmethod
    def bi_freq(state):
        f_lo, f_hi, r_lo, r_hi = state
        return np.maximum(f_hi - f_lo + 1, 0) + np.maximum(r_hi - r_lo + 1, 0)

    @staticmethod
    def bi_valid(state):
        """BiBWTInterval::isValid — BOTH strands valid (BWTInterval.h:84)."""
        f_lo, f_hi, r_lo, r_hi = state
        return (f_lo <= f_hi) & (r_lo <= r_hi)

    def find_bi_interval(self, word: np.ndarray):
        word = np.asarray(word, dtype=np.int64)
        state = self.init_bi(word[..., 0])
        for j in range(1, word.shape[-1]):
            state = self.extend_bi(state, word[..., j])
        return state

    def kmer_freq_table(self, read: np.ndarray, max_k: int):
        """freq/valid for every (k, pos): k in 1..max_k.

        Vectorised incremental expansion over all positions of one read (the
        host analog of ops.scan.kmer_freq_scan, additionally recording every
        intermediate size for the dynamic-kmer logic).

        Returns (freq int64 [max_k+1, L], valid bool [max_k+1, L]); row k is
        the k-mer starting at each position, freq == -1 where fake
        (pos + k > L, KmerFeature.h:62,90), row 0 unused.
        """
        read = np.asarray(read, dtype=np.int64)
        L = len(read)
        freq = np.full((max_k + 1, L), -1, dtype=np.int64)
        valid = np.zeros((max_k + 1, L), dtype=bool)
        state = self.init_bi(read)
        for k in range(1, max_k + 1):
            fake = np.arange(L) + k > L
            freq[k] = np.where(fake, -1, self.bi_freq(state))
            valid[k] = np.where(fake, False, self.bi_valid(state))
            if k == max_k:
                break
            nxt = np.full(L, 0, dtype=np.int64)
            # clamped for k > L (reads shorter than max_k); the JAX copy raises
            nxt[: max(L - k, 0)] = read[k : k + max(L - k, 0)]
            live = np.arange(L) + k < L
            new_state = self.extend_bi(state, np.where(live, nxt, 1))
            state = tuple(np.where(live, n, o) for n, o in zip(new_state, state))
        return freq, valid

