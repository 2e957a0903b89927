"""Global alignment scoring for hybrid-correction path ranking.

The reference ranks FM-walk candidates by the banded global alignment
score of stdaln's aln_param_pacbio profile (Thirdparty/stdaln.c:248,
PacBio/SAIPBHybridCTree.cpp:164-215).  The scorer itself is an original
C implementation (native/alnscore.c), verified score-exact against the
reference binary on fuzzed pairs; this module is the ctypes binding with
a pure-python fallback (same recurrence, used when the .so is absent).
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

_NT4 = np.full(256, 4, np.uint8)
for _c, _v in zip(b"AGCT", range(4)):
    _NT4[_c] = _v
    _NT4[_c + 32] = _v

_LIB = None
_MISSING = False


def _lib():
    global _LIB, _MISSING
    if _LIB is None and not _MISSING:
        p = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                         "alnscore.so")
        p = os.path.abspath(p)
        if not os.path.exists(p):
            src = p[:-3] + ".c"
            if os.path.exists(src):  # build on first use
                os.system(f"cc -O2 -shared -fPIC -o {p} {src}")
        if os.path.exists(p):
            _LIB = ctypes.CDLL(p)
            _LIB.aln_global_score.restype = ctypes.c_int
        else:
            _MISSING = True
    return _LIB


def _encode(s: str) -> bytes:
    return _NT4[np.frombuffer(s.encode(), np.uint8)].tobytes()


_SM = np.array([
    [1, -8, -8, -8, -2],
    [-8, 1, -8, -8, -2],
    [-8, -8, 1, -8, -2],
    [-8, -8, -8, 1, -2],
    [-2, -2, -2, -2, -2],
], np.int64)
_NEG = -1073741823


def _score_py(a1, a2, gap_open=1, gap_ext=1, gap_end=0, band=50):
    """Pure-python mirror of native/alnscore.c (tests + fallback)."""
    len1, len2 = len(a1), len(a2)
    if len1 == 0 or len2 == 0:
        return 0
    if len1 > len2:
        b1, b2 = len1 - len2 + band, band
    else:
        b1, b2 = band, len2 - len1 + band
    b1, b2 = min(b1, len1), min(b2, len2)
    M = np.full(len1 + 1, _NEG, np.int64)
    I = np.full(len1 + 1, _NEG, np.int64)
    D = np.full(len1 + 1, _NEG, np.int64)
    M[0] = 0
    for i in range(1, b1):
        D[i] = max(M[i - 1] - gap_open - gap_end, D[i - 1] - gap_end)
    p2_hi = len2 - b2 + 1
    for j in range(1, len2 + 1):
        lo, hi = max(j - b2, 0), min(j + b1 - 1, len1)
        part1, lastrow = j <= b2, j == len2
        part2 = (not part1) and j <= p2_hi
        dext = gap_end if lastrow else gap_ext
        Mn = np.full(len1 + 1, _NEG, np.int64)
        In = np.full(len1 + 1, _NEG, np.int64)
        Dn = np.full(len1 + 1, _NEG, np.int64)
        if part1:
            In[0] = max(M[0] - gap_open - gap_end, I[0] - gap_end)
        mat = _SM[a2[j - 1]]
        for i in range(lo + 1, hi + 1):
            Mn[i] = max(M[i - 1], I[i - 1], D[i - 1]) + mat[a1[i - 1]]
            Dn[i] = max(Mn[i - 1] - gap_open - dext, Dn[i - 1] - dext)
        if hi > lo:
            iv = np.arange(lo + 1, hi)
            In[iv] = np.maximum(M[iv] - gap_open, I[iv]) - gap_ext
            over = j + b1 - 1 > len1
            if hi == len1 and ((part1 and over) or (not part1 and not part2)):
                In[len1] = max(M[len1] - gap_open - gap_end, I[len1] - gap_end)
            elif hi < len1 or part1 or part2:
                In[hi] = _NEG
        M, I, D = Mn, In, Dn
    return int(max(M[len1], I[len1], D[len1]))


def aln_score_pacbio(s1: str, s2: str) -> int:
    """Global alignment score of s1 vs s2 under aln_param_pacbio."""
    lib = _lib()
    a1, a2 = _encode(s1), _encode(s2)
    if lib is not None:
        return lib.aln_global_score(a1, len(s1), a2, len(s2), 1, 1, 0, 50)
    return _score_py(np.frombuffer(a1, np.uint8), np.frombuffer(a2, np.uint8))
