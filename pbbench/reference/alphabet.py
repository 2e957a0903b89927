"""DNA alphabet encodings for the FM-index rank space.

Rank alphabet follows the reference convention (Util/Alphabet.h:39
``RANK_ALPHABET = {'$','A','C','G','T'}``): rank 0 is the string terminator,
A..T are ranks 1..4.  All device tensors carry symbols in this rank space as
int8 (an out-of-alphabet pad value PAD_RANK=5 marks padding).
"""
from __future__ import annotations

import numpy as np

DOLLAR = 0
A, C, G, T = 1, 2, 3, 4
ALPHABET_SIZE = 5       # $ACGT
DNA_SIZE = 4            # ACGT
PAD_RANK = 5            # padding symbol outside the rank alphabet

RANK_TO_CHAR = np.frombuffer(b"$ACGTN", dtype=np.uint8)

_CHAR_TO_RANK = np.zeros(256, dtype=np.int8)
for i, ch in enumerate(b"$ACGT"):
    _CHAR_TO_RANK[ch] = i
for i, ch in enumerate(b"$acgt"):
    _CHAR_TO_RANK[ch] = i

# complement in rank space: $->$, A<->T, C<->G.  comp(b) = 5-b for ACGT
# (matches BWT_ALPHABET::getChar(5-i) usage in LongReadCorrectByOverlap.cpp:695).
_COMP = np.array([DOLLAR, T, G, C, A, PAD_RANK], dtype=np.int8)


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII DNA string -> int8 rank array."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _CHAR_TO_RANK[np.frombuffer(seq, dtype=np.uint8)].copy()


def decode(ranks: np.ndarray) -> str:
    """int8 rank array -> ASCII DNA string (pads rendered as N)."""
    return RANK_TO_CHAR[np.asarray(ranks, dtype=np.int64)].tobytes().decode()


def complement(ranks: np.ndarray) -> np.ndarray:
    return _COMP[np.asarray(ranks, dtype=np.int64)]


def reverse_complement(ranks: np.ndarray) -> np.ndarray:
    return complement(ranks)[::-1].copy()


def revcomp_str(seq: str) -> str:
    return decode(reverse_complement(encode(seq)))
