"""Batched rank / LF-mapping primitives in plain torch.

The plain counterparts of the JAX package's ops/rank.py:

* ``occ``             ~ RLBWT::getOcc           (SuffixTools/RLBWT.h:121)
* ``occ_all``         ~ RLBWT::getFullOcc       (SuffixTools/RLBWT.h:143)
* ``update_interval`` ~ BWTAlgorithms::updateInterval (BWTAlgorithms.h:66-72)
* ``extend_bi``       ~ BWTAlgorithms::updateBiInterval (BWTAlgorithms.h:73-77)

Every function is vectorised over arbitrary leading batch dimensions and
works on any device; the hand-written kernels carry the same rank as a
``__device__`` function (csrc/rank.cuh).  An interval (lower, upper) is
invalid when lower > upper, and invalidity is sticky under the update math.
Row indices are clamped into the table as a JAX gather clamps them.
"""
from __future__ import annotations

import torch

from ..index.fmindex import FMIndex, IndexSet

I32 = torch.int32


def comp(sym: torch.Tensor) -> torch.Tensor:
    """Rank-space complement: $->$, A<->T, C<->G (comp(b) = 5-b for bases)."""
    return torch.where(sym == 0, torch.zeros_like(sym), 5 - sym)


class RowTracker:
    """Marks the index rows that rank queries read while it is active::

        with RowTracker(ix) as rt:
            ...                  # plain versions
        rt.rows                  # distinct rows of ix read
        rt.queries               # rank queries made

    The rows a kernel making the same queries must move (a measuring aid;
    the plain versions only)."""

    active: "RowTracker | None" = None

    def __init__(self, ix: IndexSet):
        self.seen = {id(fm): torch.zeros(fm.blocks.shape[0], dtype=torch.bool,
                                         device=fm.blocks.device)
                     for fm in (ix.rbwt, ix.bwt)}
        self.queries = 0

    def __enter__(self) -> "RowTracker":
        RowTracker.active = self
        return self

    def __exit__(self, *exc) -> None:
        RowTracker.active = None

    def mark(self, fm: FMIndex, q: torch.Tensor) -> None:
        seen = self.seen.get(id(fm))
        if seen is not None:
            seen[q.reshape(-1)] = True
            self.queries += q.numel()

    @property
    def rows(self) -> int:
        return sum(int(m.sum()) for m in self.seen.values())


def _row(fm: FMIndex, idx: torch.Tensor):
    """(q, r): the block row and in-block prefix length of BWT[0..idx]."""
    p = idx.to(I32) + 1
    q = torch.div(p, fm.block, rounding_mode="floor")
    r = p - q * fm.block
    q = q.clamp(0, fm.blocks.shape[0] - 1).long()
    if RowTracker.active is not None:
        RowTracker.active.mark(fm, q)
    return q, r


def occ(fm: FMIndex, sym: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """#occurrences of ``sym`` in BWT[0..idx] inclusive; idx == -1 -> 0."""
    q, r = _row(fm, idx)
    rows = fm.blocks[q]                                # [..., block] gather
    lane = torch.arange(fm.block, device=rows.device, dtype=I32)
    hits = (rows == sym.to(torch.int8)[..., None]) & (lane < r[..., None])
    base = fm.ckpt[q, sym.long().clamp(0, fm.ckpt.shape[1] - 1)]
    return base + hits.sum(dim=-1, dtype=I32)


def occ_all(fm: FMIndex, idx: torch.Tensor) -> torch.Tensor:
    """AlphaCount over all 5 rank symbols of BWT[0..idx]; shape [..., 5]."""
    q, r = _row(fm, idx)
    rows = fm.blocks[q]                                # [..., block]
    lane = torch.arange(fm.block, device=rows.device, dtype=I32)
    in_prefix = lane < r[..., None]
    syms = torch.arange(5, device=rows.device, dtype=torch.int8)
    hits = (rows[..., None] == syms) & in_prefix[..., None]
    return fm.ckpt[q] + hits.sum(dim=-2, dtype=I32)


def pc(fm: FMIndex, sym: torch.Tensor) -> torch.Tensor:
    """getPC: #symbols lexicographically smaller than sym."""
    return fm.C[sym.long()]


def init_interval(fm: FMIndex, sym: torch.Tensor):
    """Interval of all suffixes starting with sym."""
    s = sym.long()
    return fm.C[s], fm.C[s + 1] - 1


def update_interval(fm: FMIndex, lower: torch.Tensor, upper: torch.Tensor,
                    sym: torch.Tensor):
    """LF step: interval of S -> interval of (sym)S."""
    pb = pc(fm, sym)
    return pb + occ(fm, sym, lower - 1), pb + occ(fm, sym, upper) - 1


def interval_size(lower: torch.Tensor, upper: torch.Tensor) -> torch.Tensor:
    """getFreq: interval size, 0 when invalid (BWTInterval.h:27-29)."""
    return (upper - lower + 1).clamp(min=0).to(I32)


# Bidirectional (both-strand) intervals over the {BWT, RBWT} pair: for a
# word W, fwd = interval of reverse(W) in the RBWT and rvc = interval of
# revcomp(W) in the BWT; appending base b updates fwd with b on the RBWT and
# rvc with comp(b) on the BWT (KmerFeature.h:92-99).

def init_bi(ix: IndexSet, sym: torch.Tensor):
    f_lo, f_hi = init_interval(ix.rbwt, sym)
    r_lo, r_hi = init_interval(ix.bwt, comp(sym))
    return f_lo, f_hi, r_lo, r_hi


def extend_bi(ix: IndexSet, state, sym: torch.Tensor):
    f_lo, f_hi, r_lo, r_hi = state
    f_lo, f_hi = update_interval(ix.rbwt, f_lo, f_hi, sym)
    r_lo, r_hi = update_interval(ix.bwt, r_lo, r_hi, comp(sym))
    return f_lo, f_hi, r_lo, r_hi


def bi_freq(state) -> torch.Tensor:
    f_lo, f_hi, r_lo, r_hi = state
    return interval_size(f_lo, f_hi) + interval_size(r_lo, r_hi)
