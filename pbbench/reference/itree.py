"""Centered interval tree, ported with identical construction and traversal
order to PacBio/IntervalTree.{h,cpp} — the result ORDER of findOverlapping
feeds tie-breaks in seed-support matching, so it must match.

Note findOverlapping(start, stop) here returns intervals that *contain* the
query range (IntervalTree.cpp:80), which is what leaf-interval ⊆ seed-interval
containment checks need.
"""
from __future__ import annotations


class ITree:
    __slots__ = ("intervals", "left", "right", "center")

    def __init__(self, ivals, depth=16, minbucket=8, leftextent=0, rightextent=0):
        """ivals: list of (start, stop, value) tuples."""
        self.intervals = []
        self.left = None
        self.right = None
        self.center = 0
        if leftextent == 0 and rightextent == 0:
            # std::sort with greater<interval> -> start descending; starts are
            # the SA-interval lower bounds (ties possible for repeated kmers --
            # python's stable sort fixes an order; std::sort is unstable there)
            ivals = sorted(ivals, key=lambda t: t[0], reverse=True)
        depth -= 1
        if depth == 0 or len(ivals) < minbucket:
            self.intervals = list(ivals)
            return
        leftp = ivals[-1][0]
        rightp = max(ivals, key=lambda t: t[1])[1]
        centerp = ivals[len(ivals) >> 1][0]
        self.center = centerp
        lefts, rights = [], []
        for iv in ivals:
            if iv[1] < self.center:
                lefts.append(iv)
            elif iv[0] > self.center:
                rights.append(iv)
            else:
                self.intervals.append(iv)
        if lefts:
            self.left = ITree(lefts, depth, minbucket, leftp, centerp)
        if rights:
            self.right = ITree(rights, depth, minbucket, centerp, rightp)

    def find_overlapping(self, start, stop, out=None):
        """All stored intervals with iv.start <= start and iv.stop >= stop,
        in the reference's traversal order."""
        if out is None:
            out = []
        if self.intervals and not (stop < self.intervals[-1][0]):
            for iv in self.intervals:
                if iv[0] <= start and iv[1] >= stop:
                    out.append(iv)
        if self.left is not None and start < self.center:
            self.left.find_overlapping(start, stop, out)
        if self.right is not None and stop > self.center:
            self.right.find_overlapping(start, stop, out)
        return out


def make_tree(ivals):
    """Construct a tree; empty input gives an always-empty tree."""
    if not ivals:
        t = ITree.__new__(ITree)
        t.intervals, t.left, t.right, t.center = [], None, None, 0
        return t
    return ITree(ivals)
