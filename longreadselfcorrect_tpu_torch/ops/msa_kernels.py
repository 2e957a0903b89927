"""The MSA/DP fallback's two device loops (the JAX package's ops/msa_kernels.py).

* ``lf_extract``  — batched LF-walk string extraction across SA rows, the
  device form of retrieveStr's per-row per-base loop
  (PacBio/LongReadOverlap.cpp:700-751).  All rows advance together; a row
  that reaches '$' parks.  ``lf_extract_groups`` runs up to MAX_GROUPS
  such extractions, each on either BWT of one IndexSet with its own step
  count, as one launch: a multiple alignment's four.
* ``banded_fill`` — the banded DP cell fill of Overlapper::extendMatch
  (Thirdparty/overlapper.cpp:421-620) for N (query, candidate) lanes with
  their own band origins.  The fill is integer-exact: the host backtrack
  (core/overlapper.extend_match) reads the downloaded cells.

``lf_extract``, ``lf_extract_groups`` and ``banded_fill`` take and return
numpy, as the JAX wrappers do; ``lf_extract`` is one group of
``lf_extract_groups``.  ``lf_extract_groups_tensors`` /
``banded_fill_tensors`` launch csrc/msa.cu for CUDA tensors and run the
plain versions ``lf_extract_groups_plain`` / ``banded_fill_plain`` for CPU
tensors; ``lf_extract_plain`` is one group's plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from ..index.fmindex import FMIndex, IndexSet
from . import cuda, rank

I32 = torch.int32
I8 = torch.int8
INVALID = -(1 << 30)
MAX_GROUPS = 4          # extractions per lf_extract launch
STRANDS = ("bwt", "rbwt")  # a group's index: 0 = ix.bwt, 1 = ix.rbwt


# ---------------------------------------------------------------------------
# lf_extract
# ---------------------------------------------------------------------------

def lf_extract_plain(fm: FMIndex, roots: torch.Tensor, max_steps: int):
    """(mat int8 [N, max_steps], lens int32 [N]) in plain torch: the next
    <= max_steps symbols reached by LF from each BWT row, 0 after '$'."""
    N = roots.shape[0]
    idx = roots.to(I32)
    mat = torch.zeros((N, max_steps), dtype=I8, device=roots.device)
    alive = torch.ones(N, dtype=torch.bool, device=roots.device)
    flat = fm.blocks.reshape(-1)
    for step in range(max_steps):
        b = flat[idx.long()].to(I32)
        alive = alive & (b != 0)
        if not bool(alive.any()):
            break
        mat[:, step] = torch.where(alive, b, 0).to(I8)
        nxt = rank.pc(fm, b) + rank.occ(fm, b, idx - 1)
        idx = torch.where(alive, nxt, idx)
    return mat, (mat != 0).sum(dim=1, dtype=I32)


def lf_extract_groups_plain(ix, roots: torch.Tensor, group: torch.Tensor, table):
    """(mat int8 [N, S], lens int32 [N]) in plain torch, S the largest
    max_steps of `table`: row n is lf_extract_plain of its group's index
    and max_steps (table[group[n]] = (index 0 bwt / 1 rbwt, max_steps)),
    zero past them."""
    N = roots.shape[0]
    S = max(steps for _, steps in table)
    mat = torch.zeros((N, S), dtype=I8, device=roots.device)
    lens = torch.zeros(N, dtype=I32, device=roots.device)
    for g, (which, steps) in enumerate(table):
        sel = (group == g).nonzero()[:, 0]
        if sel.numel():
            m, l = lf_extract_plain(getattr(ix, STRANDS[which]), roots[sel], steps)
            mat[sel, :steps] = m
            lens[sel] = l
    return mat, lens


def lf_extract_args(fm0: FMIndex, fm1: FMIndex, roots, group, table, mat, lens,
                    on_card: bool = True) -> list:
    """lrsc_lf_extract's arguments, the stream aside: the two indexes a
    group can name, the rows and their groups, the group table as a host
    int array, the outputs.  on_card=False takes CPU tensors (the kernel
    compiled for the host, in the tests)."""
    name = "lf_extract"
    N, S = mat.shape
    if not 1 <= len(table) <= MAX_GROUPS:
        raise ValueError(f"{name}: takes 1 to {MAX_GROUPS} groups, got {len(table)}")
    args = []
    for fm in (fm0, fm1):
        if fm.block != 128:
            raise ValueError(f"{name}: the kernel takes 128-symbol blocks, got {fm.block}")
        if fm.blocks.data_ptr() % 16:
            raise ValueError(f"{name}: blocks must be 16-byte aligned")
        nb = fm.blocks.shape[0]
        args += [cuda.check(name, fm.blocks, I8, (nb, 128), on_card),
                 cuda.check(name, fm.ckpt, I32, (nb, 5), on_card),
                 cuda.check(name, fm.C, I32, (6,), on_card), nb]
    return args + [cuda.check(name, roots, I32, (N,), on_card),
                   cuda.check(name, group, I8, (N,), on_card), N,
                   cuda.int_array([v for row in table for v in row]), len(table), S,
                   cuda.check(name, mat, I8, (N, S), on_card),
                   cuda.check(name, lens, I32, (N,), on_card)]


def lf_extract_groups_tensors(ix, roots: torch.Tensor, group: torch.Tensor, table):
    """lf_extract_groups_plain's contract on roots' device: roots int32
    [N], group int8 [N] (< len(table)), table [(index, max_steps >= 1)].
    CUDA tensors launch the kernel once; CPU tensors take the plain
    version."""
    if roots.device != ix.device:
        raise ValueError(f"lf_extract: roots on {roots.device}, index on {ix.device}")
    if not roots.is_cuda:
        return lf_extract_groups_plain(ix, roots, group, table)
    N = roots.shape[0]
    S = max(steps for _, steps in table)
    mat = torch.empty((N, S), dtype=I8, device=roots.device)
    lens = torch.empty(N, dtype=I32, device=roots.device)
    cuda.launch("lf_extract", "lrsc_lf_extract",
                *lf_extract_args(ix.bwt, ix.rbwt, roots, group, table, mat, lens))
    return mat, lens


def lf_extract(fm: FMIndex, roots, max_steps: int):
    """core.msa._lf_extract on fm's device: the next <= max_steps symbols
    reached by LF from each BWT row (per-row stop at '$'), as one group of
    lf_extract_groups.  Returns (mat int8 [N, max(max_steps, 1)], lens
    int64 [N]) as numpy."""
    return lf_extract_groups(IndexSet(bwt=fm, rbwt=fm), [("bwt", roots, max_steps)])[0]


def lf_extract_groups(ix, jobs):
    """lf_extract for each of jobs [(strand "bwt" | "rbwt", roots,
    max_steps)] on ix's device (an IndexSet), the non-empty ones as one
    launch.  Returns [(mat int8 [N_j, max(max_steps_j, 1)], lens int64
    [N_j])] as numpy, in the order of jobs."""
    out = [None] * len(jobs)
    live = []
    for j, (strand, roots, max_steps) in enumerate(jobs):
        roots = np.asarray(roots, np.int64)
        if len(roots) == 0 or max_steps <= 0:
            out[j] = (np.zeros((len(roots), max(max_steps, 1)), np.int8),
                      np.zeros(len(roots), np.int64))
            continue
        n = getattr(ix, strand).n
        if roots.min() < 0 or roots.max() >= n:
            raise ValueError(f"lf_extract: roots outside [0, {n})")
        live.append((j, STRANDS.index(strand), roots, int(max_steps)))
    if len(live) > MAX_GROUPS:
        raise ValueError(f"lf_extract: {len(live)} groups, at most {MAX_GROUPS} a launch")
    if live:
        roots = np.concatenate([r for _, _, r, _ in live]).astype(np.int32)
        group = np.repeat(np.arange(len(live), dtype=np.int8), [len(r) for _, _, r, _ in live])
        table = [(which, steps) for _, which, _, steps in live]
        mat, lens = lf_extract_groups_tensors(
            ix, torch.from_numpy(roots).to(ix.device), torch.from_numpy(group).to(ix.device),
            table)
        mat, lens = mat.cpu().numpy(), lens.cpu().numpy().astype(np.int64)
        base = 0
        for j, _, r, steps in live:
            out[j] = (mat[base : base + len(r), :steps], lens[base : base + len(r)])
            base += len(r)
    return out


# ---------------------------------------------------------------------------
# banded_fill
# ---------------------------------------------------------------------------

def banded_fill_plain(q: torch.Tensor, t: torch.Tensor, t_len: torch.Tensor,
                      origin: torch.Tensor, bw: int, scores=(1, -1, -8)):
    """cells int32 [N, Q + 1, bw] in plain torch; cells[n, i, k] is DP cell
    (i, j = origin[n] + i + k).  q int8 [N, Q] (pad 0), t int8 [N, T]
    (pad -1), t_len and origin int32 [N].  Out-of-band cells are 0."""
    match, gap, mismatch = (int(s) for s in scores)
    N, Q = q.shape
    T = t.shape[1]
    dev = q.device
    ks = torch.arange(bw, dtype=I32, device=dev)
    lanes = torch.arange(N, device=dev)[:, None]
    num_rows = t_len.to(I32) + 1
    origin = origin.to(I32)
    cells = torch.zeros((N, Q + 1, bw), dtype=I32, device=dev)
    prev = cells[:, 0]
    invalid = torch.full((N, 1), INVALID, dtype=I32, device=dev)
    for i in range(1, Q + 1):
        j0 = origin + i                                     # [N]
        rows = j0[:, None] + ks[None, :]                    # [N, bw] candidate j
        in_band = (rows >= j0.clamp(min=1)[:, None]) & (
            rows < torch.minimum(j0 + bw, num_rows)[:, None])
        qch = q[:, i - 1]
        tch = t[lanes, (rows - 1).clamp(0, T - 1).long()]
        sub = torch.where(tch == qch[:, None], match, mismatch).to(I32)
        diag = prev + sub
        left = torch.cat([prev[:, 1:] + gap, invalid], dim=1)
        # the last in-band row of the column has no left predecessor
        n_in = in_band.sum(dim=1, dtype=I32)
        first = torch.argmax(in_band.to(I32), dim=1).to(I32)
        last = first + n_in - 1
        is_last = (ks[None, :] == last[:, None]) & (n_in[:, None] > 1)
        base = torch.where(is_last, diag, torch.maximum(diag, left))
        # up-chain: running max of base - k*gap, reset outside the band
        shifted = torch.where(in_band, base - ks[None, :] * gap, INVALID)
        run = torch.cummax(shifted, dim=1).values
        prev = torch.where(in_band, run + ks[None, :] * gap, 0).to(I32)
        cells[:, i] = prev
    return cells


def _banded_fill_kernel(q, t, t_len, origin, bw: int, scores):
    name = "banded_fill"
    if not 1 <= bw <= 1024:
        raise ValueError(f"{name}: one thread per band slot takes bw <= 1024, got {bw}")
    N, Q = q.shape
    T = t.shape[1]
    cells = torch.empty((N, Q + 1, bw), dtype=I32, device=q.device)
    match, gap, mismatch = (int(s) for s in scores)
    cuda.launch(name, "lrsc_banded_fill",
                cuda.check(name, q, I8, (N, Q)), cuda.check(name, t, I8, (N, T)),
                cuda.check(name, t_len, I32, (N,)), cuda.check(name, origin, I32, (N,)),
                N, Q, T, bw, match, gap, mismatch, cells.data_ptr())
    return cells


def banded_fill_tensors(q, t, t_len, origin, bw: int, scores=(1, -1, -8)):
    """banded_fill_plain's contract on q's device: CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    if not q.is_cuda:
        return banded_fill_plain(q, t, t_len, origin, bw, scores)
    return _banded_fill_kernel(q, t, t_len, origin, bw, scores)


def encode_pairs(queries: list[str], targets: list[str], starts1, starts2,
                 band_width: int):
    """The kernel's inputs as numpy: (q int8 [N, Q], t int8 [N, T], t_len,
    origin int32 [N], bw).  Characters stay their bytes, so a lane matches
    exactly where the host fill's characters match."""
    N = len(queries)
    half = band_width // 2
    bw = half * 2 + 1
    Q = max((len(s) for s in queries), default=0)
    T = max(max((len(s) for s in targets), default=0), 1)
    q = np.zeros((N, Q), np.int8)
    t = np.full((N, T), -1, np.int8)
    t_len = np.zeros(N, np.int32)
    origin = np.zeros(N, np.int32)
    for n, (qs, ts) in enumerate(zip(queries, targets)):
        q[n, : len(qs)] = np.frombuffer(qs.encode(), dtype=np.int8)
        t[n, : len(ts)] = np.frombuffer(ts.encode(), dtype=np.int8)
        t_len[n] = len(ts)
        origin[n] = starts2[n] - starts1[n] + 1 - (half + 1)
    return q, t, t_len, origin, bw


def banded_fill(queries: list[str], targets: list[str], starts1, starts2,
                band_width: int, scores=(1, -1, -8), device="cuda") -> np.ndarray:
    """Batched extend_match cell fill on `device`.

    queries/targets: N sequences; starts1/starts2: the per-lane anchor
    positions; scores = (match, gap, mismatch) — the MSA call sites use
    match 1 / gap -1 / mismatch -8 (PacBio/LongReadOverlap.cpp:633-638).
    Returns int32 cells [N, max_len(queries) + 1, bw] aligned with
    core.overlapper.extend_match's band layout; lane n is the host
    fill_cells for i <= len(queries[n])."""
    q, t, t_len, origin, bw = encode_pairs(queries, targets, starts1, starts2,
                                           band_width)
    dev = torch.device(device)
    args = [torch.from_numpy(a).to(dev) for a in (q, t, t_len, origin)]
    cells = banded_fill_tensors(*args, bw, scores)
    if not cells.is_cuda:
        return cells.numpy()
    # the cells are the bulk of the DP fallback's traffic: one copy into
    # pinned host memory
    out = torch.empty(cells.shape, dtype=cells.dtype, pin_memory=True)
    out.copy_(cells)
    return out.numpy()
