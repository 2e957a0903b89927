"""The MSA/DP fallback's two device loops (the JAX package's ops/msa_kernels.py).

* ``lf_extract``  — batched LF-walk string extraction across SA rows, the
  device form of retrieveStr's per-row per-base loop
  (PacBio/LongReadOverlap.cpp:700-751).  All rows advance together; a row
  that reaches '$' parks.
* ``banded_fill`` — the banded DP cell fill of Overlapper::extendMatch
  (Thirdparty/overlapper.cpp:421-620) for N (query, candidate) lanes with
  their own band origins.  The fill is integer-exact: the host backtrack
  (core/overlapper.extend_match) reads the downloaded cells.

``lf_extract`` and ``banded_fill`` take and return numpy, as the JAX
wrappers do.  ``lf_extract_tensors`` / ``banded_fill_tensors`` launch
csrc/msa.cu for CUDA tensors and run the plain versions
``lf_extract_plain`` / ``banded_fill_plain`` for CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..index.fmindex import FMIndex
from . import cuda, rank

I32 = torch.int32
I8 = torch.int8
INVALID = -(1 << 30)


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


def _lf_extract_kernel(fm: FMIndex, roots: torch.Tensor, max_steps: int):
    name = "lf_extract"
    if fm.block != 128:
        raise ValueError(f"{name}: the kernel takes 128-symbol blocks, got {fm.block}")
    if fm.blocks.data_ptr() % 16:
        raise ValueError(f"{name}: blocks must be 16-byte aligned")
    N = roots.shape[0]
    nb = fm.blocks.shape[0]
    mat = torch.empty((N, max_steps), dtype=I8, device=roots.device)
    lens = torch.empty(N, dtype=I32, device=roots.device)
    cuda.launch(name, "lrsc_lf_extract",
                cuda.check(name, fm.blocks, I8, (nb, 128)),
                cuda.check(name, fm.ckpt, I32, (nb, 5)),
                cuda.check(name, fm.C, I32, (6,)), nb,
                cuda.check(name, roots, I32, (N,)), N, max_steps,
                mat.data_ptr(), lens.data_ptr())
    return mat, lens


def lf_extract_tensors(fm: FMIndex, roots: torch.Tensor, max_steps: int):
    """(mat int8 [N, max_steps], lens int32 [N]) on roots' device; roots
    int32 [N], each a row of fm (0 <= root < fm.n), max_steps >= 1.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if roots.device != fm.device:
        raise ValueError(f"lf_extract: roots on {roots.device}, index on {fm.device}")
    if not roots.is_cuda:
        return lf_extract_plain(fm, roots, max_steps)
    return _lf_extract_kernel(fm, roots, max_steps)


def lf_extract(fm: FMIndex, roots, max_steps: int):
    """core.msa._lf_extract on fm's device: the next <= max_steps symbols
    reached by LF from each BWT row (per-row stop at '$').
    Returns (mat int8 [N, max(max_steps, 1)], lens int64 [N]) as numpy."""
    roots = np.asarray(roots, np.int64)
    N = len(roots)
    if N == 0 or max_steps <= 0:
        return (np.zeros((N, max(max_steps, 1)), np.int8), np.zeros(N, np.int64))
    if roots.min() < 0 or roots.max() >= fm.n:
        raise ValueError(f"lf_extract: roots outside [0, {fm.n})")
    r = torch.from_numpy(roots.astype(np.int32)).to(fm.device)
    mat, lens = lf_extract_tensors(fm, r, max_steps)
    return mat.cpu().numpy(), lens.cpu().numpy().astype(np.int64)


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
