"""Batched FM-extension walk engine on the device.

The host engine (core/extend.py) walks one seed-gap at a time.  This module
walks many gaps at once as fixed-shape state over ``G`` gap lanes x ``L``
leaf slots, one superstep per base, as the JAX package's ops/walk.py does
(semantics of PacBio/LongReadCorrectByOverlap.cpp).  One documented
divergence of the JAX module is kept: seed-support ties break by smaller
position.  The JAX module builds its error rates in float32 from integer
counters and flags for host replay the lanes whose outcome hinges on an
f32 tie; here each leaf carries the host engine's running
``num_redeem_seed`` as an f64, and computeErrorRate, the erase and prune
tests, the retry's minimum and the result choice run in f64 in the host
engine's order, so every tie is decided as HostExtendEngine decides it.
A lane that met such a tie carries the informational ``tie`` bit.

Four CUDA kernels (csrc/walk.cu) carry it on the card (the walk kernels
one warp per gap lane, the lane's state in shared memory as
``lane_smem_bytes`` plans it):

* ``wcache_level_up`` -- one trie level of the ck-mer interval cache;
* ``walk_prep``       -- the per-task constants and root seeds of a batch;
* ``walk_steps``      -- up to n supersteps per gap lane, then the
  best-result reduction (superstep / multistep / run_to_completion /
  _reduce_results of the JAX module);
* ``walk_queue``      -- the persistent queue engine (queue_run): each
  lane takes the next task of a bank, walks it and writes its result.

Each wrapper launches its kernel for CUDA tensors and runs the ``*_plain``
version (a lockstep transcript of the JAX code) for CPU tensors.  The
TPU-only devices of the JAX module are not carried over: the one-hot
selects (_osel), the MXU slab count (_slab_B/_slab_cnt), the XLA compile
buckets (_quant_g/_quant_t) and the 2-bit packing of the tunnel transfers.
Every rank is a direct rank query.  Where the JAX slab path reads a rank
off a block slab, the value is the same direct rank (every such query lies
in the slot-0 interval's slab, the others are masked), so only the slab
span test and its -300 escape are kept, with the slab path's own
conventions for empty intervals.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..core import alphabet as ab
from ..index.fmindex import IndexSet
from ..index.pack import save_npy
from . import cuda, rank

I32 = torch.int32
I8 = torch.int8
F32 = torch.float32
F64 = torch.float64

CACHE_K = 8  # base cached k-mer length for chain seeding (BWTIntervalCache analog)
# walk_steps launches per config (G set to 0): which configs a run walked
STEP_CONFIGS: dict = {}
_BIG = 1 << 30
ERR_BOUND = 0.25  # HostExtendEngine's error_rate bound on a leaf's local error


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(np.float32(x), dtype=F32)


def redeem_adds(pacbio_error_rate: float, seed_size: int) -> torch.Tensor:
    """The host engine's two num_redeem_seed increments as f64 [2]:
    (seed_size - 1) * e on a found seed, 1 - e otherwise (core/extend.py
    _pruned_by_seed_support), from e as the Python double it is there."""
    return torch.tensor([(seed_size - 1) * pacbio_error_rate, 1 - pacbio_error_rate],
                        dtype=F64)


def add_redeem(nrs, hit, miss, redeem):
    """A leaf's num_redeem_seed after one step of PrunedBySeedSupport: plus
    redeem[0] on a found seed past seed_size (hit), plus redeem[1] on a
    miss past it or a step between seed checks (miss), else unchanged."""
    return torch.where(hit, nrs + redeem[0], torch.where(miss, nrs + redeem[1], nrs))


def error_rates(total_seeds, covl, nrs, old, wrap: torch.Tensor, ss: int, ring: int):
    """computeErrorRate (:638-664) in f64, term for term in the host
    engine's order (core/extend.py _compute_error_rate): the global error
    (total - matched) / total with matched = total_seeds + ss - 1 + nrs
    (the integer part exact), and the local error, which once the lane has
    RING global errors (wrap) takes out the one RING back (old).  Each
    torch op rounds once: nothing is contracted."""
    matched = (total_seeds + (ss - 1)).to(F64) + nrs
    total = covl.to(F64)
    gerr = (total - matched) / total
    # a CUDA tensor divided by a Python number is multiplied by the number's
    # reciprocal, a second rounding: divide by a tensor
    local = torch.where(wrap, (gerr * total - old * (total - ring)) / torch.full_like(total, ring),
                        gerr)
    return gerr, local


# ---------------------------------------------------------------------------
# index bundle and the ck-mer interval cache
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WalkIndex:
    """The device index for the walk: the {BWT, RBWT} pair plus the
    walk-convention bi-interval of every ck-mer (wcache i32 [4^ck, 4],
    columns f_lo, f_hi, r_lo, r_hi; code of a word = its chars left to
    right, 2 bits each) and of every shorter word: pyramid i32
    [(4^ck - 4) / 3, 4], levels 1..ck-1 one after another (level j from
    row (4^j - 4) / 3), which the seed phase's kmer_table_full reads."""

    ix: IndexSet
    wcache: torch.Tensor
    ck: int
    pyramid: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.ix.device

    @staticmethod
    def build(ix: IndexSet, host_ix, ck: int = CACHE_K, reuse: bool = True) -> "WalkIndex":
        pyramid, wcache = get_tables(ix, host_ix, ck, reuse)
        return WalkIndex(ix=ix, wcache=wcache, ck=ck, pyramid=pyramid)

    def level(self, j: int) -> torch.Tensor:
        """The interval table of every j-mer, i32 [4^j, 4], 1 <= j <= ck."""
        if not 1 <= j <= self.ck:
            raise ValueError(f"level {j} is outside 1..{self.ck}")
        if j == self.ck:
            return self.wcache
        a = (4 ** j - 4) // 3
        return self.pyramid[a : a + 4 ** j]


def walk_ck(n_symbols: int) -> int:
    """Word length of the walk's interval table for an index of n_symbols
    per strand: larger indexes use a deeper table, so that the slot-0
    interval is narrow enough for the slab span test."""
    return 12 if n_symbols > (1 << 24) else CACHE_K


def build_kmer_levels(host_ix, k: int) -> list[np.ndarray]:
    """Host interval tables of all j-mers, j = 1..k, built level by level
    over the 4-ary trie (each level one batched LF over 4^j lanes)."""
    sym1 = np.arange(1, 5, dtype=np.int64)
    state = list(host_ix.init_bi(sym1))
    levels = [np.stack(state, axis=1).astype(np.int32)]
    for _ in range(k - 1):
        n = len(state[0])
        rep = [np.repeat(x, 4) for x in state]
        csym = np.tile(sym1, n)
        state = list(host_ix.extend_bi(tuple(rep), csym))
        levels.append(np.stack(state, axis=1).astype(np.int32))
    return levels


def build_kmer_caches(host_ix) -> np.ndarray:
    """Host interval table of all CACHE_K-mers (the trie's last level)."""
    return build_kmer_levels(host_ix, CACHE_K)[-1]


def get_wcache(ix: IndexSet, host_ix, ck: int, reuse: bool = True) -> torch.Tensor:
    """wcache for word length ck on ix's device (get_tables' level ck)."""
    return get_tables(ix, host_ix, ck, reuse)[1]


def get_tables(ix: IndexSet, host_ix, ck: int, reuse: bool = True):
    """(pyramid, wcache) for word length ck on ix's device: the interval
    tables of levels 1..ck-1 one after another, and of level ck.

    Levels up to CACHE_K come from the host trie, the CACHE_K table from
    the pack (``host_ix._kmer_cache8``) where it is there; deeper levels
    are CACHE_K's extended level by level on the device (wcache_level_up).
    The level-ck table is persisted as ``wcache{ck}.npy`` beside the pack
    when its directory is known, and loaded from there next time unless
    the pack was rewritten after it (then only the levels below ck are
    extended on the device).  reuse=False builds the tables anew (and
    rewrites the file) even when they are at hand."""
    caches = host_ix.__dict__.setdefault("_kmer_caches", {})
    key = (ck, str(ix.device))
    if reuse and key in caches:
        return caches[key]
    pack_dir = getattr(host_ix, "pack_dir", None)
    path = None if pack_dir is None else os.path.join(pack_dir, f"wcache{ck}.npy")
    dev = ix.device

    def up(a):
        return torch.from_numpy(np.array(a, np.int32)).to(dev)

    base_k = min(ck, CACHE_K)
    wc8 = getattr(host_ix, "_kmer_cache8", None) if base_k == CACHE_K else None
    host = build_kmer_levels(host_ix, base_k if wc8 is None else base_k - 1)
    if wc8 is not None:
        host.append(wc8)
    elif base_k == CACHE_K:
        host_ix._kmer_cache8 = host[-1]
    levels = [up(a) for a in host]
    top = None
    if ck > CACHE_K and reuse and path is not None and _newer_than_pack(path, pack_dir):
        top = torch.from_numpy(np.load(path)).to(dev)
    st = tuple(levels[-1][:, i].contiguous() for i in range(4))
    for k in range(CACHE_K + 1, ck + 1):
        if k == ck and top is not None:
            break
        st = wcache_level_up(ix, *st, k - 1)
        levels.append(torch.stack(st, dim=1).contiguous())
    if top is None:
        top = levels[-1]
        if ck > CACHE_K and path is not None:
            save_npy(path, top.cpu().numpy())
    pyramid = (torch.cat(levels[: ck - 1]) if ck > 1
               else torch.zeros((0, 4), dtype=torch.int32, device=dev))
    caches[key] = (pyramid, top)
    return caches[key]


def _newer_than_pack(path: str, pack_dir: str) -> bool:
    """Is the table at path at least as new as the pack's meta.json?  A
    re-pack rewrites meta.json; a table written before it is stale."""
    meta = os.path.join(pack_dir, "meta.json")
    return (os.path.exists(path) and os.path.exists(meta)
            and os.stat(path).st_mtime_ns >= os.stat(meta).st_mtime_ns)


def wcache_level_up_plain(ix: IndexSet, f_lo, f_hi, r_lo, r_hi, chunk=1 << 22):
    """One trie level: child code = code*4 + (c-1) (append char c)."""
    n = f_lo.shape[0]
    outs = [torch.empty(4 * n, dtype=I32, device=f_lo.device) for _ in range(4)]
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        sym = torch.arange(1, 5, dtype=I32, device=f_lo.device).repeat(b - a)
        csym = rank.comp(sym)
        pb, pc = ix.rbwt.C[sym.long()], ix.bwt.C[csym.long()]

        def rep(x):
            return x[a:b].repeat_interleave(4)

        outs[0][4 * a : 4 * b] = pb + rank.occ(ix.rbwt, sym, rep(f_lo) - 1)
        outs[1][4 * a : 4 * b] = pb + rank.occ(ix.rbwt, sym, rep(f_hi)) - 1
        outs[2][4 * a : 4 * b] = pc + rank.occ(ix.bwt, csym, rep(r_lo) - 1)
        outs[3][4 * a : 4 * b] = pc + rank.occ(ix.bwt, csym, rep(r_hi)) - 1
    return tuple(outs)


def _index_ptrs(name: str, ix: IndexSet, on_card: bool = True) -> list[int]:
    """Pointers of the index pair, RBWT first: blocks, ckpt, C each."""
    out = []
    for fm in (ix.rbwt, ix.bwt):
        out += [cuda.check(name, fm.blocks, I8, on_card=on_card),
                cuda.check(name, fm.ckpt, I32, on_card=on_card),
                cuda.check(name, fm.C, I32, on_card=on_card)]
    return out


def _index_dims(ix: IndexSet) -> list[int]:
    return [ix.rbwt.blocks.shape[0], ix.bwt.blocks.shape[0]]


def wcache_level_up(ix: IndexSet, f_lo, f_hi, r_lo, r_hi, k: int | None = None):
    """4 x i32 [n] intervals of every k-mer -> 4 x i32 [4n] of every
    (k+1)-mer.  Kernel on CUDA tensors, plain version on CPU tensors.  The
    kernel visits the parents in the order of their intervals, which it
    derives from the level: k is required there and n must be 4^k."""
    if k is not None and f_lo.shape[0] != 4 ** k:
        raise ValueError(f"wcache_level_up: {f_lo.shape[0]} parents are not the 4^{k} "
                         f"of level {k}")
    if not f_lo.is_cuda:
        return wcache_level_up_plain(ix, f_lo, f_hi, r_lo, r_hi)
    if k is None or not 1 <= k <= 15:
        raise ValueError(f"wcache_level_up: the kernel takes a parent level 1..15, got {k}")
    return _level_up_kernel(ix, f_lo, f_hi, r_lo, r_hi, k)


def _level_up_kernel(ix: IndexSet, f_lo, f_hi, r_lo, r_hi, k: int):
    name = "wcache_level_up"
    n = f_lo.shape[0]
    ins = [cuda.check(name, t, I32, (n,)) for t in (f_lo, f_hi, r_lo, r_hi)]
    outs = [torch.empty(4 * n, dtype=I32, device=f_lo.device) for _ in range(4)]
    cuda.launch(name, "lrsc_wcache_level_up",
                cuda.ptr_array(_index_ptrs(name, ix) + ins + [o.data_ptr() for o in outs]),
                cuda.int_array(_index_dims(ix) + [n, k]))
    return tuple(outs)


# ---------------------------------------------------------------------------
# walk data types
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WalkConfig:
    G: int = 64            # gap lanes of a batch (the plain queue walks G at a time)
    L: int = 4             # leaf storage slots (gaps that grow beyond L but
                           # <= maxLeaves are re-run at L = max_leaves)
    CAND: int = 16         # transient candidates (4 * L)
    MAXLEN: int = 512      # label buffer (covers maxLength)
    QMAX: int = 512        # query buffer
    TMAX: int = 48         # terminal-interval slots (trg_len - minOverlap + 1)
    RMAX: int = 16         # result slots per gap
    RING: int = 100        # localSimilarlykmerSize
    KMAX: int = 24         # upper bound on any backward-search chain length
    WSCAN: int = 288       # query-position scan window (>= 2*max_indel+21)
    seed_size: int = 9     # idmer length
    max_leaves: int = 32
    CK: int = CACHE_K      # chain-ring bottom slot length (= wcache word len)
    SLAB: bool = False     # the JAX slab engine: span test, -300 escape
    SB: int = 6            # slab span in blocks (slot-0 interval must fit)

    @property
    def NCHAIN(self) -> int:
        """Chain-ring slots: one per suffix length in [CK, KMAX]."""
        return self.KMAX - self.CK + 1


@dataclass
class GapTask:
    """One seed-gap walk (inputs of LongReadSelfCorrectByOverlap's
    constructor)."""

    src: str               # source seed suffix (length == init_k)
    path: str              # raw read between the seeds
    trg: str               # target seed
    dis: int               # disBetweenSrcTarget
    init_k: int
    max_overlap: int
    min_overlap: int
    min_sa_threshold: int
    tag: object = None


@dataclass
class WalkConsts:
    """Per-task constants (leading dim T or G on the per-task fields)."""

    query: torch.Tensor        # i8  [T, QMAX]
    q_len: torch.Tensor        # i32 [T]
    trg: torch.Tensor          # i8  [T, TMAX + KMAX]
    trg_len: torch.Tensor      # i32 [T]
    n_term: torch.Tensor       # i32 [T]
    term_f: torch.Tensor       # i32 [T, TMAX, 2]
    term_r: torch.Tensor       # i32 [T, TMAX, 2]
    qcode9: torch.Tensor       # i32 [T, QMAX] packed idmer at each pos (-1 pad)
    qcode5: torch.Tensor       # i32 [T, QMAX] packed 5-mer at each pos
    init_k: torch.Tensor       # i32 [T]
    max_overlap: torch.Tensor  # i32 [T]
    min_overlap: torch.Tensor  # i32 [T]
    min_sa: torch.Tensor       # i32 [T]
    max_indel: torch.Tensor    # i32 [T]
    max_length: torch.Tensor   # i32 [T]
    min_length: torch.Tensor   # i32 [T] (clamped; no_term handles the wrap)
    no_term: torch.Tensor      # bool [T] min-length wrapped: never terminates
    freqs: torch.Tensor        # f32 [101] expected freq per k (shared)
    redeem: torch.Tensor       # f64 [2]: the num_redeem_seed adds (redeem_adds)
    err_bound: torch.Tensor    # f64 0-dim (ERR_BOUND)


@dataclass
class RootPack:
    """Per-task root-leaf seeds: the root bi-interval, its chain ring and
    tail codes."""

    f_lo: torch.Tensor         # i32 [T]
    f_hi: torch.Tensor
    r_lo: torch.Tensor
    r_hi: torch.Tensor
    freq: torch.Tensor         # i32 [T]
    chain0: torch.Tensor       # i32 [T, 4, NCHAIN]
    tail9: torch.Tensor        # i32 [T]
    tail8: torch.Tensor        # i32 [T]
    tail_letter: torch.Tensor  # i8  [T]
    tail_count: torch.Tensor   # i32 [T]


@dataclass
class WalkState:
    # per (gap, leaf)
    labels: torch.Tensor       # i8 [G, L, MAXLEN]
    f_lo: torch.Tensor         # i32 [G, L]
    f_hi: torch.Tensor
    r_lo: torch.Tensor
    r_hi: torch.Tensor
    alive: torch.Tensor        # bool [G, L]
    kmer_freq: torch.Tensor    # i32 [G, L]
    total_kmer: torch.Tensor
    last_seed_idx: torch.Tensor
    last_overlap_len: torch.Tensor
    total_seeds: torch.Tensor
    curr_overlap_len: torch.Tensor
    num_errors: torch.Tensor
    seed_idx_offset: torch.Tensor
    query_overlap_len: torch.Tensor
    nrs: torch.Tensor          # f64 [G, L]: the host's num_redeem_seed
    res_first: torch.Tensor    # resultindex.first, -1 none
    res_second: torch.Tensor
    tail_letter: torch.Tensor  # i8 [G, L]
    tail_count: torch.Tensor
    tail9: torch.Tensor        # packed last-9-chars code per leaf
    tail8: torch.Tensor        # packed last-CK-chars 2-bit code (wcache key)
    chain: torch.Tensor        # i32 [G, L, 4, NCHAIN]: slot j = interval of
                               # the label suffix of length CK + j
    local_err: torch.Tensor    # f64 [G, L]
    gerr_last: torch.Tensor    # f64 [G, L]
    ring: torch.Tensor         # f64 [G, L, RING]
    # per gap
    active: torch.Tensor       # bool [G]
    cur_len: torch.Tensor      # i32 [G]
    cur_k: torch.Tensor
    gerr_n: torch.Tensor
    code: torch.Tensor         # 0 active; 1/-1/-2/-3 finished; -200/-300 rerun
    # results
    res_labels: torch.Tensor   # i8 [G, RMAX, MAXLEN]
    res_len: torch.Tensor      # i32 [G, RMAX]
    res_err: torch.Tensor      # f64 [G, RMAX]
    res_i: torch.Tensor        # i32 [G, RMAX]
    res_count: torch.Tensor    # i32 [G]
    res_overflow: torch.Tensor  # bool [G]: more results than RMAX slots
    # sticky, informational: distinct leaves tied at the minimum local
    # error and the tie gated a threshold retry (decided in f64)
    res_tie: torch.Tensor      # bool [G]


@dataclass
class QueueBank:
    """Per-task constants + root seeds of T tasks, resident on the device."""

    consts: WalkConsts
    root: RootPack


@dataclass
class Reduced:
    """_reduce_results per gap lane (or per task of a queue bank)."""

    code: torch.Tensor         # i32 [G]
    overflow: torch.Tensor     # bool [G]
    has: torch.Tensor          # bool [G]
    lab: torch.Tensor          # i8 [G, MAXLEN]
    len: torch.Tensor          # i32 [G]
    i: torch.Tensor            # i32 [G]
    tie: torch.Tensor          # bool [G]: the walk resolved a tie (res_tie)


def field_names(obj) -> list[str]:
    return [f.name for f in dataclasses.fields(obj)]


def clone(obj):
    """Deep copy of a tensor dataclass."""
    return replace(obj, **{k: getattr(obj, k).clone() for k in field_names(obj)})


# the kernels' argument order: WalkConsts per-task fields, RootPack fields,
# WalkState fields (csrc/walk.cuh reads its pointer array in this order)
CONST_FIELDS = (
    "query", "q_len", "trg", "trg_len", "n_term", "term_f", "term_r",
    "qcode9", "qcode5", "init_k", "max_overlap", "min_overlap", "min_sa",
    "max_indel", "max_length", "min_length", "no_term",
)
ROOT_FIELDS = ("f_lo", "f_hi", "r_lo", "r_hi", "freq", "chain0", "tail9",
               "tail8", "tail_letter", "tail_count")
STATE_FIELDS = tuple(f.name for f in dataclasses.fields(WalkState))
REDUCED_FIELDS = ("code", "overflow", "has", "lab", "len", "i", "tie")


# ---------------------------------------------------------------------------
# prep: per-task constants and root seeds (_prep_core)
# ---------------------------------------------------------------------------

def _take(x, pos):
    """x[t, pos[t, j]] for [T, W] x and [T, J] pos (already in range)."""
    return torch.gather(x, 1, pos.long())


def prep_plain(wx: WalkIndex, query, q_len, trg, n_term, init_k, min_overlap,
               cfg: WalkConfig, kb_term: int, kb_root: int, use_wcache: bool):
    """qcode9/qcode5, terminal intervals, root interval, chain ring and
    tail metadata of every task (JAX _prep_core, walk.py:371-518).
    Returns a dict of the computed fields."""
    ix = wx.ix
    T = query.shape[0]
    dev = query.device
    PAD = ab.PAD_RANK
    CK = cfg.CK
    ckmask = (1 << (2 * CK)) - 1
    q32 = query.to(I32)

    qpad = torch.cat([q32, torch.full((T, cfg.seed_size), PAD, dtype=I32,
                                      device=dev)], dim=1)
    pos = torch.arange(cfg.QMAX, dtype=I32, device=dev)[None, :]

    def codes(k):
        c = torch.zeros((T, cfg.QMAX), dtype=I32, device=dev)
        for j in range(k):
            c = (c << 3) | qpad[:, j : j + cfg.QMAX]
        n = q_len - k + 1
        return torch.where(pos < n[:, None], c, -1)

    out = {"qcode9": codes(cfg.seed_size), "qcode5": codes(5)}

    # terminal intervals: window m of trg, length min_overlap
    t32 = trg.to(I32)
    m = torch.arange(cfg.TMAX, dtype=I32, device=dev)[None, :]

    def tchar(j):
        return t32[:, j : j + cfg.TMAX].clamp(1, 4)

    def wc(code):
        w = wx.wcache[code.long()]
        return (w[..., 0], w[..., 1], w[..., 2], w[..., 3])

    if use_wcache:
        tcode = torch.zeros((T, cfg.TMAX), dtype=I32, device=dev)
        for j in range(CK):
            tcode = ((tcode << 2) | (tchar(j) - 1)) & ckmask
        st, t_from = wc(tcode), CK
    else:
        st, t_from = rank.init_bi(ix, tchar(0)), 1
    for j in range(t_from, kb_term):
        ns = rank.extend_bi(ix, st, tchar(j))
        live = (j < min_overlap)[:, None]
        st = tuple(torch.where(live, a, b) for a, b in zip(ns, st))
    valid_m = m < n_term[:, None]
    out["term_f"] = torch.stack([torch.where(valid_m, st[0], 1),
                                 torch.where(valid_m, st[1], 0)], dim=-1)
    out["term_r"] = torch.stack([torch.where(valid_m, st[2], 1),
                                 torch.where(valid_m, st[3], 0)], dim=-1)

    # root leaf interval: query[:init_k] left to right
    if use_wcache:
        rcode = torch.zeros(T, dtype=I32, device=dev)
        for j in range(CK):
            rcode = ((rcode << 2) | (q32[:, j].clamp(1, 4) - 1)) & ckmask
        rst, r_from = wc(rcode), CK
    else:
        rst, r_from = rank.init_bi(ix, q32[:, 0].clamp(1, 4)), 1
    for j in range(r_from, kb_root):
        ns = rank.extend_bi(ix, rst, q32[:, j].clamp(1, 4))
        live = j < init_k
        rst = tuple(torch.where(live, a, b) for a, b in zip(ns, rst))
    out["f_lo"], out["f_hi"], out["r_lo"], out["r_hi"] = rst
    out["freq"] = rank.interval_size(rst[0], rst[1]) + rank.interval_size(rst[2], rst[3])

    # chain ring of the root leaf: suffixes of length CK..KMAX
    NC = cfg.NCHAIN
    ks = CK + torch.arange(NC, dtype=I32, device=dev)[None, :]
    start = init_k[:, None] - ks

    def cchar(i):
        return _take(q32, (start + i).clamp(0, cfg.QMAX - 1)).clamp(1, 4)

    if use_wcache:
        ccode = torch.zeros((T, NC), dtype=I32, device=dev)
        for i in range(CK):
            ccode = ((ccode << 2) | (cchar(i) - 1)) & ckmask
        cst, c_from = wc(ccode), CK
    else:
        cst, c_from = rank.init_bi(ix, cchar(0)), 1
    for i in range(c_from, max(kb_root, CK)):
        ns = rank.extend_bi(ix, cst, cchar(i))
        live = i < ks
        cst = tuple(torch.where(live, a, b) for a, b in zip(ns, cst))
    ok = ks <= init_k[:, None]
    out["chain0"] = torch.stack([
        torch.where(ok, cst[0], 0), torch.where(ok, cst[1], -1),
        torch.where(ok, cst[2], 0), torch.where(ok, cst[3], -1)], dim=1)

    # root label tail metadata
    i9 = torch.arange(cfg.seed_size, dtype=I32, device=dev)
    pos9 = init_k[:, None] - cfg.seed_size + i9[None, :]
    ch9 = _take(q32, pos9.clamp(0, cfg.QMAX - 1))
    tail9 = torch.zeros(T, dtype=I32, device=dev)
    for i in range(cfg.seed_size):
        tail9 = torch.where(pos9[:, i] >= 0, (tail9 << 3) | ch9[:, i], tail9)
    i8 = torch.arange(CK, dtype=I32, device=dev)
    pos8 = init_k[:, None] - CK + i8[None, :]
    ch8 = _take(q32, pos8.clamp(0, cfg.QMAX - 1))
    tail8 = torch.zeros(T, dtype=I32, device=dev)
    for i in range(CK):
        tail8 = torch.where(pos8[:, i] >= 0,
                            ((tail8 << 2) | (ch8[:, i] - 1)) & ckmask, tail8)
    out["tail9"], out["tail8"] = tail9, tail8
    last = (init_k - 1).clamp(0, cfg.QMAX - 1)
    out["tail_letter"] = _take(query, last[:, None])[:, 0]
    back = init_k[:, None] - 1 - torch.arange(cfg.KMAX, dtype=I32, device=dev)[None, :]
    chb = _take(q32, back.clamp(0, cfg.QMAX - 1))
    eq = (chb == chb[:, :1]) & (back >= 0)
    out["tail_count"] = torch.cumprod(eq.to(I32), dim=1).sum(1, dtype=I32)
    return out


_PREP_OUT = ("qcode9", "qcode5", "term_f", "term_r") + ROOT_FIELDS
# parts of walk_prep a launch runs (csrc/walk.cuh PREP_*): the code rows, the
# terminal windows, the chain ring with the root and tails; a launch of
# fewer than all leaves the other outputs unwritten (timing variants)
PREP_CODES, PREP_TERM, PREP_CHAIN, PREP_ALL = 1, 2, 4, 7


def prep_outputs(T: int, cfg: WalkConfig, dev) -> dict:
    """Empty output tensors of walk_prep for T tasks."""
    shapes = {"qcode9": (T, cfg.QMAX), "qcode5": (T, cfg.QMAX),
              "term_f": (T, cfg.TMAX, 2), "term_r": (T, cfg.TMAX, 2),
              "chain0": (T, 4, cfg.NCHAIN)}
    return {k: torch.empty(shapes.get(k, (T,)),
                           dtype=I8 if k == "tail_letter" else I32, device=dev)
            for k in _PREP_OUT}


def prep_args(wx: WalkIndex, query, q_len, trg, n_term, init_k, min_overlap,
              cfg: WalkConfig, kb_term: int, kb_root: int, use_wcache: bool,
              out: dict, parts: int = PREP_ALL, on_card: bool = True):
    """(pointer array, int array) of lrsc_walk_prep: the inputs, the
    outputs `out` (prep_outputs) and the launch's dimensions."""
    name = "walk_prep"
    T = query.shape[0]
    ins = [cuda.check(name, query, I8, (T, cfg.QMAX), on_card=on_card),
           cuda.check(name, q_len, I32, (T,), on_card=on_card),
           cuda.check(name, trg, I8, (T, cfg.TMAX + cfg.KMAX), on_card=on_card),
           cuda.check(name, n_term, I32, (T,), on_card=on_card),
           cuda.check(name, init_k, I32, (T,), on_card=on_card),
           cuda.check(name, min_overlap, I32, (T,), on_card=on_card),
           cuda.check(name, wx.wcache, I32, on_card=on_card)]
    # the kernel starts a ladder of CK or more symbols from the table when
    # it holds every CK-mer (walk.cuh prep_task)
    table = tuple(wx.wcache.shape) == (4 ** cfg.CK, 4) and wx.wcache.data_ptr() % 16 == 0
    if use_wcache and not table:
        raise ValueError(f"{name}: use_wcache needs the interval table of every "
                         f"{cfg.CK}-mer, got {tuple(wx.wcache.shape)}")
    if kb_term > cfg.KMAX + 1:
        raise ValueError(f"{name}: kb_term {kb_term} reads past the target rows")
    dims = _index_dims(wx.ix) + [T, cfg.QMAX, cfg.TMAX, cfg.KMAX, cfg.CK,
                                 cfg.seed_size, kb_term, kb_root, int(use_wcache),
                                 int(table), parts]
    ptrs = (_index_ptrs(name, wx.ix, on_card) + ins
            + [cuda.check(name, out[k], out[k].dtype, on_card=on_card) for k in _PREP_OUT])
    return cuda.ptr_array(ptrs), cuda.int_array(dims)


def _prep_kernel(wx: WalkIndex, query, q_len, trg, n_term, init_k, min_overlap,
                 cfg: WalkConfig, kb_term: int, kb_root: int, use_wcache: bool,
                 parts: int = PREP_ALL):
    T = query.shape[0]
    out = prep_outputs(T, cfg, query.device)
    if T:
        cuda.launch("walk_prep", "lrsc_walk_prep",
                    *prep_args(wx, query, q_len, trg, n_term, init_k, min_overlap, cfg,
                               kb_term, kb_root, use_wcache, out, parts))
    return out


def prep(wx: WalkIndex, query, q_len, trg, trg_len, n_term, init_k,
         max_overlap, min_overlap, min_sa, max_indel, max_length, min_length,
         no_term, freqs, pacbio_e: float, cfg: WalkConfig, kb_term: int,
         kb_root: int, use_wcache: bool):
    """All FM-derived batch setup: (WalkConsts, RootPack).  Kernel
    walk_prep on CUDA tensors, prep_plain on CPU tensors.  pacbio_e is the
    host engine's error rate, a Python float (redeem_adds)."""
    fn = _prep_kernel if query.is_cuda else prep_plain
    o = fn(wx, query, q_len, trg, n_term, init_k, min_overlap, cfg, kb_term,
           kb_root, use_wcache)
    dev = query.device
    consts = WalkConsts(
        query=query, q_len=q_len, trg=trg, trg_len=trg_len, n_term=n_term,
        term_f=o["term_f"], term_r=o["term_r"], qcode9=o["qcode9"],
        qcode5=o["qcode5"], init_k=init_k, max_overlap=max_overlap,
        min_overlap=min_overlap, min_sa=min_sa, max_indel=max_indel,
        max_length=max_length, min_length=min_length, no_term=no_term,
        freqs=freqs, redeem=redeem_adds(pacbio_e, cfg.seed_size).to(dev),
        err_bound=torch.tensor(ERR_BOUND, dtype=F64, device=dev))
    return consts, RootPack(**{k: o[k] for k in ROOT_FIELDS})


def init_state(consts: WalkConsts, root: RootPack, used, cfg: WalkConfig) -> WalkState:
    """Fresh lane state for each task (leaf slot 0 = the root leaf)."""
    G, L = consts.q_len.shape[0], cfg.L
    dev = used.device
    PAD = ab.PAD_RANK
    query, init_k = consts.query, consts.init_k
    leaf0 = (torch.arange(L, device=dev) == 0)[None, :]
    u_l = used[:, None] & leaf0
    iota_m = torch.arange(cfg.MAXLEN, dtype=I32, device=dev)[None, :]
    qm = query[:, : cfg.MAXLEN]
    if cfg.MAXLEN > cfg.QMAX:
        qm = torch.cat([qm, torch.full((G, cfg.MAXLEN - cfg.QMAX), PAD, dtype=I8,
                                       device=dev)], dim=1)
    lab0 = torch.where(iota_m < init_k[:, None], qm, PAD)
    labels = torch.where(u_l[..., None], lab0[:, None, :], PAD).to(I8)

    def put(val, fill=0):
        return torch.where(u_l, val[:, None], fill).to(I32)

    def zeros(*shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    fill = torch.tensor([0, -1, 0, -1], dtype=I32, device=dev)[None, None, :, None]
    chain = torch.where(u_l[:, :, None, None], root.chain0[:, None], fill)
    return WalkState(
        labels=labels,
        f_lo=put(root.f_lo), f_hi=put(root.f_hi, -1),
        r_lo=put(root.r_lo), r_hi=put(root.r_hi, -1),
        alive=u_l,
        kmer_freq=put(root.freq),
        total_kmer=zeros(G, L),
        last_seed_idx=put(init_k - cfg.seed_size),
        last_overlap_len=put(init_k),
        total_seeds=put(init_k - cfg.seed_size + 1),
        curr_overlap_len=put(init_k),
        num_errors=zeros(G, L),
        seed_idx_offset=zeros(G, L),
        query_overlap_len=put(init_k),
        nrs=zeros(G, L, dtype=F64),
        res_first=torch.full((G, L), -1, dtype=I32, device=dev),
        res_second=torch.full((G, L), -1, dtype=I32, device=dev),
        tail_letter=torch.where(u_l, root.tail_letter[:, None], 0).to(I8),
        tail_count=put(root.tail_count),
        tail9=put(root.tail9),
        tail8=put(root.tail8),
        chain=chain.contiguous(),
        local_err=zeros(G, L, dtype=F64),
        gerr_last=zeros(G, L, dtype=F64),
        ring=zeros(G, L, cfg.RING, dtype=F64),
        active=used.clone(),
        cur_len=torch.where(used, init_k, 0).to(I32),
        cur_k=torch.where(used, init_k, 0).to(I32),
        gerr_n=torch.where(used, 1, 0).to(I32),
        code=zeros(G),
        res_labels=torch.full((G, cfg.RMAX, cfg.MAXLEN), PAD, dtype=I8, device=dev),
        res_len=zeros(G, cfg.RMAX),
        res_err=zeros(G, cfg.RMAX, dtype=F64),
        res_i=zeros(G, cfg.RMAX),
        res_count=zeros(G),
        res_overflow=zeros(G, dtype=torch.bool),
        res_tie=zeros(G, dtype=torch.bool),
    )


# ---------------------------------------------------------------------------
# the superstep (plain version)
# ---------------------------------------------------------------------------

def _gather1(x, idx):
    """x[g, idx[g, k], ...] for x [G, N, ...] and idx [G, K]."""
    shape = tuple(idx.shape) + tuple(x.shape[2:])
    ix = idx.long().reshape(tuple(idx.shape) + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, ix)


def _chain_slot(chain, k, ck):
    """Ring read: the interval of the label suffix of per-gap length k.
    chain [G, L, 4, NCHAIN], k [G] -> [G, L, 4] (f_lo, f_hi, r_lo, r_hi)."""
    G, L, _, NC = chain.shape
    j = (k - ck).clamp(0, NC - 1).long()
    return torch.gather(chain, 3, j[:, None, None, None].expand(G, L, 4, 1))[..., 0]


def _probe4(ix: IndexSet, f_lo, f_hi, r_lo, r_hi):
    """4-way ACGT probes (getFMIndexExtensions :686-718): inputs [G, L],
    outputs [G, L, 4] (+ freq); an invalid side keeps its interval."""
    f_valid = (f_lo <= f_hi)[..., None]
    Cb = ix.rbwt.C[1:5]
    nf_lo = Cb + rank.occ_all(ix.rbwt, f_lo - 1)[..., 1:5]
    nf_hi = Cb + rank.occ_all(ix.rbwt, f_hi)[..., 1:5] - 1
    pf_lo = torch.where(f_valid, nf_lo, f_lo[..., None])
    pf_hi = torch.where(f_valid, nf_hi, f_hi[..., None])
    # the rvc extension by base b uses the complement rank 5-b
    r_valid = (r_lo <= r_hi)[..., None]
    Cr = ix.bwt.C[1:5].flip(0)
    nr_lo = Cr + rank.occ_all(ix.bwt, r_lo - 1)[..., 1:5].flip(-1)
    nr_hi = Cr + rank.occ_all(ix.bwt, r_hi)[..., 1:5].flip(-1) - 1
    pr_lo = torch.where(r_valid, nr_lo, r_lo[..., None])
    pr_hi = torch.where(r_valid, nr_hi, r_hi[..., None])
    freq = rank.interval_size(pf_lo, pf_hi) + rank.interval_size(pr_lo, pr_hi)
    return pf_lo, pf_hi, pr_lo, pr_hi, freq


def _select_freqs_of_range(consts, freq3, lower, upper, alive):
    """SelectFreqsOfrange decision ladder (:281-331): per-gap ReduceSize."""
    reduce_size = upper
    decided = torch.zeros_like(upper, dtype=torch.bool)
    for i in range(3):
        ln = lower + i
        valid = ln <= upper
        maxf = torch.where(alive, freq3[i], 0).amax(dim=1)
        expected = consts.freqs[ln.clamp(0, 100).long()].to(I32)
        hit = valid & ((maxf - expected) < 5) & ~decided
        reduce_size = torch.where(hit, ln, reduce_size)
        decided = decided | hit
    return reduce_size


def _match5_any(consts, codes5, valid, cur_len, max_indel):
    """ismatchedbykmer (:787-821): any query 5-mer equal to the candidate's
    5-suffix within [max(cur_len - indel, 0), cur_len + indel]."""
    lo = (cur_len - max_indel).clamp(min=0)
    hi = cur_len + max_indel
    Q = consts.qcode5.shape[1]
    pos = torch.arange(Q, dtype=I32, device=lo.device)[None, :]
    in_win = (pos >= lo[:, None]) & (pos <= hi[:, None]) & (consts.qcode5 >= 0)
    hit = (consts.qcode5[:, None, :] == codes5[:, :, None]) & in_win[:, None, :]
    return hit.any(dim=-1) & valid


def _seed_support_match(consts, codes9, valid, start_idx, large_idx, curr_seed_idx):
    """isSupportedByNewSeed (:566-635) via 9-suffix code equality; ties on
    |pos - currSeedIdx| go to the smaller pos (first argmin of the key)."""
    Q = consts.qcode9.shape[1]
    pos = torch.arange(Q, dtype=I32, device=codes9.device)[None, None, :]
    eq = consts.qcode9[:, None, :] == codes9[:, :, None]
    in_win = ((pos >= start_idx[..., None]) & (pos <= large_idx[..., None])
              & (consts.qcode9 >= 0)[:, None, :])
    m = eq & in_win & valid[..., None]
    found = m.any(dim=-1)
    diff = (pos - curr_seed_idx[..., None]).abs()
    key = torch.where(m, diff * 2 * Q + pos, _BIG)
    return found, key.argmin(dim=-1).to(I32)


_C06, _C025, _C02, _C0125, _C03 = (
    _f32(0.6), _f32(0.25), _f32(0.2), _f32(0.125), _f32(0.3))


def _cutoff_mask(freq4, total_cnt, max_freq, match5, tail_count, thresh):
    """Extension acceptance (getFMIndexExtensions :725-781): [G, X, 4]."""
    dev = freq4.device
    ratio = freq4.to(F32) / max_freq[..., None].to(F32)
    t = thresh[:, None, None]
    is_freq_pass = freq4 >= t
    is_low_cov = total_cnt[..., None] >= t + 2
    is_repeat = (max_freq > 100)[..., None]
    is_highly = (max_freq > 150)[..., None]
    is_lowly = (max_freq > 50)[..., None]
    cut = torch.full(freq4.shape, 2.0, dtype=F32, device=dev)
    cut = torch.where(is_low_cov, _C06.to(dev), cut)
    cut = torch.where(is_freq_pass, _C025.to(dev), cut)
    cut = torch.where(match5 & is_lowly, _C02.to(dev), cut)
    cut = torch.where(match5 & is_highly, _C0125.to(dev), cut)
    homo = (tail_count >= 3)[..., None]
    cut = torch.where(homo & is_repeat, torch.maximum(cut, _C03.to(dev)),
                      torch.where(homo, torch.maximum(cut, _C06.to(dev)), cut))
    return ratio >= cut


def _leaf_choice(ext_t, ext_t1, alive, retry_ok):
    """attempToExtend per-leaf retry ladder (:406-455)."""
    any_t = ext_t.any(dim=-1)
    use = torch.where(any_t[..., None], ext_t,
                      retry_ok[..., None] & ext_t1)
    return use & alive[..., None]


def _lf(fm, C, sym, idx_lo, idx_hi):
    """Raw LF of [lo, hi] by sym (no validity test)."""
    pb = C[sym.long()]
    return pb + rank.occ(fm, sym, idx_lo - 1), pb + rank.occ(fm, sym, idx_hi) - 1


def superstep_plain(wx: WalkIndex, consts: WalkConsts, state: WalkState,
                    cfg: WalkConfig) -> WalkState:
    """One while-iteration of extendOverlap (:155-193) over all gap lanes
    (JAX superstep, walk.py:997-1593)."""
    ix = wx.ix
    s = state
    G, L = s.alive.shape
    C = 4 * L
    dev = s.alive.device
    NC = cfg.NCHAIN
    ss = cfg.seed_size

    # ---------- while-condition check on the state left by the last step
    n_alive = s.alive.sum(dim=1, dtype=I32)
    cond_ok = (n_alive > 0) & (n_alive <= cfg.max_leaves) & (s.cur_len <= consts.max_length)
    gap_go = s.active & (s.code == 0)
    newly_done = gap_go & ~cond_ok
    code = s.code
    code = torch.where(newly_done & (s.res_count > 0), 1, code)
    code = torch.where(newly_done & (s.res_count == 0) & (n_alive == 0), -1, code)
    code = torch.where(newly_done & (s.res_count == 0) & (n_alive > 0)
                       & (s.cur_len > consts.max_length), -2, code)
    code = torch.where(newly_done & (code == 0), -3, code)
    run = gap_go & cond_ok

    # ---------- slab escape: the slot-0 interval must span <= SB blocks
    c0 = s.chain[:, :, :, 0]
    if cfg.SLAB:
        BLK = ix.bwt.block

        def span_ok(lo0, hi0):
            valid = lo0 <= hi0
            span = torch.div(hi0 + 1, BLK, rounding_mode="floor") \
                - torch.div(lo0, BLK, rounding_mode="floor") + 1
            return ~valid | (span <= cfg.SB)

        inv_f = (s.f_lo <= s.f_hi) & (c0[:, :, 0] > c0[:, :, 1])
        inv_r = (s.r_lo <= s.r_hi) & (c0[:, :, 2] > c0[:, :, 3])
        lane_bad = s.alive & (~(span_ok(c0[:, :, 0], c0[:, :, 1])
                                & span_ok(c0[:, :, 2], c0[:, :, 3])) | inv_f | inv_r)
        slab_bad = run & lane_bad.any(dim=1)
        code = torch.where(slab_bad, -300, code)
        run = run & ~slab_bad

    def ext_slot(k):
        """4-way extensions of chain slot (k - CK) with probe4's semantics."""
        sl = _chain_slot(s.chain, k, cfg.CK)
        return _probe4(ix, sl[..., 0], sl[..., 1], sl[..., 2], sl[..., 3])

    # ---------- extendLeaves: optional kmer-size clamp refine
    need_ref0 = run & (s.cur_k > consts.max_overlap)
    rf = _chain_slot(s.chain, consts.max_overlap, cfg.CK)
    sel0 = need_ref0[:, None] & s.alive
    f_lo = torch.where(sel0, rf[..., 0], s.f_lo)
    f_hi = torch.where(sel0, rf[..., 1], s.f_hi)
    r_lo = torch.where(sel0, rf[..., 2], s.r_lo)
    r_hi = torch.where(sel0, rf[..., 3], s.r_hi)
    cur_k0 = torch.where(need_ref0, consts.max_overlap, s.cur_k)

    # ---------- attempToExtend: erase relatively-bad leaves (f64, as the
    # host engine compares its local errors)
    err_vals = torch.where(s.alive, s.local_err, 2.0)
    min_err = err_vals.amin(dim=1)
    diff = s.local_err - min_err[:, None]
    erase = s.alive & (
        ((diff > 0.05) & (s.cur_len[:, None] > cfg.RING // 2))
        | ((diff > 0.1) & (s.cur_len[:, None] > 15)))
    alive1 = s.alive & ~erase
    leaf_cnt = alive1.sum(dim=1, dtype=I32)
    is_min = err_vals == min_err[:, None]
    retry_ok = is_min & (leaf_cnt[:, None] > 1)
    tie_leaf = retry_ok & ((is_min & s.alive).sum(dim=1) > 1)[:, None]

    # ---------- attempt at base threshold (level 0)
    b4 = torch.arange(1, 5, dtype=I32, device=dev)
    cand9 = ((s.tail9[..., None] << 3) | b4) & ((1 << 27) - 1)     # [G, L, 4]
    cand5 = cand9 & ((1 << 15) - 1)

    def attempt(p, thresh):
        pf_lo, pf_hi, pr_lo, pr_hi, freq = p
        total_cnt = freq.sum(dim=-1, dtype=I32)
        max_freq = freq.amax(dim=-1)
        pvalid = (pf_lo <= pf_hi) | (pr_lo <= pr_hi)
        m5 = _match5_any(consts, cand5.reshape(G, C), pvalid.reshape(G, C),
                         s.cur_len, consts.max_indel).reshape(G, L, 4)
        mask_t = _cutoff_mask(freq, total_cnt, max_freq, m5, s.tail_count, thresh)
        mask_t1 = _cutoff_mask(freq, total_cnt, max_freq, m5, s.tail_count, thresh - 1)
        ext = _leaf_choice(mask_t, mask_t1, alive1, retry_ok)
        tie = (tie_leaf & alive1 & ~mask_t.any(-1) & mask_t1.any(-1)).any(dim=1)
        return ext, (mask_t, mask_t1, m5, total_cnt, max_freq), tie

    if cfg.SLAB:
        p0 = ext_slot(cur_k0)
    else:
        p0 = _probe4(ix, f_lo, f_hi, r_lo, r_hi)
    extA, _, tieA = attempt(p0, consts.min_sa)
    gapA = extA.any(dim=2).any(dim=1)

    # ---------- level 1 (k reduce) + level 2 (threshold relax); the JAX
    # dense path runs this only when some gap needs it, and every value
    # is used only under need_l1, so computing it always is the same
    need_l1 = run & ~gapA
    lower = torch.maximum(cur_k0 - 2, consts.min_overlap)
    freq3 = []
    for i in range(3):
        sl = _chain_slot(s.chain, lower + i, cfg.CK)
        freq3.append(rank.interval_size(sl[..., 0], sl[..., 1])
                     + rank.interval_size(sl[..., 2], sl[..., 3]))
    reduce_size = _select_freqs_of_range(consts, torch.stack(freq3), lower,
                                         cur_k0, alive1)
    p1 = ext_slot(reduce_size)
    extB, aux1, tieB = attempt(p1, consts.min_sa)
    mask_t1, m5, total_cnt, max_freq = aux1[1], aux1[2], aux1[3], aux1[4]
    mask_t2 = _cutoff_mask(p1[4], total_cnt, max_freq, m5, s.tail_count,
                           consts.min_sa - 2)
    extC = _leaf_choice(mask_t1, mask_t2, alive1, retry_ok)
    tieC = (tie_leaf & alive1 & ~mask_t1.any(-1) & mask_t2.any(-1)).any(dim=1)
    gapB = extB.any(dim=2).any(dim=1) & need_l1
    gapC = extC.any(dim=2).any(dim=1) & need_l1 & ~gapB

    use_l1 = need_l1 & (gapB | gapC)
    ext = torch.where(gapA[:, None, None], extA,
                      torch.where(gapB[:, None, None], extB,
                                  gapC[:, None, None] & extC))
    sel_l1 = use_l1[:, None, None]
    c_f_lo = torch.where(sel_l1, p1[0], p0[0]).reshape(G, C)
    c_f_hi = torch.where(sel_l1, p1[1], p0[1]).reshape(G, C)
    c_r_lo = torch.where(sel_l1, p1[2], p0[2]).reshape(G, C)
    c_r_hi = torch.where(sel_l1, p1[3], p0[3]).reshape(G, C)
    c_freq = torch.where(sel_l1, p1[4], p0[4]).reshape(G, C)
    cand = ext.reshape(G, C) & run[:, None]
    success = cand.any(dim=1)
    cur_k_base = torch.where(use_l1, reduce_size, cur_k0)

    # ---------- materialise candidates
    ci = torch.arange(C, dtype=I32, device=dev)
    parent = (ci // 4).long()
    echar = (ci % 4 + 1)

    def par(x):
        return x[:, parent]

    c_tail9 = ((par(s.tail9) << 3) | echar[None, :]) & ((1 << 27) - 1)
    c_code9 = cand9.reshape(G, C)
    c_total_kmer = par(s.total_kmer) + c_freq
    c_curr_ovl = par(s.curr_overlap_len) + 1
    c_query_ovl = par(s.query_overlap_len) + 1
    same_tail = par(s.tail_letter).to(I32) == echar[None, :]
    c_tail_cnt = torch.where(same_tail, par(s.tail_count) + 1, 1).to(I32)
    c_tail_letter = echar.to(I8)[None, :].expand(G, C)
    c_last_seed = par(s.last_seed_idx)
    c_last_ovl = par(s.last_overlap_len)
    c_total_seeds = par(s.total_seeds)
    c_num_err = par(s.num_errors)
    c_sio = par(s.seed_idx_offset)
    c_nrs = par(s.nrs)
    c_res_first = par(s.res_first)
    c_res_second = par(s.res_second)
    c_ring = s.ring[:, parent, :]

    cur_len_new = torch.where(success, s.cur_len + 1, s.cur_len)
    cur_k_new = torch.where(success, cur_k_base + 1, cur_k_base)

    # ---------- isInsufficientFreqs -> reduce + refine candidates
    hft = consts.min_sa[:, None]
    high_cnt = (cand & (c_freq > hft)).sum(dim=1)
    n_new = cand.sum(dim=1, dtype=I32)
    insuff = ((high_cnt == 0) | ((high_cnt <= 2) & (n_new >= 5))
              | ((high_cnt <= 1) & (n_new >= 3)))
    need_post = run & success & insuff

    lower2 = torch.maximum(cur_k_new - 2, consts.min_overlap)
    sym = echar[None, :].expand(G, C)
    csym = rank.comp(sym)
    e3 = []
    for i in range(3):
        sl = _chain_slot(s.chain, lower2 + i - 1, cfg.CK)[:, parent]   # [G, C, 4]
        lo_f, hi_f = _lf(ix.rbwt, ix.rbwt.C, sym, sl[..., 0], sl[..., 1])
        lo_r, hi_r = _lf(ix.bwt, ix.bwt.C, csym, sl[..., 2], sl[..., 3])
        if cfg.SLAB:
            # the slab path reads these off probe4 of the slot: an invalid
            # side keeps the slot's interval
            fv, rv = sl[..., 0] <= sl[..., 1], sl[..., 2] <= sl[..., 3]
            lo_f, hi_f = torch.where(fv, lo_f, sl[..., 0]), torch.where(fv, hi_f, sl[..., 1])
            lo_r, hi_r = torch.where(rv, lo_r, sl[..., 2]), torch.where(rv, hi_r, sl[..., 3])
        e3.append((lo_f, hi_f, lo_r, hi_r))
    freq3p = torch.stack([rank.interval_size(e[0], e[1]) + rank.interval_size(e[2], e[3])
                          for e in e3])
    rsize2 = _select_freqs_of_range(consts, freq3p, lower2, cur_k_new, cand)
    pick = rsize2 - lower2
    rf2 = [sum(torch.where((pick == i)[:, None], e3[i][f], 0) for i in range(3))
           for f in range(4)]
    selp = need_post[:, None]
    c_f_lo = torch.where(selp, rf2[0], c_f_lo)
    c_f_hi = torch.where(selp, rf2[1], c_f_hi)
    c_r_lo = torch.where(selp, rf2[2], c_r_lo)
    c_r_hi = torch.where(selp, rf2[3], c_r_hi)
    cur_k_new = torch.where(need_post, rsize2, cur_k_new)

    # ---------- PrunedBySeedSupport
    curr_seed_idx = cur_len_new - ss
    indel_off = ss + consts.max_indel
    small_idx = torch.where(curr_seed_idx <= indel_off, 0, curr_seed_idx - indel_off)
    q_top = consts.q_len - ss
    large_idx = torch.minimum(curr_seed_idx + indel_off, q_top)

    gap_len = cur_len_new[:, None] - c_last_ovl
    do_match = cand & ((gap_len > ss) | (gap_len <= 1))
    sio_q = torch.where(c_last_ovl < cur_len_new[:, None] - ss, ss,
                        cur_len_new[:, None] - c_last_ovl)
    start_idx = torch.maximum(small_idx[:, None], c_last_seed + sio_q)
    c_valid = (c_f_lo <= c_f_hi) | (c_r_lo <= c_r_hi)
    found, best_pos = _seed_support_match(
        consts, c_code9, c_valid, start_idx, large_idx[:, None].expand(G, C),
        curr_seed_idx[:, None].expand(G, C))
    found = found & do_match
    miss = do_match & ~found

    # the host's num_redeem_seed adds, at most one a leaf a step
    v = curr_seed_idx[:, None] + c_sio - c_last_seed
    c_num_err = c_num_err + (miss & (v % ss == 1)).to(I32)
    c_nrs = add_redeem(c_nrs, found & (v > ss),
                       (miss & (v % ss != 1) & (v > ss - 1)) | (cand & ~do_match),
                       consts.redeem)
    c_sio = torch.where(found, best_pos - curr_seed_idx[:, None], c_sio)
    c_last_seed = torch.where(found, best_pos, c_last_seed)
    c_query_ovl = torch.where(found, best_pos + ss, c_query_ovl)
    c_last_ovl = torch.where(found, cur_len_new[:, None], c_last_ovl)
    c_curr_ovl = torch.where(found, cur_len_new[:, None], c_curr_ovl)
    c_total_seeds = c_total_seeds + found.to(I32)

    # computeErrorRate (:638-664) in f64, in the host engine's order
    n_app = s.gerr_n + 1
    slot_w = (n_app - 1) % cfg.RING
    slot_r = n_app % cfg.RING
    old = torch.gather(c_ring, 2, slot_r.long()[:, None, None].expand(G, C, 1))[..., 0]
    gerr, local = error_rates(c_total_seeds, c_curr_ovl, c_nrs, old,
                              (n_app >= cfg.RING)[:, None], ss, cfg.RING)
    wpos = torch.arange(cfg.RING, device=dev)[None, None, :] == slot_w[:, None, None]
    c_ring = torch.where(wpos & cand[..., None], gerr[..., None], c_ring)
    surv = cand & ~(local > consts.err_bound)

    # ---------- isTerminated (:824-877)
    may_term = run & success & ~consts.no_term & (cur_len_new >= consts.min_length)
    ti = torch.arange(cfg.TMAX, dtype=I32, device=dev)
    startt = c_res_second.clamp(min=0)
    fv = (c_f_lo <= c_f_hi)[..., None]
    rv = (c_r_lo <= c_r_hi)[..., None]
    cont_f = fv & (c_f_lo[..., None] >= consts.term_f[:, None, :, 0]) & (
        c_f_hi[..., None] <= consts.term_f[:, None, :, 1])
    cont_r = rv & (c_r_lo[..., None] >= consts.term_r[:, None, :, 0]) & (
        c_r_hi[..., None] <= consts.term_r[:, None, :, 1])
    tmask = ((cont_f | cont_r)
             & (ti[None, None, :] >= startt[..., None])
             & (ti[None, None, :] < consts.n_term[:, None, None])
             & surv[..., None] & may_term[:, None, None])
    t_found = tmask.any(dim=-1)
    imax = torch.where(tmask, ti[None, None, :], -1).amax(dim=-1)

    is_new_res = t_found & (c_res_first == -1)
    new_rank = torch.cumsum(is_new_res.to(I32), dim=1, dtype=I32)
    slot = torch.where(is_new_res, s.res_count[:, None] + new_rank - 1,
                       torch.where(t_found, c_res_first - 1, -1))
    res_overflow = s.res_overflow | (slot >= cfg.RMAX).any(dim=1)
    res_tie = s.res_tie | (run & (tieA | ((tieB | tieC) & need_l1)))
    writer = t_found & (slot >= 0) & (slot < cfg.RMAX)
    c_res_first = torch.where(is_new_res, slot + 1, c_res_first)
    c_res_second = torch.where(t_found, imax, c_res_second)
    res_count = s.res_count + is_new_res.sum(dim=1, dtype=I32)

    # last writer wins: the largest candidate index per result slot
    rr = torch.arange(cfg.RMAX, device=dev)
    src = torch.where(writer[:, :, None] & (slot[:, :, None] == rr[None, None, :]),
                      ci[None, :, None], -1).amax(dim=1)          # [G, RMAX]
    has_src = src >= 0
    srcc = src.clamp(0, C - 1)
    src_parent = parent[srcc.long()]
    src_char = (srcc % 4 + 1).to(I8)
    src_lab = _gather1(s.labels, src_parent)                      # [G, RMAX, MAXLEN]
    iota_m = torch.arange(cfg.MAXLEN, device=dev)[None, None, :]
    wpos_l = iota_m == (cur_len_new[:, None, None] - 1)
    src_lab = torch.where(wpos_l, src_char[..., None], src_lab)
    res_labels = torch.where(has_src[..., None], src_lab, s.res_labels)
    res_len = torch.where(has_src, cur_len_new[:, None].expand(G, cfg.RMAX), s.res_len)
    res_err = torch.where(has_src, torch.gather(gerr, 1, srcc.long()), s.res_err)
    res_i = torch.where(has_src, torch.gather(imax, 1, srcc.long()), s.res_i)

    # ---------- compact survivors into leaf slots (candidate order)
    rank_s = torch.cumsum(surv.to(I32), dim=1, dtype=I32) - 1
    n_surv = surv.sum(dim=1, dtype=I32)
    li = torch.arange(L, dtype=I32, device=dev)
    lsrc = torch.where((surv & (rank_s < L))[:, :, None]
                       & (rank_s[:, :, None] == li[None, None, :]),
                       ci[None, :, None], -1).amax(dim=1)         # [G, L]
    has_leaf = lsrc >= 0
    lsrcc = lsrc.clamp(0, C - 1)

    def upd(old_arr, cand_arr):
        new = torch.where(has_leaf, torch.gather(cand_arr, 1, lsrcc.long()), old_arr)
        return torch.where(run[:, None], new, old_arr)

    new_alive = torch.where(run[:, None], has_leaf, s.alive)
    leaf_parent = parent[lsrcc.long()]
    leaf_char = (lsrcc % 4 + 1)
    leaf_lab = _gather1(s.labels, leaf_parent)
    wpos_f = iota_m == (cur_len_new[:, None, None] - 1)
    leaf_lab = torch.where(wpos_f & cand.any(dim=1)[:, None, None],
                           leaf_char.to(I8)[..., None], leaf_lab)
    new_labels = torch.where(run[:, None, None] & has_leaf[..., None], leaf_lab, s.labels)
    new_ring = torch.where(run[:, None, None] & has_leaf[..., None],
                           _gather1(c_ring, lsrcc), s.ring)

    # ---------- advance the chain ring: new slot j >= 1 = parent slot j-1
    # extended by the leaf's char; slot 0 reseeds from the ck-mer cache
    par_chain = _gather1(s.chain, leaf_parent)                    # [G, L, 4, NC]
    prev = par_chain[..., : NC - 1]
    lsym = leaf_char[..., None].expand(G, L, NC - 1)
    lcsym = rank.comp(lsym)
    a_flo, a_fhi = _lf(ix.rbwt, ix.rbwt.C, lsym, prev[:, :, 0], prev[:, :, 1])
    a_rlo, a_rhi = _lf(ix.bwt, ix.bwt.C, lcsym, prev[:, :, 2], prev[:, :, 3])
    if cfg.SLAB:
        f_empty = prev[:, :, 0] > prev[:, :, 1]
        r_empty = prev[:, :, 2] > prev[:, :, 3]
        a_flo, a_fhi = torch.where(f_empty, 0, a_flo), torch.where(f_empty, -1, a_fhi)
        a_rlo, a_rhi = torch.where(r_empty, 0, a_rlo), torch.where(r_empty, -1, a_rhi)
    adv = torch.stack([a_flo, a_fhi, a_rlo, a_rhi], dim=2)       # [G, L, 4, NC-1]
    c_tail8 = ((par(s.tail8) << 2) | (echar[None, :] - 1)) & ((1 << (2 * cfg.CK)) - 1)
    new_tail8 = upd(s.tail8, c_tail8)
    slot0 = wx.wcache[new_tail8.long()]                           # [G, L, 4]
    new_chain = torch.cat([slot0[..., None], adv], dim=3)
    chain_sel = ((run & success)[:, None] & has_leaf)[:, :, None, None]
    new_chain = torch.where(chain_sel, new_chain, s.chain)

    # >maxLeaves: the reference's while-condition exit (-3, or 1 with
    # results); n_surv > L below it: re-run in the wide config (-200)
    leaves_over = run & (n_surv > cfg.max_leaves)
    code = torch.where(leaves_over, torch.where(res_count > 0, 1, -3), code)
    code = torch.where(run & ~leaves_over & (n_surv > L), -200, code).to(I32)

    rs = run[:, None]
    return WalkState(
        labels=new_labels,
        f_lo=upd(s.f_lo, c_f_lo), f_hi=upd(s.f_hi, c_f_hi),
        r_lo=upd(s.r_lo, c_r_lo), r_hi=upd(s.r_hi, c_r_hi),
        alive=new_alive,
        kmer_freq=upd(s.kmer_freq, c_freq),
        total_kmer=upd(s.total_kmer, c_total_kmer),
        last_seed_idx=upd(s.last_seed_idx, c_last_seed),
        last_overlap_len=upd(s.last_overlap_len, c_last_ovl),
        total_seeds=upd(s.total_seeds, c_total_seeds),
        curr_overlap_len=upd(s.curr_overlap_len, c_curr_ovl),
        num_errors=upd(s.num_errors, c_num_err),
        seed_idx_offset=upd(s.seed_idx_offset, c_sio),
        query_overlap_len=upd(s.query_overlap_len, c_query_ovl),
        nrs=upd(s.nrs, c_nrs),
        res_first=upd(s.res_first, c_res_first),
        res_second=upd(s.res_second, c_res_second),
        tail_letter=upd(s.tail_letter, c_tail_letter),
        tail_count=upd(s.tail_count, c_tail_cnt),
        tail9=upd(s.tail9, c_tail9),
        tail8=new_tail8,
        chain=new_chain,
        local_err=upd(s.local_err, local),
        gerr_last=upd(s.gerr_last, gerr),
        ring=new_ring,
        active=s.active,
        cur_len=torch.where(run, cur_len_new, s.cur_len),
        cur_k=torch.where(run, cur_k_new, s.cur_k),
        gerr_n=torch.where(run & success, n_app, s.gerr_n),
        code=code,
        res_labels=torch.where(run[:, None, None], res_labels, s.res_labels),
        res_len=torch.where(rs, res_len, s.res_len),
        res_err=torch.where(rs, res_err, s.res_err),
        res_i=torch.where(rs, res_i, s.res_i),
        res_count=torch.where(run, res_count, s.res_count),
        res_overflow=torch.where(run, res_overflow, s.res_overflow),
        res_tie=torch.where(run, res_tie, s.res_tie),
    )


def reduce_results_plain(state: WalkState, cfg: WalkConfig) -> Reduced:
    """findTheBestPath's argmin (:214-236): the first slot with the least
    error wins; slots with err >= 1.0 never win (has=False)."""
    RMAX = state.res_err.shape[1]
    n = state.res_count.clamp(max=RMAX)
    slot_ok = torch.arange(RMAX, device=n.device)[None, :] < n[:, None]
    err = torch.where(slot_ok & (state.res_err < 1.0), state.res_err, float("inf"))
    best = err.argmin(dim=1)
    has = torch.gather(err, 1, best[:, None])[:, 0] < 1.0
    lab = _gather1(state.res_labels, best[:, None])[:, 0]
    blen = torch.gather(state.res_len, 1, best[:, None])[:, 0]
    bi = torch.gather(state.res_i, 1, best[:, None])[:, 0]
    return Reduced(code=state.code.clone(), overflow=state.res_overflow.clone(),
                   has=has, lab=lab, len=blen, i=bi, tie=state.res_tie.clone())


# ---------------------------------------------------------------------------
# walk_steps: superstep / multistep / run_to_completion + _reduce_results
# ---------------------------------------------------------------------------

def _check_cfg(cfg: WalkConfig, wx: WalkIndex) -> None:
    if cfg.CAND != 4 * cfg.L:
        raise ValueError(f"CAND {cfg.CAND} != 4 * L {cfg.L}")
    if cfg.CK != wx.ck:
        raise ValueError(f"cfg.CK {cfg.CK} != wcache word length {wx.ck}")


def _cfg_dims(cfg: WalkConfig) -> list[int]:
    return [cfg.L, cfg.MAXLEN, cfg.QMAX, cfg.TMAX, cfg.RMAX, cfg.RING, cfg.KMAX,
            cfg.seed_size, cfg.max_leaves, cfg.CK, int(cfg.SLAB), cfg.SB]


def _tensor_ptrs(name: str, obj, fields, on_card: bool = True) -> list[int]:
    out = []
    for f in fields:
        t = getattr(obj, f)
        if (on_card and not t.is_cuda) or not t.is_contiguous():
            raise ValueError(f"{name}: {f} must be a contiguous CUDA tensor")
        out.append(t.data_ptr())
    return out


def _shared_ptrs(name: str, consts: WalkConsts, on_card: bool = True) -> list[int]:
    return [cuda.check(name, consts.freqs, F32, (101,), on_card),
            cuda.check(name, consts.redeem, F64, (2,), on_card),
            cuda.check(name, consts.err_bound.reshape(1), F64, on_card=on_card)]


def _reduced_empty(G: int, cfg: WalkConfig, dev) -> Reduced:
    return Reduced(
        code=torch.zeros(G, dtype=I32, device=dev),
        overflow=torch.zeros(G, dtype=torch.bool, device=dev),
        has=torch.zeros(G, dtype=torch.bool, device=dev),
        lab=torch.full((G, cfg.MAXLEN), ab.PAD_RANK, dtype=I8, device=dev),
        len=torch.zeros(G, dtype=I32, device=dev),
        i=torch.zeros(G, dtype=I32, device=dev),
        tie=torch.zeros(G, dtype=torch.bool, device=dev))


def walk_steps_plain(wx: WalkIndex, consts: WalkConsts, state: WalkState,
                     cfg: WalkConfig, n: int) -> Reduced:
    """Up to n supersteps (a lane that finished, code != 0, or is inactive
    no longer changes), in place on `state`; then _reduce_results."""
    for _ in range(n):
        if not bool((state.active & (state.code == 0)).any()):
            break
        new = superstep_plain(wx, consts, state, cfg)
        for f in STATE_FIELDS:
            setattr(state, f, getattr(new, f))
    return reduce_results_plain(state, cfg)


def walk_steps(wx: WalkIndex, consts: WalkConsts, state: WalkState,
               cfg: WalkConfig, n: int) -> Reduced:
    """n = 1: one superstep; n = max_steps: run_to_completion (multistep
    of a fixed n is the same loop).  Updates `state` in place and returns
    the per-lane reduction.  Kernel on CUDA tensors, plain version on CPU."""
    _check_cfg(cfg, wx)
    if not state.code.is_cuda:
        return walk_steps_plain(wx, consts, state, cfg, n)
    return _walk_steps_kernel(wx, consts, state, cfg, n)


def _walk_steps_kernel(wx: WalkIndex, consts: WalkConsts, state: WalkState,
                       cfg: WalkConfig, n: int) -> Reduced:
    name = "walk_steps"
    G = state.code.shape[0]
    red = _reduced_empty(G, cfg, state.code.device)
    if G == 0:
        return red
    info = cuda.int_array([0] * 4)
    cuda.launch(name, "lrsc_walk_steps", *steps_args(wx, consts, state, red, cfg, n), info)
    _geometry(name, cfg, info)
    key = replace(cfg, G=0)
    STEP_CONFIGS[key] = STEP_CONFIGS.get(key, 0) + 1
    return red


def steps_args(wx: WalkIndex, consts: WalkConsts, state: WalkState, red: Reduced,
               cfg: WalkConfig, n: int, on_card: bool = True):
    """(pointer array, int array) of lrsc_walk_steps, in csrc/walk.cu's
    order; on_card=False takes CPU tensors (the entry compiled for the
    host, in the tests)."""
    name = "walk_steps"
    G = state.code.shape[0]
    plan = lane_smem_bytes(cfg)
    ptrs = (_index_ptrs(name, wx.ix, on_card) + [cuda.check(name, wx.wcache, I32, on_card=on_card)]
            + _tensor_ptrs(name, consts, CONST_FIELDS, on_card)
            + _shared_ptrs(name, consts, on_card)
            + _tensor_ptrs(name, state, STATE_FIELDS, on_card)
            + _tensor_ptrs(name, red, REDUCED_FIELDS, on_card))
    ints = (_index_dims(wx.ix) + _cfg_dims(cfg)
            + [G, n, plan.total, min(plan.warps_per_block, G)])
    return cuda.ptr_array(ptrs), cuda.int_array(ints)


# ---------------------------------------------------------------------------
# the walk kernels' shared-memory plan and launch geometry
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232448   # shared memory one block may use on the H100 (bytes)
LANE_WARPS = 4        # most gap lanes (warps) per block of the walk kernels
_SCAL, _CAND_W = 28, 24  # ints of a leaf record's scalars, of a candidate's scratch
# the last launch geometry of each walk kernel (from its C entry)
GEOMETRY: dict = {}


@dataclass(frozen=True)
class LanePlan:
    """One gap lane's shared memory (bytes), as csrc/walk.cuh lays it out:
    two records per leaf slot (scalars, chain ring, the f64 error ring),
    the candidates' scratch of a superstep, the result slots, the leaf
    sources and the labels as a history of (symbol, parent slot) bytes."""

    records: int
    candidates: int
    results: int
    leaf_src: int
    history: int
    labels: str            # where the labels live: "shared"
    total: int
    warps_per_block: int   # lanes per block of a launch


def _a16(x: int) -> int:
    return (x + 15) & ~15


def lane_smem_bytes(cfg: WalkConfig) -> LanePlan:
    """The shared-memory plan of one gap lane of the walk kernels; raises
    where the kernels cannot take cfg (a lane above one block's shared
    memory, more than 32 leaf slots or 64 result slots, labels or queries
    of 64k positions)."""
    if not 1 <= cfg.L <= 32 or cfg.RMAX > 64 or max(cfg.MAXLEN, cfg.QMAX) >= 1 << 16:
        raise ValueError(f"walk kernels: L={cfg.L} RMAX={cfg.RMAX} MAXLEN={cfg.MAXLEN} "
                         f"QMAX={cfg.QMAX} out of range")
    rs = _SCAL + 4 * cfg.NCHAIN + 2 * ((cfg.RING + 1) & ~1)
    parts = dict(records=2 * cfg.L * rs * 4, candidates=4 * cfg.L * _CAND_W * 4,
                 results=_a16(6 * cfg.RMAX * 4), leaf_src=_a16(cfg.L * 4),
                 history=_a16(cfg.MAXLEN * cfg.L))
    total = sum(parts.values())
    if total > SMEM_LIMIT:
        raise ValueError(f"walk kernels: a lane of {cfg} needs {total} bytes of shared "
                         f"memory, above {SMEM_LIMIT}")
    return LanePlan(**parts, labels="shared", total=total,
                    warps_per_block=min(LANE_WARPS, SMEM_LIMIT // total))


def _geometry(name: str, cfg: WalkConfig, info) -> None:
    per_sm, warps, blocks, smem = list(info)
    GEOMETRY[name] = dict(L=cfg.L, MAXLEN=cfg.MAXLEN, KMAX=cfg.KMAX, blocks_per_sm=per_sm,
                          warps_per_block=warps, warps_per_sm=per_sm * warps,
                          blocks=blocks, smem_per_block=smem,
                          lane_bytes=lane_smem_bytes(cfg).total)


# ---------------------------------------------------------------------------
# walk_queue: the persistent queue engine (queue_run)
# ---------------------------------------------------------------------------

def _bank_rows(bank: QueueBank, idx):
    """(WalkConsts, RootPack) of the bank rows idx."""
    c = replace(bank.consts, **{f: getattr(bank.consts, f)[idx] for f in CONST_FIELDS})
    r = RootPack(**{f: getattr(bank.root, f)[idx] for f in ROOT_FIELDS})
    return c, r


def walk_queue_plain(wx: WalkIndex, bank: QueueBank, n: int, cfg: WalkConfig,
                     max_steps: int) -> Reduced:
    """Walk tasks 0..n-1 of the bank, cfg.G lanes at a time, each task to
    completion or max_steps supersteps (code -900); per-task reductions
    [T] (code 0 = never run).  A task's result depends on the task alone,
    so the lane that walks it does not matter."""
    T = bank.consts.q_len.shape[0]
    dev = bank.consts.q_len.device
    out = _reduced_empty(T, cfg, dev)
    for a in range(0, n, cfg.G):
        idx = torch.arange(a, min(a + cfg.G, n), device=dev)
        consts, root = _bank_rows(bank, idx)
        st = init_state(consts, root, torch.ones(len(idx), dtype=torch.bool, device=dev), cfg)
        walk_steps_plain(wx, consts, st, cfg, max_steps)
        st.code = torch.where(st.active & (st.code == 0), -900, st.code).to(I32)
        red = reduce_results_plain(st, cfg)
        for f in REDUCED_FIELDS:
            getattr(out, f)[idx] = getattr(red, f)
    return out


def walk_queue(wx: WalkIndex, bank: QueueBank, n: int, cfg: WalkConfig,
               max_steps: int) -> Reduced:
    """queue_run of the JAX module: the n tasks of the bank, each walked to
    completion (or flagged -900 after max_steps supersteps), per-task
    reductions [T].  Kernel on CUDA tensors: as many warps as fit the card
    (one lane each, its state in shared memory), each taking the next task
    from a head counter as it finishes one; plain version on CPU (cfg.G
    lanes in lockstep).
    The JAX loop's global bound max_total (never reached) has no
    counterpart: each task is bounded by max_steps, so a launch ends after
    at most ceil(n / G) * max_steps supersteps per lane."""
    _check_cfg(cfg, wx)
    if not bank.consts.q_len.is_cuda:
        return walk_queue_plain(wx, bank, n, cfg, max_steps)
    return _walk_queue_kernel(wx, bank, n, cfg, max_steps)


def _walk_queue_kernel(wx: WalkIndex, bank: QueueBank, n: int, cfg: WalkConfig,
                       max_steps: int) -> Reduced:
    name = "walk_queue"
    T = bank.consts.q_len.shape[0]
    out = _reduced_empty(T, cfg, bank.consts.q_len.device)
    if n == 0:
        return out
    info = cuda.int_array([0] * 4)
    head = torch.zeros(1, dtype=I32, device=bank.consts.q_len.device)
    cuda.launch(name, "lrsc_walk_queue",
                *queue_args(wx, bank, out, head, n, cfg, max_steps), info)
    _geometry(name, cfg, info)
    return out


def queue_args(wx: WalkIndex, bank: QueueBank, out: Reduced, head, n: int,
               cfg: WalkConfig, max_steps: int, on_card: bool = True):
    """(pointer array, int array) of lrsc_walk_queue, in csrc/walk.cu's
    order (head: an int32 [1] zero, the task counter)."""
    name = "walk_queue"
    plan = lane_smem_bytes(cfg)
    ptrs = (_index_ptrs(name, wx.ix, on_card) + [cuda.check(name, wx.wcache, I32, on_card=on_card)]
            + _tensor_ptrs(name, bank.consts, CONST_FIELDS, on_card)
            + _shared_ptrs(name, bank.consts, on_card)
            + _tensor_ptrs(name, out, REDUCED_FIELDS, on_card)
            + _tensor_ptrs(name, bank.root, ROOT_FIELDS, on_card)
            + [cuda.check(name, head, I32, (1,), on_card)])
    ints = (_index_dims(wx.ix) + _cfg_dims(cfg)
            + [max_steps, n, plan.total, min(plan.warps_per_block, n)])
    return cuda.ptr_array(ptrs), cuda.int_array(ints)


# ---------------------------------------------------------------------------
# host side: batches, banks, results
# ---------------------------------------------------------------------------

def _expected_freqs(tasks, pacbio_error_rate: float, pb_coverage: int) -> np.ndarray:
    freqs = np.zeros(101, np.float32)
    mo = min((t.min_overlap for t in tasks), default=13)
    for i in range(mo, 101):
        freqs[i] = ((1 - pacbio_error_rate) ** i) * pb_coverage
    return freqs


def _task_arrays(tasks, cfg: WalkConfig, T: int, bank: bool):
    """numpy per-task inputs of the prep (JAX build_batch / build_bank)."""
    n = len(tasks)
    query = np.full((T, cfg.QMAX), ab.PAD_RANK, np.int8)
    trg = np.full((T, cfg.TMAX + cfg.KMAX), ab.PAD_RANK, np.int8)
    a = {k: np.zeros(T, np.int32) for k in (
        "q_len", "trg_len", "n_term", "init_k", "max_overlap", "max_indel",
        "max_length", "min_length")}
    a["min_overlap"] = np.full(T, 13, np.int32)
    a["min_sa"] = np.full(T, 3, np.int32)
    a["no_term"] = np.zeros(T, bool)
    used = np.zeros(T, bool)
    for g, t in enumerate(tasks):
        q = t.src[len(t.src) - t.init_k:] + t.path + t.trg
        q_enc = ab.encode(q)
        t_enc = ab.encode(t.trg)
        if bank:
            # the JAX bank ships 2-bit symbols: inside a row '$' becomes A
            q_enc = np.clip(q_enc, 1, 4)
            t_enc = np.clip(t_enc, 1, 4)
        assert len(q) <= cfg.QMAX, (len(q), cfg.QMAX)
        assert len(t.trg) - t.min_overlap + 1 <= cfg.TMAX
        query[g, : len(q)] = q_enc
        trg[g, : len(t_enc)] = t_enc
        a["q_len"][g] = len(q)
        a["trg_len"][g] = len(t.trg)
        a["n_term"][g] = max(len(t.trg) - t.min_overlap + 1, 0)
        a["init_k"][g] = t.init_k
        a["max_overlap"][g] = t.max_overlap
        a["min_overlap"][g] = t.min_overlap
        a["min_sa"][g] = t.min_sa_threshold
        assert t.max_overlap + 1 <= cfg.KMAX and t.init_k <= cfg.KMAX
        assert t.min_overlap >= cfg.CK + 1, "chain cache requires minOverlap >= CK+1"
        a["max_indel"][g] = int(t.dis * 0.2) if t.dis > 100 else 20
        a["max_length"][g] = int(1.2 * (t.dis + 10) + 2 * t.init_k)
        v = 0.8 * (t.dis - 20) + 2 * t.init_k
        if v >= 0:
            a["min_length"][g] = int(v)
        else:
            a["no_term"][g] = True  # size_t wrap: termination never fires
        assert a["max_length"][g] + 2 <= cfg.MAXLEN, (a["max_length"][g], cfg.MAXLEN)
        assert cfg.WSCAN >= 2 * a["max_indel"][g] + cfg.seed_size * 2 + 3
        used[g] = True
    n_ = max(n, 1)
    kb_term = max(int(a["min_overlap"][:n_].max()), 2) if n else 2
    kb_root = max(int(a["init_k"][:n_].max()), 2) if n else 2
    return query, trg, a, used, kb_term, kb_root


def _prep_tasks(wx: WalkIndex, tasks, cfg, T, bank, pacbio_error_rate,
                pb_coverage, use_wcache):
    query, trg, a, used, kb_term, kb_root = _task_arrays(tasks, cfg, T, bank)
    dev = wx.device

    def up(x):
        return torch.from_numpy(x).to(dev)

    consts, root = prep(
        wx, up(query), up(a["q_len"]), up(trg), up(a["trg_len"]), up(a["n_term"]),
        up(a["init_k"]), up(a["max_overlap"]), up(a["min_overlap"]),
        up(a["min_sa"]), up(a["max_indel"]), up(a["max_length"]),
        up(a["min_length"]), up(a["no_term"]),
        up(_expected_freqs(tasks, pacbio_error_rate, pb_coverage)),
        pacbio_error_rate, cfg, kb_term, kb_root, use_wcache)
    return consts, root, up(used)


def build_batch(wx: WalkIndex, tasks: list[GapTask], cfg: WalkConfig,
                pacbio_error_rate: float, pb_coverage: int):
    """(WalkConsts, WalkState) of a batch of at most cfg.G tasks (JAX
    build_batch + _prep_batch: chains by plain LF, no ck-mer cache)."""
    assert len(tasks) <= cfg.G
    consts, root, used = _prep_tasks(wx, tasks, cfg, cfg.G, False,
                                     pacbio_error_rate, pb_coverage, False)
    return consts, init_state(consts, root, used, cfg)


def build_bank(wx: WalkIndex, tasks: list[GapTask], cfg: WalkConfig,
               pacbio_error_rate: float, pb_coverage: int) -> QueueBank:
    """QueueBank of the tasks (JAX build_bank + _prep_bank_packed): chains
    seeded from the ck-mer cache when every task's chains reach length CK."""
    use_wc = bool(tasks) and all(t.init_k >= cfg.CK and t.min_overlap >= cfg.CK
                                 for t in tasks)
    consts, root, _ = _prep_tasks(wx, tasks, cfg, len(tasks), True,
                                  pacbio_error_rate, pb_coverage, use_wc)
    return QueueBank(consts=consts, root=root)


def finalize_gap(task: GapTask, red: dict, g: int) -> tuple[int, str]:
    """(code, merged sequence) of a finished lane (from its reduction)."""
    code = int(red["code"][g])
    if code != 1:
        return code, ""
    if not red["has"][g]:
        return -4, ""
    ln = int(red["len"][g])
    thread = red["lab_row"](g, ln)
    i = int(red["i"][g])
    if len(task.trg) > task.min_overlap:
        thread += task.trg[i + task.min_overlap:]
    return 1, thread


def _to_host(red: Reduced) -> dict:
    out = {f: getattr(red, f).cpu().numpy() for f in REDUCED_FIELDS}
    lab = out["lab"]
    W = lab.shape[1]
    lab_bytes = ab.RANK_TO_CHAR[np.clip(lab, 0, 5).astype(np.int64)].tobytes()
    out["lab_row"] = lambda g, ln: lab_bytes[g * W : g * W + ln].decode()
    return out


def submit_gap_batch(wx: WalkIndex, tasks, cfg: WalkConfig,
                     pacbio_error_rate: float, pb_coverage: int,
                     max_steps: int = 4096):
    """Enqueue one gap batch on the device without waiting for it."""
    consts, state = build_batch(wx, tasks, cfg, pacbio_error_rate, pb_coverage)
    return tasks, cfg, walk_steps(wx, consts, state, cfg, max_steps)


def run_gap_batch(host_ix, wx: WalkIndex, tasks, cfg: WalkConfig,
                  pacbio_error_rate: float, pb_coverage: int,
                  max_steps: int = 4096, _handle=None, why: list | None = None,
                  ties: list | None = None):
    """[(code, merged_seq)] of a batch of GapTasks, -100 where the host
    engine must replay (flagged, or not converged in max_steps); -200 and
    -300 lanes are re-run in the wide and the dense config.  why, if
    given, is extended by one entry per task: the FLAG_REASONS entry of a
    -100 (of the task's last run), None for any other code; ties, if
    given, by the tie bit of each task's last run (Reduced.tie)."""
    if _handle is None:
        _handle = submit_gap_batch(wx, tasks, cfg, pacbio_error_rate,
                                   pb_coverage, max_steps)
    return _collect(host_ix, wx, _handle, pacbio_error_rate, pb_coverage, max_steps,
                    why, ties)


# why a lane comes back -100: more results than RMAX slots (slots), no end
# in max_steps (unfinished: code 0, or -900 in the queue), more leaves than
# max_leaves at the widest config (leaves).  hazard is never given (the
# walk decides its ties in f64); its counter stays, and reads 0
FLAG_REASONS = ("hazard", "slots", "unfinished", "leaves")


def _collect(host_ix, wx, handle, pacbio_error_rate, pb_coverage, max_steps, why,
             ties=None):
    """run_gap_batch / collect_queue_batch of a handle whose reductions were
    launched: -100 where the host engine must replay, -200 / -300 lanes
    re-run (_retry_flagged), the rest finalized; why and ties as
    run_gap_batch's."""
    tasks, cfg, red = handle
    red = _to_host(red)
    out, reasons, retry, retry_dense = [], [], [], []
    tie = [bool(x) for x in red["tie"][: len(tasks)]]
    for g, t in enumerate(tasks):
        c = int(red["code"][g])
        reason = None
        if red["overflow"][g]:
            reason = "slots"
        elif c in (0, -900):
            reason = "unfinished"
        reasons.append(reason)
        if reason is not None:
            out.append((-100, ""))
        elif c == -200:
            out.append(None)
            retry.append(g)
        elif c == -300:
            out.append(None)
            retry_dense.append(g)
        else:
            out.append(finalize_gap(t, red, g))
    _retry_flagged(host_ix, wx, tasks, out, reasons, tie, retry, retry_dense, cfg,
                   pacbio_error_rate, pb_coverage, max_steps)
    if why is not None:
        why.extend(reasons)
    if ties is not None:
        ties.extend(tie)
    return out


def _retry_flagged(host_ix, wx, tasks, out, reasons, tie, retry, retry_dense,
                   cfg: WalkConfig, pacbio_error_rate, pb_coverage, max_steps):
    """Re-run -200 (leaf-slot overflow) gaps in the wide config and -300
    (slab-span overflow) gaps on the dense engine; fill `out`, `reasons`
    and `tie`."""
    if retry_dense:
        _rerun(host_ix, wx, tasks, out, reasons, tie, retry_dense, dense_config(cfg),
               pacbio_error_rate, pb_coverage, max_steps)
    if retry:
        if cfg.L >= cfg.max_leaves:
            for g in retry:
                out[g] = (-100, "")
                reasons[g] = "leaves"
        else:
            _rerun(host_ix, wx, tasks, out, reasons, tie, retry, wide_config(cfg),
                   pacbio_error_rate, pb_coverage, max_steps)


def dense_config(cfg: WalkConfig) -> WalkConfig:
    """The rerun config of -300 (slab-span overflow) lanes."""
    return replace(cfg, SLAB=False)


def wide_config(cfg: WalkConfig) -> WalkConfig:
    """The rerun config of -200 (leaf-slot overflow) lanes."""
    return replace(cfg, L=cfg.max_leaves, CAND=4 * cfg.max_leaves)


def _rerun(host_ix, wx, tasks, out, reasons, tie, which, cfg, pacbio_error_rate,
           pb_coverage, max_steps):
    sub = [tasks[g] for g in which]
    for base in range(0, len(sub), cfg.G):
        chunk = sub[base : base + cfg.G]
        why: list = []
        ties: list = []
        res = run_gap_batch(host_ix, wx, chunk, replace(cfg, G=len(chunk)),
                            pacbio_error_rate, pb_coverage, max_steps, why=why, ties=ties)
        for j, (r, w, x) in enumerate(zip(res, why, ties)):
            out[which[base + j]] = r
            reasons[which[base + j]] = w
            tie[which[base + j]] = x


def submit_queue_batch(wx: WalkIndex, tasks, cfg: WalkConfig,
                       pacbio_error_rate: float, pb_coverage: int,
                       max_steps: int = 4096):
    """Enqueue a queue-engine round without waiting for it."""
    bank = build_bank(wx, tasks, cfg, pacbio_error_rate, pb_coverage)
    return tasks, cfg, walk_queue(wx, bank, len(tasks), cfg, max_steps)


def collect_queue_batch(host_ix, wx: WalkIndex, handle, pacbio_error_rate,
                        pb_coverage, why: list | None = None, ties: list | None = None):
    """Wait for a submit_queue_batch handle; returns [(code, seq)], -100
    where the host engine must replay (flag / timeout / not run); why and
    ties as run_gap_batch's."""
    return _collect(host_ix, wx, handle, pacbio_error_rate, pb_coverage, 4096, why, ties)
