"""Per-position multi-k k-mer frequency tables (the seed phase's first stage).

For every (read, pos) lane, the both-strand frequency and validity of the
k-mer reads[pos : pos+k], from one incremental bi-interval LF chain per
lane (LongReadProbe.cpp:136-158, KmerFeature.h:37-64).  A k-mer whose
window runs past the read end is fake: freq -1, valid False
(KmerFeature.h:62,90).

The counterparts of the JAX package's ops/scan.py, each a wrapper that
launches a kernel for CUDA tensors and runs its ``*_plain`` twin, the
lockstep transcript of the JAX function, for CPU tensors:

* ``kmer_table_full``   every k in 1..max_k (csrc/kmer_table.cu), a lane's
  levels up to its first non-ACGT symbol (at most ck) read from the walk
  index's interval-table pyramid;
* ``kmer_table_wire``   the same table as int16 freq and valid packed 8
  k-levels per byte (csrc/kmer_table.cu), from the pyramid as
  ``kmer_table_full``; ``unpack_valid_bits`` undoes the packing on the
  host;
* ``kmer_freq_scan``    freq for each k of a pool (csrc/kmer_table.cu), from
  the pyramid as ``kmer_table_full`` where it is given;
* ``build_plane_rows``  the index as bit-plane rows (csrc/planes.cu);
* ``kmer_table_planes`` ``kmer_table_full`` on the plane rows, its chain
  seeded at k = ck from the walk's ck-mer interval table (csrc/planes.cu).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import alphabet as ab
from ..index.fmindex import FMIndex, IndexSet
from . import cuda, rank

I32 = torch.int32
MAX_POOL = 16      # pool sizes a kmer_freq_scan launch takes (kmer_table.cu)
MAX_PYRAMID = 12   # deepest interval-table pyramid kmer_table_full takes (kmer_table.cu)
PLANE_WORDS = 4    # 32-symbol words per plane of a 128-symbol block
PLANE_ROW = 3 * PLANE_WORDS + 5


def _next_syms(sym0: torch.Tensor, j: int) -> torch.Tensor:
    """sym0 shifted left by j, PAD_RANK past the row."""
    R, L = sym0.shape
    nxt = torch.full((R, L), ab.PAD_RANK, dtype=I32, device=sym0.device)
    nxt[:, : max(L - j, 0)] = sym0[:, j:]
    return nxt


def _ladder_plain(step, state, sym0, lengths, j0: int, j1: int, emit) -> None:
    """The levels j0..j1 of the lanes' chain from state (level j0):
    emit(j, fake, state) at each; step(state, sym) is the LF step."""
    R, L = sym0.shape
    pos = torch.arange(L, dtype=I32, device=sym0.device)[None, :]
    lens = lengths.to(I32)[:, None]
    for j in range(j0, j1 + 1):
        emit(j, pos + j > lens, state)
        if j == j1:
            break
        nxt = _next_syms(sym0, j)
        live = nxt < 5
        new_state = step(state, nxt.clamp(0, 4))
        state = tuple(torch.where(live, n, o) for n, o in zip(new_state, state))


def _bi_valid(state) -> torch.Tensor:
    f_lo, f_hi, r_lo, r_hi = state
    return (f_lo <= f_hi) & (r_lo <= r_hi)


def kmer_table_full_plain(ix: IndexSet, reads: torch.Tensor, lengths: torch.Tensor,
                          max_k: int):
    """freq int32 [max_k+1, R, L], valid bool [max_k+1, R, L] in plain torch."""
    R, L = reads.shape
    sym0 = reads.to(I32)
    minus1 = torch.full((R, L), -1, dtype=I32, device=reads.device)
    freqs = [minus1]
    valids = [torch.zeros((R, L), dtype=torch.bool, device=reads.device)]

    def emit(j, fake, state):
        freqs.append(torch.where(fake, minus1, rank.bi_freq(state)))
        valids.append(~fake & _bi_valid(state))

    _ladder_plain(lambda st, s: rank.extend_bi(ix, st, s),
                  rank.init_bi(ix, sym0.clamp(0, 4)), sym0, lengths, 1, max_k, emit)
    return torch.stack(freqs), torch.stack(valids)


def _index_args(name: str, ix: IndexSet, reads: torch.Tensor, on_card: bool = True) -> list:
    """The kernel arguments of the index pair, RBWT first."""
    out = []
    for fm in (ix.rbwt, ix.bwt):
        if fm.block != 128:
            raise ValueError(f"{name}: the kernel takes 128-symbol blocks, got {fm.block}")
        if fm.blocks.data_ptr() % 16:
            raise ValueError(f"{name}: blocks must be 16-byte aligned")
        out += [cuda.check(name, fm.blocks, torch.int8, on_card=on_card),
                cuda.check(name, fm.ckpt, I32, (fm.blocks.shape[0], 5), on_card=on_card),
                cuda.check(name, fm.C, I32, (6,), on_card=on_card), fm.blocks.shape[0]]
    if reads.device != ix.rbwt.blocks.device:
        raise ValueError(f"{name}: reads on {reads.device}, index on {ix.rbwt.blocks.device}")
    return out


def _read_args(name: str, reads: torch.Tensor, lengths: torch.Tensor,
               on_card: bool = True) -> list:
    R, L = reads.shape
    return [cuda.check(name, reads, torch.int8, on_card=on_card),
            cuda.check(name, lengths, I32, (R,), on_card=on_card), R, L]


def kmer_table_full(ix: IndexSet, reads: torch.Tensor, lengths: torch.Tensor,
                    max_k: int, levels=None):
    """freq int32 [max_k+1, R, L] (-1 where fake), valid bool [max_k+1, R, L].

    reads int8 [R, L] rank symbols padded with PAD_RANK, lengths int32 [R].
    levels: the walk index over ix (ops/walk.WalkIndex: its interval-table
    pyramid and ck), from which the kernel reads each lane's levels up to
    its first non-ACGT symbol or ck; None runs every lane's ladder from
    level 1.  The table is the same either way.
    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if not reads.is_cuda:
        return kmer_table_full_plain(ix, reads, lengths, max_k)
    R, L = reads.shape
    freq = torch.empty((max_k + 1, R, L), dtype=I32, device=reads.device)
    valid = torch.empty((max_k + 1, R, L), dtype=torch.bool, device=reads.device)
    cuda.launch("kmer_table_full", "lrsc_kmer_table_full",
                *kmer_table_full_args(ix, reads, lengths, max_k, levels, freq, valid))
    return freq, valid


def kmer_table_full_args(ix: IndexSet, reads, lengths, max_k: int, levels, freq, valid,
                         on_card: bool = True) -> list:
    """The arguments of lrsc_kmer_table_full but the stream (on_card=False
    takes CPU tensors: the C entry compiled for the host, in the tests)."""
    name = "kmer_table_full"
    K = max_k + 1
    R, L = reads.shape
    out = [cuda.check(name, t, dt, (K, R, L), on_card=on_card)
           for t, dt in ((freq, I32), (valid, torch.bool))]
    return (_index_args(name, ix, reads, on_card) + _pyramid_args(name, levels, reads, on_card)
            + _read_args(name, reads, lengths, on_card) + [max_k] + out)


def _pyramid_args(name: str, levels, reads: torch.Tensor, on_card: bool = True) -> list:
    """The kernel arguments of a walk index's pyramid: its levels below ck,
    level ck (the wcache) and ck; (0, 0, 0) for none."""
    if levels is None:
        return [0, 0, 0]
    ck = levels.ck
    if not 1 <= ck <= MAX_PYRAMID:
        raise ValueError(f"{name}: the kernel takes a pyramid of 1..{MAX_PYRAMID} levels, "
                         f"got ck={ck}")
    out = []
    for t, rows in ((levels.pyramid, (4 ** ck - 4) // 3), (levels.wcache, 4 ** ck)):
        if t.device != reads.device:
            raise ValueError(f"{name}: pyramid on {t.device}, reads on {reads.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: pyramid tables must be 16-byte aligned")
        out.append(cuda.check(name, t, I32, (rows, 4), on_card=on_card))
    return out + [ck]


# ---------------------------------------------------------------------------
# the wire format: int16 freq, valid bit-packed
# ---------------------------------------------------------------------------

def kmer_table_wire_plain(ix: IndexSet, reads: torch.Tensor, lengths: torch.Tensor,
                          max_k: int):
    """freq int16 [K, R, L], vbits uint8 [ceil(K/8), R, L] in plain torch."""
    freq, valid = kmer_table_full_plain(ix, reads, lengths, max_k)
    f16 = freq.clamp(-1, 32767).to(torch.int16)
    K = valid.shape[0]
    pad = (-K) % 8
    v = torch.cat([valid, valid.new_zeros((pad, *valid.shape[1:]))])
    v = v.reshape(-1, 8, *valid.shape[1:]).to(torch.uint8)
    bits = torch.arange(8, dtype=torch.uint8, device=v.device)[None, :, None, None]
    vbits = (v << bits).sum(dim=1, dtype=torch.uint8)
    return f16, vbits


def kmer_table_wire(ix: IndexSet, reads: torch.Tensor, lengths: torch.Tensor,
                    max_k: int, levels=None):
    """kmer_table_full in wire format for the host seed scan: freq as int16
    (clipped at 32767; the dynamic-kmer thresholds top out around ~700) and
    valid packed 8 k-levels per byte, bit b of byte g = row 8g + b.
    Returns (freq int16 [K, R, L], vbits uint8 [ceil(K/8), R, L]), K = max_k+1.
    levels: the walk index over ix, as for kmer_table_full; None runs every
    lane's ladder from level 1.  The table is the same either way.
    """
    if not reads.is_cuda:
        return kmer_table_wire_plain(ix, reads, lengths, max_k)
    R, L = reads.shape
    K = max_k + 1
    freq = torch.empty((K, R, L), dtype=torch.int16, device=reads.device)
    vbits = torch.empty(((K + 7) // 8, R, L), dtype=torch.uint8, device=reads.device)
    cuda.launch("kmer_table_wire", "lrsc_kmer_table_wire",
                *kmer_table_wire_args(ix, reads, lengths, max_k, levels, freq, vbits))
    return freq, vbits


def kmer_table_wire_args(ix: IndexSet, reads, lengths, max_k: int, levels, freq, vbits,
                         on_card: bool = True) -> list:
    """The arguments of lrsc_kmer_table_wire but the stream (on_card=False
    takes CPU tensors: the C entry compiled for the host, in the tests)."""
    name = "kmer_table_wire"
    K = max_k + 1
    R, L = reads.shape
    out = [cuda.check(name, freq, torch.int16, (K, R, L), on_card=on_card),
           cuda.check(name, vbits, torch.uint8, ((K + 7) // 8, R, L), on_card=on_card)]
    return (_index_args(name, ix, reads, on_card) + _pyramid_args(name, levels, reads, on_card)
            + _read_args(name, reads, lengths, on_card) + [max_k] + out)


def unpack_valid_bits(vbits: np.ndarray, n_k: int) -> np.ndarray:
    """Host-side inverse of kmer_table_wire's bit packing -> bool [n_k, R, L]."""
    b = np.unpackbits(vbits[:, None], axis=1, bitorder="little")
    return b.reshape(-1, *vbits.shape[1:])[:n_k].astype(bool)


# ---------------------------------------------------------------------------
# freq over a pool of k
# ---------------------------------------------------------------------------

def kmer_freq_scan_plain(ix: IndexSet, reads: torch.Tensor, lengths: torch.Tensor,
                         pool: tuple[int, ...]):
    """freqs int32 [len(pool), R, L] in plain torch."""
    pool = tuple(pool)
    if tuple(sorted(pool)) != pool:
        raise ValueError(f"kmer_freq_scan: pool {pool} is not ascending")
    R, L = reads.shape
    sym0 = reads.to(I32)
    minus1 = torch.full((R, L), -1, dtype=I32, device=reads.device)
    freqs = []

    def emit(j, fake, state):
        if j in pool:
            freqs.append(torch.where(fake, minus1, rank.bi_freq(state)))

    _ladder_plain(lambda st, s: rank.extend_bi(ix, st, s),
                  rank.init_bi(ix, sym0.clamp(0, 4)), sym0, lengths, 1, pool[-1], emit)
    return torch.stack(freqs)


def kmer_freq_scan(ix: IndexSet, reads: torch.Tensor, lengths: torch.Tensor,
                   pool: tuple[int, ...], levels=None):
    """Bi-strand k-mer frequencies at every position for every k in pool.

    reads int8 [R, L] rank symbols padded with PAD_RANK, lengths int32 [R],
    pool ascending k sizes.  Returns int32 [len(pool), R, L]; -1 where the
    k-mer is fake (pos + k > read length).  levels: the walk index over ix
    (ops/walk.WalkIndex), from whose pyramid the kernel reads each lane's
    pool entries and start up to its first non-ACGT symbol or ck; None runs
    every lane's ladder from level 1.  The table is the same either way.
    """
    if not reads.is_cuda:
        return kmer_freq_scan_plain(ix, reads, lengths, pool)
    freq = torch.empty((len(pool), *reads.shape), dtype=I32, device=reads.device)
    cuda.launch("kmer_freq_scan", "lrsc_kmer_freq_scan",
                *kmer_freq_scan_args(ix, reads, lengths, pool, levels, freq))
    return freq


def kmer_freq_scan_args(ix: IndexSet, reads, lengths, pool, levels, freq,
                        on_card: bool = True) -> list:
    """The arguments of lrsc_kmer_freq_scan but the stream (on_card=False
    takes CPU tensors: the C entry compiled for the host, in the tests)."""
    name = "kmer_freq_scan"
    pool = tuple(int(k) for k in pool)
    if not (0 < len(pool) <= MAX_POOL and pool[0] >= 1
            and all(a < b for a, b in zip(pool, pool[1:]))):
        raise ValueError(f"{name}: the kernel takes 1-{MAX_POOL} strictly ascending "
                         f"sizes >= 1, got {pool}")
    out = cuda.check(name, freq, I32, (len(pool), *reads.shape), on_card=on_card)
    return (_index_args(name, ix, reads, on_card) + _pyramid_args(name, levels, reads, on_card)
            + _read_args(name, reads, lengths, on_card)
            + [cuda.int_array(pool), len(pool), out])


def kmer_freq_single(ix: IndexSet, reads: torch.Tensor, lengths: torch.Tensor, k: int,
                     levels=None):
    """Frequencies for one k, [R, L]."""
    return kmer_freq_scan(ix, reads, lengths, (k,), levels)[0]


# ---------------------------------------------------------------------------
# bit-plane rows and the table counted on them
# ---------------------------------------------------------------------------
#
# Each 128-symbol block as 3 bit-planes (4 int32 words each) + its 5
# checkpoint counts in one 68-byte row: occ is XOR/AND word math and a
# population count over 4 words, against a 128-byte row and a checkpoint
# word in the block layout.

@dataclass(frozen=True)
class PlaneFM:
    """One BWT as bit-plane rows: prows int32 [nb, 17] = 3 planes x 4 words
    + ckpt; C int32 [6]."""

    prows: torch.Tensor
    C: torch.Tensor
    block: int


@dataclass(frozen=True)
class PlaneIndexSet:
    fwd: PlaneFM   # RBWT (fwd-extension side)
    rev: PlaneFM   # BWT


def build_plane_rows_plain(blocks: torch.Tensor, ckpt: torch.Tensor) -> torch.Tensor:
    """int32 [nb, 17] plane rows in plain torch."""
    nb, B = blocks.shape
    if B % 32:
        raise ValueError(f"build_plane_rows: block {B} is not a multiple of 32")
    sh = torch.arange(32, dtype=torch.int64, device=blocks.device)
    words = []
    for i in range(3):
        bits = ((blocks >> i) & 1).to(torch.int64).reshape(nb, B // 32, 32)
        w = (bits << sh).sum(dim=-1)
        words.append(torch.where(w >= 1 << 31, w - (1 << 32), w).to(I32))
    return torch.cat(words + [ckpt.to(I32)], dim=1)


def build_plane_rows(blocks: torch.Tensor, ckpt: torch.Tensor) -> torch.Tensor:
    """blocks int8 [nb, 128], ckpt int32 [nb, 5] -> int32 [nb, 17]: bit j of
    word w of plane i is bit i of symbol 32w + j, then the 5 counts."""
    if not blocks.is_cuda:
        return build_plane_rows_plain(blocks, ckpt)
    out = torch.empty((blocks.shape[0], PLANE_ROW), dtype=I32, device=blocks.device)
    cuda.launch("plane_rows", "lrsc_plane_rows", *plane_rows_args(blocks, ckpt, out))
    return out


def plane_rows_args(blocks: torch.Tensor, ckpt: torch.Tensor, out: torch.Tensor,
                    on_card: bool = True) -> list:
    """The arguments of lrsc_plane_rows but the stream (on_card=False takes
    CPU tensors: the C entry compiled for the host, in the tests)."""
    name = "plane_rows"
    nb = blocks.shape[0]
    if tuple(blocks.shape) != (nb, 128):
        raise ValueError(f"{name}: the kernel takes 128-symbol blocks, got {tuple(blocks.shape)}")
    if blocks.data_ptr() % 16:
        raise ValueError(f"{name}: blocks must be 16-byte aligned")
    return [cuda.check(name, blocks, torch.int8, on_card=on_card),
            cuda.check(name, ckpt, I32, (nb, 5), on_card=on_card), nb,
            cuda.check(name, out, I32, (nb, PLANE_ROW), on_card=on_card)]


def _plane_fm(fm: FMIndex) -> PlaneFM:
    return PlaneFM(prows=build_plane_rows(fm.blocks, fm.ckpt), C=fm.C, block=fm.block)


def build_planes(ix: IndexSet) -> PlaneIndexSet:
    return PlaneIndexSet(fwd=_plane_fm(ix.rbwt), rev=_plane_fm(ix.bwt))


def plane_index_of(host_ix, dev_ix) -> PlaneIndexSet:
    """The PlaneIndexSet of a device index (an IndexSet or a WalkIndex),
    built once per device and cached on its host index."""
    ix = dev_ix.ix if hasattr(dev_ix, "ix") else dev_ix
    cache = host_ix.__dict__.setdefault("_plane_ix", {})
    key = str(ix.device)
    if key not in cache:
        cache[key] = build_planes(ix)
    return cache[key]


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of the low 32 bits of int64 x."""
    x = x & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _occ_planes(pf: PlaneFM, sym: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """#occurrences of sym in BWT[0..idx]; same contract as rank.occ."""
    B = pf.block
    W = B // 32
    p = idx.to(I32) + 1
    q = torch.div(p, B, rounding_mode="floor")
    r = p - q * B
    row = pf.prows[q.clamp(0, pf.prows.shape[0] - 1).long()].to(torch.int64)
    sym64 = sym.to(torch.int64)
    ck = torch.gather(row, -1, (3 * W + sym64)[..., None])[..., 0]
    e = [-((sym64 >> i) & 1) for i in range(3)]
    cnt = torch.zeros(p.shape, dtype=torch.int64, device=p.device)
    for w in range(W):
        match = ~((row[..., w] ^ e[0]) | (row[..., W + w] ^ e[1])
                  | (row[..., 2 * W + w] ^ e[2]))
        k = (r - 32 * w).to(torch.int64)
        mask = torch.where(k <= 0, 0,
                           torch.where(k >= 32, -1, (1 << k.clamp(0, 31)) - 1))
        cnt = cnt + _popcount32(match & mask)
    return (ck + cnt).to(I32)


def _update_planes(pf: PlaneFM, lo, hi, sym):
    pb = pf.C[sym.long()]
    return pb + _occ_planes(pf, sym, lo - 1), pb + _occ_planes(pf, sym, hi) - 1


def plane_codes(reads: torch.Tensor, ck: int) -> torch.Tensor:
    """int32 [R, L]: reads[p : p+ck] as 2-bit codes, first char most
    significant; chars past the row are code 0 and every symbol is clipped
    into 1..4 first (so an N counts as A)."""
    R, L = reads.shape
    sym0 = reads.to(I32)
    code = torch.zeros((R, L), dtype=I32, device=reads.device)
    for j in range(ck):
        nxt = torch.ones((R, L), dtype=I32, device=reads.device)
        nxt[:, : max(L - j, 0)] = sym0[:, j:]
        code = ((code << 2) | (nxt.clamp(1, 4) - 1)) & ((1 << (2 * ck)) - 1)
    return code


def kmer_table_planes_plain(pix: PlaneIndexSet, wcache: torch.Tensor,
                            reads: torch.Tensor, lengths: torch.Tensor,
                            max_k: int, ck: int):
    """freq int32 [max_k+1, R, L], valid bool [max_k+1, R, L] in plain torch."""
    R, L = reads.shape
    sym0 = reads.to(I32)
    st = wcache[plane_codes(reads, ck).long()]               # [R, L, 4]
    minus1 = torch.full((R, L), -1, dtype=I32, device=reads.device)
    never = torch.zeros((R, L), dtype=torch.bool, device=reads.device)
    freqs = [minus1] * ck
    valids = [never] * ck

    def emit(j, fake, state):
        freqs.append(torch.where(fake, minus1, rank.bi_freq(state)))
        valids.append(~fake & _bi_valid(state))

    def step(state, s):
        f_lo, f_hi, r_lo, r_hi = state
        nf = _update_planes(pix.fwd, f_lo, f_hi, s)
        nr = _update_planes(pix.rev, r_lo, r_hi, rank.comp(s))
        return (nf[0], nf[1], nr[0], nr[1])

    _ladder_plain(step, tuple(st[..., i] for i in range(4)), sym0, lengths, ck,
                  max_k, emit)
    return torch.stack(freqs), torch.stack(valids)


def kmer_table_planes(pix: PlaneIndexSet, wcache: torch.Tensor, reads: torch.Tensor,
                      lengths: torch.Tensor, max_k: int, ck: int):
    """kmer_table_full via bit-plane occ, chain-seeded at k = ck.

    wcache int32 [4^ck, 4] (f_lo, f_hi, r_lo, r_hi of every ck-mer, the
    walk's interval table) supplies the state at level ck; rows below ck
    report freq -1 / valid False, so callers must read no k < ck (the seed
    scan reads k >= start_kmer_len + min(offset) - 1 >= 14).
    Returns (freq int32 [max_k+1, R, L], valid bool [max_k+1, R, L]).
    """
    if not reads.is_cuda:
        return kmer_table_planes_plain(pix, wcache, reads, lengths, max_k, ck)
    R, L = reads.shape
    freq = torch.empty((max_k + 1, R, L), dtype=I32, device=reads.device)
    valid = torch.empty((max_k + 1, R, L), dtype=torch.bool, device=reads.device)
    cuda.launch("kmer_table_planes", "lrsc_kmer_table_planes",
                *kmer_table_planes_args(pix, wcache, reads, lengths, max_k, ck, freq, valid))
    return freq, valid


def kmer_table_planes_args(pix: PlaneIndexSet, wcache, reads, lengths, max_k: int, ck: int,
                           freq, valid, on_card: bool = True) -> list:
    """The arguments of lrsc_kmer_table_planes but the stream (on_card=False
    takes CPU tensors: the C entry compiled for the host, in the tests)."""
    name = "kmer_table_planes"
    if not 1 <= ck <= min(max_k, 15):
        raise ValueError(f"{name}: the kernel takes 1 <= ck <= min(max_k, 15), got "
                         f"ck={ck}, max_k={max_k}")
    args = []
    for pf in (pix.fwd, pix.rev):
        if pf.block != 128:
            raise ValueError(f"{name}: the kernel takes 128-symbol blocks, got {pf.block}")
        nb = pf.prows.shape[0]
        args += [cuda.check(name, pf.prows, I32, (nb, PLANE_ROW), on_card=on_card),
                 cuda.check(name, pf.C, I32, (6,), on_card=on_card), nb]
        if pf.prows.device != reads.device:
            raise ValueError(f"{name}: reads on {reads.device}, index on {pf.prows.device}")
    if wcache.data_ptr() % 16:
        raise ValueError(f"{name}: wcache must be 16-byte aligned")
    K = max_k + 1
    R, L = reads.shape
    return (args + [cuda.check(name, wcache, I32, (4 ** ck, 4), on_card=on_card), ck]
            + _read_args(name, reads, lengths, on_card) + [max_k]
            + [cuda.check(name, t, dt, (K, R, L), on_card=on_card)
               for t, dt in ((freq, I32), (valid, torch.bool))])
