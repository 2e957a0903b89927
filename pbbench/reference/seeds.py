"""Seed probing: hybrid static/dynamic k-mer scan over a long read.

Faithful re-implementation of PacBio/LongReadProbe.{h,cpp} +
PacBio/SeedFeature.{h,cpp} + PacBio/KmerFeature.h semantics.  The per-position
multi-k frequency tables come from vectorised scans (HostIndexSet on the host,
ops.scan on device — identical numbers); this module applies the sequential
seed-selection state machine on top of those tables.

Reference behaviors preserved exactly, including:
* position attribute via 300-bp sliding window of scan-k-mer modes with the
  reference's add/remove asymmetry (LongReadProbe.cpp:120-182)
* dynamic-kmer growth/shrink + hitchhike ratio tests (LongReadProbe.cpp:46-104)
* low-complexity rejection (KmerFeature.h:116-126)
* seed-level hitchhike removal within radius (LongReadProbe.cpp:187-227)
* best start/end kmer size estimation with the XOR-trick walk
  (SeedFeature.cpp:43-78)
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import alphabet as ab
from .threshold import KmerThreshold

F32 = np.float32


@dataclass
class ProbeParams:
    """ProbeParameters (LongReadProbe.h:7-40) + the threshold table."""

    start_kmer_len: int = 19
    scan_kmer_len: int = 19
    kmer_len_up_bound: int = 50
    pb_coverage: int = 90
    mode: int = 1
    radius: int = 100
    hh_ratio: float = float(F32(0.6))
    offset: tuple[int, int, int] = (0, 0, 0)
    pool: tuple[int, ...] = (5, 9, 19)
    manual: bool = False
    debug_seed: bool = False   # --debugseed dumps (.log / seed/error)
    directory: str = ""


class _FreqLadder:
    """Incremental boundary-kmer both-strand frequencies.

    freq(k) of word[:k] via one bi-interval extension per k (both-strand
    counts are strand-symmetric integers, so the ladder is exact)."""

    def __init__(self, iset, word):
        self.iset = iset
        self.word = word
        self.freqs = [0] * (len(word) + 1)
        self.state = None
        self.k = 0

    def freq(self, k: int) -> int:
        if self.state is None:
            self.state = self.iset.init_bi(self.word[0])
            self.freqs[1] = int(self.iset.bi_freq(self.state))
            self.k = 1
        while self.k < k:
            self.state = self.iset.extend_bi(self.state, self.word[self.k])
            self.k += 1
            self.freqs[self.k] = int(self.iset.bi_freq(self.state))
        return self.freqs[k]


@dataclass
class Seed:
    """SeedFeature (SeedFeature.h:35-45)."""

    seed_str: str
    seed_start_pos: int
    max_fixed_mer_freq: int
    is_repeat: bool
    # filled by constructor logic
    seed_len: int = 0
    seed_end_pos: int = 0
    is_hitchhiked: bool = False
    start_best_kmer_size: int = 0
    end_best_kmer_size: int = 0
    start_kmer_freq: int = 0
    end_kmer_freq: int = 0
    # private bounds
    size_upper_bound: int = 0
    size_lower_bound: int = 0
    freq_upper_bound: int = 0
    freq_lower_bound: int = 0

    @staticmethod
    def make(seed_str: str, start_pos: int, frequency: int, repeat: bool,
             kmer_size: int, pb_coverage: int) -> "Seed":
        s = Seed(seed_str, start_pos, frequency, repeat)
        s.seed_len = len(seed_str)
        s.seed_end_pos = start_pos + s.seed_len - 1
        s.start_best_kmer_size = s.end_best_kmer_size = kmer_size
        s.size_upper_bound = s.seed_len
        s.size_lower_bound = kmer_size
        s.freq_upper_bound = pb_coverage >> 1
        s.freq_lower_bound = pb_coverage >> 2
        return s

    def append(self, extended: str, target: "Seed") -> None:
        """SeedFeature::append (SeedFeature.h:22-33)."""
        self.seed_str += extended
        self.seed_len += len(extended)
        self.start_best_kmer_size = target.start_best_kmer_size
        self.end_best_kmer_size = target.end_best_kmer_size
        self.is_repeat = target.is_repeat
        self.max_fixed_mer_freq = target.max_fixed_mer_freq
        self.seed_start_pos = target.seed_start_pos
        self.seed_end_pos = target.seed_end_pos

    def estimate_best_kmer_size(self, ix, freq_table=None) -> None:
        """estimateBestKmerSize (SeedFeature.cpp:43-78): walk the k size until
        the boundary-kmer frequency falls inside [cov/4, cov/2].

        freq_table: optional per-position (k, pos) both-strand frequency
        table of the READ the seed came from — boundary kmers are read
        substrings, so their counts are plain lookups
        (freq_table[k][seed_start] / freq_table[k][seed_end - k + 1])."""
        self._freq_table = freq_table
        self._ladders = {}
        self._modify_kmer_size(ix, True)
        self._modify_kmer_size(ix, False)
        self._freq_table = None
        self._ladders = None

    def _boundary_freq(self, ix, pole: bool, k: int) -> int:
        ft = getattr(self, "_freq_table", None)
        if ft is not None:
            pos = self.seed_start_pos if pole else self.seed_end_pos - k + 1
            return int(ft[k][pos])
        # incremental ladder: ONE bi-interval extension per k instead of a
        # from-scratch double backward search per probe — the k-walk only
        # moves by +-1, so from-scratch probes made the host best-k redo
        # (seeds whose k leaves the device table) quadratic in k
        ladders = getattr(self, "_ladders", None)
        if ladders is None:
            ladders = self._ladders = {}
        lad = ladders.get(pole)
        if lad is None:
            from .host import HostIndexSet

            word = ab.encode(self.seed_str)
            if pole:
                lad = _FreqLadder(ix, word)            # prefix grows right
            else:
                # suffix growing left == prefix of the REVERSED seed
                # growing right, counted in reversed-text space
                lad = _FreqLadder(HostIndexSet(ix.rbwt, ix.bwt),
                                  word[::-1].copy())
            ladders[pole] = lad
        return lad.freq(k)

    def _modify_kmer_size(self, ix, pole: bool) -> None:
        kmer_size = self.start_best_kmer_size if pole else self.end_best_kmer_size
        kmer_freq = self._boundary_freq(ix, pole, kmer_size)
        if kmer_freq > self.freq_upper_bound:
            bit = 1
        elif kmer_freq < self.freq_lower_bound:
            bit = -1
        else:
            self._store(pole, kmer_size, kmer_freq)
            return
        freq_bound = self.freq_upper_bound if bit > 0 else self.freq_lower_bound
        cors_freq_bound = self.freq_lower_bound if bit > 0 else self.freq_upper_bound
        size_bound = self.size_upper_bound if bit > 0 else self.size_lower_bound
        # the reference's XOR trick: (bit^a) > (bit^b) compares a>b for bit=1
        # and a<b for bit=-1 — except it also flips bit0 for bit=1; preserved
        while (bit ^ kmer_freq) > (bit ^ freq_bound) and (bit ^ kmer_size) < (bit ^ size_bound):
            kmer_size += bit
            kmer_freq = self._boundary_freq(ix, pole, kmer_size)
        if (bit ^ kmer_freq) < (bit ^ cors_freq_bound):
            kmer_size -= bit
            kmer_freq = self._boundary_freq(ix, pole, kmer_size)
        self._store(pole, kmer_size, kmer_freq)

    def _store(self, pole: bool, size: int, freq: int) -> None:
        if pole:
            self.start_best_kmer_size, self.start_kmer_freq = size, freq
        else:
            self.end_best_kmer_size, self.end_kmer_freq = size, freq


# ---------------------------------------------------------------------------
# frequency tables (shared by attribute scan and seed scan)
# ---------------------------------------------------------------------------

def base_count_prefix(read: np.ndarray) -> np.ndarray:
    """prefix[i, b] = count of base rank b+1 in read[:i]; [L+1, 4]."""
    onehot = read[:, None] == np.arange(1, 5, dtype=read.dtype)
    out = np.zeros((len(read) + 1, 4), dtype=np.int64)
    np.cumsum(onehot, axis=0, out=out[1:])
    return out


def window_counts(prefix: np.ndarray, pos: int, size: int) -> np.ndarray:
    return prefix[pos + size] - prefix[pos]


def is_low_complexity(counts: np.ndarray, size: int, m: float = 0.7, d: float = 0.9) -> bool:
    """KmerFeature::isLowComplexity (KmerFeature.h:116-126), float32 math."""
    c = np.sort(counts)
    monmer = F32(c[3]) / F32(size) >= F32(m)
    dimer = F32(c[2] + c[3]) / F32(size) >= F32(d)
    return bool(monmer or dimer)


def get_seq_attribute(
    read: np.ndarray,
    freq_scan: np.ndarray,
    prefix: np.ndarray,
    thresh: KmerThreshold,
    scan_k: int,
    log_writer=None,
) -> np.ndarray:
    """Position attribute (1 unique / 2 repeat) via a 300-bp sliding window of
    scan-k-mer modes — getSeqAttribute (LongReadProbe.cpp:120-182).

    freq_scan: freq of the scan_k-mer at each position (-1 where fake).
    """
    L = len(read)
    attribute = np.ones(L, dtype=np.int64)
    repeat_value = thresh.get(2, scan_k)
    half = 150  # range 300 >> 1

    # per-position mode under the "add" rule (freq < 0 -> garbage) and the
    # "remove" rule (freq <= 0 -> garbage); the asymmetry is the reference's
    sizes = np.minimum(scan_k, L - np.arange(L))
    counts = prefix[np.minimum(np.arange(L) + scan_k, L)] - prefix[np.arange(L)]
    srt = np.sort(counts, axis=1)
    lowcx = (srt[:, 3].astype(F32) / sizes.astype(F32) >= F32(0.7)) | (
        (srt[:, 2] + srt[:, 3]).astype(F32) / sizes.astype(F32) >= F32(0.9)
    )
    eff = np.where(lowcx, -1, freq_scan)
    add_garbage = eff < 0
    rem_garbage = eff <= 0
    repeat = ~add_garbage & (eff >= repeat_value)
    rep_rem = ~rem_garbage & (eff >= repeat_value)

    cs_add_g = np.concatenate([[0], np.cumsum(add_garbage)])
    cs_rem_g = np.concatenate([[0], np.cumsum(rem_garbage)])
    cs_add_r = np.concatenate([[0], np.cumsum(repeat)])
    cs_rem_r = np.concatenate([[0], np.cumsum(rep_rem)])

    pos = np.arange(L)
    left = np.maximum(pos - half, 0)
    right = np.minimum(pos + half, L - 1)
    box_garbage = cs_add_g[right + 1] - cs_rem_g[left]
    box_repeat = cs_add_r[right + 1] - cs_rem_r[left]
    size = (right - left + 1) - box_garbage
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = (box_repeat.astype(F32) / size.astype(F32)).astype(np.float64) + 0.0005
    attribute[ratio >= 0.02] = 2
    if log_writer is not None:
        # extend/<read>.log ratio trace (LongReadProbe.cpp:122-124,171-172);
        # the reference stores float then streams at 6 significant digits
        for p in range(L):
            log_writer.write(f"{p}\t{F32(ratio[p]):g}\n")
    return attribute


# ---------------------------------------------------------------------------
# the seed scan
# ---------------------------------------------------------------------------

def search_seeds(
    read_str: str,
    ix,
    params: ProbeParams,
    thresh: KmerThreshold,
    freq_table: np.ndarray | None = None,
    valid_table: np.ndarray | None = None,
    read_id: str = "",
) -> list[Seed]:
    """searchSeedsWithHybridKmers (LongReadProbe.cpp:34-117).

    freq_table/valid_table: optional precomputed [max_k+1, L] tables (e.g.
    produced on device); computed via the host index otherwise.
    """
    read = ab.encode(read_str)
    L = len(read)
    static_size = params.start_kmer_len
    if L < static_size:
        return []
    max_k = params.kmer_len_up_bound + 1
    if freq_table is None:
        freq_table, valid_table = ix.kmer_freq_table(read, max_k)
    prefix = base_count_prefix(read)

    log_writer = open_seed_log(params, read_id)
    if params.manual:
        attribute = np.full(L, params.mode, dtype=np.int64)
    else:
        attribute = get_seq_attribute(
            read, freq_table[params.scan_kmer_len], prefix, thresh,
            params.scan_kmer_len, log_writer,
        )
    if log_writer is not None:
        log_writer.close()

    seeds: list[Seed] = []
    init_pos = 0
    while init_pos < L:
        dynamic_mode = int(attribute[init_pos])
        static_size += params.offset[dynamic_mode]
        # dynamic kmer state: window [seed_pos, seed_pos + dyn_size)
        seed_pos = init_pos
        dyn_size = static_size
        is_seed = False
        is_repeat = False
        max_fixed = int(freq_table[static_size][init_pos]) if init_pos + static_size <= L else -1

        next_init = init_pos  # value init_pos holds when the inner loop ends
        curr = init_pos
        while curr < L:
            static_mode = int(attribute[curr])
            static_fake = curr + static_size > L
            if static_fake:
                break
            if is_seed:
                dyn_size += 1
            dyn_fake = seed_pos + dyn_size > L
            dyn_freq = int(freq_table[dyn_size][seed_pos]) if not dyn_fake else -1
            dyn_valid = bool(valid_table[dyn_size][seed_pos]) if not dyn_fake else False
            static_freq = int(freq_table[static_size][curr])
            dynamic_threshold = thresh.get(dynamic_mode, dyn_size)
            static_threshold = thresh.get(static_mode, static_size)
            repeat_threshold = F32(5 - ((static_mode >> 1) << 2)) * static_threshold
            if (
                F32(static_freq) < static_threshold
                or F32(dyn_freq) < dynamic_threshold
                or not dyn_valid
                or dyn_size > params.kmer_len_up_bound
            ):
                if is_seed:
                    dyn_size -= 1  # shrink(1)
                break
            freq_diff = F32(static_freq) / F32(max_fixed)
            if freq_diff < F32(params.hh_ratio):
                next_init += 1
                dyn_size -= 1  # shrink(1)
                break
            elif freq_diff > F32(1) / F32(params.hh_ratio):
                next_init = curr - 1
                is_seed = False
                break
            next_init = seed_pos + dyn_size - 1
            is_seed = True
            is_repeat |= bool(F32(static_freq) >= repeat_threshold)
            max_fixed = max(max_fixed, static_freq)
            curr += 1

        if is_seed:
            counts = window_counts(prefix, seed_pos, dyn_size)
            if not is_low_complexity(counts, dyn_size):
                word = ab.decode(read[seed_pos : seed_pos + dyn_size])
                s = Seed.make(word, seed_pos, max_fixed, is_repeat, static_size, params.pb_coverage)
                s.estimate_best_kmer_size(ix, freq_table)
                seeds.append(s)
        static_size -= params.offset[dynamic_mode]
        init_pos = next_init + 1

    final = remove_hitchhiking_seeds(seeds, params)
    write_outcasts(params, read_id, [s for s in seeds if s.is_hitchhiked])
    return final


def open_seed_log(params: ProbeParams, read_id: str):
    """--debugseed: the writer of extend/<read>.log, the attribute ratio
    trace (LongReadProbe.cpp:122-124), or None."""
    if not (params.debug_seed and read_id):
        return None
    import os

    d = os.path.join(params.directory or ".", "extend")
    os.makedirs(d, exist_ok=True)
    return open(os.path.join(d, read_id + ".log"), "w")


def write_outcasts(params: ProbeParams, read_id: str, outcasts: list[Seed]) -> None:
    """--debugseed: seed/error/<read>.seed, the hitchhiked outcasts
    (LongReadProbe.cpp:220-225, format SeedFeature.cpp:11-19)."""
    if not (params.debug_seed and read_id):
        return
    import os

    d = os.path.join(params.directory or ".", "seed", "error")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, read_id + ".seed"), "w") as fh:
        for s in outcasts:
            fh.write(f"{s.seed_str}\t{s.max_fixed_mer_freq}\t"
                     f"{s.seed_start_pos}\t"
                     f"{'Yes' if s.is_repeat else 'No'}\n")


def remove_hitchhiking_seeds(seeds: list[Seed], params: ProbeParams) -> list[Seed]:
    """removeHitchhikingSeeds (LongReadProbe.cpp:187-227)."""
    if len(seeds) < 2:
        return seeds
    for qi in range(len(seeds) - 1):
        query = seeds[qi]
        for si in range(qi + 1, len(seeds)):
            subject = seeds[si]
            if subject.seed_start_pos - query.seed_end_pos > params.radius:
                break
            freq_diff = F32(subject.max_fixed_mer_freq) / F32(query.max_fixed_mer_freq)
            if query.is_repeat and freq_diff < F32(params.hh_ratio):
                subject.is_hitchhiked = True
            if subject.is_repeat and freq_diff > F32(1) / F32(params.hh_ratio):
                query.is_hitchhiked = True
    return [s for s in seeds if not s.is_hitchhiked]
