"""A random genome, with repeat families planted in it, and a PacBio CLR
read set drawn from it, in numpy.

The read model is PBSIM's model-based CLR simulation (Ono et al. 2013,
Bioinformatics 29:119): log-normal read lengths cut to [min, max], a
per-read accuracy drawn from a normal distribution cut to [min, max], and
errors placed uniformly along the read in a fixed substitution : insertion :
deletion ratio.  Reads come from either strand with equal chance.

Everything is vectorised over a block of reads at a time; there is no loop
over bases.  Bases are 0..3 for A, C, G, T.
"""
from __future__ import annotations

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
BLOCK_BASES = 1 << 24   # template bases simulated per block
EVENTS = ("template_bases", "substitutions", "insertions", "deletions")


LAYOUTS = ("tandem", "dispersed")


def genome(rng: np.random.Generator, length: int) -> np.ndarray:
    """A uniform random genome (uint8 0..3); ``plant`` adds repeat families."""
    return rng.integers(0, 4, size=length, dtype=np.uint8)


def _free_start(rng, taken: list, length: int, need: int, name: str) -> int:
    """A start drawn uniformly among those where need bases fit in
    [0, length) without overlapping an interval of taken."""
    ends = np.array([0] + [e for _, e in taken], np.int64)
    nexts = np.array([s for s, _ in taken] + [length], np.int64)
    fits = np.maximum(nexts - ends - need + 1, 0)
    if not fits.any():
        raise ValueError(f"repeat family {name!r} does not fit: no free stretch "
                         f"of {need} bases is left in the genome of {length}")
    cum = np.cumsum(fits)
    k = int(rng.integers(cum[-1]))
    gap = int(np.searchsorted(cum, k, side="right"))
    return int(ends[gap] + k - (cum[gap] - fits[gap]))


def plant(rng: np.random.Generator, g: np.ndarray, repeats) -> list[dict]:
    """Plants each family of repeats in g, in place and in order, and
    returns the map of the copies: family, start, end, strand and the
    identity drawn (the share of the unit's bases the copy keeps).

    A family is ``{"name", "unit_len", "copies", "identity", "layout"}``.
    Its unit is uniform random bases; each copy takes independent
    substitutions at rate ``1 - identity``.  ``tandem`` copies lie head to
    tail on the plus strand from one drawn start; ``dispersed`` copies lie
    at drawn places, each on a random strand.  No two copies overlap, and
    all lie inside g.  No family, no draw."""
    taken: list[tuple[int, int]] = []   # sorted, disjoint [start, end)
    out = []
    for fam in repeats:
        name, n, ln = fam["name"], int(fam["copies"]), int(fam["unit_len"])
        if fam["layout"] not in LAYOUTS:
            raise ValueError(f"repeat family {name!r}: layout {fam['layout']!r} "
                             f"is not one of {LAYOUTS}")
        unit = rng.integers(0, 4, size=ln, dtype=np.uint8)
        sub = rng.random((n, ln)) < 1.0 - float(fam["identity"])
        shift = rng.integers(1, 4, size=(n, ln), dtype=np.uint8)
        copies = np.where(sub, (unit + shift) % 4, unit).astype(np.uint8)
        if fam["layout"] == "tandem":
            s0 = _free_start(rng, taken, len(g), n * ln, name)
            taken = sorted(taken + [(s0, s0 + n * ln)])
            starts = s0 + ln * np.arange(n)
            minus = np.zeros(n, bool)
        else:
            minus = rng.random(n) < 0.5
            starts = []
            for _ in range(n):
                starts.append(_free_start(rng, taken, len(g), ln, name))
                taken = sorted(taken + [(starts[-1], starts[-1] + ln)])
        for c in range(n):
            s = int(starts[c])
            g[s : s + ln] = (3 - copies[c])[::-1] if minus[c] else copies[c]
            out.append({"family": name, "start": s, "end": s + ln,
                        "strand": "-" if minus[c] else "+",
                        "identity": 1.0 - float(sub[c].mean())})
    return out


def _truncated(draw, lo, hi, n):
    """n values of draw(m) that lie in [lo, hi], redrawing the others."""
    out = np.empty(0)
    while len(out) < n:
        v = draw(2 * (n - len(out)) + 16)
        out = np.concatenate([out, v[(v >= lo) & (v <= hi)]])
    return out[:n]


def read_lengths(rng, model: dict, total_bases: int) -> np.ndarray:
    """Read lengths (int64) drawn until they sum to total_bases."""
    mean, sd = float(model["length_mean"]), float(model["length_sd"])
    sigma2 = np.log1p((sd / mean) ** 2)
    mu, sigma = np.log(mean) - sigma2 / 2, np.sqrt(sigma2)
    lens = np.empty(0, np.int64)
    while lens.sum() < total_bases:
        n = int((total_bases - lens.sum()) / mean) + 64
        more = _truncated(lambda m: np.rint(rng.lognormal(mu, sigma, m)),
                          model["length_min"], model["length_max"], n)
        lens = np.concatenate([lens, more.astype(np.int64)])
    return lens[: int(np.searchsorted(np.cumsum(lens), total_bases)) + 1]


def accuracies(rng, model: dict, n: int) -> np.ndarray:
    return _truncated(lambda m: rng.normal(model["accuracy_mean"], model["accuracy_sd"], m),
                      model["accuracy_min"], model["accuracy_max"], n)


def _noisy_block(rng, g, starts, tlens, minus, err, ratio):
    """The reads of one block: (bases uint8, lengths int64, events int64
    [template bases, substitutions, insertions, deletions])."""
    n_t = int(tlens.sum())
    read_of = np.repeat(np.arange(len(tlens)), tlens)
    first = np.cumsum(tlens) - tlens
    off = np.arange(n_t, dtype=np.int64) - first[read_of]
    # a minus-strand read walks its template backwards, complemented
    pos = np.where(minus[read_of], starts[read_of] + tlens[read_of] - 1 - off,
                   starts[read_of] + off)
    base = g[pos]
    base = np.where(minus[read_of], 3 - base, base).astype(np.uint8)
    u = rng.random(n_t, dtype=np.float32)
    p = err[read_of].astype(np.float32)
    sub = u < p * ratio[0]
    ins = (u >= p * ratio[0]) & (u < p * (ratio[0] + ratio[1]))
    dele = (u >= p * (ratio[0] + ratio[1])) & (u < p)
    shift = rng.integers(1, 4, size=n_t, dtype=np.uint8)
    base = np.where(sub, (base + shift) % 4, base).astype(np.uint8)
    count = np.ones(n_t, np.int64)
    count[ins] = 2
    count[dele] = 0
    out = np.repeat(base, count)
    # an insertion puts a random base before its template base
    at = (np.cumsum(count) - count)[ins]
    out[at] = rng.integers(0, 4, size=len(at), dtype=np.uint8)
    lens = np.bincount(read_of, weights=count, minlength=len(tlens)).astype(np.int64)
    events = np.array([n_t, sub.sum(), ins.sum(), dele.sum()], np.int64)
    return out, lens, events


def clr_reads(rng, g: np.ndarray, model: dict, coverage: float):
    """PacBio CLR reads of genome g at the given coverage.

    Returns (bases uint8 [sum of lengths], offsets int64 [n + 1], events):
    read i is bases[offsets[i]:offsets[i + 1]], and events counts the
    template bases and the substitutions, insertions and deletions made."""
    lens = read_lengths(rng, model, int(round(coverage * len(g))))
    n = len(lens)
    acc = accuracies(rng, model, n)
    err = 1.0 - acc
    ratio = np.asarray(model["error_ratio_sub_ins_del"], np.float64)
    ratio = ratio / ratio.sum()
    # template length so that the read's expected length is the drawn one
    grow = 1.0 + err * (ratio[1] - ratio[2])
    tlens = np.clip(np.rint(lens / grow), 1, len(g)).astype(np.int64)
    starts = (rng.random(n) * (len(g) - tlens + 1)).astype(np.int64)
    minus = rng.random(n) < 0.5
    parts, out_lens = [], []
    events = np.zeros(4, np.int64)
    lo = 0
    while lo < n:
        hi = lo + max(1, int(np.searchsorted(np.cumsum(tlens[lo:]), BLOCK_BASES)))
        hi = min(hi, n)
        b, ln, ev = _noisy_block(rng, g, starts[lo:hi], tlens[lo:hi], minus[lo:hi],
                                 err[lo:hi], ratio)
        events += ev
        parts.append(b)
        out_lens.append(ln)
        lo = hi
    out_lens = np.concatenate(out_lens)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(out_lens, out=offsets[1:])
    return np.concatenate(parts), offsets, dict(zip(EVENTS, events.tolist()))


def read_str(bases: np.ndarray, offsets: np.ndarray, i: int) -> str:
    return ACGT[bases[offsets[i] : offsets[i + 1]]].tobytes().decode()


def write_fasta(path: str, bases: np.ndarray, offsets: np.ndarray) -> None:
    """Reads as FASTA, read i named r<i>, one line of sequence each."""
    text = ACGT[bases]
    with open(path, "wb") as fh:
        for i in range(len(offsets) - 1):
            fh.write(b">r%d\n" % i)
            fh.write(text[offsets[i] : offsets[i + 1]].tobytes())
            fh.write(b"\n")
