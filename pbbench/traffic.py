"""The one generator of every traffic mix.

A mix is a file of parameters, ``traffic/<name>.json``:

- ``min_len`` / ``max_len``: the reads the mix may take, by length (bases;
  both ends included; either may be left out);
- ``order``: ``shuffle`` or ``longest_first`` (ties in file order);
- ``batch_reads``: reads per batch handed to ``process_stream`` (pbcorrect's
  ``--batch-reads``).

The window takes a stream of the selected reads, each once, batch after
batch in a closed loop, for as long as it lasts: pbcorrect streaming a
read file.  ``shuffle`` draws the stream from the run's seed, so different
seeds correct different reads; it cuts the selection, sorted by length,
into ``batch_reads`` strata of equal count, and each batch takes one read
of each stratum, so every seed's batches carry the same spread of lengths.
The warm-up's reads (``warm``) are fixed by the data set alone and left
out of the stream.
"""
from __future__ import annotations

import numpy as np

ORDERS = ("shuffle", "longest_first")


def selection(mix: dict, lengths: np.ndarray) -> np.ndarray:
    """Ids of the reads the mix may take, in file order."""
    lo = int(mix.get("min_len", 0))
    hi = int(mix.get("max_len", np.iinfo(np.int64).max))
    return np.flatnonzero((lengths >= lo) & (lengths <= hi))


def warm(mix: dict, lengths: np.ndarray, n: int) -> np.ndarray:
    """The n reads of the selection nearest its median length (ties in
    file order): the warm-up's, the same for every seed."""
    ids = selection(mix, lengths)
    d = np.abs(lengths[ids] - np.median(lengths[ids]))
    return np.sort(ids[np.argsort(d, kind="stable")[:n]])


def stream(mix: dict, lengths: np.ndarray, rng: np.random.Generator,
           skip=()) -> np.ndarray:
    """Every read of the selection but those of skip, once, in the order
    the window takes them."""
    ids = selection(mix, lengths)
    ids = ids[~np.isin(ids, np.asarray(skip, dtype=np.int64))]
    kind = mix["order"]
    if kind == "longest_first" or len(ids) == 0:
        return ids[np.argsort(-lengths[ids], kind="stable")]
    if kind != "shuffle":
        raise ValueError(f"traffic order {kind!r} is not one of {ORDERS}")
    by_len = ids[np.argsort(lengths[ids], kind="stable")]
    strata = [rng.permutation(s) for s in np.array_split(by_len, int(mix["batch_reads"]))]
    rows = [np.array([s[j] for s in strata if j < len(s)], dtype=np.int64)
            for j in range(max(len(s) for s in strata))]
    return np.concatenate([rng.permutation(r) for r in rows])


def batches(ids: np.ndarray, batch_reads: int) -> list[np.ndarray]:
    return [ids[i : i + batch_reads] for i in range(0, len(ids), batch_reads)]
