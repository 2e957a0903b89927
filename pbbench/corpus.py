"""A configuration's data set: genome, reads, FM-index, reference tables.

The data set of a configuration is fixed by its file: the genome and the
read set are drawn from the file's ``corpus_seed``, the reads are indexed
with the repository's ``native/fmbuild`` (the ``index`` stage a user runs
once before ``pbcorrect``), and the reference's own occurrence tables are
made from fmbuild's raw BWT files.  All of it is kept under
``pbbench/.cache/<config>/`` and made again only when the configuration's
data keys change, so only a cell's first run in a checkout pays for it.

The ``genome`` block holds the genome's ``length`` and may hold
``repeats``: a list of repeat families, each
``{"name", "unit_len", "copies", "identity", "layout"}`` with ``layout``
``tandem`` or ``dispersed``, planted in the uniform random genome in the
list's order (``simreads.plant``).  Where there are any, the map of the
planted copies (family, start, end, strand, identity drawn) is kept beside
the data set as ``repeats.json``.  Without them no draw is added, so a
configuration without repeats keeps its data set and its stamp.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import time
from dataclasses import dataclass

import numpy as np

from . import simreads
from .reference import tables

VERSION = 1
DATA_KEYS = ("genome", "reads", "coverage", "corpus_seed")
REPEATS = "repeats.json"


@dataclass
class Corpus:
    prefix: str          # the FM-index prefix pbcorrect opens
    ref_dir: str         # the reference's tables
    bases: np.ndarray    # uint8 0..3, every read one after another
    offsets: np.ndarray  # int64 [n + 1]
    times: dict          # seconds of each stage this run made (empty when cached)

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def read(self, i: int) -> str:
        return simreads.read_str(self.bases, self.offsets, int(i))


def stamp(cfg: dict) -> str:
    data = {k: cfg[k] for k in DATA_KEYS}
    if "repeats" in data["genome"] and not data["genome"]["repeats"]:
        # no family plants nothing: the same data set as no list
        data["genome"] = {k: v for k, v in data["genome"].items() if k != "repeats"}
    data["version"] = VERSION
    return hashlib.sha256(json.dumps(data, sort_keys=True).encode()).hexdigest()[:16]


def fmbuild(root: str) -> str:
    """The repository's native/fmbuild, built with its Makefile if missing."""
    exe = os.path.join(root, "native", "fmbuild")
    if not os.path.exists(exe):
        subprocess.run(["make", "-s", "-C", os.path.join(root, "native"), "fmbuild"],
                       check=True, stdout=subprocess.DEVNULL)
    return exe


def _build(root: str, cfg: dict, out: str) -> dict:
    times = {}
    t = time.perf_counter()
    rng = np.random.default_rng(int(cfg["corpus_seed"]))
    g = simreads.genome(rng, int(cfg["genome"]["length"]))
    planted = simreads.plant(rng, g, cfg["genome"].get("repeats", ()))
    if planted:
        with open(os.path.join(out, REPEATS), "w") as fh:
            json.dump(planted, fh)
    bases, offsets, _ = simreads.clr_reads(rng, g, cfg["reads"], float(cfg["coverage"]))
    np.save(os.path.join(out, "bases.npy"), bases)
    np.save(os.path.join(out, "offsets.npy"), offsets)
    simreads.write_fasta(os.path.join(out, "reads.fa"), bases, offsets)
    times["reads_s"] = time.perf_counter() - t
    t = time.perf_counter()
    subprocess.run([fmbuild(root), os.path.join(out, "reads.fa"), os.path.join(out, "reads")],
                   check=True, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    times["index_s"] = time.perf_counter() - t
    t = time.perf_counter()
    tables.build(os.path.join(out, "reads"), os.path.join(out, "ref"))
    times["reference_tables_s"] = time.perf_counter() - t
    return times


def ensure(root: str, cfg: dict) -> Corpus:
    """The configuration's data set, made first if the cache lacks it.

    The cache holds one data set per configuration; a data set is made in
    a directory of its own and renamed into place when whole, so a run
    that is cut leaves nothing half made behind."""
    cache = os.path.join(root, "pbbench", ".cache")
    final = os.path.join(cache, cfg["name"])
    want = stamp(cfg)
    stamp_path = os.path.join(final, "stamp")
    times = {}
    made = None
    if os.path.exists(stamp_path):
        with open(stamp_path) as fh:
            made = fh.read()
    if made != want:
        building = final + ".building"
        shutil.rmtree(building, ignore_errors=True)
        os.makedirs(building)
        times = _build(root, cfg, building)
        with open(os.path.join(building, "stamp"), "w") as fh:
            fh.write(want)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(building, final)
    return Corpus(prefix=os.path.join(final, "reads"),
                  ref_dir=os.path.join(final, "ref"),
                  bases=np.load(os.path.join(final, "bases.npy"), mmap_mode="r"),
                  offsets=np.load(os.path.join(final, "offsets.npy")),
                  times=times)
