"""The comparison that decides ``correct``.

Once the window has closed, the reads that the window finished are
corrected again by the plain reference (``reference/``: the host corrector,
numpy only, on its own tables of the same index), in a pool of worker
processes, in an order drawn from the run's seed: first, where the window
had them, a read that reached the MSA/DP fallback and a read of a batch in
which the replay sent a gap to the host engine, then the rest.  The pool
works for a fixed share of the window's length (less where the run would
otherwise pass its time); every read that the reference finished by then
is compared, so the reference never takes longer than the window.  Each compared read's output and counters must
equal the reference's exactly: the port's outputs are strings and
integers, so the limit on differing reads is 0.
"""
from __future__ import annotations

import multiprocessing as mp
import time

import numpy as np

# what pbcorrect writes and counts for a read; the timers are not compared
COMPARED = ("merge", "corrected_strs", "total_reads_len", "corrected_len",
            "total_seed_num", "total_walk_num", "high_error_num",
            "exceed_depth_num", "exceed_leave_num", "fm_num", "dp_num",
            "seed_dis")
WORKERS = 7
SHARE = 0.8   # of the window's length that the reference may take
MIN_SECONDS = 20.0   # ... and at least this, where the run's time is short


def order(done: list, rng: np.random.Generator) -> list[int]:
    """Indexes into done ([(rid, seq, result, batch_fell_back)]) in the
    order the reference takes them."""
    first: list[int] = []
    dp = [i for i, (_, _, r, _) in enumerate(done) if r.dp_num > 0]
    fb = [i for i, (_, _, _, f) in enumerate(done) if f]
    for pool in (dp, fb):
        if pool and not set(pool) & set(first):
            first.append(int(rng.choice(pool)))
    return first + [int(i) for i in rng.permutation(len(done)) if i not in first]


_corrector = None


def _init(ref_dir: str, params: dict) -> None:
    global _corrector
    from .reference import tables
    from .reference.correct import CorrectionParams, SelfCorrector

    _corrector = SelfCorrector(tables.load(ref_dir), CorrectionParams(**params))


def _correct(item):
    rid, seq = item
    r = _corrector.process(rid, seq)
    return rid, {k: getattr(r, k) for k in COMPARED}


def reference(ref_dir: str, params: dict, items: list[tuple[str, str]],
              seconds: float, workers: int = WORKERS) -> dict:
    """{read id: compared fields} of the reads of items, taken in turn,
    that the reference finished within seconds."""
    ctx = mp.get_context("spawn")
    pool = ctx.Pool(workers, initializer=_init, initargs=(ref_dir, params))
    try:
        deadline = time.perf_counter() + seconds
        pending = [pool.apply_async(_correct, (it,)) for it in items]
        out = {}
        for job in pending:
            left = deadline - time.perf_counter()
            if left <= 0:
                break
            try:
                rid, fields = job.get(timeout=left)
            except mp.TimeoutError:
                break
            out[rid] = fields
        # the rest of the finished ones, without waiting
        for job in pending:
            if job.ready() and job.successful():
                rid, fields = job.get()
                out[rid] = fields
        return out
    finally:
        pool.terminate()
        pool.join()


def differs(result, want: dict) -> list[str]:
    """The compared fields in which a program result differs."""
    return [k for k in COMPARED if getattr(result, k, None) != want[k]]
