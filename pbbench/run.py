"""Run one cell of BENCHMARK.json once and print its result line.

    python3 pbbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run, from the root of a checkout:

1. inputs: the configuration's data set (genome, CLR reads, their FM-index
   from ``native/fmbuild``, the reference's tables), made on the cell's
   first run in the checkout and read back after (``corpus.py``); its
   seconds are printed as ``inputs_s`` and are no metric;
2. set-up, as ``pbcorrect`` does it: ``open_index(prefix, "cuda")`` (which
   packs the index on first use), ``WalkIndex.build``,
   ``BatchedSelfCorrector``; then a warm-up (``warm_corrector``) that does
   the same work for every seed and builds the CUDA kernels on the
   checkout's first run; its parts' seconds go to standard error;
3. the window: ``BatchedSelfCorrector.process_stream`` fed batch after
   batch of the traffic's stream of distinct reads (``traffic.py``), in a
   closed loop, until the first batch that comes back ``--seconds`` or
   more after the start; the window ends there, and every read whose
   result came back in it counts;
4. the check (``check.py``): the window's reads against the plain
   reference, for as long as the reference may take.

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics;
with ``--trace 1`` the window runs under ``torch.profiler`` and the line's
metrics are its per-layer metrics, each read by ``metrics/<name>.py``.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ in ("__main__", "__mp_main__"):
    # run as a script: the repository root on the path, in place of pbbench/
    sys.path[0] = ROOT

from pbbench import cells, check, corpus, devtrace, traffic  # noqa: E402

WARM_READS = 2   # reads of the warm-up's whole pass
RUN_LIMIT = 320  # seconds a warm run may take to its check's end
# top-level modules that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "longreadselfcorrect_tpu")


def say(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


@dataclass
class Measures:
    """What the window leaves for the metric readers."""

    window_s: float
    reads: int
    bases: int                   # input bases of the reads completed
    phase_times: dict            # corrector host seconds per phase
    stats: dict                  # corrector counters, window only
    timer_dp: float              # summed timer_dp of the completed reads
    trace: devtrace.Trace | None = None

    @property
    def mbp(self) -> float:
        return self.bases / 1e6


@dataclass
class Window:
    done: list = field(default_factory=list)   # (rid, seq, result, batch fell back)
    failed: int = 0
    seconds: float = 0.0
    back_s: list = field(default_factory=list)  # seconds from the start to each batch back


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_window(corrector, data, ids, batch_reads: int, seconds: float) -> Window:
    """process_stream over the batches of ids until the first batch that
    comes back seconds or more after the start, or the end of ids.  A
    batch whose correction raises counts its reads as failed, and the
    stream starts again after it."""
    import torch

    bs = traffic.batches(ids, batch_reads)
    handed: list = []   # the batches handed to the stream, as read from the file

    def feed(start):
        for j in range(start, len(bs)):
            if j == len(handed):
                handed.append([(f"r{i}", data.read(i)) for i in bs[j]])
            yield handed[j]

    w = Window()
    got = 0
    fell_back = corrector.stats["host_fallback"]
    t_start = time.perf_counter()
    deadline = t_start + seconds
    with torch.profiler.record_function(devtrace.WINDOW_RANGE):
        stream = corrector.process_stream(feed(0))
        while True:
            try:
                results = next(stream)
            except StopIteration:
                break
            except Exception:  # a failed batch is counted; the run goes on
                traceback.print_exc(file=sys.stderr)
                w.failed += len(handed[got])
                got += 1
                stream = corrector.process_stream(feed(got))
                continue
            items = handed[got]
            got += 1
            fb = corrector.stats["host_fallback"]
            results = list(results) + [None] * max(len(items) - len(results), 0)
            for (rid, seq), r in zip(items, results):
                if r is None:
                    w.failed += 1
                else:
                    w.done.append((rid, seq, r, fb > fell_back))
            fell_back = fb
            w.back_s.append(time.perf_counter() - t_start)
            if time.perf_counter() >= deadline:
                break
        w.seconds = time.perf_counter() - t_start
    stream.close()
    return w


def host_clock() -> dict:
    """This process's CPU seconds and the whole machine's stolen seconds
    (all cores; /proc/stat, where there is one): what the host's share of
    a window's spread is read from."""
    out = {"cpu_s": time.process_time()}
    try:
        with open("/proc/stat") as fh:
            fields = fh.readline().split()
        out["steal_s"] = int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return out


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def compare(data, params: dict, w: Window, rng, workers: int,
            seconds: float | None = None) -> dict:
    """The check: each number compared with its limit.  The reference may
    take check.SHARE of the window, or seconds where that is less."""
    done = [w.done[i] for i in check.order(w.done, rng)]
    t = time.perf_counter()
    budget = check.SHARE * w.seconds if seconds is None else min(check.SHARE * w.seconds, seconds)
    want = check.reference(data.ref_dir, params, [d[:2] for d in done], budget, workers)
    mismatched = 0
    for rid, _, result, _ in done:
        if rid in want:
            bad = check.differs(result, want[rid])
            if bad:
                mismatched += 1
                say(f"check: {rid} differs from the reference in {bad}")
    bases = sum(len(seq) for rid, seq, _, _ in done if rid in want)
    say(f"check: {len(want)} of {len(done)} reads ({bases} bases) "
        f"against the reference in {time.perf_counter() - t:.1f} s")
    return {"mismatched_reads": {"value": mismatched, "limit": 0},
            "failed_reads": {"value": w.failed, "limit": 0},
            "compared_reads": {"value": len(want), "at_least": 1}}


def passed(numbers: dict) -> bool:
    return all(v["value"] <= v["limit"] if "limit" in v else v["value"] >= v["at_least"]
               for v in numbers.values())


@dataclass
class Opened:
    """A cell's data set and the port's index, opened once."""

    cell: cells.Cell
    data: corpus.Corpus
    inputs_s: float
    device: str
    hix: object = None   # the host index (index/host.HostIndexSet)
    wx: object = None    # the device walk index (ops/walk.WalkIndex)
    parts: dict = field(default_factory=dict)   # seconds of each part of set-up

    @property
    def on_gpu(self) -> bool:
        return self.device == "cuda"

    def sync(self) -> None:
        if self.on_gpu:
            import torch

            torch.cuda.synchronize()

    def timed(self, part: str, t: float) -> float:
        now = time.perf_counter()
        self.parts[part] = self.parts.get(part, 0.0) + now - t
        return now


def open_cell(root: str, workload: str, device: str) -> Opened:
    """Inputs, then the index as pbcorrect opens it."""
    cell = cells.load(root, workload)
    t = time.perf_counter()
    data = corpus.ensure(root, cell.config)
    inputs_s = time.perf_counter() - t
    print("inputs_s " + json.dumps({"seconds": inputs_s, "reads": len(data.lengths),
                                    "bases": int(data.offsets[-1]), **data.times}), flush=True)
    s = Opened(cell=cell, data=data, inputs_s=inputs_s, device=device)
    s.parts["start"] = t - T0   # interpreter, torch and the harness imported
    t = time.perf_counter()
    from longreadselfcorrect_tpu_torch.index.pack import open_index
    from longreadselfcorrect_tpu_torch.ops import walk

    t = s.timed("import_port", t)
    s.hix, dix = open_index(data.prefix, device=device)
    s.sync()
    t = s.timed("open_index", t)
    s.wx = walk.WalkIndex.build(dix, s.hix, ck=walk.walk_ck(s.hix.bwt.n))
    s.sync()
    s.timed("walk_index", t)
    return s


def seeded(seed: int):
    """(the traffic's generator, the check's generator) of a run's seed."""
    import numpy as np

    return tuple(np.random.default_rng(s)
                 for s in np.random.SeedSequence(seed % 2**64).spawn(2))


def warm_corrector(s: Opened, params: dict):
    """BatchedSelfCorrector with params, warmed up, with the same work for
    every seed: every kernel library built (on a checkout's first run) and
    loaded; the device seed phase on a batch of the longest reads the
    traffic may take, so that its widest seed tables are allocated in
    set-up as in a whole pbcorrect run over the read file; then the whole
    path on the WARM_READS reads of traffic.warm, which the window leaves
    out."""
    from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector
    from longreadselfcorrect_tpu_torch.core.correct import CorrectionParams

    t = time.perf_counter()
    if s.on_gpu:
        from longreadselfcorrect_tpu_torch.ops import cuda

        cuda.build()
        for lib in cuda.SOURCES:
            cuda.library(lib)
    t = s.timed("kernels", t)
    mix, lengths = s.cell.traffic, s.data.lengths
    corrector = BatchedSelfCorrector(s.hix, s.wx, CorrectionParams(**params))
    sel = traffic.selection(mix, lengths)
    longest = sel[np.argsort(-lengths[sel], kind="stable")[: int(mix["batch_reads"])]]
    for _ in corrector._device_seed_scan([(f"r{i}", s.data.read(i)) for i in longest]):
        pass
    s.sync()
    t = s.timed("warm_seed", t)
    for _ in corrector.process_stream([[(f"r{i}", s.data.read(i))
                                        for i in traffic.warm(mix, lengths, WARM_READS)]]):
        pass
    s.sync()
    s.timed("warm_reads", t)
    return corrector


def start(s: Opened, params: dict, seed: int):
    """(the warm corrector, a function that runs the window, the check's
    generator) of one run of the cell with the corrector's params."""
    rng_order, rng_check = seeded(seed)
    mix = s.cell.traffic
    corrector = warm_corrector(s, params)
    ids = traffic.stream(mix, s.data.lengths, rng_order,
                         skip=traffic.warm(mix, s.data.lengths, WARM_READS))

    def window(seconds: float) -> Window:
        return run_window(corrector, s.data, ids, int(mix["batch_reads"]), seconds)

    return corrector, window, rng_check


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", workers: int = check.WORKERS) -> dict | None:
    """One run of a cell; returns its result line, or None when a module
    of the JAX package was loaded."""
    import torch

    s = open_cell(root, workload, device)
    cell, data = s.cell, s.data
    params = cell.config["pbcorrect"]
    corrector, window, rng_check = start(s, params, seed)
    stats0 = dict(corrector.stats)
    setup_s = time.perf_counter() - T0 - s.inputs_s
    say(f"setup_s {setup_s:.3f}: " + json.dumps(s.parts))

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if s.on_gpu else [])
        prof = profile(activities=acts)
        prof.__enter__()
    host0 = host_clock()
    w = window(seconds)
    s.sync()
    host1 = host_clock()
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if s.on_gpu else 0
    m = Measures(window_s=w.seconds, reads=len(w.done),
                 bases=sum(len(seq) for _, seq, _, _ in w.done),
                 phase_times=dict(corrector.phase_times),
                 stats=delta(corrector.stats, stats0),
                 timer_dp=sum(r.timer_dp for _, _, r, _ in w.done))
    # the program's state is freed before the reference runs
    del corrector, window
    s.hix = s.wx = None
    if s.on_gpu:
        torch.cuda.empty_cache()
    say(f"window: {m.reads} reads, {m.bases} bases in {m.window_s:.3f} s; "
        f"phases {json.dumps(m.phase_times)}; stats {json.dumps(m.stats)}")
    say("host in the window: " + json.dumps({k: host1[k] - host0[k] for k in host0}))
    say("batches back at (s): " + json.dumps([round(t, 3) for t in w.back_s]))

    if prof is not None:
        m.trace = devtrace.collect(prof) if s.on_gpu else None
        metrics = {}
        for spec in cell.per_layer:
            v = cells.reader(root, spec["name"])(m)
            if v is not None:
                metrics[spec["name"]] = {"value": v, "unit": spec["unit"]}
    else:
        values = {"corrected_kbp_per_s": m.bases / 1e3 / m.window_s,
                  "peak_device_gb": peak / 1e9, "setup_s": setup_s}
        metrics = {spec["name"]: {"value": values[spec["name"]], "unit": spec["unit"]}
                   for spec in cell.end_to_end}

    # a warm run ends within RUN_LIMIT seconds, the check within it
    left = RUN_LIMIT - (time.perf_counter() - T0 - s.inputs_s)
    numbers = compare(data, params, w, rng_check, workers, max(left, check.MIN_SECONDS))
    dev = {"platform": "gpu" if s.on_gpu else "cpu",
           "kind": torch.cuda.get_device_name(0) if s.on_gpu else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    line = {"correct": passed(numbers), "attempted": len(w.done) + w.failed,
            "failed": w.failed, "metrics": metrics, "device": dev}
    if m.trace is not None:
        dev["busy_s"] = m.trace.busy_s
        dev["window_s"] = m.trace.window_s
        line["breakdown"] = {"device_ops": m.trace.top_ops(),
                             "idle_gaps": m.trace.idle_gaps()}
    found = forbidden_modules()
    if found:
        say(f"pbbench: modules of JAX or the JAX package were loaded: {found}")
        return None
    line["check"] = numbers
    for name, v in numbers.items():
        bound = f"limit {v['limit']}" if "limit" in v else f"at least {v['at_least']}"
        say(f"check {name} {v['value']} {bound}")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's kernel caches at fixed places inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "pbbench", ".cache", "triton")
    cell = cells.load(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        say(f"pbbench: {args.workload} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    line = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace))
    if line is None:
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
