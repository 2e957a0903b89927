"""Two-process runs of the port: the TCPStore rendezvous, the ordered merge
and the CLI's multi-process mode (tests/test_distributed.py's two tests).

The reference's multi-worker semantics (one ordered output sink,
Concurrency/SequenceProcessFramework.h:183-195) across PROCESSES: each
rank corrects a contiguous shard of the reads, writes a part file, and
rank 0's ordered merge must equal the single-process output byte for byte.
The ranks run on the CPU (gloo for the all-reduce); free ports are found
by binding port 0, since the test files run in parallel.
"""
import contextlib
import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from longreadselfcorrect_tpu import cli as jcli
from longreadselfcorrect_tpu_torch.entry import free_port

from test_distributed import _make_pb_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")

WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    rank = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
    from longreadselfcorrect_tpu_torch.core import alphabet as ab
    from longreadselfcorrect_tpu_torch.parallel import distributed as dist
    dist.init(f"127.0.0.1:{port}", nproc, rank)

    # tiny deterministic corpus (what is written is irrelevant to the
    # ordered-sink semantics under test)
    rng = np.random.default_rng(5)
    genome = "".join(rng.choice(list("ACGT"), size=400))
    reads = [genome[i:i+60] for i in range(0, 340, 20)]
    reads = [ab.revcomp_str(r) if i % 2 else r for i, r in enumerate(reads)]

    out = sys.argv[4]
    lo, hi = dist.shard_bounds(len(reads), nproc, rank)
    with open(dist.part_path(out, rank), "w") as fh:
        for i in range(lo, hi):
            fh.write(f">r{i}\\n{reads[i]}\\n")

    total = dist.global_counter_sum(np.array([hi - lo, 1.0]), device="cpu")
    assert total.tolist() == [len(reads), nproc], total
    # the store's counter sum is also the barrier before the rank-0 merge
    summed = dist.kv_counter_sum(np.array([hi - lo, rank + 0.5]), nproc, rank)
    assert summed.tolist() == [len(reads), nproc * nproc / 2], summed
    if rank == 0:
        dist.merge_ordered_parts(out, nproc)
    dist.shutdown()
    print("WORKER-OK", rank)
""")


def run_ranks(argv_of, n, timeout):
    """Start n processes (argv_of(rank)), wait for all; their outputs."""
    procs = [subprocess.Popen(argv_of(r), env=ENV, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(n)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-2000:]}\n{err[-3000:]}"
    return [out for out, _ in outs]


def test_two_process_ordered_merge(tmp_path):
    out = str(tmp_path / "merged.fa")
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    port = str(free_port())
    outs = run_ranks(lambda r: [sys.executable, str(script), str(r), "2", port, out], 2, 300)
    for r, o in enumerate(outs):
        assert f"WORKER-OK {r}" in o
    # the merged file must equal the single-process order
    merged = open(out).read()
    ids = [line[1:].strip() for line in merged.splitlines() if line.startswith(">")]
    assert ids == [f"r{i}" for i in range(17)]
    assert not [p for p in os.listdir(tmp_path) if ".part" in p]


def test_global_counter_sum_runs_on_the_card_by_default():
    """Without device=, global_counter_sum reduces on the rank's card, as
    its JAX twin reduces over jax.devices(): with no card it raises instead
    of summing on the CPU; device="cpu" sums with gloo."""
    import torch

    from longreadselfcorrect_tpu_torch.parallel import distributed as dist

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default would reduce with NCCL")
    dist.init(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            dist.global_counter_sum(np.array([3.0, 1.0]))
        assert dist.global_counter_sum(np.array([3.0, 1.0]), device="cpu").tolist() == [3.0, 1.0]
    finally:
        dist.shutdown()


def test_save_atomic_keeps_a_whole_file(tmp_path):
    """The pack's and the walk tables' files are written beside their path
    and renamed over it: a write that fails leaves the old file whole and
    no temporary file (two uncoordinated processes on one prefix each
    write them on first use)."""
    from longreadselfcorrect_tpu_torch.index.pack import save_atomic, save_npy

    path = str(tmp_path / "wcache12.npy")
    save_npy(path, np.arange(4, dtype=np.int32))

    def fail(fh):
        fh.write(b"part of a table")
        raise OSError("disk full")

    with pytest.raises(OSError):
        save_atomic(path, fail)
    np.testing.assert_array_equal(np.load(path), np.arange(4, dtype=np.int32))
    assert os.listdir(tmp_path) == ["wcache12.npy"]
    save_npy(path, np.ones(3, np.int32))
    np.testing.assert_array_equal(np.load(path), np.ones(3, np.int32))


def summary(stdout: str) -> list[str]:
    """pbcorrect's summary lines, without the three per-phase timer lines
    (wall seconds, which differ from run to run)."""
    return [line for line in stdout.splitlines()
            if line and not line.startswith("Time of searching")]


def test_two_process_cli_device_engine(tmp_path):
    """End to end: `pbcorrect --engine device --device cpu --num-processes
    2`, one process per rank, after the rank-0 ordered merge, byte-equals
    the single-process run and the JAX host CLI (correct.fa, discard.fa,
    the summary)."""
    corpus, noisy = _make_pb_corpus(tmp_path)
    prefix = str(tmp_path / "ix")
    cli = [sys.executable, "-m", "longreadselfcorrect_tpu_torch.cli"]
    subprocess.run(cli + ["index", str(corpus), "-p", prefix, "--pure-python"],
                   env=ENV, check=True, capture_output=True)
    base = ["pbcorrect", str(noisy), "-p", prefix, "-c", "30"]
    port_args = base + ["--engine", "device", "--device", "cpu",
                        "--walk-config", "64,640,640,320", "--batch-reads", "8"]
    # the JAX host CLI first: it packs the index, as either engine would
    jax_out = tmp_path / "jax"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jcli.main(base + ["-o", str(jax_out), "--engine", "host"]) == 0
    single, multi = tmp_path / "single", tmp_path / "multi"
    port = free_port()
    outs = run_ranks(
        lambda r: cli + port_args + (
            ["-o", str(single)] if r == 2 else
            ["-o", str(multi), "--num-processes", "2", "--process-id", str(r),
             "--coordinator", f"127.0.0.1:{port}"]), 3, 900)
    for name in ("correct.fa", "discard.fa"):
        want = (jax_out / name).read_text()
        assert (single / name).read_text() == want, f"{name}: 1 process vs JAX host"
        assert (multi / name).read_text() == want, f"{name}: 2 processes vs JAX host"
    assert (single / "correct.fa").read_text().count(">") > 0
    assert summary(outs[2]) == summary(buf.getvalue()) != []
    assert summary(outs[0]) == summary(outs[2])
    assert outs[1] == ""          # rank 1 prints no summary
    assert not [p for p in os.listdir(multi) if ".part" in p]
