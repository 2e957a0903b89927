"""Multi-GPU correctness of the port (tests/test_multichip.py's tests): the
walk's gap lanes sharded over two gloo ranks on the CPU, walked to
completion and gathered, must equal the unsharded walk bit for bit
(reference semantics: a thread pool changes nothing about per-read
results, Concurrency/SequenceProcessFramework.h:90-230); the counter
all-reduce gives the exact sums; entry()'s superstep on the CPU equals the
JAX package's superstep on the same tiny batch.

The ranks are processes (free ports found by binding port 0, since the
test files run in parallel); JAX is imported only by the test that
compares with it, so the ranks import this module without it.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from longreadselfcorrect_tpu_torch import entry
from longreadselfcorrect_tpu_torch.ops import walk

# the walks' tensors are small: one torch thread is faster, and keeps the
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
MAX_STEPS = 256
# (setup, gap lanes): G = 15 leaves the second rank a padding lane
CASES = [("clean", 16), ("noisy", 16), ("clean", 15)]


def noisy_setup(seed=3):
    """tests/test_multichip.py's noisy corpus: 80 reads of 300 bp with 3%
    substitution noise, so walks branch and relax."""
    from longreadselfcorrect_tpu_torch.core import alphabet as ab

    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=3000))
    reads = []
    for i in range(80):
        p = int(rng.integers(0, 3000 - 300))
        r = list(genome[p : p + 300])
        for j in range(len(r)):
            if rng.random() < 0.03:
                r[j] = "ACGT"[int(rng.integers(0, 4))]
        r = "".join(r)
        reads.append(ab.revcomp_str(r) if i % 2 else r)
    return (genome, reads) + entry._index_of(reads, "cpu")


def batch(setup, G):
    genome, reads, hix, dix = (entry._tiny_setup(device="cpu") if setup == "clean"
                               else noisy_setup())
    return entry._tiny_walk_batch(hix, dix, reads, G=G)


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank, n, port, out, tests = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
    sys.path.insert(0, tests)
    from test_torch_multigpu import CASES, MAX_STEPS, batch
    from longreadselfcorrect_tpu_torch.ops import walk
    from longreadselfcorrect_tpu_torch.parallel import distributed as dist, mesh

    dist.init(f"127.0.0.1:{port}", n, rank)
    group = mesh.make_group("cpu")
    res = {}
    for setup, G in CASES:
        wx, consts, state, cfg = batch(setup, G)
        sh = mesh.sharded_multistep(wx, *mesh.shard_walk_batch(group, consts, state),
                                    cfg, MAX_STEPS, group, G)
        for f in walk.REDUCED_FIELDS:
            res[f"{setup}{G}_{f}"] = getattr(sh, f).numpy()
    block = torch.arange(8, dtype=torch.float32).reshape(2, 4)[rank : rank + 1]
    res["counters"] = mesh.all_reduce_counters(group, block).numpy()
    res["global"] = dist.global_counter_sum(np.array([rank + 1.0, 2.0]), device="cpu")
    np.savez(f"{out}.{rank}.npz", **res)
    dist.shutdown()
""")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every case sharded over two gloo ranks: each rank's gathered
    results and reductions."""
    d = tmp_path_factory.mktemp("multigpu")
    script = d / "worker.py"
    script.write_text(WORKER)
    port = str(entry.free_port())
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "2", port,
                               str(d / "res"), TESTS], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{o[-3000:]}"
    return [dict(np.load(d / f"res.{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("setup,G", CASES)
def test_sharded_walk_bit_identical(two_ranks, setup, G):
    wx, consts, state, cfg = batch(setup, G)
    ref = walk.walk_steps_plain(wx, consts, state, cfg, MAX_STEPS)
    for f in walk.REDUCED_FIELDS:
        want = getattr(ref, f).numpy()
        for r, res in enumerate(two_ranks):
            got = res[f"{setup}{G}_{f}"]
            assert got.dtype == want.dtype and got.shape == want.shape, (r, f)
            np.testing.assert_array_equal(got, want, err_msg=f"rank {r} {f}")
    assert ref.code.shape[0] == G and bool((ref.code != 0).any())


@pytest.mark.parametrize("setup,G,world", [("noisy", 15, 4), ("clean", 16, 3)])
def test_in_process_shards_equal_unsharded(setup, G, world):
    """Every rank's shard (mesh.shard_lanes, padding lanes included) walked
    one after another in this process, the Reduced fields concatenated and
    cut to G, equals the unsharded walk: chip_smoke.py's phase 15 does the
    same on the card, where its process group has one rank."""
    from dataclasses import replace

    from longreadselfcorrect_tpu_torch.parallel import mesh

    wx, consts, state, cfg = batch(setup, G)
    ref = walk.walk_steps_plain(wx, consts, walk.clone(state), cfg, MAX_STEPS)
    parts = []
    for r in range(world):
        c, s = mesh.shard_lanes(consts, walk.clone(state), world, r)
        assert s.code.shape[0] == -(-G // world)
        parts.append(walk.walk_steps(wx, c, s, replace(cfg, G=s.code.shape[0]), MAX_STEPS))
    assert not bool(parts[-1].has[G - (world - 1) * s.code.shape[0]:].any())
    for f in walk.REDUCED_FIELDS:
        got = torch.cat([getattr(p, f) for p in parts])[:G]
        np.testing.assert_array_equal(got.numpy(), getattr(ref, f).numpy(), err_msg=f)


def test_counter_allreduce(two_ranks):
    """all_reduce_counters sums the ranks' blocks of a [2, 4] matrix (the
    JAX psum over the mesh axis); global_counter_sum sums [r + 1, 2]."""
    want = np.arange(8, dtype=np.float32).reshape(2, 4).sum(0, keepdims=True)
    for res in two_ranks:
        np.testing.assert_array_equal(res["counters"], want)
        np.testing.assert_array_equal(res["global"], np.array([3.0, 4.0]))


def test_dryrun_multigpu_two_gloo_ranks():
    """entry.dryrun_multigpu spawns its ranks and checks itself."""
    assert entry.dryrun_multigpu(2, "cpu") == {"G": 16}


def test_entry_superstep_matches_jax():
    """entry() on the CPU: one walk_steps superstep of the tiny batch equals
    the JAX package's superstep (__graft_entry__.entry) on every state field
    the two share, its f64 error fields equal the host engine's first step,
    and its reduction equals _reduce_results."""
    import jax

    sys.path.insert(0, REPO)
    import __graft_entry__ as graft
    from longreadselfcorrect_tpu.ops import walk as jw

    from test_torch_walk_prep import HostWalks, assert_jax_state

    jfn, jargs = graft.entry()
    jstate = jax.jit(jfn)(*jargs)
    fn, (wx, consts, state) = entry.entry("cpu")
    red = fn(wx, consts, state)
    # every field the JAX state shares, on the lanes it did not flag; the
    # f64 error fields against the host engine's first step
    assert_jax_state(jstate, state, "entry")
    _, reads, hix, _ = entry._tiny_setup(device="cpu")
    host = HostWalks(hix, entry._tiny_walk_tasks(reads, 8))
    host.step()
    jcfg = jw.WalkConfig(G=8, L=8, CAND=32, MAXLEN=256, QMAX=256, WSCAN=128)
    tcfg = walk.WalkConfig(G=8, L=8, CAND=32, MAXLEN=256, QMAX=256, WSCAN=128)
    assert host.assert_errors(state, tcfg, "entry") == 8
    jred = jw._reduce_results(jstate, jcfg)
    keep = ~np.asarray(jstate.res_overflow)
    for f, want in zip(walk.REDUCED_FIELDS, jred):
        np.testing.assert_array_equal(getattr(red, f).numpy()[keep], np.asarray(want)[keep],
                                      err_msg=f)
    assert torch.equal(red.tie, state.res_tie)
    assert bool((state.cur_len > consts.init_k).any())
