"""Entry points of the port: one walk superstep on a tiny batch, and the
multi-GPU dry run (the counterparts of the JAX package's
__graft_entry__.py entry / dryrun_multichip).

    python -m longreadselfcorrect_tpu_torch.entry

runs entry()'s superstep on the card, then dryrun_multigpu over every
visible GPU.
"""
from __future__ import annotations

import socket

import numpy as np
import torch


def _tiny_setup(n_reads=60, read_len=300, genome_len=3000, seed=0, device="cuda"):
    """(genome, reads, host index, torch index on device) of exact reads
    of a random genome, both strands."""
    from .core import alphabet as ab

    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=genome_len))
    reads = []
    for i in range(n_reads):
        p = int(rng.integers(0, genome_len - read_len))
        r = genome[p : p + read_len]
        reads.append(ab.revcomp_str(r) if i % 2 else r)
    return (genome, reads) + _index_of(reads, device)


def _index_of(reads, device):
    """(HostIndexSet, IndexSet on device) of the reads."""
    from .core import alphabet as ab
    from .index import build
    from .index.fmindex import FMIndex, IndexSet
    from .index.host import HostFM, HostIndexSet

    fwd, rev = build.build_bwt_pair([ab.encode(r) for r in reads])
    hix = HostIndexSet(HostFM(fwd.symbols, fwd.num_strings),
                       HostFM(rev.symbols, rev.num_strings))
    dix = IndexSet(bwt=FMIndex.from_symbols(fwd.symbols, fwd.num_strings, device),
                   rbwt=FMIndex.from_symbols(rev.symbols, rev.num_strings, device))
    return hix, dix


def _tiny_walk_tasks(reads, G):
    """G gap tasks over the reads; every third lane's gap corrupted, so the
    walks end in every code of the failure taxonomy (-1/-2/-3), not just
    clean successes."""
    from .ops import walk

    rng = np.random.default_rng(123)

    def mutate(s, rate):
        out = list(s)
        for j in range(len(out)):
            if rng.random() < rate:
                out[j] = "ACGT"[int(rng.integers(0, 4))]
        return "".join(out)

    tasks = []
    for t in range(G):
        read = reads[(2 * t) % len(reads)]
        s = 10 + (t * 17) % 60
        gap = 60 + (t * 13) % 40
        trg_start = s + 19 + gap
        src = read[s + 4 : s + 19]
        path = read[s + 19 : trg_start]
        trg = read[trg_start : trg_start + 19]
        if t % 3 == 2:
            path = mutate(path, 0.4)
            trg = mutate(trg, 0.3)
        tasks.append(walk.GapTask(
            src=src, path=path, trg=trg, dis=gap, init_k=15,
            max_overlap=17, min_overlap=13, min_sa_threshold=3,
        ))
    return tasks


def _tiny_walk_batch(hix, dix, reads, G, cfg=None):
    """(WalkIndex, WalkConsts, WalkState, WalkConfig) of G tiny gap tasks
    on dix's device."""
    from .ops import walk

    cfg = cfg or walk.WalkConfig(G=G, L=8, CAND=32, MAXLEN=256, QMAX=256, WSCAN=128)
    wx = walk.WalkIndex.build(dix, hix)
    consts, state = walk.build_batch(wx, _tiny_walk_tasks(reads, G), cfg, 0.15, 30)
    return wx, consts, state, cfg


def entry(device="cuda"):
    """(fn, example_args): one superstep of the flagship batched
    FM-extension walk -- the compute core of PacBio self-correction.  fn
    updates the state in place and returns the lanes' Reduced."""
    from .ops import walk

    genome, reads, hix, dix = _tiny_setup(device=device)
    wx, consts, state, cfg = _tiny_walk_batch(hix, dix, reads, G=8)

    def fn(wx, consts, state):
        return walk.walk_steps(wx, consts, state, cfg, 1)

    return fn, (wx, consts, state)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_lanes(n: int) -> int:
    """The dry run's gap lanes: at least 16, a multiple of n."""
    G = max(8, n) * 2
    return G - G % n


def dryrun_rank(rank: int, n: int, port: int, device: str = "cuda") -> dict:
    """One rank of dryrun_multigpu: the tiny walk batch sharded over n
    ranks, walked to completion and gathered, against the unsharded walk
    on this rank; then a counter all-reduce."""
    from .ops import walk
    from .parallel import distributed, mesh

    distributed.init(f"127.0.0.1:{port}", n, rank)
    try:
        dev = distributed.rank_device(rank, device)
        group = mesh.make_group(dev)
        genome, reads, hix, dix = _tiny_setup(device=dev)
        G = dryrun_lanes(n)
        wx, consts, state, cfg = _tiny_walk_batch(hix, dix, reads, G=G)
        ref = walk.walk_steps(wx, consts, walk.clone(state), cfg, 256)
        sh = mesh.sharded_multistep(wx, *mesh.shard_walk_batch(group, consts, state),
                                    cfg, 256, group, G)
        for name in walk.REDUCED_FIELDS:
            if not torch.equal(getattr(ref, name), getattr(sh, name)):
                raise AssertionError(f"sharded {name} diverged from unsharded")
        codes = ref.code.cpu()
        if codes.shape[0] != G or not bool((codes != 0).any()):
            raise AssertionError(f"dryrun: lanes {codes.tolist()}")
        total = mesh.all_reduce_counters(group, torch.ones((1, 4), dtype=torch.float32,
                                                           device=dev))
        if not bool((total == n).all()):
            raise AssertionError(f"dryrun: counter all-reduce gave {total.tolist()}")
        return {"G": G, "codes": sorted(set(codes.tolist()))}
    finally:
        distributed.shutdown()


def _spawned_rank(rank, n, port, device):
    if device == "cpu":
        # the ranks share the host's cores, on tensors of a few KB
        torch.set_num_threads(1)
    dryrun_rank(rank, n, port, device)


def dryrun_multigpu(n: int, device: str = "cuda") -> dict:
    """Shard the walk's gap lanes over n ranks, one GPU each (gloo ranks
    with device "cpu"), walk them to completion and gather them: the lanes'
    reductions must equal the unsharded walk's bit for bit, and an
    all-reduce of a ones counter must sum to n.  One rank runs in this
    process; more are spawned as processes."""
    port = free_port()
    if n == 1:
        out = dryrun_rank(0, 1, port, device)
    else:
        torch.multiprocessing.start_processes(
            _spawned_rank, args=(n, port, device), nprocs=n, join=True,
            start_method="spawn")
        out = {"G": dryrun_lanes(n)}
    print(f"dryrun_multigpu({n}): sharded walk-to-completion == unsharded"
          + (f" (codes {out['codes']})" if "codes" in out else "") + ", all-reduce ok",
          flush=True)
    return out


if __name__ == "__main__":
    fn, fargs = entry()
    fn(*fargs)
    torch.cuda.synchronize()
    print("entry() ran one superstep on the card")
    dryrun_multigpu(torch.cuda.device_count())
