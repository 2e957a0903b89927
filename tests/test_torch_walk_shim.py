"""The walk kernels of csrc/walk.cu, compiled for the host, equal the plain
versions.

No card here: walk.cu is compiled with g++ behind the CUDA shim of
tests/test_torch_cuda_shim.py (a warp as 32 std::threads, each collective
a barrier).  The C entries are called through ctypes with CPU pointers,
the arguments built by the same functions the wrappers use (ops/walk.py
steps_args, queue_args).  walk_steps (40 supersteps, then on to
completion) and walk_queue are held against walk_steps_plain /
walk_queue_plain, every field, tolerance 0 (ints, bools, labels and f64
error rates that feed compares).  walk_prep is held against prep_plain on
banks and batches whose tasks have no terminal window, one or all 48,
init_k below, at and far above CK, and a bank whose largest init_k (21)
exceeds most of its tasks'.  wcache_level_up is held against
wcache_level_up_plain on the host trie's levels 3 to 8 (64 to 65,536
parents, the smallest below one block), and the order it visits the
parents in is checked to be the order of their intervals on level 8.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from longreadselfcorrect_tpu_torch.ops import cuda
from longreadselfcorrect_tpu_torch.ops import walk as tw

from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector
from longreadselfcorrect_tpu_torch.core.correct import CorrectionParams
from test_torch_cuda_shim import build_host
from test_torch_replay_tracing import PARAMS, clr_corpus, flagged_tasks
from test_torch_walk_prep import index_pair, make_pair, port_tasks
from test_walk import make_tasks

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_host("walk.cu", tmp_path_factory.mktemp("walk_shim"),
                      ("lrsc_walk_steps", "lrsc_walk_queue", "lrsc_walk_prep",
                       "lrsc_wcache_level_up"))


@pytest.fixture(scope="module")
def corpora():
    """test_torch_superstep.py's corpus (exact reads of a random genome:
    the walks keep one leaf) and a two-haplotype one (a SNP every 40
    bases: the walks branch up to 32 leaves, end with several results, or
    overflow L = 4 with -200)."""
    rng = np.random.default_rng(5)
    g1 = "".join(rng.choice(list("ACGT"), size=5000))
    g2 = list(g1)
    for j in range(20, len(g2), 40):
        g2[j] = "ACGT"[("ACGT".index(g2[j]) + 1) % 4]
    g2 = "".join(g2)
    reads = []
    for i in range(240):
        p = int(rng.integers(0, len(g1) - 1000))
        reads.append((g1, g2)[i % 2][p : p + 1000])
    haplo = index_pair(reads)
    haplo["tasks"] = make_tasks(reads[::2], None, 12, noisy=True)
    pair = make_pair(33, 6000, 180)
    pair["tasks"] = make_tasks(pair["reads"], None, 12, noisy=True)
    return {"pair": pair, "haplo": haplo, "tie": dict(haplo, tasks=tie_tasks(g1, g2))}


def tie_tasks(g1, g2):
    """Gaps whose walks close two sibling leaves into one result slot in
    one step (the last writer, the larger candidate, wins it).  The walk
    runs along g1 into the target and records a result there; the target
    then carries, after g1's bases up to a SNP position j, the 13-mer of g2
    that ends at j.  At j the leaf branches into g1's and g2's base, both
    in the reads, and each child's last 13 bases are a terminal window:
    both write the parent's result slot."""
    out = []
    for j in range(220, 2400, 120):   # SNP positions (j % 40 == 20)
        k, t0, s0 = 15, j - 20, j - 80
        out.append(tw.GapTask(src=g1[s0 - k : s0], path=g1[s0:t0],
                              trg=g1[t0 : j + 1] + g2[j - 12 : j + 1], dis=60, init_k=k,
                              max_overlap=k + 2, min_overlap=13, min_sa_threshold=3))
    return out


def host_steps(lib, wx, consts, state, cfg, n):
    red = tw._reduced_empty(state.code.shape[0], cfg, state.code.device)
    info = cuda.int_array([0] * 4)
    rc = lib.lrsc_walk_steps(*tw.steps_args(wx, consts, state, red, cfg, n, on_card=False),
                             info, None)
    assert rc == 0
    assert list(info)[1:3] == [min(tw.lane_smem_bytes(cfg).warps_per_block, cfg.G),
                               -(-cfg.G // list(info)[1])]
    return red


def host_queue(lib, wx, bank, n, cfg, max_steps):
    T = bank.consts.q_len.shape[0]
    out = tw._reduced_empty(T, cfg, bank.consts.q_len.device)
    head = torch.zeros(1, dtype=torch.int32)
    info = cuda.int_array([0] * 4)
    rc = lib.lrsc_walk_queue(*tw.queue_args(wx, bank, out, head, n, cfg, max_steps,
                                            on_card=False), info, None)
    assert rc == 0
    return out


def assert_equal(got, want, fields, what):
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        assert torch.equal(a, b), (what, f, (a != b).nonzero()[:5].tolist())


# (slab, L, KMAX, corpus): each value of each axis in two cases
CASES = [(True, 4, 24, "pair"), (False, 32, 24, "pair"), (False, 4, 19, "haplo"),
         (True, 32, 19, "haplo"), (True, 4, 24, "haplo"), (True, 32, 24, "tie")]
# gaps of 80 and 95 bases (and 110, 148 on the branching corpus): walks of
# ~100-190 steps; the tie corpus's 60-base gaps, walks of ~80 steps
TASKS = {"pair": [0, 5], "haplo": [0, 5, 10, 6], "tie": [0, 4, 9, 14]}


@pytest.mark.parametrize("slab,L,kmax,corpus", CASES)
def test_walk_kernels_match_plain(lib, corpora, slab, L, kmax, corpus):
    c = corpora[corpus]
    tasks = port_tasks([c["tasks"][i] for i in TASKS[corpus]])
    cfg = tw.WalkConfig(G=len(tasks), MAXLEN=512, QMAX=512, SLAB=slab, SB=2, L=L,
                        CAND=4 * L, KMAX=kmax, CK=8)
    wx = tw.WalkIndex.build(c["td"], c["th"], ck=8)
    consts, state = tw.build_batch(wx, tasks, cfg, 0.15, 30)
    # 40 supersteps, then on to completion from there: the loaded state
    # carries labels, rings, chains and results of its own
    got, want = tw.clone(state), tw.clone(state)
    for n in (40, 4096):
        rk = host_steps(lib, wx, consts, got, cfg, n)
        rp = tw.walk_steps_plain(wx, consts, want, cfg, n)
        assert_equal(got, want, tw.STATE_FIELDS, f"state after {n}")
        assert_equal(rk, rp, tw.REDUCED_FIELDS, f"reduction after {n}")
    codes = set(rp.code.tolist())
    assert codes <= {1, -1, -2, -3, -200, -300} and 1 in codes, codes
    # the queue: every task, and a max_steps that cuts the longer walks
    bank = tw.build_bank(wx, tasks, cfg, 0.15, 30)
    for max_steps in (4096, 60):
        got_q = host_queue(lib, wx, bank, len(tasks), cfg, max_steps)
        want_q = tw.walk_queue_plain(wx, bank, len(tasks), cfg, max_steps)
        assert_equal(got_q, want_q, tw.REDUCED_FIELDS, f"queue, max_steps {max_steps}")
    assert -900 in want_q.code.tolist()


@pytest.fixture(scope="module")
def clr(tmp_path_factory):
    """test_torch_replay_tracing.py's CLR read set: the gap tasks of 24
    reads, the reason the plain walk gives each -100 and their tie bits."""
    reads, hix, dix = clr_corpus(tmp_path_factory.mktemp("clr"))
    port = BatchedSelfCorrector(hix, dix, CorrectionParams(**PARAMS))
    return port, *flagged_tasks(port, reads[:24])


def test_walk_kernels_hazard_match_plain(lib, clr):
    """Two CLR gaps whose walks meet a tie among leaves at the minimum
    error (the JAX walk's f32 hazard, flagged there; decided in f64 here)
    and two that do not, at the corrector's bulk config: walk_steps (40
    supersteps, then on to completion) and walk_queue equal the plain
    versions bit for bit, the f64 error fields and the tie bit of the
    state and of the reduction included."""
    port, tasks, why, ties = clr
    assert why == [None] * len(tasks)
    pick = ([g for g, x in enumerate(ties) if x][:2]
            + [g for g, x in enumerate(ties) if not x][:2])
    sel = [tasks[g] for g in pick]
    cfg = replace(port.cfg, G=len(sel))
    consts, state = tw.build_batch(port.wx, sel, cfg, 0.15, 30)
    got, want = tw.clone(state), tw.clone(state)
    for n in (40, 4096):
        rk = host_steps(lib, port.wx, consts, got, cfg, n)
        rp = tw.walk_steps_plain(port.wx, consts, want, cfg, n)
        assert_equal(got, want, tw.STATE_FIELDS, f"state after {n}")
        assert_equal(rk, rp, tw.REDUCED_FIELDS, f"reduction after {n}")
    assert rp.tie.tolist() == [True, True, False, False]
    bank = tw.build_bank(port.wx, sel, cfg, 0.15, 30)
    got_q = host_queue(lib, port.wx, bank, len(sel), cfg, 4096)
    want_q = tw.walk_queue_plain(port.wx, bank, len(sel), cfg, 4096)
    assert_equal(got_q, want_q, tw.REDUCED_FIELDS, "queue")
    assert want_q.tie.tolist() == [True, True, False, False]


def spec_tasks(reads, spec):
    """A gap task per (init_k, target length) of spec, cut from the reads;
    min_overlap 13, so n_term = max(target length - 12, 0)."""
    out = []
    for t, (ik, tl) in enumerate(spec):
        read = reads[(3 * t) % len(reads)]
        s, gap = 40 + (t * 29) % 200, 60 + (t * 31) % 150
        out.append(tw.GapTask(src=read[s : s + ik], path=read[s + ik : s + ik + gap],
                              trg=read[s + ik + gap : s + ik + gap + tl], dis=gap,
                              init_k=ik, max_overlap=ik + 2, min_overlap=13,
                              min_sa_threshold=3))
    return out


# (init_k, target length) of each task: no terminal window (length 10),
# one (13), all 48 (60), the usual 7 (19); init_k below CK, at CK, 21
BANK = [(21, 19), (8, 10), (12, 13), (9, 60), (15, 19), (10, 19), (13, 60), (8, 19),
        (11, 13), (16, 10), (14, 19), (9, 19)]
# (ck, KMAX, QMAX, route, task specs): banks (the queue's prep, the table
# from CK where every init_k reaches it) and batches (G rows, padding rows
# with init_k 0; the JAX batch prep climbs every ladder from level 1)
PREP_CASES = {
    "bank ck8": (8, 24, 512, "bank", BANK),
    "bank ck8 short root": (8, 24, 512, "bank", BANK + [(7, 19), (5, 60)]),
    "bank ck10 kmax19": (10, 19, 512, "bank", [(10, 60), (16, 19), (12, 10), (11, 13),
                                                (16, 60), (10, 19)]),
    "batch ck8": (8, 24, 512, "batch", BANK + [(7, 19), (5, 60), (6, 13)]),
    "batch ck10 qmax500": (10, 24, 500, "batch", [(7, 60), (10, 19), (21, 13), (9, 10),
                                                  (14, 60)]),
}


@pytest.mark.parametrize("case", sorted(PREP_CASES))
def test_walk_prep_kernel_matches_plain(lib, corpora, case):
    ck, kmax, qmax, route, spec = PREP_CASES[case]
    c = corpora["pair"]
    tasks = port_tasks(spec_tasks(c["reads"], spec))
    cfg = tw.WalkConfig(G=len(tasks) + 3, MAXLEN=512, QMAX=qmax, KMAX=kmax, CK=ck)
    wx = tw.WalkIndex.build(c["td"], c["th"], ck=ck)
    bank = route == "bank"
    use_wc = bank and all(t.init_k >= ck for t in tasks)
    T = len(tasks) if bank else cfg.G
    query, trg, a, _, kbt, kbr = tw._task_arrays(tasks, cfg, T, bank)
    ins = (wx, torch.from_numpy(query), torch.from_numpy(a["q_len"]), torch.from_numpy(trg),
           torch.from_numpy(a["n_term"]), torch.from_numpy(a["init_k"]),
           torch.from_numpy(a["min_overlap"]), cfg, kbt, kbr, use_wc)
    out = tw.prep_outputs(T, cfg, "cpu")
    for v in out.values():
        v.fill_(7)   # the kernel writes every entry
    assert lib.lrsc_walk_prep(*tw.prep_args(*ins, out, on_card=False), None) == 0
    want = tw.prep_plain(*ins)
    for k, v in want.items():
        assert out[k].dtype == v.dtype and torch.equal(out[k], v), (case, k)
    n_term, init_k = a["n_term"][: len(tasks)], a["init_k"][: len(tasks)]
    assert kbr == 21 or kmax < 21
    assert {0, 1}.issubset(set(n_term.tolist())) and (n_term.max() == 48 or "kmax19" in case)
    assert (init_k < kbr).mean() > 0.5


def test_walk_prep_parts_write_their_own_outputs(lib, corpora):
    """The timing variants (walk.PREP_*): a launch of one part writes that
    part's outputs as the whole launch does (the code rows, the tails and
    the constants; the kept terminal windows; the kept chain slots and the
    root) and leaves the rest alone."""
    c = corpora["pair"]
    tasks = port_tasks(spec_tasks(c["reads"], BANK))
    cfg = tw.WalkConfig(G=len(tasks), MAXLEN=512, QMAX=512, KMAX=24, CK=8)
    wx = tw.WalkIndex.build(c["td"], c["th"], ck=8)
    query, trg, a, _, kbt, kbr = tw._task_arrays(tasks, cfg, len(tasks), True)
    ins = (wx, torch.from_numpy(query), torch.from_numpy(a["q_len"]), torch.from_numpy(trg),
           torch.from_numpy(a["n_term"]), torch.from_numpy(a["init_k"]),
           torch.from_numpy(a["min_overlap"]), cfg, kbt, kbr, True)
    want = tw.prep_plain(*ins)
    n_term, init_k = torch.from_numpy(a["n_term"]), torch.from_numpy(a["init_k"])
    kept_m = torch.arange(cfg.TMAX)[None, :] < n_term[:, None]
    kept_i = (cfg.CK + torch.arange(cfg.NCHAIN))[None, :] <= init_k[:, None]
    for bits in (tw.PREP_CODES, tw.PREP_TERM, tw.PREP_CHAIN):
        out = tw.prep_outputs(len(tasks), cfg, "cpu")
        for v in out.values():
            v.fill_(7)
        assert lib.lrsc_walk_prep(*tw.prep_args(*ins, out, bits, on_card=False), None) == 0
        for k in ("qcode9", "qcode5", "tail9", "tail8", "tail_letter", "tail_count"):
            assert torch.equal(out[k], want[k]) == (bits == tw.PREP_CODES), (bits, k)
        for k in ("term_f", "term_r"):
            part = {tw.PREP_CODES: ~kept_m, tw.PREP_TERM: kept_m}.get(bits, kept_m & False)
            assert torch.equal(out[k][part], want[k][part]), (bits, k)
            assert (out[k][~part] == 7).all(), (bits, k)
        part = {tw.PREP_CODES: ~kept_i, tw.PREP_CHAIN: kept_i}.get(bits, kept_i & False)
        got_c, want_c = out["chain0"].transpose(1, 2), want["chain0"].transpose(1, 2)
        assert torch.equal(got_c[part], want_c[part]) and (got_c[~part] == 7).all(), bits
        for k in ("f_lo", "f_hi", "r_lo", "r_hi", "freq"):
            assert torch.equal(out[k], want[k]) == (bits == tw.PREP_CHAIN), (bits, k)


RUN = 2   # csrc/walk.cu kLevelRun: the bases of a parent code a thread takes from g


def level_up_order(k):
    """The parent code each thread of the level-up kernel visits
    (csrc/walk.cu level_up_parent): its last RUN bases those of g, the
    k - RUN bases before them the base-4 digits of g >> 2 RUN in reverse
    order."""
    g = np.arange(4 ** k, dtype=np.int64)
    if k <= RUN:
        return g
    m, code = g >> (2 * RUN), np.zeros_like(g)
    for _ in range(k - RUN):
        code = (code << 2) | (m & 3)
        m >>= 2
    return (code << (2 * RUN)) | (g & (4 ** RUN - 1))


def digit_reversed(k):
    """Codes of level k in base-4 digit-reversed order: by the last base,
    then the one before, ...: the order of reverse(w)."""
    g = np.arange(4 ** k, dtype=np.int64)
    code = np.zeros_like(g)
    for _ in range(k):
        code = (code << 2) | (g & 3)
        g >>= 2
    return code


@pytest.fixture(scope="module")
def trie(corpora):
    """The host trie of the seed-33 corpus (get_tables' levels 1..8)."""
    c = corpora["pair"]
    return c["td"], tw.build_kmer_levels(c["th"], 8)


@pytest.mark.parametrize("k", [3, 4, 5, 6, 7, 8])
def test_wcache_level_up_kernel_matches_plain(lib, trie, k):
    td, levels = trie
    st = tuple(torch.from_numpy(np.ascontiguousarray(levels[k - 1][:, i])) for i in range(4))
    n = st[0].shape[0]
    assert n == 4 ** k
    outs = [torch.full((4 * n,), 7, dtype=torch.int32) for _ in range(4)]
    name = "wcache_level_up"
    p = cuda.ptr_array(tw._index_ptrs(name, td, on_card=False)
                       + [cuda.check(name, t, torch.int32, (n,), on_card=False) for t in st]
                       + [o.data_ptr() for o in outs])
    assert lib.lrsc_wcache_level_up(p, cuda.int_array(tw._index_dims(td) + [n, k]), None) == 0
    want = tw.wcache_level_up_plain(td, *st)
    for g, w in zip(outs, want):
        assert torch.equal(g, w), (g != w).nonzero()[:5].tolist()
    # the host trie's next level: the same intervals
    if k < 8:
        assert np.array_equal(torch.stack(outs, 1).numpy(), levels[k])
    # a level other than the parents' is refused, by the entry and the wrapper
    bad = cuda.int_array(tw._index_dims(td) + [n, k + 1])
    assert lib.lrsc_wcache_level_up(p, bad, None) != 0
    with pytest.raises(ValueError):
        tw.wcache_level_up(td, *st, k=k + 1)


def test_wcache_level_up_visits_parents_in_interval_order(trie):
    """On level 8: along the base-4 digit-reversed code order, f_lo never
    falls and r_lo never rises over the parents whose intervals are not
    empty; the kernel's order is that order cut into 4^RUN streams (by the
    last RUN bases) and interleaved, so each stream sweeps both BWTs
    once."""
    _, levels = trie
    lv = levels[7]
    order = digit_reversed(8)
    f_lo, f_hi, r_lo, r_hi = (lv[order, i].astype(np.int64) for i in range(4))
    live = (f_lo <= f_hi) & (r_lo <= r_hi)
    assert live.sum() > 10_000
    assert (np.diff(f_lo[live]) >= 0).all()
    assert (np.diff(r_lo[live]) <= 0).all()
    visit = level_up_order(8)
    assert sorted(visit.tolist()) == list(range(4 ** 8))
    streams, size = 4 ** RUN, 4 ** (8 - RUN)
    for d in range(streams):
        block = int(digit_reversed(RUN)[d])   # the last bases d, as the order ranks them
        assert np.array_equal(visit[d::streams], order[block * size : (block + 1) * size])
