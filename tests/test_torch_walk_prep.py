"""The port's walk prep equals the JAX package's, bit for bit.

The ck-mer interval cache and its level-up, the per-task prep of the batch
engine (_prep_batch, chains by plain LF) and of the queue bank
(_prep_bank_packed, chains seeded from the cache), every WalkConsts /
RootPack field, and the fresh lane state of _init_state.  Plain torch
versions on the CPU against the JAX functions run by jax.jit on the CPU.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from longreadselfcorrect_tpu.core import alphabet as jab
from longreadselfcorrect_tpu.index import build as jbuild
from longreadselfcorrect_tpu.index import pack as jpack
from longreadselfcorrect_tpu.index.fmindex import FMIndex as JFMIndex
from longreadselfcorrect_tpu.index.fmindex import IndexSet as JIndexSet
from longreadselfcorrect_tpu.index.host import HostFM as JHostFM
from longreadselfcorrect_tpu.index.host import HostIndexSet as JHostIndexSet
from longreadselfcorrect_tpu.ops import walk as jw
from longreadselfcorrect_tpu_torch.core.extend import FMExtendParams, HostExtendEngine
from longreadselfcorrect_tpu_torch.index.fmindex import FMIndex, IndexSet
from longreadselfcorrect_tpu_torch.index.host import HostFM, HostIndexSet
from longreadselfcorrect_tpu_torch.index.pack import open_index
from longreadselfcorrect_tpu_torch.ops import walk as tw

from test_walk import make_tasks   # seed-gap tasks cut from the reads

# the walks' tensors are small: one torch thread is faster, and keeps the
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

TASK_FIELDS = ("src", "path", "trg", "dis", "init_k", "max_overlap",
               "min_overlap", "min_sa_threshold")


def make_pair(seed, genome_len, n_reads):
    """JAX and port indexes over the same reads (tests/test_walk.py's
    corpus recipe: exact 1 kb reads of a random genome, both strands)."""
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=genome_len))
    reads = []
    for i in range(n_reads):
        p = rng.integers(0, len(genome) - 1000)
        r = genome[p : p + 1000]
        reads.append(jab.revcomp_str(r) if i % 2 else r)
    return dict(index_pair(reads), genome=genome)


def index_pair(reads):
    """JAX and port indexes of a read set."""
    fwd, rev = jbuild.build_bwt_pair([jab.encode(r) for r in reads])
    jh = JHostIndexSet(JHostFM(fwd.symbols, fwd.num_strings),
                       JHostFM(rev.symbols, rev.num_strings))
    jd = JIndexSet(bwt=JFMIndex.from_symbols(fwd.symbols, fwd.num_strings),
                   rbwt=JFMIndex.from_symbols(rev.symbols, rev.num_strings))
    th = HostIndexSet(HostFM(fwd.symbols, fwd.num_strings),
                      HostFM(rev.symbols, rev.num_strings))
    td = IndexSet(bwt=FMIndex.from_symbols(fwd.symbols, fwd.num_strings, "cpu"),
                  rbwt=FMIndex.from_symbols(rev.symbols, rev.num_strings, "cpu"))
    return {"reads": reads, "jh": jh, "jd": jd, "th": th, "td": td, "fwd": fwd,
            "rev": rev}


@pytest.fixture(scope="module")
def walk_corpus():
    """tests/test_walk.py's corpus (seed 33)."""
    return make_pair(33, 6000, 180)


# the port's f64 error fields: the JAX walk keeps f32 error rates (and the
# integer counters red_a / red_b for nrs), so these are held to the host
# engine (HostWalks) instead
F64_FIELDS = ("nrs", "local_err", "gerr_last", "ring", "res_err")
# the fields the port shares with the JAX walk: the integer, bool and label
# fields (res_tie, informational, is the port's own)
JAX_STATE_FIELDS = tuple(f for f in tw.STATE_FIELDS if f not in F64_FIELDS + ("res_tie",))


def assert_jax_state(js, ts, what):
    """Every field the port shares with the JAX walk, bit for bit, on the
    lanes the JAX walk did not flag: JAX's res_overflow is also raised by
    its f32 tie, which the port decides in f64 as the host engine does
    (HostWalks holds those lanes).  The port's res_overflow (result slots
    only) is never set where JAX's is not."""
    keep = ~np.asarray(js.res_overflow)
    for f in JAX_STATE_FIELDS:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        assert np.array_equal(a[keep], b[keep]), (what, f, np.argwhere(a[keep] != b[keep])[:5])
    assert not (ts.res_overflow.cpu().numpy() & keep).any(), what


def assert_fresh_errors(ts):
    """A fresh lane: every f64 error field zero (the root's errors are 0.0
    in the host engine), no tie."""
    for f in F64_FIELDS:
        x = getattr(ts, f)
        assert x.dtype == torch.float64 and not bool(x.any()), f
    assert not bool(ts.res_tie.any())


class HostWalks:
    """The host engine (core/extend.py HostExtendEngine) walking each task
    of a batch, one while-iteration of extendOverlap a step: the yardstick
    of the port's f64 error fields.  A superstep of the port is one such
    iteration, and its leaf slots hold the host's leaves in order."""

    def __init__(self, th, tasks, e=0.15, cov=30):
        self.eng = [HostExtendEngine(th, t.src, t.path, t.trg, t.dis, t.init_k,
                                     t.max_overlap,
                                     FMExtendParams(min_kmer_length=t.min_overlap,
                                                    pb_coverage=cov, error_rate=e),
                                     t.min_sa_threshold) for t in tasks]
        self.results = [[] for _ in tasks]

    def step(self, n=1):
        for eng, res in zip(self.eng, self.results):
            for _ in range(n):
                if not (eng.leaves and len(eng.leaves) <= eng.max_leaves
                        and eng.current_length <= eng.max_length):
                    break
                new = []
                eng._extend_leaves(new)
                eng._pruned_by_seed_support(new)
                eng.leaves = new
                if eng.current_length >= eng.min_length:
                    eng._is_terminated(res)

    def assert_errors(self, ts, cfg, what) -> int:
        """The port's f64 fields equal the host's, bit for bit, on every
        lane the host can be held to (not -200 / -300, the host's leaves
        fit L): per live leaf slot its local and global error, its
        num_redeem_seed and the ring of its last RING global errors; per
        result slot its error.  Returns the number of lanes compared."""
        n_cmp = 0
        for g, (eng, res) in enumerate(zip(self.eng, self.results)):
            code = int(ts.code[g])
            if code in (-200, -300) or len(eng.leaves) > cfg.L:
                continue
            n_cmp += 1
            alive = ts.alive[g].tolist()
            assert alive == [i < len(eng.leaves) for i in range(cfg.L)], (what, g)
            assert int(ts.res_count[g]) == len(res), (what, g)
            n = int(ts.gerr_n[g])
            for i, leaf in enumerate(eng.leaves):
                assert len(leaf.global_err) == n, (what, g, i)
                got = (float(ts.local_err[g, i]), float(ts.gerr_last[g, i]),
                       float(ts.nrs[g, i]))
                want = (leaf.local_err[-1], leaf.global_err[-1], leaf.num_redeem_seed)
                assert got == want, (what, g, i, got, want)
                ring = [0.0] * cfg.RING
                for j in range(max(n - cfg.RING, 0), n):
                    ring[j % cfg.RING] = leaf.global_err[j]
                assert ts.ring[g, i].tolist() == ring, (what, g, i)
            errs = [r.error_rate for r in res[: cfg.RMAX]]
            assert ts.res_err[g, : len(errs)].tolist() == errs, (what, g)
        return n_cmp


def port_tasks(tasks):
    return [tw.GapTask(**{k: getattr(t, k) for k in TASK_FIELDS}) for t in tasks]


def configs(**kw):
    return jw.WalkConfig(**kw), tw.WalkConfig(**kw)


def assert_same(jax_obj, port_obj, fields, what):
    """Every field equal: same shape, same dtype, same bits."""
    for f in fields:
        a = np.asarray(getattr(jax_obj, f))
        b = getattr(port_obj, f).cpu().numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (what, f, a.shape, b.shape,
                                                           a.dtype, b.dtype)
        assert np.array_equal(a, b), (what, f, np.argwhere(a != b)[:5])


@pytest.mark.parametrize("ck", [8, 10])
def test_wcache_and_level_up(walk_corpus, ck):
    """The host CACHE_K table, and the level-ups to ck, against JAX."""
    c = walk_corpus
    jwx = jw.WalkIndex.build(c["jd"], c["jh"], ck=ck)
    twx = tw.WalkIndex.build(c["td"], c["th"], ck=ck)
    assert np.array_equal(np.asarray(jwx.fused.wcache), twx.wcache.numpy())
    # one more level from ck, through both level-up functions
    base = twx.wcache
    got = tw.wcache_level_up(c["td"], *(base[:, i].contiguous() for i in range(4)))
    want = jw._wcache_level_up(jwx.fused, *(jnp.asarray(base[:, i].numpy())
                                            for i in range(4)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_pack_wcache_files(tmp_path, walk_corpus):
    """The port reads the wcache.npy a JAX pack holds, and persists and
    reloads wcache{ck}.npy beside it."""
    c = walk_corpus
    from longreadselfcorrect_tpu.index import store as jstore

    prefix = str(tmp_path / "reads")
    jstore.save_native(prefix, c["fwd"], c["rev"])
    jpack.open_index(prefix, device=False)          # JAX writes the pack
    assert os.path.exists(prefix + ".pack/wcache.npy")
    hix, dix = open_index(prefix, device="cpu")
    assert np.array_equal(hix._kmer_cache8, np.load(prefix + ".pack/wcache.npy"))
    wc10 = tw.get_wcache(dix, hix, 10)
    path = prefix + ".pack/wcache10.npy"
    assert os.path.exists(path) and np.array_equal(np.load(path), wc10.numpy())
    hix2, dix2 = open_index(prefix, device="cpu")
    assert torch.equal(tw.get_wcache(dix2, hix2, 10), wc10)
    # reuse=False builds the table anew and rewrites its file
    stamp = os.stat(path).st_mtime_ns
    assert torch.equal(tw.get_wcache(dix2, hix2, 10, reuse=False), wc10)
    assert os.stat(path).st_mtime_ns >= stamp


def test_stale_deeper_tables_are_not_used(tmp_path, walk_corpus):
    """A deeper table written before the pack was rewritten is not loaded
    (the JAX package re-packs without removing it), and a re-pack by the
    port removes it."""
    c = walk_corpus
    from longreadselfcorrect_tpu.index import store as jstore

    prefix = str(tmp_path / "reads")
    jstore.save_native(prefix, c["fwd"], c["rev"])
    hix, dix = open_index(prefix, device="cpu")
    want = tw.get_wcache(dix, hix, 10)
    path = prefix + ".pack/wcache10.npy"
    meta = os.stat(prefix + ".pack/meta.json").st_mtime_ns
    np.save(path, np.zeros_like(want.numpy()))          # a stale table
    os.utime(path, ns=(meta - 10**9, meta - 10**9))
    hix, dix = open_index(prefix, device="cpu")
    assert torch.equal(tw.get_wcache(dix, hix, 10), want)
    assert np.array_equal(np.load(path), want.numpy())  # rewritten
    # the index is rebuilt: the port's re-pack drops wcache10.npy
    jstore.save_native(prefix, c["fwd"], c["rev"])
    os.utime(prefix + jstore.NATIVE_SUFFIX, ns=(meta + 10**9, meta + 10**9))
    open_index(prefix, device="cpu")
    assert not os.path.exists(path)
    assert os.path.exists(prefix + ".pack/wcache.npy")


def test_walk_ck():
    """The deeper interval table is used above 2^24 symbols per strand
    (the JAX engine's rule)."""
    assert tw.walk_ck(1 << 24) == tw.CACHE_K
    assert tw.walk_ck((1 << 24) + 1) == 12


def test_row_tracker(walk_corpus):
    """RowTracker marks exactly the index rows the rank queries read, and
    nothing outside its block."""
    from longreadselfcorrect_tpu_torch.ops import rank

    td = walk_corpus["td"]
    idx = torch.tensor([-1, 0, 127, 128, 5000], dtype=torch.int32)
    sym = torch.ones_like(idx)
    with rank.RowTracker(td) as rt:
        rank.occ(td.bwt, sym, idx)
    assert rt.rows == len({(i + 1) // td.bwt.block for i in idx.tolist()})
    rank.occ(td.rbwt, sym, idx)
    assert not bool(rt.seen[id(td.rbwt)].any())


@pytest.mark.parametrize("noisy", [False, True])
def test_prep_batch_and_init_state(walk_corpus, noisy):
    """build_batch / _prep_batch (no cache): consts and the fresh state."""
    c = walk_corpus
    tasks = make_tasks(c["reads"], None, 16, noisy=noisy)
    jcfg, tcfg = configs(G=16, MAXLEN=512, QMAX=512)
    jc, js = jw.build_batch(c["jh"], tasks, jcfg, 0.15, 30, dev_ix=c["jd"])
    twx = tw.WalkIndex.build(c["td"], c["th"])
    tc, ts = tw.build_batch(twx, port_tasks(tasks), tcfg, 0.15, 30)
    assert_same(jc, tc, tw.CONST_FIELDS + ("freqs",), "consts")
    # the host engine's constants, from e as the Python double it is there
    assert tc.redeem.dtype == tc.err_bound.dtype == torch.float64
    assert tc.redeem.tolist() == [(9 - 1) * 0.15, 1 - 0.15] and float(tc.err_bound) == 0.25
    assert_same(js, ts, JAX_STATE_FIELDS, "state")
    assert_fresh_errors(ts)


@pytest.mark.parametrize("ck,kmax", [(8, 24), (10, 19)])
def test_prep_bank_with_wcache(walk_corpus, ck, kmax):
    """build_bank / _prep_bank_packed (chains seeded from the ck-mer
    cache): every WalkConsts and RootPack field, and _init_state of the
    bank rows."""
    c = walk_corpus
    tasks = make_tasks(c["reads"], None, 24, noisy=True)
    jcfg, tcfg = configs(G=8, MAXLEN=512, QMAX=512, CK=ck, KMAX=kmax)
    jwx = jw.WalkIndex.build(c["jd"], c["jh"], ck=ck)
    twx = tw.WalkIndex.build(c["td"], c["th"], ck=ck)
    jb = jw.build_bank(c["jh"], tasks, jcfg, 0.15, 30, dev_ix=jwx, T=len(tasks))
    tb = tw.build_bank(twx, port_tasks(tasks), tcfg, 0.15, 30)
    assert_same(jb.consts, tb.consts, tw.CONST_FIELDS, "bank consts")
    assert_same(jb.root, tb.root, tw.ROOT_FIELDS, "bank root")
    used = np.arange(len(tasks)) % 3 != 1
    js = jw._init_state(jb.consts, jb.root, jnp.asarray(used), jcfg)
    ts = tw.init_state(tb.consts, tb.root, torch.from_numpy(used), tcfg)
    assert_same(js, ts, JAX_STATE_FIELDS, "init_state")
    assert_fresh_errors(ts)


def test_prep_bank_short_seeds_skip_wcache(walk_corpus):
    """A bank with a task whose root is shorter than CK preps every chain
    by plain LF, as the JAX bank does."""
    c = walk_corpus
    tasks = make_tasks(c["reads"], None, 6)
    t0 = tasks[0]
    tasks[0] = jw.GapTask(src=t0.src[-7:], path=t0.path, trg=t0.trg, dis=t0.dis,
                          init_k=7, max_overlap=9, min_overlap=13,
                          min_sa_threshold=3)
    jcfg, tcfg = configs(G=8, MAXLEN=512, QMAX=512)
    jwx = jw.WalkIndex.build(c["jd"], c["jh"])
    twx = tw.WalkIndex.build(c["td"], c["th"])
    jb = jw.build_bank(c["jh"], tasks, jcfg, 0.15, 30, dev_ix=jwx, T=len(tasks))
    tb = tw.build_bank(twx, port_tasks(tasks), tcfg, 0.15, 30)
    assert_same(jb.consts, tb.consts, tw.CONST_FIELDS, "bank consts")
    assert_same(jb.root, tb.root, tw.ROOT_FIELDS, "bank root")
