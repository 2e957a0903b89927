"""attributes, scan_automaton, estimate_best, remove_hitchhiking and
lf_extract of csrc/seedscan.cu and csrc/msa.cu, and kmer_table_full of
csrc/kmer_table.cu, compiled for the host, equal their plain versions bit
for bit; on the hand-made attributes and estimate_best inputs the plain
versions are also held to the JAX package's.

No card here: each source is compiled with g++ behind the CUDA shim of
tests/test_torch_cuda_shim.py, blocks one at a time (the static shared
arrays of seedscan.cu stand for the block's), and its C entries are called
through ctypes with CPU pointers, the arguments built by the functions the
wrappers launch with (ops/seedscan.py scan_automaton_args,
ops/msa_kernels.py lf_extract_args).

scan_automaton runs on the JAX-made chunks of tests/test_torch_seedscan.py:
48 reads at ~9% error, and a 7168-column chunk whose clean 7 kb read
overflows the 128 seed slots (slot 127 overwritten) beside a read with
repeat and hitchhiked seeds; the three seed-slot kernels also run that
chunk at the slot count the corrector sizes from its width, where the 7 kb
read keeps every seed.  lf_extract runs grouped: both BWTs, groups
with their own max_steps, rows that park at '$', N = 1, and an empty
group.  banded_fill runs at band widths 1 to 1023 (one to 32 slots a
thread, the lane boundary of the left neighbour), with bands that run off
the top and the bottom of the target, queries longer than their target, a
one-base target, the reverse-complement anchors of retrieve_matches and
lane counts that leave a block's last warps idle.  kmer_table_full runs
from the walk index's interval-table pyramid (ck 8 and 10, and without
one) on reads with N inside the first ck symbols of some lanes, reads
shorter than ck, lanes at and past a read's end and a read as long as
the row, max_k below, at and above ck; also held against the JAX
kmer_table_full.  kmer_freq_scan runs on the same reads from the pyramid
and without one, at pools below, at and above ck.  remove_hitchhiking
also runs on hand-made records: out of order (every pair tested), long
windows, zero freqs, ratios at the bounds, n from -3 to past the slots,
3,808 slots, and gaps that wrap in int32.
"""
import numpy as np
import pytest
import torch

from longreadselfcorrect_tpu_torch.core import alphabet as ab
from longreadselfcorrect_tpu_torch.core.threshold import KmerThreshold
from longreadselfcorrect_tpu_torch.index.fmindex import FMIndex, IndexSet
from longreadselfcorrect_tpu_torch.index import build
from longreadselfcorrect_tpu_torch.ops import msa_kernels, scan, seedscan
from longreadselfcorrect_tpu_torch.ops import walk as tw

from test_torch_cuda_shim import build_host
from test_torch_walk_prep import make_pair
from test_torch_seedscan import stages  # noqa: F401  (the JAX-made chunks)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def seedscan_lib(tmp_path_factory):
    return build_host("seedscan.cu", tmp_path_factory.mktemp("seedscan_shim"),
                      ("lrsc_attributes", "lrsc_scan_automaton", "lrsc_estimate_best",
                       "lrsc_remove_hitchhiking"), one_block=True)


@pytest.fixture(scope="module")
def msa_lib(tmp_path_factory):
    return build_host("msa.cu", tmp_path_factory.mktemp("msa_shim"),
                      ("lrsc_lf_extract", "lrsc_banded_fill"), one_block=True)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("chunk", ["main", "smax"])
def test_scan_automaton_kernel_matches_plain(seedscan_lib, stages, chunk):
    pp, st = stages
    s = st[chunk]
    ins = (_t(s["freq"]), _t(s["valid"]), _t(s["attr"]), _t(s["prefix"]), _t(s["lens"]),
           _t(s["thr"]), pp.start_kmer_len, pp.kmer_len_up_bound, tuple(pp.offset),
           float(pp.hh_ratio))
    R = s["lens"].shape[0]
    outs = seedscan.scan_automaton_outputs(R, "cpu")
    for t in outs:
        t.fill_(7)   # the kernel writes every slot
    rounds = torch.zeros(R, dtype=torch.int32)
    rc = seedscan_lib.lrsc_scan_automaton(
        *seedscan.scan_automaton_args(*ins, outs, rounds, on_card=False), None)
    assert rc == 0
    want = seedscan.scan_automaton_plain(*ins)
    for g, w in zip(outs, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    n = want[0]
    if chunk == "main":
        assert int(n.sum()) > 100
    else:
        assert int(n[0]) == seedscan.SMAX and bool(want[4][1, : int(n[1])].any())
    # a read's rounds: a window started and at least one round of steps
    # per seed, far fewer than its inner iterations
    live = s["lens"] >= pp.start_kmer_len
    assert (rounds.numpy()[live] >= 2 * n.numpy()[live]).all()
    stats = {}
    seedscan.scan_automaton_plain(*ins, stats=stats)
    assert int(rounds.sum()) < stats["lane_steps"] // 4


@pytest.mark.parametrize("chunk,slots", [("main", "jax"), ("smax", "jax"),
                                         ("smax", "sized")])
def test_seed_slot_kernels_match_plain(seedscan_lib, stages, chunk, slots):
    """scan_automaton, estimate_best and remove_hitchhiking at the JAX
    design's 128 slots, or at seed_slots of the chunk's width, which the
    7 kb read of the smax chunk does not fill."""
    pp, st = stages
    s = st[chunk]
    R, L = s["attr"].shape
    smax = (seedscan.SMAX if slots == "jax"
            else seedscan.seed_slots(L, pp.start_kmer_len, pp.offset))
    freq = _t(s["freq"])
    K = freq.shape[0]
    ins = (freq, _t(s["valid"]), _t(s["attr"]), _t(s["prefix"]), _t(s["lens"]),
           _t(s["thr"]), pp.start_kmer_len, pp.kmer_len_up_bound, tuple(pp.offset),
           float(pp.hh_ratio))
    outs = seedscan.scan_automaton_outputs(R, "cpu", smax)
    for t in outs:
        t.fill_(7)
    assert seedscan_lib.lrsc_scan_automaton(
        *seedscan.scan_automaton_args(*ins, outs, on_card=False), None) == 0
    want = seedscan.scan_automaton_plain(*ins, smax=smax)
    for g, w in zip(outs, want):
        assert g.shape == (R, smax) or g.shape == (R,)
        assert torch.equal(g, w)
    n, starts, sizes, freqs, reps, statics = want

    sk, ek = (torch.full((R, smax), 7, dtype=torch.int32) for _ in range(2))
    oor = torch.ones((R, smax), dtype=torch.bool)
    assert seedscan_lib.lrsc_estimate_best(
        freq.data_ptr(), n.data_ptr(), starts.data_ptr(), sizes.data_ptr(),
        statics.data_ptr(), K, R, L, smax, pp.pb_coverage, sk.data_ptr(), ek.data_ptr(),
        oor.data_ptr(), None) == 0
    for g, w in zip((sk, ek, oor),
                    seedscan.estimate_best_plain(freq, n, starts, sizes, statics,
                                                 pp.pb_coverage)):
        assert torch.equal(g, w)

    keep = torch.ones((R, smax), dtype=torch.bool)
    hh, inv_hh = seedscan.hh_constants(float(pp.hh_ratio))
    assert seedscan_lib.lrsc_remove_hitchhiking(
        n.data_ptr(), starts.data_ptr(), sizes.data_ptr(), freqs.data_ptr(),
        reps.data_ptr(), R, smax, pp.radius, hh, inv_hh, keep.data_ptr(), None) == 0
    want_keep = seedscan.remove_hitchhiking_plain(n, starts, sizes, freqs, reps,
                                                  pp.radius, float(pp.hh_ratio))
    assert torch.equal(keep, want_keep)
    if chunk == "smax":
        assert (~keep[1, : int(n[1])]).any()   # hitchhikers were dropped
        if slots == "sized":
            assert seedscan.SMAX < int(n[0]) < smax   # every seed of the 7 kb read


def test_remove_hitchhiking_kernel_past_128_slots(seedscan_lib):
    """remove_hitchhiking on made-up records of up to 479 seeds a read
    (ascending, some within the radius of each other, a third repeats):
    the pairs past slot 128 decide as the plain version does."""
    rng = np.random.default_rng(61)
    R, smax, radius = 3, 480, 100
    n = torch.tensor([300, 0, 479], dtype=torch.int32)
    sizes = torch.from_numpy(rng.integers(15, 40, (R, smax)).astype(np.int32))
    gaps = torch.from_numpy(rng.integers(0, 150, (R, smax)).astype(np.int32))
    starts = torch.cumsum(sizes + gaps, dim=1, dtype=torch.int32) - sizes - gaps
    freqs = torch.from_numpy(rng.integers(1, 400, (R, smax)).astype(np.int32))
    reps = torch.from_numpy(rng.random((R, smax)) < 0.3)
    keep = torch.ones((R, smax), dtype=torch.bool)
    hh, inv_hh = seedscan.hh_constants(0.6)
    assert seedscan_lib.lrsc_remove_hitchhiking(
        n.data_ptr(), starts.data_ptr(), sizes.data_ptr(), freqs.data_ptr(),
        reps.data_ptr(), R, smax, radius, hh, inv_hh, keep.data_ptr(), None) == 0
    want = seedscan.remove_hitchhiking_plain(n, starts, sizes, freqs, reps, radius, 0.6)
    assert torch.equal(keep, want)
    dropped = (~want[0, :300]).nonzero()[:, 0]
    assert int(dropped.max()) > 128 and (~want[2, 128:479]).any()


def _hitch_records(seed, R, S, n, size=(15, 40), gap=(0, 150), freq=(1, 400), p_rep=0.3):
    """remove_hitchhiking's inputs: seeds in order without overlap (sizes
    and the gaps between them drawn from the ranges), freqs, repeat flags,
    all slots filled (those past n too)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(*size, (R, S)).astype(np.int64)
    gaps = rng.integers(*gap, (R, S))
    starts = np.cumsum(sizes + gaps, axis=1) - sizes - gaps
    freqs = rng.integers(*freq, (R, S))
    reps = rng.random((R, S)) < p_rep
    return [np.asarray(n, np.int32), starts.astype(np.int32), sizes.astype(np.int32),
            freqs.astype(np.int32), reps]


def _hitch_unsorted():
    """Each read's records shuffled: starts out of order."""
    n, starts, sizes, freqs, reps = _hitch_records(81, 2, 96, [96, 50])
    perm = np.random.default_rng(82).permutation(96)
    return [n, starts[:, perm], sizes[:, perm], freqs, reps]


def _hitch_overlapping():
    """Starts ascend but seeds overlap: a long seed holds the next ones,
    whose ends fall before its own."""
    n, starts, sizes, freqs, reps = _hitch_records(83, 2, 64, [64, 40])
    sizes[:, ::7] += 600
    return [n, starts, sizes, freqs, reps]


def _hitch_long_window():
    """In order, but every seed reaches past the next 60 starts: each
    slot's window holds dozens of subjects."""
    n, starts, sizes, freqs, reps = _hitch_records(84, 2, 128, [128, 90], size=(1, 2),
                                                   gap=(5, 15))
    sizes[:] = 1000
    return [n, starts, sizes, freqs, reps]


def _hitch_freq_zero():
    """Half the freqs 0 (x / 0 is inf, 0 / 0 NaN), most seeds repeats."""
    n, starts, sizes, freqs, reps = _hitch_records(85, 3, 64, [64, 64, 30], gap=(0, 40),
                                                   freq=(0, 3), p_rep=0.8)
    return [n, starts, sizes, freqs, reps]


def _hitch_ratio_ties():
    """Freqs of 3, 5, 6 and 10: ratios equal to hh (0.6) and to 1 / hh,
    where < and > must not take the bound."""
    n, starts, sizes, freqs, reps = _hitch_records(89, 2, 96, [96, 80], gap=(0, 60),
                                                   p_rep=0.5)
    freqs = np.random.default_rng(90).choice([3, 5, 6, 10], size=freqs.shape).astype(np.int32)
    return [n, starts, sizes, freqs, reps]


def _hitch_empty_and_full():
    """n = 0, n = S, n past S and n < 0."""
    return _hitch_records(86, 4, 64, [0, 64, 100, -3], gap=(0, 60))


def _hitch_wide():
    """More slots than the 3,780 a 48 KB shared array of the reads' records
    held, the first read all filled."""
    return _hitch_records(87, 2, 3808, [3808, 2500], gap=(0, 120))


def _hitch_wrapping():
    """Starts in order across the whole int32 range: a gap from the first
    seeds' ends to the last seeds' starts wraps to a small int32, so the
    pairs within the radius are no run of slots."""
    n, starts, sizes, freqs, reps = _hitch_records(88, 1, 64, [64], p_rep=0.9)
    starts[0] = np.linspace(-(2 ** 31) + 10, 2 ** 31 - 200, 64).astype(np.int64)
    sizes[0] = 20
    return [n, starts, sizes, freqs, reps]


# case -> remove_hitchhiking's inputs (n, starts, sizes, freqs, reps)
HITCH_CASES = {
    "unsorted": _hitch_unsorted,
    "overlapping": _hitch_overlapping,
    "long-window": _hitch_long_window,
    "freq-zero": _hitch_freq_zero,
    "ratio-ties": _hitch_ratio_ties,
    "empty-and-full": _hitch_empty_and_full,
    "wide": _hitch_wide,
    "wrapping": _hitch_wrapping,
}


@pytest.mark.parametrize("case", sorted(HITCH_CASES))
def test_remove_hitchhiking_kernel_cases(seedscan_lib, case):
    """remove_hitchhiking on hand-made records: reads whose starts or ends
    do not ascend, or whose gaps wrap (all pairs tested), long windows,
    zero freqs, ratios at the bounds, n at and past both ends of the slots,
    and more slots than one block's shared memory held."""
    ins = [torch.from_numpy(np.ascontiguousarray(x)) for x in HITCH_CASES[case]()]
    n, starts, sizes, freqs, reps = ins
    R, S = starts.shape
    radius, hh_ratio = 100, 0.6
    keep = torch.ones((R, S), dtype=torch.bool)
    hh, inv_hh = seedscan.hh_constants(hh_ratio)
    assert seedscan_lib.lrsc_remove_hitchhiking(
        n.data_ptr(), starts.data_ptr(), sizes.data_ptr(), freqs.data_ptr(),
        reps.data_ptr(), R, S, radius, hh, inv_hh, keep.data_ptr(), None) == 0
    want = seedscan.remove_hitchhiking_plain(*ins, radius, hh_ratio)
    assert torch.equal(keep, want)
    # each case reaches what it is for
    valid = torch.arange(S)[None, :] < n[:, None]
    assert (valid & ~want).any() or case == "empty-and-full"
    ends = starts + sizes - 1
    if case == "unsorted":
        assert (starts[:, 1:] < starts[:, :-1]).any()
    if case == "overlapping":
        assert (ends[:, 1:] < ends[:, :-1]).any() and (starts.diff(dim=1) >= 0).all()
    if case == "long-window":
        assert int((starts[0, :, None] - ends[0, None, :] <= radius).sum(1).min()) > 60
    if case == "freq-zero":
        assert (valid & (freqs == 0) & ~want).any() and (valid & (freqs == 0) & want).any()
    if case == "ratio-ties":
        fd = (freqs[:, None, :].float() / freqs[:, :, None].float())
        near = (starts[:, None, :] - ends[:, :, None] <= radius) & valid[:, :, None] & (
            torch.arange(S)[None, None, :] > torch.arange(S)[None, :, None])
        assert (near & (fd == hh)).any() and (near & (fd == inv_hh)).any()
    if case == "empty-and-full":
        assert not want[0].any() and not want[3].any() and want[1].any() and want[2].any()
    if case == "wrapping":
        far = (starts[0, None, -5:] - ends[0, :5, None] <= radius)
        assert far.any() and bool((~want[0, :5]).any())


def _attr_rows(seed, seqs, L, freq_of, lens=None):
    """attributes' inputs for hand-made reads: prefix int32 [R, L+1, 4] of
    the reads (PAD past each), freq_scan from freq_of(rng, R, L) and lens
    (default: each read's length)."""
    rng = np.random.default_rng(seed)
    R = len(seqs)
    mat = np.full((R, L), ab.PAD_RANK, np.int8)
    for i, s in enumerate(seqs):
        e = ab.encode(s)
        mat[i, : len(e)] = e
    onehot = (mat[:, :, None] == np.arange(1, 5, dtype=np.int8)).astype(np.int32)
    prefix = np.zeros((R, L + 1, 4), np.int32)
    prefix[:, 1:] = np.cumsum(onehot, axis=1)
    lens = np.array([len(s) for s in seqs] if lens is None else lens, np.int32)
    return _t(freq_of(rng, R, L).astype(np.int32)), _t(prefix), _t(lens)


def _random_freq(p_zero=0.2, p_fake=0.1, hi=40):
    def f(rng, R, L):
        x = rng.integers(1, hi, size=(R, L))
        u = rng.random((R, L))
        return np.where(u < p_fake, -1, np.where(u < p_fake + p_zero, 0, x))
    return f


def _acgt(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def _eff_zero_left(rng, R, L):
    """eff == 0 on [0, 200), low freqs past it, and six repeats at 400..405:
    a window right of 352 sees 6 repeats in 301 positions (ratio 0.0199,
    mode 2), but box_garbage subtracts the 200 zeros left of the window, so
    its size is 501 and the mode 1."""
    f = np.full((R, L), 3)
    f[:, :200] = 0
    f[:, 400:406] = 30
    return f


# name -> (rows(), rep_thr, scan_k)
ATTR_ROWS = {
    # L > 1024: 72 mask words; an empty read
    "wide": (lambda: _attr_rows(1, [_acgt(np.random.default_rng(2), n)
                                    for n in (2304, 1900, 0)], 2304, _random_freq()),
             12.0, 19),
    # positions past len (freq left set there), len 0 and 1, len = L
    "past-len": (lambda: _attr_rows(3, [_acgt(np.random.default_rng(4), n)
                                        for n in (100, 1, 640, 300)], 640,
                                    _random_freq(0.3, 0.0), lens=[100, 1, 640, 0]),
                 8.0, 19),
    # every window low-complexity: eff = -1 everywhere
    "all-low-complexity": (lambda: _attr_rows(5, ["A" * 700, "AC" * 350, "AAAAT" * 140],
                                              704, _random_freq()), 12.0, 19),
    "eff-zero-left": (lambda: _attr_rows(6, [_acgt(np.random.default_rng(7), 1200)] * 2,
                                         1216, _eff_zero_left, lens=[1200, 1216]),
                      12.0, 19),
    # rep_thr <= 0: eff == 0 is a repeat (repeat) but not rep_rem
    "rep-thr-zero": (lambda: _attr_rows(8, [_acgt(np.random.default_rng(9), n)
                                            for n in (900, 400)], 928,
                                        _random_freq(0.5, 0.1, 3)), 0.0, 19),
    "rep-thr-negative": (lambda: _attr_rows(10, [_acgt(np.random.default_rng(11), 500)],
                                            512, _random_freq(0.3, 0.3, 3)), -1.0, 19),
}


def _attr_call(lib, fs, prefix, lens, rep_thr, scan_k):
    R, L = fs.shape
    out = torch.full((R, L), 7, dtype=torch.int32)
    scratch = torch.full((R, 8, -(-L // 32)), -5, dtype=torch.int32)
    assert lib.lrsc_attributes(fs.data_ptr(), prefix.data_ptr(), lens.data_ptr(), R, L,
                               scan_k, float(np.float32(rep_thr)), seedscan._RATIO_C,
                               scratch.data_ptr(), out.data_ptr(), None) == 0
    return out


@pytest.mark.parametrize("case", ["main", "smax", *ATTR_ROWS])
def test_attributes_kernel_matches_plain(seedscan_lib, stages, case):
    """attributes (masks and prefixes in the device scratch row) against
    attributes_plain: the JAX-made chunks, then hand-made rows."""
    if case in ATTR_ROWS:
        rows, rep_thr, scan_k = ATTR_ROWS[case]
        fs, prefix, lens = rows()
    else:
        pp, st = stages
        s = st[case]
        thresh = KmerThreshold(-1, 50, pp.pb_coverage)
        fs, prefix, lens = _t(s["freq"][pp.scan_kmer_len]), _t(s["prefix"]), _t(s["lens"])
        rep_thr, scan_k = float(thresh.get(2, pp.scan_kmer_len)), pp.scan_kmer_len
    want = seedscan.attributes_plain(fs, prefix, lens, rep_thr, scan_k)
    assert torch.equal(_attr_call(seedscan_lib, fs, prefix, lens, rep_thr, scan_k), want)
    if case == "eff-zero-left":
        assert (want[0, 360:420] == 1).all() and (want[1, 360:420] == 1).all()
    if case == "smax":
        assert (want[1] == 2).any()


def test_attributes_kernel_refuses_no_scratch(seedscan_lib):
    fs, prefix, lens = ATTR_ROWS["past-len"][0]()
    R, L = fs.shape
    assert seedscan_lib.lrsc_attributes(fs.data_ptr(), prefix.data_ptr(), lens.data_ptr(),
                                        R, L, 19, 8.0, seedscan._RATIO_C, None,
                                        torch.empty((R, L), dtype=torch.int32).data_ptr(),
                                        None) != 0


@pytest.mark.parametrize("case", sorted(ATTR_ROWS))
def test_attributes_plain_matches_jax_on_rows(case):
    """The hand-made rows through the JAX package's _attributes: the plain
    version the kernel is held to is the reference's on them too."""
    from longreadselfcorrect_tpu.ops import seedscan as jseedscan
    import jax.numpy as jnp

    rows, rep_thr, scan_k = ATTR_ROWS[case]
    fs, prefix, lens = rows()
    want = jseedscan._attributes(jnp.asarray(fs.numpy()), jnp.asarray(prefix.numpy()),
                                 jnp.asarray(lens.numpy()), jnp.float32(rep_thr), scan_k)
    assert np.array_equal(seedscan.attributes_plain(fs, prefix, lens, rep_thr,
                                                    scan_k).numpy(), np.asarray(want))


def _best_inputs(seed, K, R, L, smax, n, stat, extra, start, cut, hi=(16, 60), lo=(0, 15)):
    """estimate_best's inputs: freq[k, r, p] in hi below a per-position cut
    level and in lo from it on (pb_coverage 30: upper 15, lower 7), so a
    pole walks up until the cut or its size; records random in the given
    ranges (statics + extra the sizes), slots past n included."""
    rng = np.random.default_rng(seed)
    cuts = rng.integers(*cut, size=(R, L))
    k = np.arange(K)[:, None, None]
    freq = np.where(k < cuts[None], rng.integers(*hi, size=(K, R, L)),
                    rng.integers(*lo, size=(K, R, L)))
    statics = rng.integers(*stat, size=(R, smax))
    sizes = statics + rng.integers(*extra, size=(R, smax))
    starts = rng.integers(*start, size=(R, smax))
    return tuple(_t(np.asarray(x, np.int32)) for x in (freq, n, starts, sizes, statics))


BEST_CASES = {
    # walks of up to ~70 steps: two and three rounds of 32
    "two-rounds": dict(K=96, R=3, L=200, smax=64, n=[40, 64, 7], stat=(10, 20),
                       extra=(30, 75), start=(0, 200), cut=(40, 100)),
    # walks past the table's top (k >= K) and static sizes below 1 (k < 1)
    "leaves-table": dict(K=30, R=2, L=100, smax=32, n=[32, 20], stat=(-4, 34),
                         extra=(0, 40), start=(-5, 105), cut=(20, 45)),
    # end poles whose position start + size - k falls below 0 (and starts past L)
    "end-clamps": dict(K=40, R=2, L=60, smax=32, n=[32, 32], stat=(12, 30),
                       extra=(-14, 4), start=(-3, 64), cut=(5, 45)),
    # the freq at the static size between the bounds (bit 0) or below (bit -1)
    "bit-zero-down": dict(K=40, R=2, L=80, smax=32, n=[30, 32], stat=(8, 30),
                          extra=(0, 20), start=(0, 80), cut=(0, 45), hi=(0, 25),
                          lo=(0, 12)),
    # empty slots (garbage statics), a read with no seed, n past the slots
    "empty-slots": dict(K=40, R=4, L=80, smax=48, n=[0, 5, 48, 100], stat=(-50, 50),
                        extra=(0, 30), start=(0, 80), cut=(10, 45)),
    # 1200 seeds, split among the kernel's blocks of slots
    "many-seeds": dict(K=50, R=1, L=4000, smax=1280, n=[1200], stat=(15, 22),
                       extra=(0, 40), start=(0, 4000), cut=(10, 55)),
}


@pytest.mark.parametrize("case", sorted(BEST_CASES))
def test_estimate_best_kernel_matches_plain(seedscan_lib, case):
    spec = dict(BEST_CASES[case])
    K, R, L, smax = (spec.pop(x) for x in ("K", "R", "L", "smax"))
    freq, n, starts, sizes, statics = _best_inputs(sorted(BEST_CASES).index(case), K, R, L,
                                                   smax, **spec)
    sk, ek = (torch.full((R, smax), 7, dtype=torch.int32) for _ in range(2))
    oor = torch.ones((R, smax), dtype=torch.bool)
    assert seedscan_lib.lrsc_estimate_best(
        freq.data_ptr(), n.data_ptr(), starts.data_ptr(), sizes.data_ptr(),
        statics.data_ptr(), K, R, L, smax, 30, sk.data_ptr(), ek.data_ptr(),
        oor.data_ptr(), None) == 0
    st = {}
    want = seedscan.estimate_best_plain(freq, n, starts, sizes, statics, 30, stats=st)
    for g, w in zip((sk, ek, oor), want):
        assert torch.equal(g, w)
    # each case reaches what it is for
    steps, valid = st["pole_steps"], torch.arange(smax)[None, :] < n[:, None]
    if case == "two-rounds":
        assert int(steps.max()) > 64
    if case == "leaves-table":
        assert (want[2] & (statics < 1)).any() and (want[2] & (statics >= 1)).any()
    if case == "end-clamps":
        assert (valid & (starts + sizes - statics < 0)).any()
    if case == "bit-zero-down":
        kf = freq[statics.clamp(1, K - 1).long(), torch.arange(R)[:, None],
                  starts.clamp(0, L - 1).long()]
        assert (valid & (kf >= 7) & (kf <= 15)).any() and (valid & (kf < 7)).any()
    if case == "empty-slots":
        assert torch.equal(want[0][~valid], statics[~valid]) and not want[2][~valid].any()
    if case == "many-seeds":
        assert int((steps[:, 0, 1100:1200] > 0).sum()) > 50


@pytest.mark.parametrize("case", sorted(BEST_CASES))
def test_estimate_best_plain_matches_jax_on_cases(case):
    """BEST_CASES through the JAX package's _estimate_best: the plain
    version the kernel is held to is the reference's on them too."""
    from longreadselfcorrect_tpu.ops import seedscan as jseedscan
    import jax.numpy as jnp

    spec = dict(BEST_CASES[case])
    K, R, L, smax = (spec.pop(x) for x in ("K", "R", "L", "smax"))
    ins = _best_inputs(sorted(BEST_CASES).index(case), K, R, L, smax, **spec)
    want = jseedscan._estimate_best(*(jnp.asarray(x.numpy()) for x in ins), 30)
    for g, w in zip(seedscan.estimate_best_plain(*ins, 30), want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(202)
    genome = "".join(rng.choice(list("ACGT"), size=5000))
    reads = []
    for i in range(120):
        p = int(rng.integers(0, 5000 - 400))
        r = genome[p : p + 400]
        reads.append(ab.revcomp_str(r) if i % 2 else r)
    fwd, rev = build.build_bwt_pair([ab.encode(r) for r in reads])
    return IndexSet(bwt=FMIndex.from_symbols(fwd.symbols, fwd.num_strings, "cpu"),
                    rbwt=FMIndex.from_symbols(rev.symbols, rev.num_strings, "cpu"))


# (strand, roots, max_steps) per group
GROUPS = {
    "both-bwts": [("rbwt", np.arange(5, 40), 60), ("bwt", np.arange(3, 40), 450),
                  ("bwt", np.arange(0, 37 * 97, 97), 1), ("rbwt", np.arange(900, 917), 300)],
    "one-row": [("bwt", np.array([1234]), 77)],
    "empty-group": [("rbwt", np.arange(40, 60), 120), ("bwt", np.arange(0), 50),
                    ("bwt", np.arange(60, 62), 90)],
}


@pytest.mark.parametrize("case", sorted(GROUPS))
def test_lf_extract_kernel_matches_plain(msa_lib, index, case):
    groups = GROUPS[case]
    roots = torch.from_numpy(np.concatenate([r for _, r, _ in groups]).astype(np.int32))
    group = torch.from_numpy(np.repeat(np.arange(len(groups), dtype=np.int8),
                                       [len(r) for _, r, _ in groups]))
    table = [(msa_kernels.STRANDS.index(strand), steps) for strand, _, steps in groups]
    N, S = roots.shape[0], max(steps for _, steps in table)
    mat = torch.full((N, S), 9, dtype=torch.int8)
    lens = torch.full((N,), -1, dtype=torch.int32)
    rc = msa_lib.lrsc_lf_extract(*msa_kernels.lf_extract_args(
        index.bwt, index.rbwt, roots, group, table, mat, lens, on_card=False), None)
    assert rc == 0
    want_m, want_l = msa_kernels.lf_extract_groups_plain(index, roots, group, table)
    assert torch.equal(mat, want_m) and torch.equal(lens, want_l)
    # group by group, the one-group plain version
    base = 0
    for (strand, r, steps), (_, st) in zip(groups, table):
        m, l = msa_kernels.lf_extract_plain(getattr(index, strand),
                                            torch.from_numpy(r.astype(np.int32)), steps)
        assert torch.equal(mat[base : base + len(r), :steps], m)
        assert torch.equal(lens[base : base + len(r)], l)
        base += len(r)
    if case == "both-bwts":
        assert (want_l[35:72] < 450).all()   # the 450-step rows park at "$"


def test_scan_automaton_kernel_reads_past_a_mask_segment(seedscan_lib):
    """Reads longer than the kernel's 8192-position mask segment: a 12 kb
    read at ~9% error and a clean 9 kb one, their tables made by the
    port's plain kmer_table_full / attributes from a 20 kb genome's
    index; the automaton crosses one and two segment boundaries."""
    from longreadselfcorrect_tpu_torch.core.correct import CorrectionParams
    from longreadselfcorrect_tpu_torch.core.threshold import KmerThreshold
    from longreadselfcorrect_tpu_torch.ops import scan

    rng = np.random.default_rng(41)
    genome = "".join(rng.choice(list("ACGT"), size=20000))
    reads = []
    for i in range(600):
        p = int(rng.integers(0, len(genome) - 1000))
        r = genome[p : p + 1000]
        reads.append(ab.revcomp_str(r) if i % 2 else r)
    fwd, rev = build.build_bwt_pair([ab.encode(r) for r in reads])
    ix = IndexSet(bwt=FMIndex.from_symbols(fwd.symbols, fwd.num_strings, "cpu"),
                  rbwt=FMIndex.from_symbols(rev.symbols, rev.num_strings, "cpu"))
    noisy = []
    for ch in genome[2000:13000]:
        x = rng.random()
        if x < 0.05:
            noisy.append("ACGT"[int(rng.integers(0, 4))])
        elif x < 0.07:
            pass
        elif x < 0.09:
            noisy += [ch, "ACGT"[int(rng.integers(0, 4))]]
        else:
            noisy.append(ch)
    seqs = ["".join(noisy), genome[10000:19000]]
    L = 256 * ((max(map(len, seqs)) + 255) // 256)
    assert L > 8192
    mat = np.full((2, L), ab.PAD_RANK, np.int8)
    lens = np.zeros(2, np.int32)
    for i, s in enumerate(seqs):
        e = ab.encode(s)
        mat[i, : len(e)] = e
        lens[i] = len(e)
    params = CorrectionParams(pb_coverage=30, genome=10)
    pp, _, _ = params.derived()
    thresh = KmerThreshold(-1, 50, params.pb_coverage)
    max_k = pp.kmer_len_up_bound + 1
    reads_t, lens_t = torch.from_numpy(mat), torch.from_numpy(lens)
    freq, valid = scan.kmer_table_full(ix, reads_t, lens_t, max_k)
    prefix = torch.zeros((2, L + 1, 4), dtype=torch.int32)
    torch.cumsum((reads_t[:, :, None] == torch.arange(1, 5, dtype=torch.int8)).to(torch.int32),
                 dim=1, dtype=torch.int32, out=prefix[:, 1:])
    attr = seedscan.attributes(freq[pp.scan_kmer_len], prefix, lens_t,
                               float(thresh.get(2, pp.scan_kmer_len)), pp.scan_kmer_len)
    thr = torch.from_numpy(np.ascontiguousarray(thresh.table[:, : max_k + 1]))
    ins = (freq, valid, attr, prefix, lens_t, thr, pp.start_kmer_len, pp.kmer_len_up_bound,
           tuple(pp.offset), float(pp.hh_ratio))
    outs = seedscan.scan_automaton_outputs(2, "cpu")
    assert seedscan_lib.lrsc_scan_automaton(
        *seedscan.scan_automaton_args(*ins, outs, on_card=False), None) == 0
    want = seedscan.scan_automaton_plain(*ins)
    for g, w in zip(outs, want):
        assert torch.equal(g, w)
    n, starts = want[0], want[1]
    assert int(n[0]) > 20 and int(starts[0, : int(n[0])].max()) > 8192


def fill_lanes(seed, N, Q, T, bw, origin=None, t_len=None, q_len=None):
    """banded_fill's inputs for N lanes: each target a copy of part of a
    random query with ~12% substitutions, insertions and deletions (so
    every score path of the band is taken), padded as encode_pairs pads
    (query 0, target -1).  origin, t_len and q_len default to random
    values around the band's diagonal."""
    rng = np.random.default_rng(seed)
    q = np.zeros((N, Q), np.int8)
    t = np.full((N, T), -1, np.int8)
    bases = np.frombuffer(b"ACGT", np.int8)
    q_len = np.full(N, Q) if q_len is None else np.asarray(q_len)
    t_len = (rng.integers(1, T + 1, size=N) if t_len is None else np.asarray(t_len))
    for n in range(N):
        qs = rng.choice(bases, size=int(q_len[n]))
        q[n, : len(qs)] = qs
        ts = []
        for ch in np.concatenate([qs, rng.choice(bases, size=T)]):
            x = rng.random()
            if x < 0.05:
                ts.append(rng.choice(bases))
            elif x < 0.08:
                continue
            elif x < 0.12:
                ts += [ch, rng.choice(bases)]
            else:
                ts.append(ch)
        t[n, : int(t_len[n])] = np.array(ts[: int(t_len[n])], np.int8)
    if origin is None:
        origin = rng.integers(-bw, max(T - Q // 2, 1), size=N)
    return (torch.from_numpy(q), torch.from_numpy(t),
            torch.from_numpy(np.asarray(t_len, np.int32)),
            torch.from_numpy(np.asarray(origin, np.int32)), bw)


def rc_lanes():
    """retrieve_matches' reverse-complement pileup (core/msa.py:324-326):
    the anchors at the query's and each candidate's last k-mer, band 200."""
    rng = np.random.default_rng(9)
    query = "".join(rng.choice(list("ACGT"), size=150))
    keep = []
    for n in range(7):
        ext = "".join(rng.choice(list("ACGT"), size=int(rng.integers(0, 60))))
        body = list(query[int(rng.integers(0, 40)):])
        for _ in range(12):
            body[int(rng.integers(0, len(body)))] = "ACGT"[int(rng.integers(0, 4))]
        keep.append(ext + "".join(body))
    k = 17
    s1 = [len(query) - k] * len(keep)
    s2 = [len(m) - k for m in keep]
    q, t, tl, org, bw = msa_kernels.encode_pairs([query] * len(keep), keep, s1, s2, 200)
    return (torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(tl),
            torch.from_numpy(org), bw)


# case -> banded_fill's inputs (q, t, t_len, origin, bw); N is no multiple
# of the kernel's 4 warps a block in every case but "bw32"
FILL_CASES = {
    "bw1": lambda: fill_lanes(1, 5, 30, 40, 1),
    "bw31": lambda: fill_lanes(2, 6, 40, 50, 31),
    "bw32": lambda: fill_lanes(3, 8, 40, 50, 32),
    "bw33": lambda: fill_lanes(4, 7, 40, 60, 33),
    "bw201": lambda: fill_lanes(5, 6, 60, 90, 201),
    "bw1023": lambda: fill_lanes(6, 2, 24, 40, 1023),
    # the band starts rows above the target's first base
    "off-top": lambda: fill_lanes(7, 5, 40, 50, 33, origin=[-40, -33, -20, -5, -1]),
    # targets shorter than the band: it runs off the bottom
    "off-bottom": lambda: fill_lanes(8, 5, 40, 70, 65, origin=[-32, -10, 0, 3, -60],
                                     t_len=[20, 33, 60, 5, 64]),
    # queries longer than their targets; the shorter queries padded
    "long-query": lambda: fill_lanes(10, 3, 80, 30, 33, origin=[-16, -2, 5],
                                     t_len=[30, 25, 12], q_len=[80, 61, 45]),
    "one-base-target": lambda: fill_lanes(11, 3, 20, 1, 33, origin=[-16, -1, 0],
                                          t_len=[1, 1, 1]),
    "rc-anchors": rc_lanes,
}


@pytest.mark.parametrize("case", sorted(FILL_CASES))
def test_banded_fill_kernel_matches_plain(msa_lib, case):
    q, t, t_len, origin, bw = FILL_CASES[case]()
    N, Q = q.shape
    T = t.shape[1]
    scores = (1, -1, -8)
    cells = torch.full((N, Q + 1, bw), 7, dtype=torch.int32)   # every cell is written
    rc = msa_lib.lrsc_banded_fill(q.data_ptr(), t.data_ptr(), t_len.data_ptr(),
                                  origin.data_ptr(), N, Q, T, bw, *scores,
                                  cells.data_ptr(), None)
    assert rc == 0
    want = msa_kernels.banded_fill_plain(q, t, t_len, origin, bw, scores)
    assert torch.equal(cells, want), (cells != want).nonzero()[:5].tolist()
    assert (want != 0).any()


def test_banded_fill_kernel_refuses_wide_bands(msa_lib):
    q, t, t_len, origin, _ = fill_lanes(1, 1, 4, 4, 1)
    cells = torch.zeros((1, 5, 1025), dtype=torch.int32)
    for bw in (0, 1025):
        assert msa_lib.lrsc_banded_fill(q.data_ptr(), t.data_ptr(), t_len.data_ptr(),
                                        origin.data_ptr(), 1, 4, 4, bw, 1, -1, -8,
                                        cells.data_ptr(), None) != 0
    with pytest.raises(ValueError):
        msa_kernels._banded_fill_kernel(q, t, t_len, origin, 1025, (1, -1, -8))


@pytest.fixture(scope="module")
def kmer_lib(tmp_path_factory):
    return build_host("kmer_table.cu", tmp_path_factory.mktemp("kmer_shim"),
                      ("lrsc_kmer_table_full", "lrsc_kmer_freq_scan"))


def n_reads(genome, L):
    """int8 [8, L] reads of the genome (2% substitutions) and their
    lengths: one as long as the row, two shorter than 8 and 11 symbols,
    one of 1, and N (rank 0) at positions that put one inside the first
    8-12 symbols of many lanes, next to each other and at a read's start."""
    rng = np.random.default_rng(71)
    lens = np.array([L, 7, 11, L - 9, L - 30, 1, L - 3, 40], np.int32)
    mat = np.full((8, L), ab.PAD_RANK, np.int8)
    for i, n in enumerate(lens):
        p = int(rng.integers(0, len(genome) - n))
        r = ab.encode(genome[p : p + n])
        flip = rng.random(n) < 0.02
        r[flip] = rng.integers(1, 5, size=int(flip.sum()))
        mat[i, :n] = r
    for i, pos in ((0, (5, 30, 31, 70)), (3, (0, 12, 13, 50)), (4, (9, L - 31)),
                   (6, (20,)), (7, (3, 39))):
        mat[i, list(pos)] = 0
    return torch.from_numpy(mat), torch.from_numpy(lens)


@pytest.fixture(scope="module")
def pyramid_pair():
    """tests/test_walk.py's corpus (JAX and port indexes), its walk index
    at ck 8 and 10, and N-bearing reads of its genome."""
    c = make_pair(33, 6000, 180)
    c["wx"] = {ck: tw.WalkIndex.build(c["td"], c["th"], ck=ck) for ck in (8, 10)}
    c["reads"], c["lens"] = n_reads(c["genome"], 96)
    return c


@pytest.mark.parametrize("ck,max_k", [(0, 20), (8, 5), (8, 8), (8, 20), (10, 9), (10, 24)])
def test_kmer_table_full_kernel_matches_plain(kmer_lib, pyramid_pair, ck, max_k):
    c = pyramid_pair
    reads, lens = c["reads"], c["lens"]
    R, L = reads.shape
    freq = torch.full((max_k + 1, R, L), 7, dtype=torch.int32)
    valid = torch.ones((max_k + 1, R, L), dtype=torch.bool)
    levels = c["wx"][ck] if ck else None
    assert kmer_lib.lrsc_kmer_table_full(*scan.kmer_table_full_args(
        c["td"], reads, lens, max_k, levels, freq, valid, on_card=False), None) == 0
    want_f, want_v = scan.kmer_table_full_plain(c["td"], reads, lens, max_k)
    assert torch.equal(freq, want_f) and torch.equal(valid, want_v)
    if max_k == 20:
        from longreadselfcorrect_tpu.ops import scan as jscan
        import jax.numpy as jnp

        jf, jv = jscan.kmer_table_full(c["jd"], jnp.asarray(reads.numpy()),
                                       jnp.asarray(lens.numpy()), max_k)
        assert np.array_equal(freq.numpy(), np.asarray(jf))
        assert np.array_equal(valid.numpy(), np.asarray(jv))
    # the corpus reaches what it is for: k-mers that occur, k-mers through an
    # N that occur (at '$'), lanes at and past their read's end
    assert (want_f[min(max_k, 12), 0] > 0).float().mean() > 0.5
    assert (want_f[max_k, 5] == -1).all() and (want_f[1, 5, 0] > 0)
    assert (want_f[max_k, 0, L - max_k + 1 :] == -1).all()
    for r, n in enumerate(lens.tolist()):   # a lane at or past len: fake at every level
        assert (want_f[1:, r, n:] == -1).all() and not want_v[:, r, n:].any()


@pytest.mark.parametrize("ck,pool", [
    (0, (5, 9, 19)), (0, (19,)), (8, (5, 9, 19)), (8, (5, 9, 15, 19)), (8, (19,)),
    (8, (3,)), (8, (1, 2, 8)), (10, (5, 9, 19)), (10, (10,)), (10, (4, 10, 11, 24)),
    (10, tuple(range(1, 17)))])
def test_kmer_freq_scan_kernel_matches_plain(kmer_lib, pyramid_pair, ck, pool):
    """kmer_freq_scan from the pyramid (ck 8, 10) and without (ck 0), pools
    below, at and above ck, on n_reads' reads (N inside the first ck
    symbols, reads shorter than ck, lanes at and past a read's end)."""
    c = pyramid_pair
    reads, lens = c["reads"], c["lens"]
    R, L = reads.shape
    freq = torch.full((len(pool), R, L), 7, dtype=torch.int32)
    levels = c["wx"][ck] if ck else None
    assert kmer_lib.lrsc_kmer_freq_scan(*scan.kmer_freq_scan_args(
        c["td"], reads, lens, pool, levels, freq, on_card=False), None) == 0
    want = scan.kmer_freq_scan_plain(c["td"], reads, lens, pool)
    assert torch.equal(freq, want)
    if pool == (5, 9, 19):
        from longreadselfcorrect_tpu.ops import scan as jscan
        import jax.numpy as jnp

        jf = jscan.kmer_freq_scan(c["jd"], jnp.asarray(reads.numpy()),
                                  jnp.asarray(lens.numpy()), pool)
        assert np.array_equal(freq.numpy(), np.asarray(jf))
    # k-mers that occur at every entry of the pool; every lane past its
    # read's top entry fake
    assert all((want[i, 0] > 0).any() for i in range(len(pool)))
    for r, n in enumerate(lens.tolist()):
        assert (want[-1, r, max(n - pool[-1] + 1, 0):] == -1).all()
