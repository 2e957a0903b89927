"""The port's kmer_freq_scan and kmer_table_wire (plain versions) equal the
JAX kernels, and the wire route of the seed phase equals JAX's and the
host seed scan.

Every output is int16 / int32 / uint8 / bool, so each comparison is exact
equality (np.array_equal), tolerance 0.
"""
import numpy as np
import pytest
import torch

from longreadselfcorrect_tpu.core.batch_correct import BatchedSelfCorrector as JBatched
from longreadselfcorrect_tpu.core.correct import CorrectionParams as JParams
from longreadselfcorrect_tpu.index.fmindex import FMIndex as JFMIndex
from longreadselfcorrect_tpu.index.fmindex import IndexSet as JIndexSet
from longreadselfcorrect_tpu.index.host import HostFM as JHostFM
from longreadselfcorrect_tpu.index.host import HostIndexSet as JHostIndexSet
from longreadselfcorrect_tpu.ops import scan as jscan
from longreadselfcorrect_tpu_torch.core import alphabet as ab
from longreadselfcorrect_tpu_torch.core import seeds
from longreadselfcorrect_tpu_torch.core.batch_correct import KTAB, BatchedSelfCorrector
from longreadselfcorrect_tpu_torch.core.correct import CorrectionParams
from longreadselfcorrect_tpu_torch.index import build, store
from longreadselfcorrect_tpu_torch.index.fmindex import FMIndex, IndexSet
from longreadselfcorrect_tpu_torch.index.host import HostFM, HostIndexSet
from longreadselfcorrect_tpu_torch.index.pack import open_index, pack_symbols
from longreadselfcorrect_tpu_torch.ops import scan

import jax.numpy as jnp

from test_torch_seedscan import seedscan_corpus


def make_indexes(seed, genome_len, n_reads, read_len):
    """(genome, port IndexSet, JAX IndexSet, port HostIndexSet) of n_reads
    reads of a random genome, both strands, built with numpy from seed."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(1, 5, size=genome_len).astype(np.int8)
    reads = []
    for i in range(n_reads):
        p = int(rng.integers(0, genome_len - read_len))
        r = genome[p : p + read_len]
        reads.append(ab.reverse_complement(r) if i % 2 else r.copy())
    fwd, rev = build.build_bwt_pair(reads)
    packs = {name: (*pack_symbols(b.symbols), b.num_symbols, b.num_strings)
             for name, b in (("bwt", fwd), ("rbwt", rev))}
    tix = IndexSet(bwt=FMIndex.from_pack(*packs["bwt"], "cpu"),
                   rbwt=FMIndex.from_pack(*packs["rbwt"], "cpu"))
    jix = JIndexSet(bwt=JFMIndex.from_pack(*packs["bwt"]),
                    rbwt=JFMIndex.from_pack(*packs["rbwt"]))
    hix = HostIndexSet(HostFM(fwd.symbols, fwd.num_strings),
                       HostFM(rev.symbols, rev.num_strings))
    return genome, tix, jix, hix


def ragged_chunk(rng, genome, lens, L):
    """Reads of the given lengths from genome at 2% substitutions, padded
    to L with PAD_RANK."""
    mat = np.full((len(lens), L), ab.PAD_RANK, np.int8)
    for i, n in enumerate(lens):
        p = int(rng.integers(0, len(genome) - n))
        r = genome[p : p + n].copy()
        flip = rng.random(n) < 0.02
        r[flip] = rng.integers(1, 5, size=int(flip.sum()))
        mat[i, :n] = r
    return mat


# R = 8 reads around the L = 256 bucket: full, one short, mid, shorter than
# a k-mer, empty
LENS = np.array([256, 255, 250, 180, 129, 30, 7, 0], np.int32)


@pytest.fixture(scope="module")
def small():
    genome, tix, jix, hix = make_indexes(23, 3000, 120, 300)
    mat = ragged_chunk(np.random.default_rng(29), genome, LENS, 256)
    mat[2, 40] = 0   # an N (rank 0) inside a read
    return tix, jix, hix, mat


PBCORRECT_POOL = CorrectionParams(pb_coverage=30, genome=10).derived()[0].pool


@pytest.mark.parametrize("pool", [PBCORRECT_POOL, (19,), (1,)],
                         ids=["pbcorrect", "single19", "single1"])
def test_kmer_freq_scan_matches_jax(small, pool):
    tix, jix, _, mat = small
    reads, lens = torch.from_numpy(mat), torch.from_numpy(LENS)
    want = np.asarray(jscan.kmer_freq_scan(jix, jnp.asarray(mat), jnp.asarray(LENS), pool))
    got = scan.kmer_freq_scan(tix, reads, lens, pool)
    assert got.dtype == torch.int32 and tuple(got.shape) == (len(pool), 8, 256)
    assert np.array_equal(got.numpy(), want)
    if len(pool) == 1:
        single = scan.kmer_freq_single(tix, reads, lens, pool[0])
        jsingle = jscan.kmer_freq_single(jix, jnp.asarray(mat), jnp.asarray(LENS), pool[0])
        assert np.array_equal(single.numpy(), np.asarray(jsingle))
    # not trivially empty: most k-mers of the full read occur
    assert (got[-1, 0, :200] > 0).float().mean() > 0.5


def test_kmer_freq_scan_matches_host_table(small):
    """The device counterpart of the host kmer_freq_table, row for row (on
    the reads at least pool[-1] long, the ones the host function takes)."""
    tix, _, hix, mat = small
    pool = PBCORRECT_POOL
    got = scan.kmer_freq_scan(tix, torch.from_numpy(mat), torch.from_numpy(LENS), pool).numpy()
    for i, n in enumerate(LENS):
        if n < pool[-1]:
            continue
        freq, _ = hix.kmer_freq_table(mat[i, :n], pool[-1])
        for ki, k in enumerate(pool):
            assert np.array_equal(got[ki, i, :n], freq[k]), (i, k)
            assert (got[ki, i, n:] == -1).all()


def test_kmer_table_wire_matches_jax():
    """On an index whose k = 1 row passes 32767 (~78k symbols per strand),
    both outputs equal JAX's; unpacking the bits gives kmer_table_full's
    valid and widening the int16 freq its clipped freq."""
    genome, tix, jix, _ = make_indexes(31, 20000, 260, 300)
    mat = ragged_chunk(np.random.default_rng(37), genome, LENS, 256)
    max_k = 51
    reads, lens = torch.from_numpy(mat), torch.from_numpy(LENS)
    f16, vbits = scan.kmer_table_wire(tix, reads, lens, max_k)
    jf16, jvbits = jscan.kmer_table_wire(jix, jnp.asarray(mat), jnp.asarray(LENS), max_k)
    assert f16.dtype == torch.int16 and vbits.dtype == torch.uint8
    assert tuple(vbits.shape) == (7, 8, 256)
    assert np.array_equal(f16.numpy(), np.asarray(jf16))
    assert np.array_equal(vbits.numpy(), np.asarray(jvbits))

    freq, valid = scan.kmer_table_full(tix, reads, lens, max_k)
    assert int(freq[1].max()) > 32767          # the clip bites on this index
    assert (f16[1] == 32767).any()
    assert np.array_equal(f16.numpy().astype(np.int32),
                          np.minimum(freq.numpy(), 32767))
    assert np.array_equal(scan.unpack_valid_bits(vbits.numpy(), max_k + 1), valid.numpy())
    assert valid[19].any()


# ---------------------------------------------------------------------------
# the wire route of the seed phase
# ---------------------------------------------------------------------------

def _sig(s):
    return (s.seed_start_pos, s.seed_len, s.seed_str, s.max_fixed_mer_freq,
            s.is_repeat, s.start_best_kmer_size, s.end_best_kmer_size)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The seed-phase corpus indexed once on disk; both packages read it."""
    _, reads = seedscan_corpus()
    prefix = str(tmp_path_factory.mktemp("wire") / "reads")
    fwd, rev = build.build_bwt_pair([ab.encode(r) for r in reads])
    store.save_native(prefix, fwd, rev)
    hix, dix = open_index(prefix, device="cpu")
    items = [(f"r{i}", reads[i]) for i in range(70)]   # two chunks, one partial
    port = BatchedSelfCorrector(hix, dix, CorrectionParams(pb_coverage=20, genome=10))
    return hix, port, items


def test_device_seed_tables_match_jax(corpus):
    hix, port, items = corpus
    jhix = JHostIndexSet(JHostFM(hix.bwt.symbols, hix.bwt.num_strings),
                         JHostFM(hix.rbwt.symbols, hix.rbwt.num_strings))
    jdix = JIndexSet(bwt=JFMIndex.from_symbols(hix.bwt.symbols, hix.bwt.num_strings),
                     rbwt=JFMIndex.from_symbols(hix.rbwt.symbols, hix.rbwt.num_strings))
    jdev = JBatched(jhix, jdix, JParams(pb_coverage=20, genome=10))
    f, v, lens = port._device_seed_tables(items)
    jf, jv, jlens = jdev._device_seed_tables(items)
    K = min(port.probe_params.kmer_len_up_bound + 1, KTAB) + 1
    assert f.dtype == np.int32 and v.dtype == bool
    assert f.shape == jf.shape and f.shape[:2] == (K, len(items))
    assert np.array_equal(f, jf)
    assert np.array_equal(v, jv)
    assert np.array_equal(lens, jlens)


def test_search_seeds_from_wire_tables(corpus):
    """search_seeds fed the wire tables finds the seeds it finds alone,
    and those of the device seed scan."""
    hix, port, items = corpus
    f, v, lens = port._device_seed_tables(items)
    dev = [ss for _, _, sl in port._device_seed_scan(items) for ss in sl]
    n_seeds = 0
    for i, (rid, seq) in enumerate(items[:16]):
        n = int(lens[i])
        got = [_sig(s) for s in seeds.search_seeds(
            seq, hix, port.probe_params, port.thresh, freq_table=f[:, i, :n],
            valid_table=v[:, i, :n])]
        want = [_sig(s) for s in seeds.search_seeds(seq, hix, port.probe_params,
                                                    port.thresh)]
        assert got == want, rid
        assert got == [_sig(s) for s in dev[i]], rid
        n_seeds += len(got)
    assert n_seeds > 50
