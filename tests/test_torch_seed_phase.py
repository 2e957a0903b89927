"""The port's seed phase equals the JAX device seed scan and the host
search_seeds, field for field.

Seeds are compared as tuples of ints, strings and bools (exact equality).
The 48 corpus reads are ~1 kb, which gives at most a few dozen seeds per
read, so none fills the 128 seed slots; the slot-overflow path is held
against JAX in test_torch_seedscan.py (its 7 kb clean read fills them),
and the corrector's wider slots for such a read against search_seeds below.
"""
import numpy as np
import pytest

from longreadselfcorrect_tpu.core import seeds as jseeds
from longreadselfcorrect_tpu.core.batch_correct import BatchedSelfCorrector as JBatched
from longreadselfcorrect_tpu.core.correct import CorrectionParams as JParams
from longreadselfcorrect_tpu.core.correct import SelfCorrector as JSelfCorrector
from longreadselfcorrect_tpu.index.fmindex import FMIndex as JFMIndex
from longreadselfcorrect_tpu.index.fmindex import IndexSet as JIndexSet
from longreadselfcorrect_tpu.index.host import HostFM as JHostFM
from longreadselfcorrect_tpu.index.host import HostIndexSet as JHostIndexSet
from longreadselfcorrect_tpu_torch.core import alphabet as ab
from longreadselfcorrect_tpu_torch.core import seeds
from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector
from longreadselfcorrect_tpu_torch.core.correct import CorrectionParams
from longreadselfcorrect_tpu_torch.index import build
from longreadselfcorrect_tpu_torch.index.pack import open_index
from longreadselfcorrect_tpu_torch.io import fasta
from longreadselfcorrect_tpu_torch.ops import seedscan

from test_torch_seedscan import seedscan_corpus


def _sig(s):
    return (s.seed_start_pos, s.seed_len, s.seed_str, s.max_fixed_mer_freq,
            s.is_repeat, s.start_best_kmer_size, s.end_best_kmer_size)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The corpus indexed once on disk; both packages read the one pack."""
    _, reads = seedscan_corpus()
    d = tmp_path_factory.mktemp("seedphase")
    prefix = str(d / "reads")
    fwd, rev = build.build_bwt_pair([ab.encode(r) for r in reads])
    from longreadselfcorrect_tpu_torch.index import store

    store.save_native(prefix, fwd, rev)
    hix, dix = open_index(prefix, device="cpu")
    return reads, prefix, hix, dix


def test_seed_phase_matches_jax_device_and_host(corpus):
    reads, prefix, hix, dix = corpus
    items = [(f"r{i}", reads[i]) for i in range(48)]

    port = BatchedSelfCorrector(hix, dix, CorrectionParams(pb_coverage=20, genome=10))
    got = {}
    for _, chunk, seeds_lists in port._device_seed_scan(items):
        for (rid, _), ss in zip(chunk, seeds_lists):
            got[rid] = [_sig(s) for s in ss]

    jhix = JHostIndexSet(JHostFM(hix.bwt.symbols, hix.bwt.num_strings),
                         JHostFM(hix.rbwt.symbols, hix.rbwt.num_strings))
    jdix = JIndexSet(bwt=JFMIndex.from_symbols(hix.bwt.symbols, hix.bwt.num_strings),
                     rbwt=JFMIndex.from_symbols(hix.rbwt.symbols, hix.rbwt.num_strings))
    jparams = JParams(pb_coverage=20, genome=10)
    jdev = JBatched(jhix, jdix, jparams)
    jhost = JSelfCorrector(jhix, jparams)
    want_dev = {}
    for _, chunk, seeds_lists in jdev._device_seed_scan(items):
        for (rid, _), ss in zip(chunk, seeds_lists):
            want_dev[rid] = [_sig(s) for s in ss]

    n_seeds = 0
    for rid, seq in items:
        want_host = [_sig(s) for s in jseeds.search_seeds(
            seq, jhix, jhost.probe_params, jhost.thresh)]
        assert got[rid] == want_dev[rid], rid
        assert got[rid] == want_host, rid
        # the port's own host copy agrees too
        assert got[rid] == [_sig(s) for s in seeds.search_seeds(
            seq, hix, port.probe_params, port.thresh)], rid
        n_seeds += len(want_host)
    assert n_seeds > 100   # the corpus must actually exercise the scan


def test_seed_phase_read_past_the_seed_slots_matches_host(corpus):
    """A clean 7 kb stretch of the corpus genome has more seeds than the
    JAX design's 128 seed slots hold (the automaton overwrites the last
    slot once they are full): the corrector gives its chunk the slots
    seed_slots sizes from the chunk's width, so the seed scan keeps every
    seed and equals search_seeds', beside a 1 kb read."""
    genome, reads = seedscan_corpus()
    reads_, prefix, hix, dix = corpus
    items = [("long", genome[3000:10000]), ("short", reads_[0])]
    port = BatchedSelfCorrector(hix, dix, CorrectionParams(pb_coverage=20, genome=10))
    pp = port.probe_params
    assert seedscan.seed_slots(7168, pp.start_kmer_len, pp.offset) > seedscan.SMAX
    got = [[_sig(s) for s in ss] for _, _, sl in port._device_seed_scan(items) for ss in sl]
    want = [[_sig(s) for s in seeds.search_seeds(seq, hix, port.probe_params, port.thresh)]
            for _, seq in items]
    assert got == want
    assert len(want[0]) > 128
