"""The port's bit-plane rows and kmer_table_planes (plain versions) equal
the JAX kernels, and the plane route of the seed phase finds the seeds of
the device seed scan.

Every output is int32 / bool, so each comparison is exact equality
(np.array_equal), tolerance 0.  Both sides of the table comparison read
one numpy wcache, so a slip in its column order or code convention shows
as a table difference here, not as a seed difference later.
"""
import numpy as np
import pytest
import torch

from longreadselfcorrect_tpu.ops import scan as jscan
from longreadselfcorrect_tpu_torch.core import alphabet as ab
from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector
from longreadselfcorrect_tpu_torch.core.correct import CorrectionParams
from longreadselfcorrect_tpu_torch.index import build, store
from longreadselfcorrect_tpu_torch.index.pack import open_index
from longreadselfcorrect_tpu_torch.ops import scan, walk

import jax.numpy as jnp

from test_torch_scan_tables import LENS, make_indexes, ragged_chunk
from test_torch_seedscan import seedscan_corpus


@pytest.fixture(scope="module")
def small():
    return make_indexes(41, 3000, 120, 300)


@pytest.mark.parametrize("strand", ["bwt", "rbwt"])
def test_build_plane_rows_matches_jax(small, strand):
    _, tix, jix, _ = small
    fm, jfm = getattr(tix, strand), getattr(jix, strand)
    assert (fm.blocks[-1] == ab.PAD_RANK).any()     # a padded last block
    got = scan.build_plane_rows(fm.blocks, fm.ckpt)
    want = np.asarray(jscan._build_plane_rows(jfm.blocks, jfm.ckpt))
    assert got.dtype == torch.int32 and tuple(got.shape) == (fm.blocks.shape[0], 17)
    assert np.array_equal(got.numpy(), want)
    assert (got[:, :12] < 0).any()                   # bit 31 set in some word
    pix = scan.build_planes(tix)
    assert torch.equal((pix.fwd if strand == "rbwt" else pix.rev).prows, got)


def test_kmer_table_planes_matches_jax(small):
    """ck = 8 on the walk's 8-mer table, ragged lengths (full, short,
    shorter than ck, empty) and a read with an N in its first ck chars.
    Against JAX at max_k = 14 (the smallest k the seed scan reads; XLA's
    compile of the unrolled levels grows fast with depth); at max_k = 51,
    on N-free reads, rows ck.. equal kmer_table_full's and rows below ck
    are -1 / False."""
    genome, tix, jix, hix = small
    ck, jax_k, max_k = 8, 14, 51
    mat = ragged_chunk(np.random.default_rng(43), genome, LENS, 256)
    mat[1, 3] = 0   # an N (rank 0) in the first ck chars of lanes 0..3
    wcache = walk.build_kmer_caches(hix)
    assert wcache.shape == (4 ** ck, 4)
    reads, lens = torch.from_numpy(mat), torch.from_numpy(LENS)
    pix = scan.build_planes(tix)
    freq, valid = scan.kmer_table_planes(pix, torch.from_numpy(wcache), reads, lens,
                                         jax_k, ck)
    jf, jv = jscan.kmer_table_planes(jscan.build_planes(jix), jnp.asarray(wcache),
                                     jnp.asarray(mat), jnp.asarray(LENS), jax_k, ck)
    assert freq.dtype == torch.int32 and valid.dtype == torch.bool
    assert tuple(freq.shape) == (jax_k + 1, 8, 256) == tuple(jf.shape)
    assert np.array_equal(freq.numpy(), np.asarray(jf))
    assert np.array_equal(valid.numpy(), np.asarray(jv))
    assert not torch.equal(freq[ck:, 1, :4], scan.kmer_table_full(
        tix, reads, lens, jax_k)[0][ck:, 1, :4])   # the N lanes differ from full

    freq, valid = scan.kmer_table_planes(pix, torch.from_numpy(wcache), reads, lens,
                                         max_k, ck)
    assert (freq[:ck] == -1).all() and not valid[:ck].any()
    full_f, full_v = scan.kmer_table_full(tix, reads, lens, max_k)
    clean = [i for i in range(len(LENS)) if i != 1]
    assert torch.equal(freq[ck:, clean], full_f[ck:, clean])
    assert torch.equal(valid[ck:, clean], full_v[ck:, clean])
    assert (freq[19, 0, :200] > 0).float().mean() > 0.5


def _sig(s):
    return (s.seed_start_pos, s.seed_len, s.seed_str, s.max_fixed_mer_freq,
            s.is_repeat, s.start_best_kmer_size, s.end_best_kmer_size)


def test_plane_route_seeds_match_device_seed_scan(tmp_path):
    """The seed phase with kmer_table_planes in place of kmer_table_full
    (chain seeded from the walk's table) finds the same seeds."""
    _, reads = seedscan_corpus()
    prefix = str(tmp_path / "reads")
    fwd, rev = build.build_bwt_pair([ab.encode(r) for r in reads])
    store.save_native(prefix, fwd, rev)
    hix, dix = open_index(prefix, device="cpu")
    items = [(f"r{i}", reads[i]) for i in range(70)]
    port = BatchedSelfCorrector(hix, dix, CorrectionParams(pb_coverage=20, genome=10))
    pp = port.probe_params
    assert port.wx.ck <= pp.start_kmer_len + min(pp.offset) - 1

    pix = scan.plane_index_of(hix, port.wx)
    assert scan.plane_index_of(hix, dix) is pix      # built once per device
    max_k = pp.kmer_len_up_bound + 1
    submitted = []
    for base, chunk, mat, lens in port._seed_chunks(items):
        dmat, dlens = torch.from_numpy(mat), torch.from_numpy(lens)
        freq, valid = scan.kmer_table_planes(pix, port.wx.wcache, dmat, dlens, max_k,
                                             port.wx.ck)
        submitted.append((base, chunk, port._seed_records(freq, valid, dmat, dlens)))
    got = [[_sig(s) for s in ss] for _, _, sl in port._seed_collect(submitted) for ss in sl]
    want = [[_sig(s) for s in ss] for _, _, sl in port._device_seed_scan(items) for ss in sl]
    assert got == want
    assert sum(map(len, got)) > 150
