"""The port's kmer_table_full (plain version) equals the JAX kernel.

freq is int32 and valid is bool, so the comparison is exact equality
(np.array_equal) over the whole [max_k+1, R, L] tables.
"""
import numpy as np
import torch

from longreadselfcorrect_tpu.index.fmindex import FMIndex as JFMIndex
from longreadselfcorrect_tpu.index.fmindex import IndexSet as JIndexSet
from longreadselfcorrect_tpu.ops import scan as jscan
from longreadselfcorrect_tpu_torch.core import alphabet as ab
from longreadselfcorrect_tpu_torch.index import build
from longreadselfcorrect_tpu_torch.index.fmindex import FMIndex, IndexSet
from longreadselfcorrect_tpu_torch.index.pack import pack_symbols
from longreadselfcorrect_tpu_torch.ops import scan

import jax.numpy as jnp


def test_kmer_table_full_matches_jax():
    rng = np.random.default_rng(23)
    genome = rng.integers(1, 5, size=3000).astype(np.int8)
    reads = []
    for i in range(120):
        p = int(rng.integers(0, len(genome) - 300))
        r = genome[p : p + 300]
        reads.append(ab.reverse_complement(r) if i % 2 else r.copy())
    fwd, rev = build.build_bwt_pair(reads)
    packs = {name: (*pack_symbols(b.symbols), b.num_symbols, b.num_strings)
             for name, b in (("bwt", fwd), ("rbwt", rev))}
    tix = IndexSet(bwt=FMIndex.from_pack(*packs["bwt"], "cpu"),
                   rbwt=FMIndex.from_pack(*packs["rbwt"], "cpu"))
    jix = JIndexSet(bwt=JFMIndex.from_pack(*packs["bwt"]),
                    rbwt=JFMIndex.from_pack(*packs["rbwt"]))

    # R = 8 reads, lengths ragged around the L = 256 bucket (full, one
    # short, mid, shorter than a k-mer, empty); 2% substitutions
    R, L, max_k = 8, 256, 51
    lens = np.array([256, 255, 250, 180, 129, 30, 7, 0], np.int32)
    mat = np.full((R, L), ab.PAD_RANK, np.int8)
    for i, n in enumerate(lens):
        p = int(rng.integers(0, len(genome) - n))
        r = genome[p : p + n].copy()
        flip = rng.random(n) < 0.02
        r[flip] = rng.integers(1, 5, size=int(flip.sum()))
        mat[i, :n] = r

    freq, valid = scan.kmer_table_full(tix, torch.from_numpy(mat),
                                       torch.from_numpy(lens), max_k)
    jf, jv = jscan.kmer_table_full(jix, jnp.asarray(mat), jnp.asarray(lens), max_k)
    assert freq.dtype == torch.int32 and valid.dtype == torch.bool
    assert tuple(freq.shape) == (max_k + 1, R, L) == tuple(jf.shape)
    assert np.array_equal(freq.numpy(), np.asarray(jf))
    assert np.array_equal(valid.numpy(), np.asarray(jv))
    # the table is not trivially empty: most 19-mers of the full read occur
    assert (freq[19, 0, :200] > 0).float().mean() > 0.5
