"""Per-position multi-k k-mer frequency table (the seed phase's first stage).

For every (read, pos) lane, the both-strand frequency and validity of the
k-mer reads[pos : pos+k] for every k in 1..max_k, from one incremental
bi-interval LF chain per lane (LongReadProbe.cpp:136-158, KmerFeature.h:
37-64).  A k-mer whose window runs past the read end is fake: freq -1,
valid False (KmerFeature.h:62,90).

``kmer_table_full`` launches csrc/kmer_table.cu for CUDA tensors and runs
``kmer_table_full_plain`` for CPU tensors; the plain version is the lockstep
twin of the JAX package's ops/scan.py kmer_table_full.
"""
from __future__ import annotations

import torch

from ..core import alphabet as ab
from ..index.fmindex import IndexSet
from . import cuda, rank

I32 = torch.int32


def kmer_table_full_plain(ix: IndexSet, reads: torch.Tensor, lengths: torch.Tensor,
                          max_k: int):
    """freq int32 [max_k+1, R, L], valid bool [max_k+1, R, L] in plain torch."""
    R, L = reads.shape
    sym0 = reads.to(I32)
    state = rank.init_bi(ix, sym0.clamp(0, 4))
    pos = torch.arange(L, dtype=I32, device=reads.device)[None, :]
    lens = lengths.to(I32)[:, None]
    minus1 = torch.full((R, L), -1, dtype=I32, device=reads.device)
    freqs = [minus1]
    valids = [torch.zeros((R, L), dtype=torch.bool, device=reads.device)]
    for j in range(1, max_k + 1):
        fake = pos + j > lens
        f_lo, f_hi, r_lo, r_hi = state
        bival = (f_lo <= f_hi) & (r_lo <= r_hi)
        freqs.append(torch.where(fake, minus1, rank.bi_freq(state)))
        valids.append(~fake & bival)
        if j == max_k:
            break
        nxt = torch.full((R, L), ab.PAD_RANK, dtype=I32, device=reads.device)
        nxt[:, : L - j] = sym0[:, j:]
        live = nxt < 5
        s = nxt.clamp(0, 4)
        new_state = rank.extend_bi(ix, state, s)
        state = tuple(torch.where(live, n, o) for n, o in zip(new_state, state))
    return torch.stack(freqs), torch.stack(valids)


def kmer_table_full(ix: IndexSet, reads: torch.Tensor, lengths: torch.Tensor,
                    max_k: int):
    """freq int32 [max_k+1, R, L] (-1 where fake), valid bool [max_k+1, R, L].

    reads int8 [R, L] rank symbols padded with PAD_RANK, lengths int32 [R].
    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if not reads.is_cuda:
        return kmer_table_full_plain(ix, reads, lengths, max_k)
    name = "kmer_table_full"
    R, L = reads.shape
    fw, rv = ix.rbwt, ix.bwt
    for fm in (fw, rv):
        if fm.block != 128:
            raise ValueError(f"{name}: the kernel takes 128-symbol blocks, got {fm.block}")
        if fm.blocks.data_ptr() % 16:
            raise ValueError(f"{name}: blocks must be 16-byte aligned")
    args = [
        cuda.check(name, fw.blocks, torch.int8),
        cuda.check(name, fw.ckpt, torch.int32, (fw.blocks.shape[0], 5)),
        cuda.check(name, fw.C, torch.int32, (6,)), fw.blocks.shape[0],
        cuda.check(name, rv.blocks, torch.int8),
        cuda.check(name, rv.ckpt, torch.int32, (rv.blocks.shape[0], 5)),
        cuda.check(name, rv.C, torch.int32, (6,)), rv.blocks.shape[0],
    ]
    if reads.device != fw.blocks.device:
        raise ValueError(f"{name}: reads on {reads.device}, index on {fw.blocks.device}")
    freq = torch.empty((max_k + 1, R, L), dtype=I32, device=reads.device)
    valid = torch.empty((max_k + 1, R, L), dtype=torch.bool, device=reads.device)
    cuda.launch(name, "lrsc_kmer_table_full", *args,
                cuda.check(name, reads, torch.int8),
                cuda.check(name, lengths, I32, (R,)), R, L, max_k,
                freq.data_ptr(), valid.data_ptr())
    return freq, valid
