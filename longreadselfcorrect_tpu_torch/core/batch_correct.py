"""Batched self-correction with the seed phase on the device.

The whole seed phase of many reads runs on the device in 64-read chunks
(ops.scan k-mer table -> ops.seedscan attributes, automaton, best-k,
hitchhike removal): the tables never leave the device, only per-seed
records do.  Each read's correction workflow then runs as in
SelfCorrector (FM-extension walks and the MSA/DP fallback on the host), so
the outputs are SelfCorrector's.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import alphabet as ab
from .correct import CorrectionParams, CorrectionResult, SelfCorrector
from .seeds import Seed
from ..ops import scan, seedscan

CHUNK_READS = 64   # reads per device seed-scan chunk
L_BUCKET = 256     # chunk widths are multiples of this


class BatchedSelfCorrector(SelfCorrector):
    """SelfCorrector whose seed phase runs batched on the device of dev_ix.

    ix: the HostIndexSet the host walks, MSA and best-k redos use;
    dev_ix: the same index as a torch IndexSet (index.fmindex)."""

    def __init__(self, ix, dev_ix, params: CorrectionParams, thresh=None):
        super().__init__(ix, params, thresh)
        self.dix = dev_ix
        self.device = dev_ix.device
        self.phase_times = {"seed": 0.0, "walks": 0.0, "replay": 0.0}
        self._walk_time = 0.0

    # ------------------------------------------------------------------
    def _seed_submit(self, items):
        """Launch the device seed scan of every 64-read chunk without
        waiting for any of it."""
        pp = self.probe_params
        dev = self.device
        max_k = pp.kmer_len_up_bound + 1
        thr = torch.from_numpy(
            np.ascontiguousarray(self.thresh.table[:, : max_k + 1])).to(dev)
        rep_thr = float(self.thresh.get(2, pp.scan_kmer_len))
        R = CHUNK_READS
        if not items:
            return []
        L = max(len(seq) for _, seq in items)
        L = L_BUCKET * ((L + L_BUCKET - 1) // L_BUCKET)
        bases = torch.arange(1, 5, dtype=torch.int8, device=dev)
        submitted = []
        for base in range(0, len(items), R):
            chunk = items[base : base + R]
            mat = np.full((R, L), ab.PAD_RANK, np.int8)
            lens = np.zeros(R, np.int32)
            for i, (_, seq) in enumerate(chunk):
                e = ab.encode(seq)
                mat[i, : len(e)] = e
                lens[i] = len(e)
            dmat = torch.from_numpy(mat).to(dev)
            dlens = torch.from_numpy(lens).to(dev)
            freq, valid = scan.kmer_table_full(self.dix, dmat, dlens, max_k)
            onehot = (dmat[:, :, None] == bases).to(torch.int32)
            prefix = torch.zeros((R, L + 1, 4), dtype=torch.int32, device=dev)
            torch.cumsum(onehot, dim=1, dtype=torch.int32, out=prefix[:, 1:])
            if pp.manual:
                attr = torch.full((R, L), pp.mode, dtype=torch.int32, device=dev)
            else:
                attr = seedscan.attributes(freq[pp.scan_kmer_len], prefix, dlens,
                                           rep_thr, pp.scan_kmer_len)
            n, starts, sizes, freqs, reps, statics = seedscan.scan_automaton(
                freq, valid, attr, prefix, dlens, thr,
                pp.start_kmer_len, pp.kmer_len_up_bound, tuple(pp.offset),
                float(pp.hh_ratio))
            sk, ek, oor = seedscan.estimate_best(
                freq, n, starts, sizes, statics, pp.pb_coverage)
            keep = seedscan.remove_hitchhiking(
                n, starts, sizes, freqs, reps, pp.radius, float(pp.hh_ratio))
            submitted.append((base, chunk,
                              (n, starts, sizes, freqs, reps, statics,
                               sk, ek, oor, keep)))
        return submitted

    def _seed_collect(self, submitted):
        """Pull the seed records to the host and build Seed objects.
        Yields (base, chunk, seeds_per_read)."""
        pp = self.probe_params
        for base, chunk, devs in submitted:
            (n, starts, sizes, freqs, reps, statics, sk, ek, oor,
             keep) = (x.cpu().numpy() for x in devs)
            out = []
            for i, (rid, seq) in enumerate(chunk):
                seeds = []
                for j in range(int(n[i])):
                    st, sz = int(starts[i, j]), int(sizes[i, j])
                    s = Seed.make(seq[st : st + sz], st, int(freqs[i, j]),
                                  bool(reps[i, j]), int(statics[i, j]),
                                  pp.pb_coverage)
                    if oor[i, j]:
                        # best-k walked past the device table: host redo
                        s.estimate_best_kmer_size(self.ix)
                    else:
                        s.start_best_kmer_size = int(sk[i, j])
                        s.end_best_kmer_size = int(ek[i, j])
                    s.is_hitchhiked = not bool(keep[i, j])
                    if not s.is_hitchhiked:
                        seeds.append(s)
                out.append(seeds)
            yield base, chunk, out

    def _device_seed_scan(self, items):
        """The entire seed phase on the device.  Yields
        (base, chunk, seeds_per_read)."""
        yield from self._seed_collect(self._seed_submit(items))

    # ------------------------------------------------------------------
    def _correct_by_fm_extension(self, source: Seed, target: Seed, read_seq: str,
                                 result: CorrectionResult):
        t0 = time.perf_counter()
        try:
            return super()._correct_by_fm_extension(source, target, read_seq, result)
        finally:
            self._walk_time += time.perf_counter() - t0

    def _correct_reads(self, per_read) -> list[CorrectionResult]:
        """The per-read workflow of SelfCorrector.process after its seeds."""
        out = []
        for rid, seq, seeds in per_read:
            result = CorrectionResult(read_id=rid)
            result.total_seed_num = len(seeds)
            self._dump_seeds(rid, seeds)
            pieces = self._init_correct(seq, seeds, result)
            result.merge = bool(pieces)
            result.total_reads_len = len(seq)
            result.corrected_strs = [p.seed_str for p in pieces]
            out.append(result)
        return out

    def _submit_timed(self, items):
        t0 = time.perf_counter()
        handles = self._seed_submit(items)
        self.phase_times["seed"] += time.perf_counter() - t0
        return handles

    def _collect_timed(self, handles):
        t0 = time.perf_counter()
        collected = list(self._seed_collect(handles))
        self.phase_times["seed"] += time.perf_counter() - t0
        return collected

    def _correct_collected(self, collected) -> list[CorrectionResult]:
        per_read = []
        for _, chunk, seeds_lists in collected:
            for (rid, seq), seeds in zip(chunk, seeds_lists):
                per_read.append((rid, seq, seeds))
        t0 = time.perf_counter()
        self._walk_time = 0.0
        out = self._correct_reads(per_read)
        dt = time.perf_counter() - t0
        self.phase_times["walks"] += self._walk_time
        self.phase_times["replay"] += dt - self._walk_time
        return out

    def process_batch(self, items: list[tuple[str, str]]) -> list[CorrectionResult]:
        """Correct a batch of (read_id, sequence) reads.

        phase_times (host wall seconds): seed = launching the device seed
        phase and collecting its records; walks = the host FM-extension
        walks; replay = the rest of the per-read workflow (MSA/DP fallback
        included)."""
        self.phase_times = {"seed": 0.0, "walks": 0.0, "replay": 0.0}
        return self._correct_collected(
            self._collect_timed(self._submit_timed(items)))

    def process_stream(self, batches):
        """Streamed multi-batch correction with bounded memory: yields one
        result list per input batch, in order.  Batch k+1's seed phase is
        launched before batch k's host workflow starts, so the device
        computes it meanwhile.  phase_times accumulate over the stream."""
        self.phase_times = {"seed": 0.0, "walks": 0.0, "replay": 0.0}
        batches = iter(batches)
        items = next(batches, None)
        pending = self._submit_timed(items) if items is not None else None
        while pending is not None:
            collected = self._collect_timed(pending)
            items = next(batches, None)
            pending = self._submit_timed(items) if items is not None else None
            yield self._correct_collected(collected)
