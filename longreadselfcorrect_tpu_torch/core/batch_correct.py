"""Device-accelerated self-correction.

The whole seed phase of many reads runs on the device in 64-read chunks
(ops.scan k-mer table -> ops.seedscan attributes, automaton, best-k,
hitchhike removal): the tables never leave the device, only per-seed
records do.  The FM-extension walks of every consecutive seed pair of
every read then run as one batched device frontier (ops.walk), and the
per-read correction workflow is replayed against those prefetched
results (the JAX package's core/batch_correct.py).  The replay checks each
gap's inputs against the optimistic prefetch: a gap it did not prefetch
goes to the next device round, and after the last round, like a flagged
or oversized gap, to the host engine; so the outputs are SelfCorrector's.
The MSA/DP fallback extracts its candidates and fills their DP bands on
the device; the backtrack, the pileup and the consensus stay on the host.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import replace

import numpy as np
import torch

from . import alphabet as ab
from . import seeds as seedmod
from .correct import CorrectionParams, CorrectionResult, SelfCorrector
from .extend import HostExtendEngine
from .seeds import Seed
from ..ops import scan, seedscan, walk

CHUNK_READS = 64   # reads per device seed-scan chunk
L_BUCKET = 256     # chunk widths are multiples of this
# depth of the wire tables (_seed_table_chunks); larger k is not tabled
KTAB = 64
QUEUE_BANK = 8192  # tasks per queue-engine bank
MISS_ROUNDS = 6    # replay rounds; misses of the last go to the host engine
MISS_FLUSH = 256   # misses that start a device round during a replay
MISS_CHUNK = 512   # tasks per submitted miss round
# phase_times' keys: the three phases, and three spans inside the replay
# that never run inside one another
PHASES = ("seed", "walks", "replay", "replay.host_engine", "replay.dp", "replay.rounds")


class BatchedSelfCorrector(SelfCorrector):
    """SelfCorrector with the seed phase and the FM-extension walks batched
    on the device of dev_ix.

    ix: the HostIndexSet the host fallback walks, MSA and best-k redos use;
    dev_ix: the same index as a torch IndexSet (index.fmindex), or a
    walk.WalkIndex over it."""

    def __init__(self, ix, dev_ix, params: CorrectionParams, thresh=None,
                 cfg: walk.WalkConfig | None = None):
        super().__init__(ix, params, thresh)
        self.wx = (dev_ix if isinstance(dev_ix, walk.WalkIndex)
                   else walk.WalkIndex.build(dev_ix, ix, ck=walk.walk_ck(ix.bwt.n)))
        self.dix = self.wx.ix
        self.device = self.dix.device
        # the seed scan's dynamic-kmer thresholds, k = 0..kmer_len_up_bound+1
        self._seed_thr = torch.from_numpy(np.ascontiguousarray(
            self.thresh.table[:, : self.probe_params.kmer_len_up_bound + 2])).to(self.device)
        ck = self.wx.ck
        cfg = cfg or walk.WalkConfig(G=512, MAXLEN=768, QMAX=768, WSCAN=320)
        # the JAX engine's config ladder (core/batch_correct.py:95-122):
        # the primary slab config, its narrow-chain variant for the bulk,
        # wide/long buckets, and a deep-k tier for long best-k seeds
        self.cfg = replace(cfg, CK=ck, SLAB=True, SB=2)
        self.cfg_lo = replace(self.cfg, KMAX=max(ck + 7, 19))
        self.cfg_big = walk.WalkConfig(
            G=128, MAXLEN=1536, QMAX=1536, WSCAN=576, TMAX=self.cfg.TMAX,
            KMAX=self.cfg.KMAX, CK=ck, SLAB=True, SB=3)
        self.cfg_huge = walk.WalkConfig(
            G=64, MAXLEN=2816, QMAX=2816, WSCAN=1120, TMAX=self.cfg.TMAX,
            KMAX=self.cfg.KMAX, CK=ck, SLAB=True)
        self.cfg_deep = replace(self.cfg_big, G=64, KMAX=52)
        self.cfg_dense = replace(self.cfg_huge, SLAB=False, G=32)
        self._prefetch: dict = {}
        self._flag_why: dict = {}    # gap key -> walk.FLAG_REASONS entry of a -100
        self._tie_keys: set = set()  # gap keys whose walk resolved a tie (Reduced.tie)
        self._host_walked: set = set()   # gap keys the host engine walked this batch
        # the DP/MSA fallback runs its LF extraction and banded DP fills on
        # the device (core/msa.py dev= route -> ops/msa_kernels)
        self.msa_dev = self.dix
        self._misses = None
        self._read_incomplete = False
        # counters, summed over the corrector's life (a flat dict of numbers):
        # gap lookups (hits, misses, host fallbacks by cause, the flagged ones
        # by the card's reason fl_*), the hits whose walk resolved a tie
        # among leaves at the minimum error (walk_ties), the host engine's
        # calls, failures (code < 0) and repeats of a gap key in one batch,
        # the DP seconds of replay rounds thrown away, and the miss rounds
        # and their tasks
        self.stats = {"prefetch_hit": 0, "prefetch_miss": 0, "host_fallback": 0,
                      "fb_unfit": 0, "fb_flagged": 0, "fb_lastround": 0, "gaps": 0,
                      **{"fl_" + r: 0 for r in walk.FLAG_REASONS}, "walk_ties": 0,
                      "he_calls": 0, "he_fail": 0, "he_repeat": 0,
                      "dp_discarded_s": 0.0, "miss_rounds": 0, "miss_tasks": 0}
        self.phase_times = dict.fromkeys(PHASES, 0.0)

    # ------------------------------------------------------------------
    def _seed_chunks(self, items):
        """The reads in CHUNK_READS-read chunks of one width (a multiple of
        L_BUCKET): yields (base, chunk, reads int8 [R, L] padded with
        PAD_RANK, lens int32 [R]) as numpy arrays."""
        R = CHUNK_READS
        L = max(len(seq) for _, seq in items)
        # a batch of only empty reads still gets one bucket: no launch at L 0
        L = L_BUCKET * max((L + L_BUCKET - 1) // L_BUCKET, 1)
        for base in range(0, len(items), R):
            chunk = items[base : base + R]
            mat = np.full((R, L), ab.PAD_RANK, np.int8)
            lens = np.zeros(R, np.int32)
            for i, (_, seq) in enumerate(chunk):
                e = ab.encode(seq)
                mat[i, : len(e)] = e
                lens[i] = len(e)
            yield base, chunk, mat, lens

    def _seed_submit(self, items):
        """Launch the device seed scan of every 64-read chunk without
        waiting for any of it."""
        if not items:
            return []
        max_k = self.probe_params.kmer_len_up_bound + 1
        submitted = []
        for base, chunk, mat, lens in self._seed_chunks(items):
            dmat = torch.from_numpy(mat).to(self.device)
            dlens = torch.from_numpy(lens).to(self.device)
            freq, valid = scan.kmer_table_full(self.dix, dmat, dlens, max_k, self.wx)
            submitted.append((base, chunk, self._seed_records(freq, valid, dmat, dlens)))
        return submitted

    def _seed_records(self, freq, valid, dmat, dlens):
        """The seed scan of one chunk from its k-mer tables (freq, valid
        [max_k+1, R, L] on the device): attributes, automaton, best k,
        hitchhikers.  Each read has seed_slots(L) slots, more than its
        seeds, so every seed stays on the device.  Returns the device
        records _seed_collect reads."""
        pp = self.probe_params
        R, L = dmat.shape
        dev = self.device
        rep_thr = float(self.thresh.get(2, pp.scan_kmer_len))
        bases = torch.arange(1, 5, dtype=torch.int8, device=dev)
        onehot = (dmat[:, :, None] == bases).to(torch.int32)
        prefix = torch.zeros((R, L + 1, 4), dtype=torch.int32, device=dev)
        torch.cumsum(onehot, dim=1, dtype=torch.int32, out=prefix[:, 1:])
        if pp.manual:
            attr = torch.full((R, L), pp.mode, dtype=torch.int32, device=dev)
        else:
            attr = seedscan.attributes(freq[pp.scan_kmer_len], prefix, dlens,
                                       rep_thr, pp.scan_kmer_len)
        n, starts, sizes, freqs, reps, statics = seedscan.scan_automaton(
            freq, valid, attr, prefix, dlens, self._seed_thr,
            pp.start_kmer_len, pp.kmer_len_up_bound, tuple(pp.offset),
            float(pp.hh_ratio), seedscan.seed_slots(L, pp.start_kmer_len, pp.offset))
        sk, ek, oor = seedscan.estimate_best(
            freq, n, starts, sizes, statics, pp.pb_coverage)
        keep = seedscan.remove_hitchhiking(
            n, starts, sizes, freqs, reps, pp.radius, float(pp.hh_ratio))
        records = (n, starts, sizes, freqs, reps, statics, sk, ek, oor, keep)
        if pp.debug_seed:
            # the scan-k freq row, for the --debugseed attribute trace
            records += (freq[pp.scan_kmer_len],)
        return records

    def _seed_collect(self, submitted):
        """Pull the seed records to the host and build Seed objects.
        Yields (base, chunk, seeds_per_read)."""
        pp = self.probe_params
        for base, chunk, devs in submitted:
            host = [x.cpu().numpy() for x in devs]
            n, starts, sizes, freqs, reps, statics, sk, ek, oor, keep = host[:10]
            if n.max(initial=0) >= starts.shape[1]:
                raise RuntimeError(f"seed scan: a read filled its {starts.shape[1]} seed slots")
            out = []
            for i, (rid, seq) in enumerate(chunk):
                seeds, outcasts = [], []
                for j in range(int(n[i])):
                    st, sz = int(starts[i, j]), int(sizes[i, j])
                    # from rank space, as search_seeds does: upper case
                    # whatever the read's case
                    word = ab.decode(ab.encode(seq[st : st + sz]))
                    s = Seed.make(word, st, int(freqs[i, j]),
                                  bool(reps[i, j]), int(statics[i, j]),
                                  pp.pb_coverage)
                    if oor[i, j]:
                        # best-k walked past the device table: host redo
                        s.estimate_best_kmer_size(self.ix)
                    else:
                        s.start_best_kmer_size = int(sk[i, j])
                        s.end_best_kmer_size = int(ek[i, j])
                    s.is_hitchhiked = not bool(keep[i, j])
                    (outcasts if s.is_hitchhiked else seeds).append(s)
                if pp.debug_seed and len(seq) >= pp.start_kmer_len:
                    self._dump_seed_scan(rid, seq, host[10][i, : len(seq)], outcasts)
                out.append(seeds)
            yield base, chunk, out

    def _dump_seed_scan(self, rid, seq, freq_scan, outcasts):
        """--debugseed files that search_seeds writes on the host engine:
        extend/<read>.log (the attribute ratio trace, from the read's
        scan-k freq row) and seed/error/<read>.seed (the outcasts)."""
        pp = self.probe_params
        log = seedmod.open_seed_log(pp, rid)
        if log is not None:
            with log:
                if not pp.manual:
                    read = ab.encode(seq)
                    seedmod.get_seq_attribute(read, freq_scan, seedmod.base_count_prefix(read),
                                              self.thresh, pp.scan_kmer_len, log)
        seedmod.write_outcasts(pp, rid, outcasts)

    def _device_seed_scan(self, items):
        """The entire seed phase on the device.  Yields
        (base, chunk, seeds_per_read)."""
        yield from self._seed_collect(self._seed_submit(items))

    def _seed_table_chunks(self, items):
        """Per-position (k, pos) freq/valid tables for the host seed scan
        (search_seeds' freq_table/valid_table), one kmer_table_wire launch
        per chunk, from the walk index's pyramid.  Every chunk is launched before any is read back, so the
        device computes chunk k+1 while chunk k crosses to the host.
        Yields (base, chunk, freq int32 [K, n, L], valid bool [K, n, L],
        lens [n]) for the chunk's n reads, K = min(kmer_len_up_bound+1,
        KTAB) + 1."""
        max_k = min(self.probe_params.kmer_len_up_bound + 1, KTAB)
        submitted = []
        for base, chunk, mat, lens in self._seed_chunks(items):
            handle = scan.kmer_table_wire(self.dix, torch.from_numpy(mat).to(self.device),
                                          torch.from_numpy(lens).to(self.device), max_k,
                                          self.wx)
            submitted.append((base, chunk, handle, lens))
        for base, chunk, (freq, vbits), lens in submitted:
            # int16 and bit-packed across the link, widened here so that the
            # seed scan sees int32/bool tables
            n = len(chunk)
            f = freq.cpu().numpy()[:, :n].astype(np.int32)
            v = scan.unpack_valid_bits(vbits.cpu().numpy(), max_k + 1)[:, :n]
            yield base, chunk, f, v, lens[:n]

    def _device_seed_tables(self, items):
        """Dense tables for all reads: (freq int32 [K, N, L], valid bool
        [K, N, L], lens int32 [N]) as numpy arrays."""
        freqs, valids, lens_all = [], [], np.zeros(len(items), np.int32)
        for base, chunk, f, v, lens in self._seed_table_chunks(items):
            freqs.append(f)
            valids.append(v)
            lens_all[base : base + len(chunk)] = lens
        return (np.concatenate(freqs, axis=1), np.concatenate(valids, axis=1),
                lens_all)

    # ------------------------------------------------------------------
    # gap planning (PacBioSelfCorrectionProcess.cpp:159-189)
    # ------------------------------------------------------------------
    def _plan_gap(self, source: Seed, target: Seed, read_seq: str):
        """_gap_setup + the R->U transform of correctByFMExtension."""
        interval, ek, src, trg, path = self._gap_setup(source, target, read_seq)
        if source.is_repeat and not target.is_repeat:
            src, trg = trg, src
            src = ab.revcomp_str(src)
            trg = ab.revcomp_str(trg)
            path = ab.revcomp_str(path)
        min_sa = (self.params.pb_coverage // 60) * 3 if self.params.pb_coverage > 60 else 3
        return src, path, trg, interval, ek, min_sa

    def _task_fits(self, src, path, trg, interval, ek, cfg=None) -> bool:
        """Does the gap fit cfg's windows?"""
        cfg = cfg or self.cfg
        if ek + len(path) + len(trg) > cfg.QMAX:
            return False
        if int(1.2 * (interval + 10) + 2 * ek) + 2 > cfg.MAXLEN:
            return False
        max_indel = int(interval * 0.2) if interval > 100 else 20
        if cfg.WSCAN < 2 * max_indel + cfg.seed_size * 2 + 3:
            return False
        if len(trg) - 13 + 1 > cfg.TMAX or len(trg) < 13:
            return False
        # chains only ever run at k >= minOverlap; ek sets the root interval
        if ek + 2 + 1 > cfg.KMAX or ek < 5:
            return False
        return True

    def _fits_any(self, src, path, trg, interval, ek) -> bool:
        """Does any device config cover this gap?"""
        return (self._task_fits(src, path, trg, interval, ek, self.cfg_huge)
                or self._task_fits(src, path, trg, interval, ek, self.cfg_deep))

    def _task(self, src, path, trg, interval, ek, min_sa) -> walk.GapTask:
        return walk.GapTask(src=src, path=path, trg=trg, dis=interval, init_k=ek,
                            max_overlap=ek + 2, min_overlap=self.params.min_kmer_len,
                            min_sa_threshold=min_sa)

    # ------------------------------------------------------------------
    # optimistic prefetch enumeration
    # ------------------------------------------------------------------
    def _enum_state(self):
        return {"tasks": [], "keys": [], "seen": set(), "pending_b": []}

    def _enum_push(self, st, src, path, trg, interval, ek, min_sa):
        key = (src, path, trg, interval, ek)
        if key in st["seen"]:
            return
        st["seen"].add(key)
        if not self._fits_any(src, path, trg, interval, ek):
            return
        st["tasks"].append(self._task(src, path, trg, interval, ek, min_sa))
        st["keys"].append(key)

    def _enumerate_walks(self, per_read):
        """Prefetch tasks of a scanned batch: (tasks, keys)."""
        st = self._enum_state()
        for _, seq, seeds in per_read:
            self._enum_read(st, seq, seeds)
        return self._enum_finalize(st)

    def _enum_read(self, st, seq, seeds):
        """Every consecutive seed pair of the read.  For i >= 2 the replay's
        source is the accumulated piece, whose seed_len is the merged
        length: for repeat-flanked gaps that changes ek and the source
        tail, so that variant is enumerated too; its source bases are
        predicted by _enum_finalize."""
        for i in range(1, len(seeds)):
            src, path, trg, interval, ek, min_sa = self._plan_gap(seeds[i - 1], seeds[i], seq)
            self._enum_push(st, src, path, trg, interval, ek, min_sa)
            prev, curr = seeds[i - 1], seeds[i]
            if i >= 2 and (prev.is_repeat or curr.is_repeat):
                ek2 = min(curr.seed_len, self.start_kmer_len + 2)
                if ek2 != ek:
                    need = ek2 - prev.seed_len
                    args = (seq, prev, curr, interval, min_sa, ek2, path)
                    if need <= 0:
                        st["pending_b"].append((args, prev.seed_str[prev.seed_len - ek2:], 0))
                    elif need <= 2:
                        st["pending_b"].append((args, prev.seed_str, need))

    def _enum_finalize(self, st):
        """The accumulated-source variants of the whole batch (JAX
        batch_correct.py:457-495, once per batch): the corrected bases left
        of a seed are predicted as the FM consensus left extension of the
        seed (freq of base + seed[:12]), batched over all variants."""
        pending_b = st["pending_b"]
        W = 12
        rounds = max((nb for _, _, nb in pending_b), default=0)
        for _ in range(rounds):
            grow = [j for j, (_, _, nb) in enumerate(pending_b) if nb > 0]
            if not grow:
                break
            words = np.stack([np.concatenate([np.zeros(1, np.int8),
                                              ab.encode(pending_b[j][1][:W])])
                              for j in grow])
            cand = np.repeat(words, 4, axis=0)
            cand[:, 0] = np.tile(np.arange(1, 5, dtype=np.int8), len(grow))
            lo, hi = self.ix.bwt.find_interval(cand)
            fwd = np.maximum(hi - lo + 1, 0)
            lo, hi = self.ix.bwt.find_interval(ab.complement(cand)[:, ::-1])
            freq = (fwd + np.maximum(hi - lo + 1, 0)).reshape(len(grow), 4)
            best = np.argmax(freq, axis=1)
            for j, b in zip(grow, best):
                args, w, nb = pending_b[j]
                pending_b[j] = (args, "ACGT"[int(b)] + w, nb - 1)
        for (seq, prev, curr, interval, min_sa, ek2, path), w, _ in pending_b:
            if len(w) < ek2:
                continue
            src2 = w[len(w) - ek2:]
            trg2 = curr.seed_str
            if prev.is_repeat and not curr.is_repeat:
                # R->U strand flip, as in _plan_gap
                p2 = (seq[prev.seed_end_pos + 1 : prev.seed_end_pos + 1 + interval]
                      if interval >= 0 else seq[prev.seed_end_pos + 1:])
                src2, trg2 = ab.revcomp_str(trg2), ab.revcomp_str(src2)
                path2 = ab.revcomp_str(p2)
            else:
                path2 = path
            self._enum_push(st, src2, path2, trg2, interval, ek2, min_sa)
        return st["tasks"], st["keys"]

    # ------------------------------------------------------------------
    # device rounds
    # ------------------------------------------------------------------
    def buckets(self, tasks):
        """Route gap tasks to the config ladder: [(engine, cfg, indices)],
        engine "queue" (the bulk, one bank per QUEUE_BANK tasks) or
        "batch" (one batch per cfg.G tasks), indices sorted by gap length."""
        small, small_lo, big, huge, deep, dense = [], [], [], [], [], []
        for i, t in enumerate(tasks):
            if t.init_k < self.cfg.CK:
                dense.append(i)
            elif self._task_fits(t.src, t.path, t.trg, t.dis, t.init_k):
                # the narrow-chain bank holds every chain length the walk
                # can reach (max_overlap + 1)
                (small_lo if t.max_overlap + 1 <= self.cfg_lo.KMAX else small).append(i)
            elif self._task_fits(t.src, t.path, t.trg, t.dis, t.init_k, self.cfg_big):
                big.append(i)
            elif self._task_fits(t.src, t.path, t.trg, t.dis, t.init_k, self.cfg_huge):
                huge.append(i)
            else:
                deep.append(i)
        out = []
        for engine, sel_all, cfg in (("queue", small_lo, self.cfg_lo),
                                     ("queue", small, self.cfg),
                                     ("batch", big, self.cfg_big),
                                     ("batch", huge, self.cfg_huge),
                                     ("batch", deep, self.cfg_deep),
                                     ("batch", dense, self.cfg_dense)):
            order = sorted(sel_all, key=lambda i: tasks[i].dis)
            step = QUEUE_BANK if engine == "queue" else cfg.G
            for base in range(0, len(order), step):
                out.append((engine, cfg, order[base : base + step]))
        return out

    def _submit_tasks(self, tasks, keys):
        """Launch the tasks' buckets without waiting.  Returns
        [(engine, task_keys, payload)] for _collect_tasks."""
        e, cov = self.params.error_rate, self.params.pb_coverage
        submitted = []
        for engine, cfg, sel in self.buckets(tasks):
            chunk = [tasks[i] for i in sel]
            if engine == "queue":
                h = walk.submit_queue_batch(self.wx, chunk, cfg, e, cov)
            else:
                h = walk.submit_gap_batch(self.wx, chunk, replace(cfg, G=len(chunk)), e, cov)
            submitted.append((engine, [keys[i] for i in sel], h))
        return submitted

    def _collect_tasks(self, submitted) -> None:
        e, cov = self.params.error_rate, self.params.pb_coverage
        for kind, tkeys, h in submitted:
            why: list = []
            ties: list = []
            if kind == "queue":
                res = walk.collect_queue_batch(self.ix, self.wx, h, e, cov, why=why,
                                               ties=ties)
            else:
                res = walk.run_gap_batch(self.ix, self.wx, h[0], h[1], e, cov, _handle=h,
                                         why=why, ties=ties)
            for k, r, w, x in zip(tkeys, res, why, ties):
                self._prefetch[k] = r
                if w is not None:
                    self._flag_why[k] = w
                if x:
                    self._tie_keys.add(k)

    # ------------------------------------------------------------------
    # replay
    # ------------------------------------------------------------------
    def _replay(self, per_read):
        """The per-read workflow against self._prefetch.  A gap that was
        not prefetched is collected (the replay goes on optimistically, so
        one round collects a read's whole chain of missing gaps), its read
        is replayed after the next device round; misses of the last round
        go to the host engine."""
        out = [None] * len(per_read)
        pending = list(range(len(per_read)))
        for round_i in range(MISS_ROUNDS):
            self._misses = [] if round_i < MISS_ROUNDS - 1 else None
            still = []
            seen = set()
            miss_tasks, miss_keys, submitted = [], [], []

            def flush(force=False):
                while self._misses:
                    t, k = self._misses.pop()
                    if k not in seen:
                        seen.add(k)
                        miss_tasks.append(t)
                        miss_keys.append(k)
                while miss_tasks and (force or len(miss_tasks) >= MISS_FLUSH):
                    take, tkeys = miss_tasks[:MISS_CHUNK], miss_keys[:MISS_CHUNK]
                    del miss_tasks[:MISS_CHUNK], miss_keys[:MISS_CHUNK]
                    self.stats["miss_tasks"] += len(take)
                    with self._phase("replay.rounds"):
                        submitted.extend(self._submit_tasks(take, tkeys))

            for ri in pending:
                rid, seq, seeds = per_read[ri]
                result = CorrectionResult(read_id=rid)
                result.total_seed_num = len(seeds)
                self._read_incomplete = False
                dp0 = self.phase_times["replay.dp"]
                pieces = self._init_correct(seq, seeds, result)
                if self._read_incomplete:
                    # the read is replayed: this round's result, DP included,
                    # is thrown away
                    self.stats["dp_discarded_s"] += self.phase_times["replay.dp"] - dp0
                    still.append(ri)
                    if self._misses is not None:
                        flush()
                    continue
                self._dump_seeds(rid, seeds)
                result.merge = bool(pieces)
                result.total_reads_len = len(seq)
                result.corrected_strs = [p.seed_str for p in pieces]
                out[ri] = result
            if not still:
                break
            flush(force=True)
            self.stats["miss_rounds"] += 1
            with self._phase("replay.rounds"):
                self._collect_tasks(submitted)
            pending = still
        self._misses = None
        return out

    def _correct_by_fm_extension(self, source: Seed, target: Seed, read_seq: str,
                                 result: CorrectionResult):
        """correctByFMExtension served from the prefetch; a miss is queued
        for the next device round (the read is replayed), the host engine
        takes gaps no config fits, flagged ones and last-round misses."""
        src, path, trg, interval, ek, min_sa = self._plan_gap(source, target, read_seq)
        key = (src, path, trg, interval, ek)
        hit = self._prefetch.get(key)
        if hit is not None and hit[0] != -100:
            self.stats["prefetch_hit"] += 1
            self.stats["walk_ties"] += key in self._tie_keys
            code, merged = hit
        elif (self._misses is not None and hit is None
              and self._fits_any(src, path, trg, interval, ek)):
            self._misses.append((self._task(src, path, trg, interval, ek, min_sa), key))
            self.stats["prefetch_miss"] += 1
            self._read_incomplete = True
            # pretend success shaped like the raw-subsequence fallback: only
            # the resulting source tail matters until the read is replayed;
            # upper case, as a walk's output is, so that the next gap's key
            # does not depend on the read's case
            result.fm_num += 1
            return 1, ab.decode(ab.encode(read_seq[source.seed_end_pos + 1 :
                                                   target.seed_end_pos + 1]))
        else:
            self.stats["host_fallback"] += 1
            if hit is not None:
                self.stats["fb_flagged"] += 1
                self.stats["fl_" + self._flag_why[key]] += 1
            elif self._misses is None:
                self.stats["fb_lastround"] += 1
            else:
                self.stats["fb_unfit"] += 1
            self.stats["he_calls"] += 1
            if key in self._host_walked:
                self.stats["he_repeat"] += 1
            self._host_walked.add(key)
            t0 = self.phase_times["replay.host_engine"]
            with self._phase("replay.host_engine"):
                engine = HostExtendEngine(self.ix, src, path, trg, interval, ek, ek + 2,
                                          self.fm_params, min_sa)
                code, wres = engine.extend()
            # SelfCorrector's timer_fm: the host engine's seconds
            result.timer_fm += self.phase_times["replay.host_engine"] - t0
            self.stats["he_fail"] += int(code < 0)
            merged = wres.merged_seq
        if code < 0:
            return code, ""
        if source.is_repeat and not target.is_repeat:
            merged = ab.revcomp_str(merged)
            merged += ab.revcomp_str(src)[ek:]
        out = merged[ek:]
        result.corrected_len += len(out)
        result.seed_dis += interval
        result.fm_num += 1
        return code, out

    def _correct_by_msa(self, source: Seed, target: Seed, read_seq: str,
                        result: CorrectionResult):
        """SelfCorrector's MSA/DP fallback inside the replay.dp span."""
        with self._phase("replay.dp"):
            return super()._correct_by_msa(source, target, read_seq, result)

    # ------------------------------------------------------------------
    # entry points
    # ------------------------------------------------------------------
    def _seeds_of(self, collected):
        per_read = []
        for _, chunk, seeds_lists in collected:
            for (rid, seq), seeds in zip(chunk, seeds_lists):
                per_read.append((rid, seq, seeds))
        return per_read

    @contextmanager
    def _phase(self, name: str):
        """Adds the block's host wall seconds to phase_times[name]; a
        profiler sees the block as the range "pbcorrect.<name>", nested in
        the ranges open around it ("replay.dp" inside "replay")."""
        t0 = time.perf_counter()
        with torch.profiler.record_function("pbcorrect." + name):
            yield
        self.phase_times[name] += time.perf_counter() - t0

    def _walk_and_replay(self, per_read) -> list[CorrectionResult]:
        with self._phase("walks"):
            tasks, keys = self._enumerate_walks(per_read)
            self._prefetch = {}
            self._flag_why = {}
            self._tie_keys = set()
            self._host_walked = set()
            self._collect_tasks(self._submit_tasks(tasks, keys))
            self.stats["gaps"] += len(tasks)
        with self._phase("replay"):
            return self._replay(per_read)

    def _seed_timed(self, items):
        with self._phase("seed"):
            return self._seed_submit(items)

    def _collect_timed(self, handles):
        with self._phase("seed"):
            return self._seeds_of(self._seed_collect(handles))

    def process_batch(self, items: list[tuple[str, str]]) -> list[CorrectionResult]:
        """Correct a batch of (read_id, sequence) reads.

        phase_times (host wall seconds): seed = launching the device seed
        phase and collecting its records; walks = enumerating the prefetch
        and walking it on the device; replay = the per-read workflow, its
        miss rounds, host-engine fallbacks and the MSA/DP fallback, of
        which replay.host_engine = the host engine's walks, replay.dp = the
        MSA/DP fallback (of kept and thrown-away rounds), replay.rounds =
        the miss rounds' submits and collects."""
        self.phase_times = dict.fromkeys(PHASES, 0.0)
        return self._walk_and_replay(self._collect_timed(self._seed_timed(items)))

    def process_stream(self, batches):
        """Streamed multi-batch correction with bounded memory: yields one
        result list per input batch, in order.  Batch k+1's seed phase is
        launched before batch k's walks, so the device computes it ahead.
        phase_times accumulate over the stream."""
        self.phase_times = dict.fromkeys(PHASES, 0.0)
        batches = iter(batches)
        items = next(batches, None)
        pending = self._seed_timed(items) if items is not None else None
        while pending is not None:
            per_read = self._collect_timed(pending)
            items = next(batches, None)
            pending = self._seed_timed(items) if items is not None else None
            yield self._walk_and_replay(per_read)
