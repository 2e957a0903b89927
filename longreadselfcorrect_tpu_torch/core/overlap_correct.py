"""Short-read overlap error correction (`correct -a overlap` / `-a hybrid`).

Port of ErrorCorrectProcess::overlapCorrectionNew
(Algorithm/ErrorCorrectProcess.cpp:83-283) + KmerOverlaps::retrieveMatches
(Algorithm/KmerOverlaps.cpp:69-240) + the KmerContext consensus overload
(Thirdparty/multiple_alignment.cpp:669-740):

1. locate the error index via the adjacent-kmer frequency cliff rules,
   trying the single-base k-mer fix (attemptKmerCorrection) first;
2. collect overlapping reads through shared k-mers (FM intervals expanded
   row-by-row, LF-backtracked to read ranks with visited-marking);
3. banded-extend (or full-DP on repeated anchors) each candidate and keep
   overlaps above the identity/length thresholds;
4. column-majority consensus gated by the base's own k-mer frequency.

The reference's visited-marking map is an unordered_map, so WHICH anchor
position survives per matched read follows libstdc++ bucket order.  That
order is replayed exactly through libstdc++ itself when native/hashorder.so
is built (see _bucket_order below — byte parity verified on 6000-read
corpora, docs/PARITY.md); without the shim the fallback is python-dict
insertion order, which only reorders anchor seeds of the banded alignment,
so outputs almost always still coincide.
"""
from __future__ import annotations

import os

import numpy as np

_DEBUG = bool(os.environ.get("OC_DEBUG"))

from . import alphabet as ab
from .kmer_correct import _attempt
from .msa import ALPHABET, MultipleAlignment, _lf_extract, _symbol2index
from .overlapper import compute_overlap, extend_match
from .pe_merge import kmer_context

_B2C = np.frombuffer(b"$ACGT", dtype=np.uint8)


def _hash_iter_order(keys: list[tuple[int, bool]]) -> list[int]:
    """Iteration order of the reference's prematch unordered_map
    (KmerOverlaps.cpp:101,138: hash = BWT row, equality = (row, strand)).

    The map's bucket order decides which k-mer anchor survives per matched
    read, so it is replayed through libstdc++ itself (native/hashorder.so);
    without the helper, insertion order is used (outputs may then differ
    from the reference on reads sharing several anchor k-mers)."""
    lib = _hashorder_lib()
    if lib is None or not keys:
        return list(range(len(keys)))
    import ctypes

    n = len(keys)
    rows = (ctypes.c_uint64 * n)(*[r for r, _ in keys])
    rcs = (ctypes.c_uint8 * n)(*[int(rc) for _, rc in keys])
    out = (ctypes.c_long * n)()
    m = lib.hash_iter_order(rows, rcs, n, out)
    return list(out[:m])


_HASHORDER = None


def _hashorder_lib():
    global _HASHORDER
    if _HASHORDER is None:
        import ctypes
        import os.path as op

        path = op.join(op.dirname(op.dirname(op.dirname(op.abspath(__file__)))),
                       "native", "hashorder.so")
        try:
            lib = ctypes.CDLL(path)
            lib.hash_iter_order.restype = ctypes.c_long
            _HASHORDER = (lib,)
        except OSError:
            _HASHORDER = (None,)
    return _HASHORDER[0]


def extract_read(ix, dollar_row: int, max_len: int = 1 << 14) -> str:
    """BWTAlgorithms::extractString: invert the BWT from a read's $-sector
    row; LF steps yield the read's characters last-to-first."""
    mat, lens = _lf_extract(ix.bwt, np.array([dollar_row]), max_len)
    return _B2C[mat[0, : lens[0]][::-1]].tobytes().decode()


def read_extractor(ix, lex):
    """read id -> sequence, via BWT inversion (SampledSuffixArray +
    BWTAlgorithms::extractString in the reference).

    The $ sector is ordered by read index (distinct per-read sentinels, as
    in the reference's multi-string BWT), so read i's own terminator IS
    row i and LF-walking from it yields read i last-to-first.  `lex` is
    only needed to map a backtrack's LF($)-image row to a read id."""
    del lex
    return lambda rid: extract_read(ix, rid)




def _find_interval(ix, word: str):
    codes = ab.encode(word)
    lo, hi = ix.bwt.find_interval(codes)
    return int(lo), int(hi)


def retrieve_matches(ix, lex, reads_by_rank, query: str, k: int,
                     min_overlap: int, min_identity: float,
                     kmer_threshold: int, error_idx: int):
    """KmerOverlaps::retrieveMatches (KmerOverlaps.cpp:69-240)."""
    max_interval_size = 50
    prematch: dict[tuple[int, bool], tuple[int, bool]] = {}
    num_kmers = len(query) - k + 1
    for i in range(error_idx, num_kmers):
        kmer = query[i : i + k]
        for rc in (False, True):
            w = ab.revcomp_str(kmer) if rc else kmer
            lo, hi = _find_interval(ix, w)
            if lo <= hi and hi - lo + 1 >= kmer_threshold:
                for j in range(lo, min(hi + 1, lo + max_interval_size)):
                    prematch.setdefault((j, rc), None)
                    if prematch[(j, rc)] is None:
                        prematch[(j, rc)] = [i, False]

    # LF-backtrack each row to its read's lexicographic rank, marking
    # visited rows so shared suffixes are processed once.  The processing
    # order follows the reference's unordered_map bucket order: the first
    # entry of a read encountered here claims the read's anchor position.
    symbols = ix.bwt.symbols
    matches: dict[tuple[int, bool], int] = {}
    pm_keys = list(prematch)
    for oi in _hash_iter_order(pm_keys):
        row, rc = pm_keys[oi]
        rec = prematch[(row, rc)]
        if rec[1]:
            continue
        rec[1] = True
        pos = rec[0]
        idx = row
        while True:
            b = int(symbols[idx])
            idx = int(ix.bwt.pc(b)) + int(ix.bwt.occ(b, idx - 1))
            hit = prematch.get((idx, rc))
            if hit is not None:
                if hit[1]:
                    break
                hit[1] = True
            if b == 0:
                # idx is now the read's $-sector row; order by its read id
                # (lookupLexoRank) like the reference's ordered match set
                rid = int(lex[idx]) if lex is not None else idx
                key = (rid, rc)
                if key not in matches:
                    matches[key] = (pos, idx)
                break

    out = []
    if _DEBUG:
        print(f"RM k {k} thr {kmer_threshold} eidx {error_idx} "
              f"prematch {len(prematch)} matches {len(matches)}")
    bandwidth = int(len(query) * (1 - min_identity))
    maxshift = len(query) - min_overlap + bandwidth // 2
    n_aligned = 0
    for (rid, rc) in sorted(matches):
        if n_aligned > max_interval_size:
            break
        pos, dollar_row = matches[(rid, rc)]
        match_sequence = reads_by_rank(rid)
        if rc:
            match_sequence = ab.revcomp_str(match_sequence)
        if match_sequence == query:
            continue
        match_kmer = query[pos : pos + k]
        pos_1 = match_sequence.find(match_kmer)
        if pos_1 < 0:
            if _DEBUG:
                print(f"SKIP nokmer rid {rid} rc {int(rc)} pos {pos} "
                      f"seq {match_sequence[:50]}")
            continue
        if abs(pos - pos_1) > maxshift:
            if _DEBUG:
                print(f"SKIP shift rid {rid} rc {int(rc)} {pos} {pos_1}")
            continue
        if (query.find(match_kmer, pos + 1) >= 0
                or match_sequence.find(match_kmer, pos_1 + 1) >= 0):
            overlap = compute_overlap(query, match_sequence)
        else:
            overlap = extend_match(query, match_sequence, pos, pos_1, bandwidth)
        ok = (overlap.overlap_length() >= min_overlap
              and overlap.percent_identity() / 100 >= min_identity)
        if _DEBUG:
            print(f"MATCH pos {pos} rc {int(rc)} ovl {overlap.overlap_length()}"
                  f" pid {overlap.percent_identity():.4f} pass {int(ok)}"
                  f" seq {match_sequence}")
        if ok:
            # only overlaps that pass count toward the cap (maxAlignSeq)
            n_aligned += 1
            out.append((match_sequence, overlap))
    return out


def consensus_with_context(ma: MultipleAlignment, kc_same, kc_revc,
                           k: int, read_len: int, threshold: int) -> str:
    """calculateBaseConsensus(KmerContext&, ...)
    (multiple_alignment.cpp:669-740)."""
    base = ma.rows[0]
    start_c, end_c = base.start_column(), base.end_column()
    consensus = []
    last_good = -1
    idxoffset = 0
    num_kmer = read_len - k + 1
    for c in range(start_c, end_c + 1):
        counts = ma.column_base_counts(c)
        max_symbol = "\0"
        max_count = -1
        for a, symbol in enumerate(ALPHABET):
            if symbol != "N" and counts[a] > max_count:
                max_symbol = symbol
                max_count = counts[a]
        base_symbol = base.column_symbol(c)
        base_count = counts[_symbol2index(base_symbol)]
        if base_symbol == "-":
            idxoffset += 1
        idx = c - idxoffset
        if idx < k // 2:
            idx = 0
        elif idx > read_len - k:
            idx = read_len - k
        else:
            idx = idx - k // 2
        base_kmer_freq = int(kc_same[idx]) + int(kc_revc[idx])
        if max_count > base_count and base_kmer_freq < threshold * 2:
            consensus_symbol = max_symbol
        else:
            consensus_symbol = base_symbol
        if _DEBUG and max_count != base_count:
            print(f"CONS c {c} idx {idx} base {base_symbol} bc {base_count}"
                  f" max {max_symbol} mc {max_count} kf {base_kmer_freq}"
                  f" -> {consensus_symbol}")
        if consensus_symbol != "-":
            consensus.append(consensus_symbol)
        if len(consensus) - 1 > last_good:
            last_good = len(consensus) - 1
    return "".join(consensus[: last_good + 1]) if last_good != -1 else ""


def overlap_correction(ix, lex, reads_by_rank, seq: str, k: int,
                       num_rounds: int, min_identity: float,
                       threshold: int) -> tuple[str, bool]:
    """overlapCorrectionNew (ErrorCorrectProcess.cpp:83-283).

    Returns (corrected sequence, overlapQC) — the reference always sets
    overlapQC on this path."""
    if reads_by_rank is None:
        reads_by_rank = read_extractor(ix, lex)
    current = seq
    consensus = ""
    is_first_round = True
    round_i = 0
    while round_i < num_rounds:
        ctx = kmer_context(ix, current, k)
        if ctx is None:
            return current, True
        same, revc = (x.astype(np.int64) for x in ctx)
        nk = len(same)
        all_good = True
        error_idx = -1
        fixed = False
        for i in range(nk):
            if same[i] + revc[i] < threshold * 2:
                all_good = False
            if i >= nk - 1:
                continue
            # frequency cliff down: the kmer ending at i+k-1+1 hit an error
            f_dn = (same[i] > threshold
                    and (int(same[i]) - int(same[i + 1])) / float(same[i]) >= 0.5
                    and int(same[i]) - int(same[i + 1]) > 10)
            r_dn = (revc[i] > threshold
                    and (int(revc[i]) - int(revc[i + 1])) / float(revc[i]) >= 0.5
                    and int(revc[i]) - int(revc[i + 1]) > 10)
            if f_dn and r_dn:
                tmp_err = i + k
                k_idx = tmp_err - k // 2
                if k_idx >= nk:
                    k_idx = nk - 1
                if same[k_idx] + revc[k_idx] < threshold * 2:
                    all_good = False
                    newseq = _attempt(ix, current, tmp_err, k_idx,
                                      threshold, k)
                    if newseq is not None:
                        current = newseq
                        fixed = True
                        break
                    elif not is_first_round:
                        error_idx = i - 4 if i - 4 >= 0 else 0
                        break
            # frequency cliff up: the kmer starting at i is past an error
            f_up = (same[i + 1] > threshold
                    and (int(same[i + 1]) - int(same[i])) / float(same[i + 1]) >= 0.5
                    and int(same[i + 1]) - int(same[i]) > 10)
            r_up = (revc[i + 1] > threshold
                    and (int(revc[i + 1]) - int(revc[i])) / float(revc[i + 1]) >= 0.5
                    and int(revc[i + 1]) - int(revc[i]) > 10)
            if f_up and r_up:
                tmp_err = i
                k_idx = tmp_err - k // 2 if tmp_err >= k // 2 else 0
                if same[k_idx] + revc[k_idx] < threshold * 2:
                    all_good = False
                    newseq = _attempt(ix, current, tmp_err, k_idx,
                                      threshold, k)
                    if newseq is not None:
                        current = newseq
                        fixed = True
                        break
                    elif not is_first_round:
                        error_idx = i + 1
                        break
        if all_good:
            return current, True
        if is_first_round:
            # the reference redoes the first scan once (round--), giving a
            # successful single-base fix a second chance before the MSA
            is_first_round = False
            continue
        del fixed  # a non-first-round fix still falls through to the MSA
        if error_idx == -1:
            error_idx = 0
        if _DEBUG:
            print(f"OC round {round_i} ErrorIdx {error_idx} seq {current}")
        matches = retrieve_matches(
            ix, lex, reads_by_rank, current, k, len(current) // 2,
            min_identity - round_i * 0.01, threshold, error_idx)
        ma = MultipleAlignment()
        ma.add_base_sequence("query", current)
        for seq2, ovl in matches:
            ma.add_overlap("null", seq2, ovl)
        # NB the consensus reads the ROUND-START kmer context even when a
        # base fix mutated the sequence this round (the reference builds kc
        # once per round and attemptKmerCorrection mutates in place)
        out = consensus_with_context(ma, same, revc, k, len(current),
                                     threshold)
        if round_i == num_rounds - 1:
            consensus = out
        else:
            current = out  # unconditional, as in the reference
        round_i += 1

    if consensus:
        return consensus, True
    return current, True
