"""Barcode ground-truth validation harness (`pbcorrect --onlyseed`).

Port of the reference's BCode checker (PacBio/BCode.{h,cpp}): a barcode
file marks, per read, aligned ground-truth intervals with a hex "code"
string (2 hex chars per base: upper nibble stream = insertion counts,
lower = deletion flags).  A seed is scored correct when its k-mer span is
error-free under the code's indel bookkeeping (BCode::validate,
BCode.cpp:82-153); seeds outside every block score "none".

Scoring flow mirrors PacBioSelfCorrectionPostProcess (--onlyseed branch,
PacBioSelfCorrectionProcess.cpp:315-335,372-380).
"""
from __future__ import annotations

from dataclasses import dataclass

_BASE_HEX = {"a": 1, "t": 2, "c": 4, "g": 8, "A": 1, "T": 2, "C": 4, "G": 8}
_CHAR_INT = {c: i for i, c in enumerate("0123456789abcdef")}


def _hex_num(o: int) -> int:
    return bin(o & 0xF).count("1")


@dataclass
class BCode:
    start: int
    end: int
    code: str
    rvc: bool


def load_barcode(path: str) -> dict:
    """BCode::load (BCode.cpp:27-48): whitespace-separated records
    qname qstart qend tname tstart tend code rvc sup."""
    log: dict[str, list[BCode]] = {}
    with open(path) as fh:
        tokens = fh.read().split()
    for i in range(0, len(tokens) - 8, 9):
        qname, qstart, qend = tokens[i], int(tokens[i + 1]), int(tokens[i + 2])
        code, rvc = tokens[i + 6], tokens[i + 7]
        log.setdefault(qname, []).append(
            BCode(qstart, qend, code, rvc == "True"))
    return log


def _fetch(s: str, pos: int, step: int) -> str:
    """'s[pos::step]' with pythonic negative pos (BCode::fetch)."""
    if pos < 0:
        pos += len(s)
    out = []
    i = pos
    while 0 <= i < len(s):
        out.append(s[i])
        i += step
    return "".join(out)


def _sum(s: str) -> int:
    return sum(_CHAR_INT[c] for c in s)


def _pys(pos: int, length: int) -> int:
    if pos < 0:
        pos += length
    assert pos >= 0
    return pos


def validate(pos: int, ksize: int, block: BCode, seq: str) -> bool:
    """BCode::validate (BCode.cpp:82-153), semantics preserved exactly."""
    start = pos
    end = start + ksize
    base = block.start
    first = (start - base) * 2
    last = (end - base) * 2 - 1
    kmer = seq[pos : pos + ksize]
    code = block.code
    info = code[first : last]
    rvc = block.rvc
    sign = -1 if rvc else 1
    bit = 0 if rvc else 1
    pole = start if rvc else end

    # insertion gap
    upper = _sum(_fetch(info, 0, 2))
    if upper > 0:
        igap = 0
        n = 0
        for c in _fetch(info, -bit, -sign * 2):
            v = _CHAR_INT[c]
            if not ((igap == 0 and v in (0, 1)) or (igap > 0 and v == 1)):
                break
            n += 1
            igap += v
        if upper - igap != 0:
            return False
        if igap > 0:
            ioffset = 0
            upper_stream = _fetch(code, 0, 2)
            for c in _fetch(upper_stream, pole - base + bit - 1, sign):
                if _CHAR_INT[c] != 1:
                    break
                ioffset += 1
            if (n - igap) > 0 and ioffset > 0:
                return False
            for i in range(n):
                ci = pole - base + sign * (1 - bit + ioffset + i) - sign * (n - igap)
                si = pole + sign * (1 - bit + ioffset + i) - sign * (n - igap)
                if not (
                    upper_stream[ci] == "0"
                    and kmer[_pys(-sign * (n + bit - 1 - i), ksize)] == seq[si]
                ):
                    return False

    # deletion gap
    lower = _sum(_fetch(info, 1, 2))
    if lower > 0:
        dgap = 0
        m = 0
        hexv = 0
        for c in _fetch(info, -sign * (1 + bit), -sign * 2):
            v = _CHAR_INT[c]
            if dgap != 0:
                break
            hexv |= _BASE_HEX[kmer[_pys(-sign * (bit + m), ksize)]]
            m += 1
            dgap += v
        if lower - dgap != 0:
            return False
        if dgap > 0:
            if not (dgap == hexv or (m == 1 and (dgap & hexv) > 0
                                     and _hex_num(dgap) == 2)):
                return False
    return True


def score_seeds(seeds, blocks: list, seq: str) -> tuple[int, int, int]:
    """Per-read (correct, error, none) seed counts
    (PacBioSelfCorrectionProcess.cpp:315-335)."""
    status = [0, 0, 0]
    for s in seeds:
        m = 2
        for b in blocks:
            if s.seed_start_pos >= b.start and s.seed_end_pos <= b.end:
                m = 0 if validate(s.seed_start_pos, s.seed_len, b, seq) else 1
                break
        status[m] += 1
    return tuple(status)


def summarize_line(subject: str, status) -> str | None:
    """summarize (PacBioSelfCorrectionProcess.cpp:372-380): printed only
    when the read has at least one error seed."""
    total = sum(status)
    if status[1] == 0 or total == 0:
        return None
    return (f"{subject} [{total}] {100*status[0]/total:.2f}% "
            f"{100*status[1]/total:.2f}% {100*status[2]/total:.2f}%")
