"""FASTA/FASTQ streaming IO (gz-transparent), mirroring Util/SeqReader
parsing (id = header token before first space/tab; multi-line fasta) and
SeqItem::write output (">id\\nseq\\n", Util/Util.h:51-62)."""
from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from typing import Iterator


@dataclass
class SeqRecord:
    id: str
    seq: str
    qual: str = ""


def open_maybe_gz(path: str, mode: str = "rt"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_seqs(path: str) -> Iterator[SeqRecord]:
    with open_maybe_gz(path) as fh:
        header = None
        seq_lines: list[str] = []
        is_fastq = False
        it = iter(fh)
        line = next(it, None)
        while line is not None:
            line = line.rstrip("\n")
            if not line:
                line = next(it, None)
                continue
            if line[0] == ">":
                header = line
                seq_lines = []
                line = next(it, None)
                while line is not None and not line.startswith((">", "@")):
                    s = line.rstrip("\n")
                    if s:
                        seq_lines.append(s)
                    line = next(it, None)
                yield _make_record(header, "".join(seq_lines), "")
            elif line[0] == "@":
                header = line
                seq = next(it, "").rstrip("\n")
                next(it, None)  # '+'
                qual = next(it, "").rstrip("\n")
                yield _make_record(header, seq, qual)
                line = next(it, None)
            else:
                line = next(it, None)


def _make_record(header: str, seq: str, qual: str) -> SeqRecord:
    body = header[1:]
    end = len(body)
    for i, ch in enumerate(body):
        if ch in (" ", "\t"):
            end = i
            break
    return SeqRecord(id=body[:end], seq=seq, qual=qual)


def write_fasta(fh, rec_id: str, seq: str) -> None:
    fh.write(f">{rec_id}\n{seq}\n")
