"""K-mer frequency threshold table.

Exact transcription of the quadratic threshold model in
PacBio/KmerThreshold.cpp:11-79 (modes: 0 lowcov, 1 unique, 2 repeat; value is
a monotone running minimum over ksize of max(formula, 2.0), all in float32).
"""
from __future__ import annotations

import numpy as np

# rows: lowcov, unique, repeat; columns: x*x, x*y, y*y, x, y, 1
_FORMULA = np.array(
    [
        [0.0004799107143, -0.008037815126, 0.03673552754, 0.1850695903, -1.572552521, 18.0522088],
        [0.0003348214286, -0.009112394958, 0.04286714686, 0.240519958, -1.8793367350, 21.29319228],
        [0.01714285714, -0.6193907563, 2.266956783, 17.28450630, -100.6983493, 1103.571729],
    ],
    dtype=np.float32,
)


class KmerThreshold:
    """table[mode][ksize] for ksize in [0, end+1] (zeros outside [start, end])."""

    def __init__(self, start: int, end: int, coverage: int):
        self.start = max(start, 15)
        self.end = end
        self.cov = coverage
        self.table = np.zeros((3, end + 2), dtype=np.float32)
        for mode in range(3):
            cavity = np.float32(np.finfo(np.float32).max)
            for ksize in range(self.start, end + 1):
                cavity = np.fmin(cavity, self._calculate(mode, coverage, ksize))
                self.table[mode, ksize] = cavity

    @staticmethod
    def _calculate(mode: int, x: int, y: int) -> np.float32:
        f = _FORMULA[mode]
        x = np.float32(x)
        y = np.float32(y)
        v = f[0] * x * x + f[1] * x * y + f[2] * y * y + f[3] * x + f[4] * y + f[5]
        return np.fmax(v, np.float32(2.0))

    def get(self, mode: int, ksize: int) -> np.float32:
        return self.table[mode][ksize]

    def write_table(self, path: str) -> None:
        """The pbcorrect threshold-table dump (KmerThreshold.cpp:33-41,65-72):
        written whenever pbcorrect has an output directory."""
        with open(path, "w") as out:
            out.write(f"Coverage : {self.cov}\nsize\tlowcov\tunique\trepeat\n")
            for ksize in range(self.start, self.end + 1):
                row = [f"{np.float32(self.table[m, ksize]):g}"
                       for m in range(3)]
                out.write(f"{ksize}\t{row[0]}\t{row[1]}\t{row[2]}\n")


def default_table(coverage: int) -> KmerThreshold:
    """KmerThreshold::Instance().initialize(-1, 50, cov, dir) as used by
    pbcorrect (StriDe/PacBioSelfCorrection.cpp:231)."""
    return KmerThreshold(-1, 50, coverage)
