"""Device-resident FM-index rank structure as torch tensors.

The BWT is stored as fixed-size symbol blocks plus an absolute occurrence
checkpoint per block, so a rank query is

    occ(b, i) = ckpt[i // B, b]  +  #b in block[i // B][:i % B]

The arrays are the JAX package's packed layout (index/pack.py), carried
across unchanged: both implementations rank over the very same index.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

DEFAULT_BLOCK = 128


def _tensor(arr: np.ndarray, dtype, device: torch.device) -> torch.Tensor:
    """Contiguous tensor copy of a (possibly read-only, mmapped) array."""
    arr = np.ascontiguousarray(arr, dtype)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


@dataclass(frozen=True)
class FMIndex:
    """One BWT as tensors on one device.

    blocks : int8  [nb, block]   BWT symbols, padded with PAD_RANK
    ckpt   : int32 [nb, 5]       occ counts of each symbol before block start
    C      : int32 [6]           C[s] = #symbols < s over the whole BWT (getPC)
    """

    blocks: torch.Tensor
    ckpt: torch.Tensor
    C: torch.Tensor
    n: int
    num_strings: int
    block: int

    @staticmethod
    def from_symbols(symbols: np.ndarray, num_strings: int, device,
                     block: int = DEFAULT_BLOCK) -> "FMIndex":
        from .pack import pack_symbols

        blocks, ckpt, C = pack_symbols(symbols, block)
        return FMIndex.from_pack(blocks, ckpt, C, len(symbols), num_strings,
                                 device)

    @staticmethod
    def from_pack(blocks: np.ndarray, ckpt: np.ndarray, C: np.ndarray, n: int,
                  num_strings: int, device) -> "FMIndex":
        """Wrap a packed layout (index/pack.py) as tensors on `device`."""
        dev = torch.device(device)
        return FMIndex(
            blocks=_tensor(blocks, np.int8, dev),
            ckpt=_tensor(ckpt, np.int32, dev),
            C=_tensor(C, np.int32, dev),
            n=int(n),
            num_strings=int(num_strings),
            block=int(blocks.shape[1]),
        )

    @property
    def device(self) -> torch.device:
        return self.blocks.device


@dataclass(frozen=True)
class IndexSet:
    """The {BWT, RBWT} bundle (BWTIndexSet, SuffixTools/BWTIndexSet.h:23-34)."""

    bwt: FMIndex
    rbwt: FMIndex

    @property
    def device(self) -> torch.device:
        return self.bwt.device
