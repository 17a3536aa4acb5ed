"""``xenome classify --pairs`` of the original gossamer
(``src/GossCmdGroupReads.cc``: in paired mode a pair's class bits are the
OR of both mates'), plain:

1. the index and each read's class bits as :mod:`.xenome` has them (each
   valid window's canonical k-mer in the index sets the bit
   ``1 << (lhs << 1 | rhs)``, marginal k-mers cleared);
2. a pair's bits: the OR of its two mates' bits;
3. the pair's class: ``CLASS_OF_BITS`` of those bits; both mates go to the
   files of that class, mate 1 to the ``_1`` file and mate 2 to the ``_2``.
"""

from __future__ import annotations

import numpy as np
import torch

from .kmers import canonical, lookup, window_keys
from .xenome import CLASS_OF_BITS, READ_BLOCK


def read_bits(reads: np.ndarray, keys, cls, k: int, device) -> np.ndarray:
    """Read codes uint8[n, length] -> uint8 class bits of each read (bit v
    set where a valid window's k-mer has class v in the index)."""
    out = []
    for s in range(0, len(reads), READ_BLOCK):
        codes = torch.from_numpy(np.ascontiguousarray(reads[s : s + READ_BLOCK])).to(device)
        win, valid = window_keys(codes, k)
        r, hit = lookup(keys, canonical(win, k))
        hit &= valid
        c = cls[r]
        bits = torch.zeros(codes.shape[0], dtype=torch.uint8, device=device)
        for v in range(4):
            bits |= (hit & (c == v)).any(dim=1).to(torch.uint8) << v
        out.append(bits.cpu())
    return torch.cat(out).numpy()


def classes_of_bits(bits: np.ndarray) -> np.ndarray:
    """uint8 index into ``xenome.CLASSES`` of each set of class bits."""
    return np.asarray(CLASS_OF_BITS, np.uint8)[bits]


def pair_classes(bits_1: np.ndarray, bits_2: np.ndarray) -> np.ndarray:
    """The class of each pair from its mates' bits: step 2 and 3 above."""
    return classes_of_bits(bits_1 | bits_2)
