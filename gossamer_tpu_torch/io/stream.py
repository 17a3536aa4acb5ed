"""Flat 2-bit base streams for device kmerization.

Copy of ``flat_code_chunks``, ``pack_chunk`` and ``packed_code_chunks``
from ``gossamer_tpu/io/stream.py``.  Reads are concatenated into one flat
code stream with a separator code (255) between reads; any k-mer window
containing a separator or an invalid base is masked out on device, which
reproduces the reference's "skip windows with non-ACGT bases" semantics
(``src/GossReadBaseString.hh:52-103``).

Each yielded chunk has ``chunk + k - 1`` codes; the window start positions
``0..chunk-1`` belong to this chunk, and the trailing ``k-1`` codes
overlap the next chunk so no window is lost or double-counted.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np

from ..core.kmer import encode_bases
from .readers import Read

SEP = np.uint8(255)


def flat_code_chunks(
    reads: Iterable[Read], k: int, chunk: int = 1 << 22
) -> Iterator[np.ndarray]:
    """Yield uint8 arrays of length ``chunk + k - 1`` (last one padded)."""
    tail = np.full(k - 1, SEP, dtype=np.uint8) if k > 1 else np.zeros(0, np.uint8)
    buf: list[np.ndarray] = [tail]
    # Number of *window-start* positions currently buffered.  The first
    # k-1 codes of the buffer are the previous chunk's overlap region and
    # their windows belong to the previous chunk.
    have = 0

    sep = np.array([SEP], dtype=np.uint8)
    for read in reads:
        codes = encode_bases(read.seq)
        buf.append(codes)
        buf.append(sep)
        have += len(codes) + 1
        while have >= chunk:
            data = np.concatenate(buf)
            out = data[: chunk + k - 1]
            rest = data[chunk:]
            buf = [rest]
            have = len(rest) - (k - 1)
            yield out
    if have > 0:
        data = np.concatenate(buf)
        pad = chunk + k - 1 - len(data)
        if pad > 0:
            data = np.concatenate([data, np.full(pad, SEP, dtype=np.uint8)])
        yield data[: chunk + k - 1]


def pack_chunk(codes: np.ndarray, k: int, chunk: int | None = None):
    """Pack one flat code chunk into the engine's packed-transfer format.

    Returns ``(words, inval)`` per :func:`gossamer_tpu_torch.ops.kmerize.
    kmerize_packed`: uint32 big-endian 2-bit words (base p at bits
    ``[30 - 2*(p % 16), +2)`` of word ``p // 16``) plus the little-endian
    invalid-code bitmap.  The format has ``C // 16 + 2`` words, room for an
    overlap of at most 32 bases: for ``k - 1 > 32`` it raises, and the caller
    feeds raw codes instead (the wide engine packs them on the device).
    """
    if k - 1 > 32:
        raise ValueError(f"pack_chunk: the packed format holds an overlap of "
                         f"at most 32 bases (k - 1 = {k - 1}); feed raw codes")
    C = chunk if chunk is not None else len(codes) - k + 1
    if C % 16 or len(codes) != C + k - 1:
        raise ValueError(f"pack_chunk: need C % 16 == 0 and C + k - 1 codes "
                         f"(C={C}, k={k}, codes={len(codes)})")
    inval = np.packbits(codes > 3, bitorder="little")
    return _pack_words(codes, C), inval


def _pack_words(codes: np.ndarray, C: int) -> np.ndarray:
    """The ``C // 16 + 2`` big-endian 2-bit words of ``codes``; an invalid
    code packs as 0."""
    c = np.where(codes > 3, 0, codes).astype(np.uint32)
    W = C // 16 + 2
    pad = W * 16 - len(c)
    if pad > 0:
        c = np.concatenate([c, np.zeros(pad, np.uint32)])
    m = c[: W * 16].reshape(W, 16)
    shifts = (30 - 2 * np.arange(16)).astype(np.uint32)
    return np.bitwise_or.reduce(m << shifts, axis=1).astype(np.uint32)


def packed_code_chunks(
    reads: Iterable[Read], k: int, chunk: int = 1 << 22
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """:func:`flat_code_chunks` packed with :func:`pack_chunk`."""
    for codes in flat_code_chunks(reads, k, chunk=chunk):
        yield pack_chunk(codes, k, chunk)
