"""Sequence files from 2-bit codes (0-3 = ACGT, 4 = N).

``ACGTN`` and the record layout are frozen from ``chip_smoke.py`` at commit
04cc210 (``write_fastq``, ``write_reference``); the FASTQ labels here are
``r<7-digit read number>`` with no mate suffix.
"""

from __future__ import annotations

import numpy as np

ACGTN = np.frombuffer(b"ACGTN", np.uint8)
LABEL_DIGITS = 7


def fastq_records(reads: np.ndarray) -> np.ndarray:
    """uint8[n, record bytes]: ``@r<7 digits>``, the bases, ``+``, all
    qualities I, one record a row (every read has the same length)."""
    n, length = reads.shape
    if n >= 10 ** LABEL_DIGITS:
        raise ValueError(f"{n} reads: labels hold {LABEL_DIGITS} digits")
    head = 2 + LABEL_DIGITS + 1
    rec = np.empty((n, head + 2 * length + 4), np.uint8)
    rec[:, 0:2] = np.frombuffer(b"@r", np.uint8)
    idx = np.arange(n)
    for j in range(LABEL_DIGITS):
        rec[:, 2 + j] = ord("0") + (idx // 10 ** (LABEL_DIGITS - 1 - j)) % 10
    rec[:, head - 1] = ord("\n")
    rec[:, head : head + length] = ACGTN[reads]
    rec[:, head + length : head + length + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, head + length + 3 : -1] = ord("I")
    rec[:, -1] = ord("\n")
    return rec


def write_fastq(path, reads: np.ndarray) -> None:
    fastq_records(reads).tofile(path)


def write_reference(path, label: str, codes: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(b">" + label.encode() + b"\n" + ACGTN[codes].tobytes() + b"\n")
