"""The classify engine the xenome and electus CLIs run
(``classify_codes_device``) against the JAX package's stream functions
(``tests/test_device_classify.py`` is the shape): the two-sort periodic
stream, the periodic stream and the packed stream, on the same uniform
reads.  Exact comparisons.
"""

import numpy as np
import pytest
import torch

from gossamer_tpu.classify import device as jd
from gossamer_tpu_torch import convert
from gossamer_tpu_torch.classify import device as td
from gossamer_tpu_torch.core import kmer as K
from gossamer_tpu_torch.io.stream import pack_chunk

CPU = torch.device("cpu")
K13 = 13
L = 50
T = L + 1
WINDOW = 1 << 13


@pytest.fixture(scope="module")
def world():
    """Two 4 kbp genomes' annotated union at k = 13 (uint64 E plane, FNV
    representatives), 400 uniform N-free reads, and their words-only chunks."""
    rng = np.random.default_rng(5)
    genomes = [rng.integers(0, 4, 4000, dtype=np.uint8) for _ in range(2)]
    sets = []
    for g in genomes:
        win = np.lib.stride_tricks.sliding_window_view(g, K13)
        lo = np.zeros(len(win), np.uint64)
        for j in range(K13):
            lo = (lo << np.uint64(2)) | win[:, j].astype(np.uint64)
        sets.append(np.unique(K.normalize(lo, np.zeros_like(lo), K13)[0]))
    union = np.union1d(*sets)
    E = td.encode_set(union, np.isin(union, sets[0]), np.isin(union, sets[1]))
    reads = []
    for i in range(400):
        s = int(rng.integers(0, 4000 - L))
        r = genomes[i % 2][s : s + L].copy()
        if i % 9 == 0:  # a mismatch: partial and neither classes
            r[L // 2] = (r[L // 2] + 1) % 4
        if i % 2:
            r = (3 - r[::-1]).astype(np.uint8)
        reads.append(r)
    per = WINDOW // T
    chunks, packed = [], []
    for base in range(0, len(reads), per):
        grp = reads[base : base + per]
        flat, starts = td._flat_batch(grp, K13, WINDOW)
        words, inval = pack_chunk(flat, K13, WINDOW)
        chunks.append((words, len(grp)))
        packed.append((words, inval, starts))
    return E, reads, chunks, packed


def _cli_engine(E, reads):
    return td.classify_codes_device(reads, convert.set_from_u64(E, CPU), K13,
                                    window=WINDOW)


def test_periodic_stream2_matches_jax_and_the_cli_engine(world):
    E, reads, chunks, _packed = world
    want = np.asarray(jd.classify_periodic_stream2(chunks, E, K13, WINDOW, L))
    got = _cli_engine(E, reads)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert len(set(got.tolist())) >= 4


def test_periodic_stream_matches_jax(world):
    E, reads, chunks, _packed = world
    want = jd.classify_periodic_stream(chunks, E, K13, WINDOW, L)
    assert np.array_equal(_cli_engine(E, reads), np.asarray(want))


def test_packed_stream_matches_jax(world):
    E, reads, _chunks, packed = world
    want = jd.classify_packed_stream(
        [(w, v, len(s)) for w, v, s in packed], E, K13, WINDOW)
    assert np.array_equal(_cli_engine(E, reads), np.asarray(want))
