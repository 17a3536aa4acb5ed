"""The two-sort periodic classify engine and the stream functions of the
PyTorch port against the JAX package (``tests/test_device_classify.py`` is
the shape): ``recanon_set_value``, ``classify_batch_periodic2``,
``classify_periodic_stream2``, ``classify_periodic_stream`` and
``classify_packed_stream``.  Both of the port's engines are also held to one
another: ``classify_periodic_stream2`` must give the classes of
``classify_codes_device`` on the same uniform reads.  Exact comparisons.
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


def test_recanon_set_value_matches_jax(world):
    E, _reads, _chunks, _packed = world
    got = td.recanon_set_value(E, K13)
    assert got.dtype == np.uint64
    assert np.array_equal(got, jd.recanon_set_value(E, K13))
    keys = got >> np.uint64(2)
    assert (keys[1:] > keys[:-1]).all()  # distinct and sorted
    assert not np.array_equal(got, E)  # some classes changed representative
    assert np.array_equal(np.sort(got & np.uint64(3)), np.sort(E & np.uint64(3)))


def test_prepare_set_value_and_convert_agree(world):
    E, _reads, _chunks, _packed = world
    prepared = td.prepare_set_value(E, K13, CPU)
    jh, jl = (np.asarray(x) for x in jd.prepare_set_value(E, K13))
    assert torch.equal(convert.set_from_planes(jh, jl, CPU), prepared)
    eh, el = convert.planes_from_set(convert.set_from_u64(E, CPU))
    assert torch.equal(convert.value_set_from_planes(eh, el, K13, CPU), prepared)


def test_classify_batch_periodic2_matches_jax(world):
    E, _reads, chunks, _packed = world
    words, n = chunks[0]
    max_reads = WINDOW // T
    jh, jl = jd.prepare_set_value(E, K13)
    want = np.asarray(jd.classify_batch_periodic2(
        words, np.int32(n), jh, jl, K13, max_reads, WINDOW, T))
    got = td.classify_batch_periodic2(
        torch.from_numpy(words.view(np.int32)), n,
        td.prepare_set_value(E, K13, CPU), K13, max_reads, WINDOW, T).numpy()
    assert np.array_equal(got, want) and got.max() > 0


def test_periodic_stream2_matches_jax_and_the_cli_engine(world):
    E, reads, chunks, _packed = world
    want = jd.classify_periodic_stream2(chunks, E, K13, WINDOW, L)
    got = td.classify_periodic_stream2(chunks, E, K13, WINDOW, L, device=CPU)
    assert got.dtype == np.uint8 and np.array_equal(got, np.asarray(want))
    # the engine the xenome CLI runs, on the same reads
    cli = td.classify_codes_device(reads, convert.set_from_u64(E, CPU), K13,
                                   window=WINDOW)
    assert np.array_equal(got, cli)
    assert len(set(got.tolist())) >= 4
    again = td.classify_periodic_stream2(
        chunks, None, K13, WINDOW, L, device=CPU,
        prepared=td.prepare_set_value(E, K13, CPU))
    assert np.array_equal(again, got)


def test_periodic_stream_matches_jax(world):
    E, _reads, chunks, _packed = world
    want = jd.classify_periodic_stream(chunks, E, K13, WINDOW, L)
    got = td.classify_periodic_stream(chunks, convert.set_from_u64(E, CPU),
                                      K13, WINDOW, L)
    assert np.array_equal(got, np.asarray(want))


def test_packed_stream_matches_jax(world):
    E, _reads, _chunks, packed = world
    want = jd.classify_packed_stream(
        [(w, v, len(s)) for w, v, s in packed], E, K13, WINDOW)
    got = td.classify_packed_stream(packed, convert.set_from_u64(E, CPU), K13,
                                    WINDOW)
    assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("stream", ["periodic2", "periodic", "packed"])
def test_streams_on_empty_input_and_too_many_reads(world, stream):
    E, _reads, chunks, packed = world
    set_E = convert.set_from_u64(E, CPU)
    words, n = chunks[0]
    if stream == "periodic2":
        run = lambda c, **kw: td.classify_periodic_stream2(  # noqa: E731
            c, E, K13, WINDOW, L, device=CPU)
        bad = [(words, WINDOW // T + 1)]
    elif stream == "periodic":
        run = lambda c: td.classify_periodic_stream(  # noqa: E731
            c, set_E, K13, WINDOW, L, max_reads=n - 1)
        bad = [(words, n)]
    else:
        run = lambda c: td.classify_packed_stream(  # noqa: E731
            c, set_E, K13, WINDOW, max_reads=n - 1)
        bad = packed[:1]
    empty = run([])
    assert empty.dtype == np.uint8 and len(empty) == 0
    with pytest.raises(ValueError, match="exceeds"):
        run(bad)
