"""Device classify of the PyTorch port against the JAX package.

On reads without ``N`` the port's engines (``classify_batch``,
``classify_batch_packed``, ``classify_batch_periodic``) and the driver
``classify_codes_device`` must give the JAX functions' blrg exactly, on
the same index carried across with ``convert``; ``compute_near_kmers``
must clear the same bits as the JAX version.

On reads with ``N`` the JAX engines count an ``N`` as a read separator
and give the windows after it to the next read.  The port must equal a
per-read brute force and the OR over each read's ``N``-free fragments
classified by the JAX function.
"""

import numpy as np
import pytest
import torch

from gossamer_tpu.classify import device as jd
from gossamer_tpu.classify.annotated_set import AnnotatedKmerSet as JaxAnn
from gossamer_tpu.classify.annotated_set import compute_near_kmers as jax_near
from gossamer_tpu.classify.xenome import classify_reads as jax_classify_reads
from gossamer_tpu.graph.kmer_set import KmerSet as JaxKmerSet
from gossamer_tpu.io.readers import Read as JaxRead
from gossamer_tpu_torch.classify import device as td
from gossamer_tpu_torch.classify.annotated_set import (
    AnnotatedKmerSet,
    compute_near_kmers,
    compute_near_kmers_host,
    merge_and_annotate,
    near_kmers,
)
from gossamer_tpu_torch.classify.xenome import _batch_blrg, classify_reads
from gossamer_tpu_torch.convert import planes_from_set, set_from_planes, set_from_u64, set_to_u64
from gossamer_tpu_torch.core import kmer as K
from gossamer_tpu_torch.graph.build import build_kmer_set
from gossamer_tpu_torch.io.readers import Read
from gossamer_tpu_torch.io.stream import pack_chunk

from specmodel import py_normalize, read_kmers

CPU = torch.device("cpu")
ACGT = np.frombuffer(b"ACGT", np.uint8)
K13 = 13
W = 4096
MAX_READS = 256


def index(graft: np.ndarray, host: np.ndarray, k: int, near: bool = True):
    """Port-built annotated set of two code sequences (host copies)."""
    def kset(codes):
        ks, _ = build_kmer_set([Read("x", ACGT[codes].tobytes())], k,
                               device=CPU, chunk=4096)
        return ks

    ann, _common = merge_and_annotate(kset(graft), kset(host))
    if near:
        compute_near_kmers(ann, CPU)
    return ann


def as_jax(ann: AnnotatedKmerSet) -> JaxAnn:
    return JaxAnn(JaxKmerSet(ann.kset.k, ann.kset.lo.copy(), ann.kset.hi.copy()),
                  ann.lhs.copy(), ann.rhs.copy())


@pytest.fixture(scope="module")
def world():
    """An index at k = 13 and ~300 N-free reads (mixed and one length)."""
    rng = np.random.default_rng(2026)
    shared = rng.integers(0, 4, 300)
    graft = np.concatenate([rng.integers(0, 4, 3000), shared])
    host = np.concatenate([rng.integers(0, 4, 3000), shared])
    ann = index(graft, host, K13)
    reads = []
    for i in range(300):
        src = (graft, host, shared, rng.integers(0, 4, 200))[i % 4]
        L = 60 if i % 2 else int(rng.integers(20, 90))
        p = int(rng.integers(0, len(src) - L))
        c = src[p : p + L].astype(np.uint8)
        if rng.random() < 0.5:
            c = (3 - c[::-1]).astype(np.uint8)
        reads.append(c)
    E = td.encode_set(ann.kset.lo, ann.lhs, ann.rhs)
    return ann, reads, E


def flat(reads, k: int, window: int):
    parts = []
    for c in reads:
        parts += [c, np.array([255], np.uint8)]
    f = np.concatenate(parts)
    f = np.concatenate([f, np.full(window + k - 1 - len(f), 255, np.uint8)])
    lens = np.array([len(c) + 1 for c in reads])
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    return f, torch.from_numpy(starts)


def test_set_convert_round_trip(world):
    _ann, _reads, E = world
    t = set_from_u64(E, CPU)
    assert t.dtype == torch.int64 and np.array_equal(set_to_u64(t), E)
    eh, el = planes_from_set(t)
    assert torch.equal(set_from_planes(eh, el, CPU), t)
    assert np.array_equal(eh, (E >> np.uint64(32)).astype(np.uint32))


def test_classify_batch_matches_jax(world):
    _ann, reads, E = world
    batch = reads[:60]
    f, starts = flat(batch, K13, W)
    want = np.asarray(jd.classify_batch(f, E, K13, MAX_READS))
    got = td.classify_batch(torch.from_numpy(f), starts, set_from_u64(E, CPU),
                            K13, MAX_READS).numpy()
    assert np.array_equal(got, want)
    assert got[:60].any() and not got[60:].any()


def test_classify_batch_packed_matches_jax(world):
    _ann, reads, E = world
    batch = reads[:60]
    f, starts = flat(batch, K13, W)
    words, inval = pack_chunk(f, K13, W)
    eh, el = planes_from_set(set_from_u64(E, CPU))
    want = np.asarray(jd.classify_batch_packed(words, inval, eh, el, K13,
                                               MAX_READS, W))
    got = td.classify_batch_packed(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(inval),
        starts, set_from_u64(E, CPU), K13, MAX_READS, W).numpy()
    assert np.array_equal(got, want)


def test_classify_batch_periodic_matches_jax(world):
    _ann, reads, E = world
    batch = [c for c in reads if len(c) == 60][:60]
    f, _starts = flat(batch, K13, W)
    words, _ = pack_chunk(f, K13, W)
    T = 61
    nwin = len(batch) * T - K13 + 1
    eh, el = planes_from_set(set_from_u64(E, CPU))
    want = np.asarray(jd.classify_batch_periodic(words, np.int32(nwin), eh, el,
                                                 K13, MAX_READS, W, T))
    got = td.classify_batch_periodic(torch.from_numpy(words.view(np.int32)),
                                     nwin, set_from_u64(E, CPU), K13,
                                     MAX_READS, W, T).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("uniform", [False, True], ids=["packed", "periodic"])
def test_classify_codes_device_matches_jax(world, uniform):
    ann, reads, E = world
    lst = [c for c in reads if len(c) == 60] if uniform else reads
    want = jd.classify_codes_device(lst, E, K13)
    got = td.classify_codes_device(lst, set_from_u64(E, CPU), K13)
    assert np.array_equal(got, want)
    assert np.array_equal(got, _batch_blrg(lst, ann))


def test_empty_set_slice_matches_nothing(world):
    _ann, reads, _E = world
    empty = set_from_u64(np.zeros(0, np.uint64), CPU)
    assert not td.classify_codes_device(reads[:50], empty, K13).any()


def test_flat_engine_when_window_not_a_multiple_of_16(world):
    ann, reads, E = world
    got = td.classify_codes_device(reads[:40], set_from_u64(E, CPU), K13,
                                   window=3001)
    assert np.array_equal(got, _batch_blrg(reads[:40], ann))


def test_compute_near_kmers_matches_jax():
    rng = np.random.default_rng(8)
    shared = rng.integers(0, 4, 200)
    graft = np.concatenate([rng.integers(0, 4, 1500), shared])
    # the host differs from the graft by scattered substitutions, so many
    # exclusive k-mers have a near neighbour of the other class
    host = graft.copy()
    sub = rng.integers(0, len(host), 60)
    host[sub] = (host[sub] + 1) % 4
    ann = index(graft, host, K13, near=False)
    jann = as_jax(ann)
    host_ann = AnnotatedKmerSet(ann.kset, ann.lhs.copy(), ann.rhs.copy())
    want = jax_near(jann)
    assert want > 0
    assert compute_near_kmers(ann, CPU) == want
    assert np.array_equal(ann.lhs, jann.lhs) and np.array_equal(ann.rhs, jann.rhs)
    assert compute_near_kmers_host(host_ann) == want
    assert np.array_equal(host_ann.lhs, jann.lhs)


def test_near_kmers_rejects_wide_keys():
    """The one-lane pass takes k <= 31; wider keys have near_kmers_wide."""
    t = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="wide keys"):
        near_kmers(t, t.bool(), t.bool(), 32)


# ------------------------------------------------------------ reads with N
def brute_blrg(codes: np.ndarray, ann: AnnotatedKmerSet) -> int:
    """Per-read brute force (``tests/test_xenome.py``): each valid window's
    normalized k-mer looked up in the set."""
    cls = {int(v): (int(lhs) << 1) | int(rhs)
           for v, lhs, rhs in zip(ann.kset.lo, ann.lhs, ann.rhs)}
    seq = "".join("ACGTN"[min(int(c), 4)] for c in codes)
    blrg = 0
    for v in read_kmers(seq, ann.kset.k):
        c = cls.get(py_normalize(v, ann.kset.k))
        if c is not None:
            blrg |= 1 << c
    return blrg


def jax_reads(seqs):
    return [JaxRead(str(i), bytes(s)) for i, s in enumerate(seqs)]


def test_n_inside_a_read_stays_in_that_read():
    """[graft read with one N, host read, all-N read] at k = 5: the port
    gives [4, 2, 0]; the JAX engines give the windows after the N to the
    next read."""
    rng = np.random.default_rng(4)
    graft = rng.integers(0, 4, 40)
    host = rng.integers(0, 4, 40)
    ann = index(graft, host, 5, near=False)
    assert not (ann.lhs & ann.rhs).any()
    g = ACGT[graft].copy()
    g[20] = ord("N")
    seqs = [g.tobytes(), ACGT[host].tobytes(), b"N" * 40]
    got = [b for _r, b in classify_reads(
        [Read(str(i), s) for i, s in enumerate(seqs)], ann, device=CPU)]
    assert got == [4, 2, 0]
    assert got == [brute_blrg(K.encode_bases(s), ann) for s in seqs]
    jax_got = [b for _r, b in jax_classify_reads(jax_reads(seqs), as_jax(ann))]
    assert jax_got != got


def test_reads_with_n_match_fragment_or_oracle(world):
    """Each read split at its invalid bases, the N-free fragments
    classified by the JAX function and OR-ed per read."""
    ann, reads, _E = world
    rng = np.random.default_rng(12)
    seqs = []
    for c in reads:
        s = ACGT[c].copy()
        for p in rng.integers(0, len(s), rng.integers(0, 4)):
            s[p] = ord("N")
        seqs.append(s.tobytes())
    frags, owner = [], []
    for i, s in enumerate(seqs):
        for part in s.split(b"N"):
            if part:
                frags.append(part)
                owner.append(i)
    jb = [b for _r, b in jax_classify_reads(jax_reads(frags), as_jax(ann))]
    want = np.zeros(len(seqs), np.uint8)
    np.bitwise_or.at(want, owner, np.array(jb, np.uint8))
    got = np.array([b for _r, b in classify_reads(
        [Read(str(i), s) for i, s in enumerate(seqs)], ann, device=CPU)])
    assert np.array_equal(got, want)
    codes = [K.encode_bases(s) for s in seqs]
    assert np.array_equal(_batch_blrg(codes, ann), want)
    assert [brute_blrg(c, ann) for c in codes[:40]] == want[:40].tolist()
