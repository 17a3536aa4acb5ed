"""The port's sharded classifiers (``parallel/classify_sharded.py``) against
the JAX package's on the 8 virtual CPU devices, on the same set and N-free
reads: ``ShardedClassifier`` (also with a set length that does not divide
by the mesh) and ``RingClassifier``, blrg for blrg.  On reads with an ``N``
the JAX sharded classifiers start a new read after the ``N`` (ROADMAP C.7);
the port must equal a per-read brute force.  A failing sharded classify
raises: nothing answers from the host instead.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from gossamer_tpu.classify.device import classify_codes_device as jax_classify
from gossamer_tpu.classify.device import encode_set
from gossamer_tpu.parallel import classify_sharded as JC
from gossamer_tpu.parallel.mesh import data_mesh as jax_mesh
from gossamer_tpu_torch.classify import xenome as TX
from gossamer_tpu_torch.classify.annotated_set import AnnotatedKmerSet
from gossamer_tpu_torch.core import kmer as K
from gossamer_tpu_torch.graph.kmer_set import KmerSet
from gossamer_tpu_torch.io.readers import Read
from gossamer_tpu_torch.parallel import classify_sharded as TC
from gossamer_tpu_torch.parallel.mesh import Mesh

from specmodel import py_normalize, read_kmers

CPU = torch.device("cpu")


def rand_seq(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


@pytest.fixture(scope="module")
def annotated():
    """``tests/test_classify_sharded.py``'s set (k = 15, two 800 bp
    genomes) and reads: 40 random, the rest from either genome."""
    rng = random.Random(5)
    k = 15
    genomes = [rand_seq(rng, 800), rand_seq(rng, 800)]
    sets = [{py_normalize(v, k) for v in read_kmers(g, k)} for g in genomes]
    union = np.array(sorted(sets[0] | sets[1]), np.uint64)
    lhs = np.array([v in sets[0] for v in union])
    rhs = np.array([v in sets[1] for v in union])
    reads = [rand_seq(rng, 60) for _ in range(40)]
    reads += [genomes[0][i : i + 60] for i in range(0, 700, 37)]
    reads += [genomes[1][i : i + 60] for i in range(0, 700, 41)]
    return union, lhs, rhs, reads, k


def codes_of(reads):
    return [K.encode_bases(r.encode()) for r in reads]


def brute_blrg(reads, union, lhs, rhs, k):
    """Per read, the OR of the class bits of its N-free windows."""
    cls = {int(v): (int(a) << 1) | int(b) for v, a, b in zip(union, lhs, rhs)}
    out = []
    for r in reads:
        b = 0
        for i in range(len(r) - k + 1):
            w = r[i : i + k]
            if "N" not in w:
                c = cls.get(py_normalize(read_kmers(w, k)[0], k))
                if c is not None:
                    b |= 1 << c
        out.append(b)
    return np.array(out, np.uint8)


def test_sharded_classify_matches_jax(annotated):
    union, lhs, rhs, reads, k = annotated
    set_E = encode_set(union, lhs, rhs)
    codes = codes_of(reads)
    want = JC.ShardedClassifier(jax_mesh(), set_E, k,
                                window=1 << 12).classify_codes(codes)
    got = TC.ShardedClassifier(Mesh((CPU,) * 8), set_E, k,
                               window=1 << 12).classify_codes(codes)
    assert np.array_equal(got, np.asarray(want)) and got.max() > 0


def test_sharded_classify_uneven_set(annotated):
    """A set length that the mesh does not divide: the sentinel padding
    gives no phantom match."""
    union, lhs, rhs, reads, k = annotated
    odd = encode_set(union, lhs, rhs)
    odd = odd[: len(odd) - (len(odd) % 8) - 3]
    codes = codes_of(reads)
    want = jax_classify(codes, jnp.asarray(odd), k, window=1 << 12)
    got = TC.ShardedClassifier(Mesh((CPU,) * 8), odd, k,
                               window=1 << 12).classify_codes(codes)
    assert np.array_equal(got, np.asarray(want))


def test_ring_classify_matches_jax():
    """Ring read rotation over 4 shards == the JAX ring, blocks over several
    rotation cycles (``tests/test_classify_sharded.py``'s case)."""
    import jax

    k = 11
    rng = np.random.default_rng(17)
    glen = 3000
    genomes = [rng.integers(0, 4, size=glen, dtype=np.uint8) for _ in range(2)]
    sets = []
    for g in genomes:
        lo = np.zeros(glen - k + 1, np.uint64)
        for j in range(k):
            lo = (lo << np.uint64(2)) | g[j : j + glen - k + 1].astype(np.uint64)
        nlo, _, _ = K.normalize(lo, np.zeros_like(lo), k)
        sets.append(np.unique(nlo))
    union = np.union1d(sets[0], sets[1])
    set_E = encode_set(union, np.isin(union, sets[0]), np.isin(union, sets[1]))
    reads = []
    for i in range(730):
        s = int(rng.integers(0, glen - 40))
        reads.append(genomes[i % 2][s : s + 40])
    want = JC.RingClassifier(JaxMesh(np.array(jax.devices()[:4]), ("d",)),
                             set_E, k, window=1 << 12).classify_codes(reads)
    got = TC.RingClassifier(Mesh((CPU,) * 4), set_E, k,
                            window=1 << 12).classify_codes(reads)
    assert np.array_equal(got, np.asarray(want)) and got.max() > 0


@pytest.mark.parametrize("ring", [False, True])
def test_reads_with_n_match_a_per_read_brute_force(annotated, ring):
    """C.7: windows after an N stay in their read."""
    union, lhs, rhs, reads, k = annotated
    rng = random.Random(8)
    with_n = []
    for i, r in enumerate(reads):
        r = list(r)
        for _ in range(1 + i % 3):
            r[rng.randrange(len(r))] = "N"
        with_n.append("".join(r))
    with_n += ["N" * 30, "ACGT"]  # no window; shorter than k
    want = brute_blrg(with_n, union, lhs, rhs, k)
    cls = TC.RingClassifier if ring else TC.ShardedClassifier
    got = cls(Mesh((CPU,) * 4), encode_set(union, lhs, rhs), k,
              window=1 << 10).classify_codes(codes_of(with_n))
    assert np.array_equal(got, want) and (want > 0).sum() > 20


def test_classify_reads_n_devices_equals_one_device(annotated):
    union, lhs, rhs, reads, k = annotated
    ann = AnnotatedKmerSet(KmerSet(k, union, np.zeros_like(union)), lhs, rhs)
    rds = [Read(str(i), r.encode()) for i, r in enumerate(reads)]
    one = [b for _, b in TX.classify_reads(rds, ann, device=CPU)]
    for kw in (dict(n_devices=4), dict(mesh=Mesh((CPU,) * 2)),
               dict(n_devices=2, passes=3)):
        got = [b for _, b in TX.classify_reads(rds, ann, device=CPU, **kw)]
        assert got == one
    pairs = list(zip(rds[::2], rds[1::2]))
    assert ([b for *_, b in TX.classify_pairs(pairs, ann, device=CPU,
                                              n_devices=4)]
            == [b for *_, b in TX.classify_pairs(pairs, ann, device=CPU)])


def test_a_failing_sharded_classify_raises(annotated, monkeypatch):
    """No host fallback: an error inside the sharded join reaches the
    caller (the JAX package's ``except Exception: pass`` answers from the
    host instead)."""
    union, lhs, rhs, reads, k = annotated
    ann = AnnotatedKmerSet(KmerSet(k, union, np.zeros_like(union)), lhs, rhs)

    def broken(*args, **kw):
        raise RuntimeError("shard join failed")

    monkeypatch.setattr(TC, "classify_batch", broken)
    host_calls = []
    monkeypatch.setattr(TX, "_batch_blrg",
                        lambda *a: host_calls.append(a) or np.zeros(0))
    rds = [Read(str(i), r.encode()) for i, r in enumerate(reads)]
    with pytest.raises(RuntimeError, match="shard join failed"):
        list(TX.classify_reads(rds, ann, device=CPU, n_devices=4))
    assert not host_calls


def test_sharded_classify_on_cuda_needs_the_cards(annotated):
    union, lhs, rhs, reads, k = annotated
    ann = AnnotatedKmerSet(KmerSet(k, union, np.zeros_like(union)), lhs, rhs)
    n = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(RuntimeError, match="are visible"):
        list(TX.classify_reads([Read("r", reads[0].encode())], ann,
                               device=torch.device("cuda"), n_devices=n))
