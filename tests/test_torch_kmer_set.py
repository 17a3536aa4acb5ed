"""FNV canonicalization, canonical counting and ``goss build-kmer-set`` of
the PyTorch port against the JAX package.

``canon_ref`` must equal the JAX ``canon_ref`` (and the pure-Python model)
on random keys, rho = 31 and palindromes included; canonical counting must
equal JAX ``count_rho_mers(canonical=True)``; the files of
``build-kmer-set`` and the text of ``dump-kmer-set`` must be
byte-identical to the JAX CLI's.
"""

import numpy as np
import pytest
import torch

from gossamer_tpu.cli.goss import build_app as jax_app
from gossamer_tpu.graph.kmer_set import KmerSet as JaxKmerSet
from gossamer_tpu.io.readers import Read as JaxRead
from gossamer_tpu.ops.count import count_rho_mers as jax_count
from gossamer_tpu.ops.engine import canon_ref as jax_canon_ref
from gossamer_tpu_torch.cli.goss import main as port_main
from gossamer_tpu_torch.graph.kmer_set import KmerSet
from gossamer_tpu_torch.io.factory import PhysicalFileFactory
from gossamer_tpu_torch.io.readers import Read
from gossamer_tpu_torch.ops.canon import canon_ref, fnv_planes
from gossamer_tpu_torch.ops.count import count_rho_mers

from specmodel import py_fnv, py_normalize, py_revcomp

CPU = torch.device("cpu")
ACGT = np.frombuffer(b"ACGT", np.uint8)


def palindromes(rng, rho: int, n: int) -> np.ndarray:
    """Keys equal to their reverse complement (even rho only)."""
    half = rng.integers(0, 1 << rho, n, dtype=np.int64)
    return np.array([(int(h) << rho) | py_revcomp(int(h), rho // 2)
                     for h in half], np.int64)


@pytest.mark.parametrize("rho", [5, 13, 26, 31])
def test_canon_ref_matches_jax(rho):
    rng = np.random.default_rng(rho)
    keys = rng.integers(0, 1 << (2 * rho), 4000, dtype=np.int64)
    if rho % 2 == 0:
        pal = palindromes(rng, rho, 50)
        assert all(py_revcomp(int(p), rho) == p for p in pal)
        keys = np.concatenate([keys, pal])
    got = canon_ref(torch.from_numpy(keys), rho).numpy()
    n1, n0 = jax_canon_ref((keys >> 32).astype(np.uint32),
                           (keys & 0xFFFFFFFF).astype(np.uint32), rho)
    want = (np.asarray(n1).astype(np.int64) << 32) | np.asarray(n0).astype(np.int64)
    assert np.array_equal(got, want)
    assert all(int(g) == py_normalize(int(x), rho)
               for g, x in zip(got[-100:], keys[-100:]))


def test_fnv_planes_match_model():
    rng = np.random.default_rng(1)
    keys = np.concatenate([[0, 1, (1 << 62) - 1],
                           rng.integers(0, 1 << 62, 200, dtype=np.int64)])
    h1, h0 = fnv_planes(torch.from_numpy(keys))
    got = (h1.numpy().astype(object) << 32) + h0.numpy().astype(object)
    assert [int(g) for g in got] == [py_fnv(int(x)) for x in keys]


def reads(seed: int, n: int = 120, length: int = 70):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 1500)
    out = []
    for i in range(n):
        p = int(rng.integers(0, len(genome) - length))
        seq = ACGT[genome[p : p + length]].copy()
        if i % 9 == 0:
            seq[rng.integers(0, length)] = ord("N")
        out.append(seq.tobytes())
    return out


@pytest.mark.parametrize("rho", [13, 31])
def test_canonical_count_matches_jax(rho):
    seqs = reads(rho)
    want = jax_count([JaxRead(str(i), s) for i, s in enumerate(seqs)], rho,
                     both_strands=False, canonical=True, chunk=2048)
    got = count_rho_mers([Read(str(i), s) for i, s in enumerate(seqs)], rho,
                         both_strands=False, canonical=True, device=CPU,
                         chunk=2048)
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w))
    assert all(py_normalize(int(x), rho) == int(x) for x in got[0][:200])


@pytest.fixture
def fasta(tmp_path):
    path = tmp_path / "reads.fa"
    path.write_text("".join(f">r{i}\n{s.decode()}\n"
                            for i, s in enumerate(reads(7))))
    return tmp_path, str(path)


def test_build_and_dump_kmer_set_match_jax_cli(fasta):
    tmp, fa = fasta
    args = ["build-kmer-set", "-k", "15", "-I", fa, "--chunk-size", "4096"]
    assert jax_app().main(args + ["-O", str(tmp / "kj")]) == 0
    assert port_main(args + ["-O", str(tmp / "kt"), "--device", "cpu"]) == 0
    for suffix in (".header", ".kmers-lo", ".kmers-hi"):
        assert (tmp / ("kt" + suffix)).read_bytes() == \
            (tmp / ("kj" + suffix)).read_bytes(), suffix
    assert jax_app().main(["dump-kmer-set", "-G", str(tmp / "kj"),
                           "-o", str(tmp / "kj.txt")]) == 0
    assert port_main(["dump-kmer-set", "-G", str(tmp / "kt"),
                      "-o", str(tmp / "kt.txt"), "--device", "cpu"]) == 0
    assert (tmp / "kt.txt").read_bytes() == (tmp / "kj.txt").read_bytes()


def test_kmer_set_queries_match_jax(fasta):
    tmp, fa = fasta
    assert port_main(["build-kmer-set", "-k", "15", "-I", fa, "-O",
                      str(tmp / "kt"), "--chunk-size", "4096",
                      "--device", "cpu"]) == 0
    ks = KmerSet.read(str(tmp / "kt"), PhysicalFileFactory())
    jks = JaxKmerSet(ks.k, ks.lo, ks.hi)
    rng = np.random.default_rng(3)
    q = np.concatenate([ks.lo[::3], rng.integers(0, 1 << 30, 500).astype(np.uint64)])
    qhi = np.zeros_like(q)
    for got, want in zip(ks.access_and_rank(q, qhi), jks.access_and_rank(q, qhi)):
        assert np.array_equal(got, want)
    r = np.arange(0, ks.count, 5)
    for got, want in zip(ks.select(r), jks.select(r)):
        assert np.array_equal(got, want)
    assert ks.stat() == jks.stat()


def test_a_header_of_neither_format_raises(tmp_path):
    """Neither this package's header nor the reference's binary one: the
    header's own error, as in the JAX package (the reference's format is
    read, ``tests/test_torch_reference_format.py``)."""
    (tmp_path / "x.header").write_bytes(b"\x00\x01binary")
    with pytest.raises(ValueError, match="Expecting value"):
        KmerSet.read(str(tmp_path / "x"), PhysicalFileFactory())
