"""Wide-key classification (30 < k <= 62) of the PyTorch port against the
JAX package: ``encode_set_wide``, ``classify_batch_wide``, the batching
``classify_codes_device_wide``, the device ``near_kmers_wide`` against the
host numpy version, and ``xenome index -K 40`` + ``classify`` byte for byte
against the JAX CLI on N-free reads.  On reads with ``N`` the port is held
to a per-read brute force (the JAX engines give the windows after an ``N``
to the next read).  All comparisons are exact.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from gossamer_tpu.classify import device as jd
from gossamer_tpu.classify.annotated_set import AnnotatedKmerSet as JaxAnn
from gossamer_tpu.classify.annotated_set import compute_near_kmers as jax_near
from gossamer_tpu.cli.xenome import build_app as jax_app
from gossamer_tpu.graph.kmer_set import KmerSet as JaxKmerSet
from gossamer_tpu_torch import convert
from gossamer_tpu_torch.classify import device as td
from gossamer_tpu_torch.classify.annotated_set import (
    AnnotatedKmerSet,
    compute_near_kmers,
    compute_near_kmers_host,
    merge_and_annotate,
)
from gossamer_tpu_torch.classify.xenome import _batch_blrg, classify_reads
from gossamer_tpu_torch.cli.xenome import main as port_main
from gossamer_tpu_torch.core import kmer as K
from gossamer_tpu_torch.graph.build import build_kmer_set
from gossamer_tpu_torch.io.factory import PhysicalFileFactory
from gossamer_tpu_torch.io.readers import Read

from specmodel import py_normalize, read_kmers

CPU = torch.device("cpu")
ACGT = np.frombuffer(b"ACGT", np.uint8)
K40 = 40
INDEX_SUFFIXES = (".header", ".kmers-lo", ".kmers-hi", ".lhs-bits", ".rhs-bits")
CLASSES = ("neither", "both", "ambiguous", "graft", "host")


def index(graft, host, k, near=True):
    def kset(codes):
        return build_kmer_set([Read("x", ACGT[codes].tobytes())], k,
                              device=CPU, chunk=4096)[0]

    ann, _common = merge_and_annotate(kset(graft), kset(host))
    if near:
        compute_near_kmers(ann, CPU)
    return ann


@pytest.fixture(scope="module")
def world():
    """An index at k = 40 and 200 N-free reads of mixed lengths."""
    rng = np.random.default_rng(2040)
    shared = rng.integers(0, 4, 400)
    graft = np.concatenate([rng.integers(0, 4, 3000), shared])
    host = np.concatenate([rng.integers(0, 4, 3000), shared])
    ann = index(graft, host, K40)
    reads = []
    for i in range(200):
        src = (graft, host, shared, rng.integers(0, 4, 300))[i % 4]
        L = int(rng.integers(45, 120))
        p = int(rng.integers(0, len(src) - L))
        c = src[p : p + L].astype(np.uint8)
        if rng.random() < 0.5:
            c = (3 - c[::-1]).astype(np.uint8)
        reads.append(c)
    jplanes = jd.encode_set_wide(ann.kset.lo, ann.kset.hi, ann.lhs, ann.rhs, K40)
    return ann, reads, jplanes


def test_encode_set_wide_matches_jax(world):
    ann, _reads, jplanes = world
    lanes = convert.wide_set_from_u64(*td.encode_set_wide(
        ann.kset.lo, ann.kset.hi, ann.lhs, ann.rhs, K40), CPU)
    for a, b in zip(jplanes, convert.planes_from_wide_set(*lanes)):
        assert np.array_equal(a, b)
    for a, b in zip(convert.wide_set_from_planes(*jplanes, CPU), lanes):
        assert torch.equal(a, b)
    hi, lo = lanes  # strictly ascending by (hi, lo): distinct and sorted
    assert bool(((hi[1:] > hi[:-1]) | ((hi[1:] == hi[:-1])
                                        & (lo[1:] > lo[:-1]))).all())


def test_classify_batch_wide_matches_jax(world):
    _ann, reads, jplanes = world
    batch = reads[:40]
    W, max_reads = 4096, 256
    flat, starts = td._flat_batch(batch, K40, W)
    want = np.asarray(jd.classify_batch_wide(flat, *jplanes, K40, max_reads))
    got = td.classify_batch_wide(
        torch.from_numpy(flat), torch.from_numpy(starts),
        *convert.wide_set_from_planes(*jplanes, CPU), K40, max_reads).numpy()
    assert np.array_equal(got, want)
    assert got[:40].any() and not got[40:].any()


def test_classify_codes_device_wide_matches_jax(world):
    ann, reads, jplanes = world
    lanes = convert.wide_set_from_planes(*jplanes, CPU)
    want = jd.classify_codes_device_wide(reads, jplanes, K40, window=1 << 13)
    got = td.classify_codes_device_wide(reads, lanes, K40, window=1 << 13)
    assert np.array_equal(got, want)
    assert np.array_equal(got, _batch_blrg(reads, ann))
    assert len(set(got.tolist())) >= 4
    assert np.array_equal(td.classify_codes_device_wide(reads, lanes, K40), got)


def test_classify_codes_device_wide_over_long_read_raises(world):
    _ann, reads, jplanes = world
    lanes = convert.wide_set_from_planes(*jplanes, CPU)
    long_read = np.zeros(5000, np.uint8)
    with pytest.raises(ValueError, match="batch exceeds window"):
        td.classify_codes_device_wide([reads[0], long_read], lanes, K40,
                                      window=1 << 12)


def test_empty_wide_set_matches_nothing(world):
    _ann, reads, _jplanes = world
    z = np.zeros(0, np.uint64)
    empty = convert.wide_set_from_u64(z, z, CPU)
    assert not td.classify_codes_device_wide(reads[:30], empty, K40).any()


@pytest.mark.parametrize("k", [31, 40])
def test_compute_near_kmers_wide_matches_host_and_jax(k):
    """k = 31 is the narrow device pass, k = 40 the wide one; both equal the
    host numpy version and the JAX package's."""
    rng = np.random.default_rng(8)
    shared = rng.integers(0, 4, 200)
    graft = np.concatenate([rng.integers(0, 4, 1200), shared])
    host = graft.copy()
    # substitutions in the low half of k-mers' reach: the probes flip the
    # low k bits only
    sub = rng.integers(0, len(host), 80)
    host[sub] = host[sub] ^ 1
    ann = index(graft, host, k, near=False)
    jann = JaxAnn(JaxKmerSet(k, ann.kset.lo.copy(), ann.kset.hi.copy()),
                  ann.lhs.copy(), ann.rhs.copy())
    host_ann = AnnotatedKmerSet(ann.kset, ann.lhs.copy(), ann.rhs.copy())
    want = compute_near_kmers_host(host_ann)
    assert want > 0
    assert compute_near_kmers(ann, CPU) == want
    assert np.array_equal(ann.lhs, host_ann.lhs)
    assert np.array_equal(ann.rhs, host_ann.rhs)
    assert jax_near(jann) == want and np.array_equal(jann.lhs, ann.lhs)


def brute_blrg(codes, ann) -> int:
    cls = {(int(h) << 64) | int(l): (int(a) << 1) | int(b)
           for l, h, a, b in zip(ann.kset.lo, ann.kset.hi, ann.lhs, ann.rhs)}
    seq = "".join("ACGTN"[min(int(c), 4)] for c in codes)
    blrg = 0
    for v in read_kmers(seq, ann.kset.k):
        c = cls.get(py_normalize(v, ann.kset.k))
        if c is not None:
            blrg |= 1 << c
    return blrg


def test_wide_reads_with_n_match_per_read_brute_force(world):
    ann, reads, _jplanes = world
    rng = np.random.default_rng(12)
    seqs = []
    for c in reads[:80]:
        s = ACGT[c].copy()
        for p in rng.integers(0, len(s), rng.integers(0, 3)):
            s[p] = ord("N")
        seqs.append(s.tobytes())
    got = [b for _r, b in classify_reads(
        [Read(str(i), s) for i, s in enumerate(seqs)], ann, device=CPU)]
    want = [brute_blrg(K.encode_bases(s), ann) for s in seqs]
    assert got == want and len(set(got)) >= 3


@pytest.mark.parametrize("k", [31, 32, 62])
def test_classifier_width_edges_match_host(k):
    """k = 31 is the first k whose E needs two lanes, k = 32 the first whose
    count runs the wide engine (with ``hi`` still 0), k = 62 the last."""
    rng = np.random.default_rng(k)
    graft = rng.integers(0, 4, 1500)
    host = np.concatenate([rng.integers(0, 4, 1300), graft[:200]])
    ann = index(graft, host, k, near=(k == 32))
    reads = [src[p : p + 100].astype(np.uint8)
             for src in (graft, host) for p in range(0, 1200, 100)]
    got = np.array([b for _r, b in classify_reads(
        [Read(str(i), ACGT[c].tobytes()) for i, c in enumerate(reads)], ann,
        device=CPU)], np.uint8)
    assert np.array_equal(got, _batch_blrg(reads, ann)) and len(set(got)) >= 2


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("xenome40")
    rng = np.random.default_rng(77)
    shared = rng.integers(0, 4, 300)
    graft = np.concatenate([rng.integers(0, 4, 2500), shared])
    host = graft.copy()
    host[:2500] = rng.integers(0, 4, 2500)
    host[::97] = host[::97] ^ 1
    (tmp / "graft.fa").write_text(f">g\n{ACGT[graft].tobytes().decode()}\n")
    (tmp / "host.fa").write_text(f">h\n{ACGT[host].tobytes().decode()}\n")
    seqs = []
    for i in range(200):
        src = (graft, host, shared, rng.integers(0, 4, 200))[i % 4]
        L = int(rng.integers(60, 110))
        p = int(rng.integers(0, len(src) - L))
        seqs.append(ACGT[src[p : p + L]].tobytes().decode())
    for name, part in (("reads.fq", seqs), ("r1.fq", seqs[0::2]),
                       ("r2.fq", seqs[1::2])):
        (tmp / name).write_text("".join(
            f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(part)))
    args = ["index", "-K", "40", "-G", str(tmp / "graft.fa"),
            "-H", str(tmp / "host.fa")]
    assert jax_app().main(args + ["-P", str(tmp / "ij")]) == 0
    assert port_main(args + ["-P", str(tmp / "it"), "--device", "cpu"]) == 0
    return tmp


def test_xenome_index_k40_files_match_jax_cli(cli_world):
    tmp = cli_world
    for suffix in INDEX_SUFFIXES:
        assert (tmp / ("it" + suffix)).read_bytes() == \
            (tmp / ("ij" + suffix)).read_bytes(), suffix
    ann = AnnotatedKmerSet.read(str(tmp / "it"), PhysicalFileFactory())
    assert ann.kset.hi.any() and (ann.lhs & ann.rhs).any()
    assert (~(ann.lhs | ann.rhs)).any()  # marginal k-mers were cleared


@pytest.mark.parametrize("mode", ["single", "pairs"])
def test_xenome_classify_k40_outputs_match_jax_cli(cli_world, mode):
    tmp = cli_world
    inputs = {"single": ["-i", str(tmp / "reads.fq")],
              "pairs": ["--pairs", "-i", str(tmp / "r1.fq"),
                        "-i", str(tmp / "r2.fq")]}[mode]
    outs = []
    for main, idx, o, extra in (
            (jax_app().main, "ij", f"{mode}-j", []),
            (port_main, "it", f"{mode}-t", ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["classify", "-P", str(tmp / idx),
                         "--output-filename-prefix", str(tmp / o),
                         *inputs, *extra]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    halves = ("_1", "_2") if mode == "pairs" else ("",)
    seen = 0
    for cls in CLASSES:
        for half in halves:
            jf = tmp / f"{mode}-j_{cls}{half}.fastq"
            tf = tmp / f"{mode}-t_{cls}{half}.fastq"
            assert tf.read_bytes() == jf.read_bytes(), (cls, half)
            seen += bool(tf.stat().st_size)
    assert seen >= 3 * len(halves)
