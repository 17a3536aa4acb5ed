"""The port's ``espresso`` (``cli/espresso.py``) against the JAX package's:
``single``, ``multi``, ``sparse-single``, ``sparse-multi`` (their ``.mat``
contents compared by ``loadmat``; the files carry a creation time),
``query`` (stdout byte-identical) and ``similarity`` (file byte-identical).

The inputs are N-free, as the JAX CLI needs: its windows take read ids
from a count of 255 codes, so an ``N`` shifts later windows to later reads
(ROADMAP C.7).  The spectra equal a ``np.bincount`` of every read's
FNV-normalized windows; on reads with an ``N`` the port's spectra and
``query`` counts equal a per-read brute force.
"""

import numpy as np
import pytest
import torch
from scipy.io import loadmat

from gossamer_tpu.cli.espresso import main as jax_espresso
from gossamer_tpu_torch.cli.espresso import build_app
from gossamer_tpu_torch.cli.espresso import main as port_espresso
from gossamer_tpu_torch.core import kmer as K
from gossamer_tpu_torch.graph.kmer_set import KmerSet
from gossamer_tpu_torch.io.factory import PhysicalFileFactory

from test_torch_contigs import run_port

FAC = PhysicalFileFactory()


def text(codes) -> str:
    return "".join("ACGTN"[c] for c in codes)


def run_both(tmp, name, args) -> dict:
    """One command in each CLI, ``-o`` to its own file -> the port's
    ``.mat`` contents, which must equal the JAX CLI's."""
    assert jax_espresso([*args, "-o", str(tmp / f"{name}_j.mat")]) == 0, args
    assert port_espresso([*args, "-o", str(tmp / f"{name}_p.mat"),
                          "--device", "cpu"]) == 0, args
    return same_mats(tmp / f"{name}_j.mat", tmp / f"{name}_p.mat")


def mat(path) -> dict:
    return {k: v for k, v in loadmat(path).items() if not k.startswith("__")}


def same_mats(a, b) -> dict:
    ma, mb = mat(a), mat(b)
    assert ma.keys() == mb.keys() and ma
    for key in ma:
        assert ma[key].dtype == mb[key].dtype
        np.testing.assert_array_equal(ma[key], mb[key])
    return mb


def normalized_windows(seq: str, k: int) -> np.ndarray:
    """FNV-normalized keys of one read's N-free k-windows (narrow k)."""
    codes = K.encode_bases(seq)
    lo = [int("".join(str(int(c)) for c in codes[i : i + k]), 4)
          for i in range(len(codes) - k + 1) if (codes[i : i + k] < 4).all()]
    lo = np.array(lo, np.uint64)
    return K.normalize(lo, np.zeros_like(lo), k)[0]


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    """Two samples (N-free reads of two genomes; the first also with an N
    in every fifth read, ``s1n.fa``) and a k = 15 set of the first genome,
    built by the port."""
    tmp = tmp_path_factory.mktemp("espresso")
    rng = np.random.default_rng(73)
    out = {}
    for name in ("s1", "s2"):
        genome = rng.integers(0, 4, 600, dtype=np.uint8)
        (tmp / f"{name}_ref.fa").write_text(f">{name}\n{text(genome)}\n")
        starts = rng.integers(0, 540, 40)
        reads = np.lib.stride_tricks.sliding_window_view(genome, 60)[starts].copy()
        (tmp / f"{name}.fa").write_text("".join(
            f">{name}r{i}\n{text(r)}\n" for i, r in enumerate(reads)))
        out[name] = [text(r) for r in reads]
    with_n = [s[:30] + "N" + s[31:] if i % 5 == 0 else s
              for i, s in enumerate(out["s1"])]
    (tmp / "s1n.fa").write_text("".join(f">s1r{i}\n{s}\n"
                                        for i, s in enumerate(with_n)))
    out["s1n"] = with_n
    run_port(["build-kmer-set", "-k", "15", "-I", str(tmp / "s1_ref.fa"), "-O",
              str(tmp / "ks"), "--chunk-size", "4096"])
    return tmp, out


@pytest.mark.parametrize("k", [5, 7])
def test_single_and_multi_match_jax_and_bincount(samples, k):
    tmp, reads = samples
    s1, s2 = str(tmp / "s1.fa"), str(tmp / "s2.fa")
    one = run_both(tmp, f"single{k}", ["single", "-k", str(k), "-S", "one",
                                       "-I", s1])["one"]
    two = run_both(tmp, f"multi{k}", ["multi", "-k", str(k), "-S", "two",
                                      "-I", s1, "-I", s2])["two"]
    rows = [np.bincount(np.concatenate([normalized_windows(s, k)
                                        for s in reads[n]]).astype(np.int64),
                        minlength=4 ** k) for n in ("s1", "s2")]
    assert one.shape == (1, 4 ** k)
    np.testing.assert_array_equal(one[0], rows[0])
    np.testing.assert_array_equal(two, np.stack(rows))
    # reads with an N: the port against a per-read brute force
    out = tmp / f"single{k}_n.mat"
    assert port_espresso(["single", "-k", str(k), "-I", str(tmp / "s1n.fa"),
                          "-o", str(out), "--device", "cpu"]) == 0
    want = np.bincount(np.concatenate([normalized_windows(s, k)
                                       for s in reads["s1n"]]).astype(np.int64),
                       minlength=4 ** k)
    np.testing.assert_array_equal(mat(out)["sample"][0], want)
    assert want.sum() < rows[0].sum()


def test_sparse_single_and_multi_match_jax(samples):
    tmp, reads = samples
    ks = KmerSet.read(str(tmp / "ks"), FAC)
    base = ["-G", str(tmp / "ks"), "-S", "sp", "-I", str(tmp / "s1.fa")]
    single = run_both(tmp, "ss", ["sparse-single", *base])["sp"]
    multi = run_both(tmp, "sm", ["sparse-multi", *base, "-I",
                                 str(tmp / "s2.fa")])["sp"]
    keys = np.concatenate([normalized_windows(s, 15) for s in reads["s1"]])
    at = np.searchsorted(ks.lo, keys)
    assert np.array_equal(ks.lo[at], keys)
    want = np.bincount(at, minlength=ks.count)
    np.testing.assert_array_equal(single[0], want)
    np.testing.assert_array_equal(multi[0], want)
    assert multi.shape == (2, ks.count) and multi[1].sum() < want.sum()


def test_query_follows_the_read_starts(samples, capsys):
    """Per-read counts of set k-mers on reads with an N: the port equals a
    per-read brute force."""
    tmp, reads = samples
    ks = KmerSet.read(str(tmp / "ks"), FAC)
    capsys.readouterr()
    assert port_espresso(["query", "-G", str(tmp / "ks"), "-I",
                          str(tmp / "s1n.fa"), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    want = [f"s1r{i}\t{int(np.isin(normalized_windows(s, 15), ks.lo).sum())}"
            for i, s in enumerate(reads["s1n"])]
    assert lines == want and len(set(lines)) > 10


def test_query_of_n_free_reads_matches_jax(samples, capsys):
    tmp, reads = samples
    ks = KmerSet.read(str(tmp / "ks"), FAC)
    args = ["query", "-G", str(tmp / "ks"), "-I", str(tmp / "s1.fa"), "-I",
            str(tmp / "s2.fa")]
    capsys.readouterr()
    assert jax_espresso(args) == 0
    want = capsys.readouterr().out
    assert port_espresso(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
    assert want.splitlines()[:40] == [
        f"s1r{i}\t{int(np.isin(normalized_windows(s, 15), ks.lo).sum())}"
        for i, s in enumerate(reads["s1"])]


def test_similarity_matches_jax(samples):
    tmp, _reads = samples
    s1, s2 = str(tmp / "s1.fa"), str(tmp / "s2.fa")
    made = []
    for name, args in (("a", ["single", "-k", "6", "-I", s1]),
                       ("b", ["multi", "-k", "6", "-I", s1, "-I", s2]),
                       ("c", ["sparse-single", "-G", str(tmp / "ks"), "-I", s2])):
        made += ["--matrices", str(tmp / f"sim{name}.mat")]
        assert port_espresso([*args, "-o", made[-1], "--device", "cpu"]) == 0
    assert jax_espresso(["similarity", *made, "-o", str(tmp / "sim_j")]) == 0
    assert port_espresso(["similarity", *made, "-o", str(tmp / "sim_p"),
                          "--device", "cpu"]) == 0
    got = (tmp / "sim_p").read_text()
    assert (tmp / "sim_j").read_text() == got
    lines = got.splitlines()
    assert len(lines) == 6 and lines[0].split("\t")[2] == "1"


def test_dense_spectra_above_k12_exit_1(samples):
    tmp, _reads = samples
    args = ["single", "-k", "13", "-I", str(tmp / "s1.fa"), "-o",
            str(tmp / "never.mat")]
    assert jax_espresso(args) == 1
    assert port_espresso(args + ["--device", "cpu"]) == 1
    assert not (tmp / "never.mat").exists()


ESPRESSO_ARGS = {"single": ["-I", "r.fa", "-o", "o"],
                 "multi": ["-I", "r.fa", "-o", "o"],
                 "sparse-single": ["-G", "g", "-I", "r.fa", "-o", "o"],
                 "sparse-multi": ["-G", "g", "-I", "r.fa", "-o", "o"],
                 "query": ["-G", "g", "-I", "r.fa"],
                 "similarity": ["--matrices", "m"]}


@pytest.mark.parametrize("cmd", sorted(ESPRESSO_ARGS))
def test_every_espresso_command_defaults_to_cuda(cmd):
    assert sorted(build_app().commands) == sorted(ESPRESSO_ARGS)
    ns = build_app().build_parser().parse_args([cmd, *ESPRESSO_ARGS[cmd]])
    assert ns.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_espresso([cmd, *ESPRESSO_ARGS[cmd]])
