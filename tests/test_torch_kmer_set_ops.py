"""The port's k-mer set algebra (``classify/annotated_set.py`` set ops,
``cmds/kmer_set_ops.py``) against the JAX package's.

Three seeded references (two share a 200 bp segment, the second's copy
with point substitutions, so that ``compute-near-kmers`` finds marginal
k-mers; the third shares a piece of the first) become k-mer sets through
the port's ``build-kmer-set`` at k = 15 and k = 40.  ``merge-kmer-sets``,
``intersect-kmer-sets``, ``subtract-kmer-set``,
``merge-and-annotate-kmer-sets`` and ``compute-near-kmers`` (in place) run
in both CLIs: the files must be byte-identical, and the sets equal numpy's
``union1d`` / ``intersect1d`` / ``setdiff1d`` of the keys.
"""

import numpy as np
import pytest

from gossamer_tpu.classify import annotated_set as jann
from gossamer_tpu.cli.goss import main as jax_main
from gossamer_tpu.graph.kmer_set import KmerSet as JKmerSet
from gossamer_tpu_torch.classify import annotated_set as pann
from gossamer_tpu_torch.cli.goss import main as port_main
from gossamer_tpu_torch.graph.kmer_set import KmerSet
from gossamer_tpu_torch.io.factory import PhysicalFileFactory

from test_torch_contigs import files, run_jax, run_port

KS = {"narrow": 15, "wide": 40}
FAC = PhysicalFileFactory()


def keys128(ks) -> np.ndarray:
    """A set's keys as one sortable Python-int array."""
    return np.array([(int(h) << 64) | int(l) for l, h in zip(ks.lo, ks.hi)],
                    dtype=object)


def write_ref(path, codes):
    path.write_text(">ref\n" + "".join("ACGT"[c] for c in codes) + "\n")


@pytest.fixture(scope="module", params=list(KS))
def sets(request, tmp_path_factory):
    """(tmp, k, {name: set base}) for the three references."""
    k = KS[request.param]
    tmp = tmp_path_factory.mktemp(f"ksops{k}")
    rng = np.random.default_rng(17)
    a, b = (rng.integers(0, 4, 700, dtype=np.uint8) for _ in range(2))
    seg = rng.integers(0, 4, 200, dtype=np.uint8)
    a[100:300] = seg
    b[100:300] = seg
    b[[130, 190, 250]] = (b[[130, 190, 250]] + 1) % 4
    c = np.concatenate([a[400:600], rng.integers(0, 4, 300, dtype=np.uint8)])
    bases = {}
    for name, codes in (("a", a), ("b", b), ("c", c)):
        write_ref(tmp / f"{name}.fa", codes)
        bases[name] = str(tmp / name)
        run_port(["build-kmer-set", "-k", str(k), "-I", str(tmp / f"{name}.fa"),
                  "-O", bases[name], "--chunk-size", "4096"])
    return tmp, k, bases


@pytest.mark.parametrize("kind", list(KS))
@pytest.mark.parametrize("op", ["merge", "intersect", "subtract"])
def test_set_algebra_matches_jax_and_numpy(kind, op):
    k = KS[kind]
    rng = np.random.default_rng(3)
    made = []
    for n in (400, 300):
        lo = rng.integers(0, 1 << 12, n).astype(np.uint64)
        hi = (rng.integers(0, 4, n).astype(np.uint64) if k > 31
              else np.zeros(n, np.uint64))
        lo, hi = pann._as_sorted_unique(lo, hi)
        made.append((lo, hi))
    p = [KmerSet(k, lo, hi) for lo, hi in made]
    j = [JKmerSet(k, lo.copy(), hi.copy()) for lo, hi in made]
    if op == "merge":
        got, want = pann.merge_sets(p + p[:1]), jann.merge_sets(j + j[:1])
    else:
        got = getattr(pann, f"{op}_sets")(*p)
        want = getattr(jann, f"{op}_sets")(*j)
    np.testing.assert_array_equal(got.lo, want.lo)
    np.testing.assert_array_equal(got.hi, want.hi)
    npop = {"merge": np.union1d, "intersect": np.intersect1d,
            "subtract": np.setdiff1d}[op]
    oracle = npop(keys128(p[0]), keys128(p[1]))
    assert keys128(got).tolist() == list(oracle) and len(oracle) > 0


@pytest.mark.parametrize("cmd,inputs,op", [
    ("merge-kmer-sets", "abc", None),
    ("intersect-kmer-sets", "ab", np.intersect1d),
    ("subtract-kmer-set", "ab", np.setdiff1d),
    ("intersect-kmer-sets", "ac", np.intersect1d),
    ("subtract-kmer-set", "ca", np.setdiff1d)])
def test_set_commands_match_jax(sets, cmd, inputs, op):
    tmp, k, bases = sets
    tag = f"{cmd.split('-')[0]}_{inputs}"
    args = [cmd, *[x for n in inputs for x in ("-G", bases[n])]]
    run_jax(args + ["-O", str(tmp / f"{tag}_j")])
    run_port(args + ["-O", str(tmp / f"{tag}_p")])
    fj, fp = files(tmp, f"{tag}_j"), files(tmp, f"{tag}_p")
    assert fj == fp and set(fp) == {".header", ".kmers-lo", ".kmers-hi"}
    keys = [keys128(KmerSet.read(bases[n], FAC)) for n in inputs]
    if op is None:
        want = np.union1d(np.union1d(keys[0], keys[1]), keys[2])
    else:
        want = op(keys[0], keys[1])
    got = KmerSet.read(str(tmp / f"{tag}_p"), FAC)
    assert got.k == k and keys128(got).tolist() == list(want)
    assert len(want) > 0


def test_merge_and_annotate_and_near_kmers_match_jax(sets):
    """merge-and-annotate-kmer-sets, then compute-near-kmers rewriting
    ``-G`` in place, in both CLIs: the same files at each step; the near
    pass clears bits, as the host numpy version does."""
    tmp, k, bases = sets
    args = ["merge-and-annotate-kmer-sets", "-G", bases["a"], "-G", bases["b"]]
    run_jax(args + ["-O", str(tmp / "ann_j")])
    run_port(args + ["-O", str(tmp / "ann_p")])
    merged = files(tmp, "ann_p")
    assert files(tmp, "ann_j") == merged
    assert {".lhs-bits", ".rhs-bits", ".kmers-lo"} <= set(merged)
    ann = pann.AnnotatedKmerSet.read(str(tmp / "ann_p"), FAC)
    union = np.union1d(keys128(KmerSet.read(bases["a"], FAC)),
                       keys128(KmerSet.read(bases["b"], FAC)))
    assert keys128(ann.kset).tolist() == list(union)
    assert (ann.lhs & ann.rhs).any() and (ann.lhs != ann.rhs).any()
    want = pann.AnnotatedKmerSet(ann.kset, ann.lhs.copy(), ann.rhs.copy())
    gray = pann.compute_near_kmers_host(want)

    run_jax(["compute-near-kmers", "-G", str(tmp / "ann_j")])
    run_port(["compute-near-kmers", "-G", str(tmp / "ann_p")])
    near = files(tmp, "ann_p")
    assert files(tmp, "ann_j") == near and near != merged
    got = pann.AnnotatedKmerSet.read(str(tmp / "ann_p"), FAC)
    assert gray > 0 and np.array_equal(got.lhs, want.lhs)
    assert np.array_equal(got.rhs, want.rhs)


def test_bad_inputs_exit_1_in_both(sets, tmp_path_factory):
    """Two -G where two are needed, and sets of differing K: exit 1 in both
    CLIs, nothing written."""
    tmp, k, bases = sets
    other = tmp_path_factory.mktemp("otherk")
    lo = np.unique(np.random.default_rng(1).integers(0, 1 << 20, 50)).astype(np.uint64)
    KmerSet(k + 2, lo, np.zeros_like(lo)).write(str(other / "x"), FAC)
    cases = [["intersect-kmer-sets", "-G", bases["a"]],
             ["subtract-kmer-set", "-G", bases["a"], "-G", bases["b"], "-G",
              bases["c"]],
             ["merge-and-annotate-kmer-sets", "-G", bases["a"]],
             ["merge-kmer-sets", "-G", bases["a"], "-G", str(other / "x")],
             ["intersect-kmer-sets", "-G", bases["a"], "-G", str(other / "x")],
             ["subtract-kmer-set", "-G", str(other / "x"), "-G", bases["a"]]]
    for i, args in enumerate(cases):
        out = str(other / f"never{i}")
        assert jax_main(args + ["-O", out]) == 1, args
        assert port_main(args + ["-O", out, "--device", "cpu"]) == 1, args
        assert not files(other, f"never{i}")
