"""``electus`` of the PyTorch port against the JAX package
(``tests/test_electus.py`` is the shape): ``RefMaskSet.build``, the device
masks == the host masks == the JAX package's at k = 25 (narrow) and k = 40
(wide: the JAX package drops to the host there, the port stays on the
device), with 1, 2, 3 and 5 references (odd counts leave the last pass
half empty); ``electus index`` + ``classify`` files and the statistics line
byte for byte against the JAX CLI, single reads and ``--pairs``.  Exact.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gossamer_tpu.classify import electus as je
from gossamer_tpu.cli.electus import build_app as jax_app
from gossamer_tpu.graph.kmer_set import KmerSet as JaxKmerSet
from gossamer_tpu_torch.classify import electus as te
from gossamer_tpu_torch.cli.electus import main as port_main
from gossamer_tpu_torch.graph.build import build_kmer_set
from gossamer_tpu_torch.io.readers import Read

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module", params=[25, 40], ids=["k25", "k40"])
def world(request):
    """Five 3 kbp references sharing a 200 bp piece, their k-mer sets, and
    ~300 N-free reads (some spanning into the shared piece)."""
    k = request.param
    rng = np.random.default_rng(17)
    shared = rng.integers(0, 4, 200, dtype=np.uint8)
    genomes = [np.concatenate([rng.integers(0, 4, 2800, dtype=np.uint8), shared])
               for _ in range(5)]
    sets = [build_kmer_set([Read("g", ACGT[g].tobytes())], k, device=CPU,
                           chunk=4096)[0] for g in genomes]
    reads = []
    for i in range(300):
        g = genomes[i % 5]
        s = int(rng.integers(0, len(g) - 90))
        r = g[s : s + 90].copy()
        if i % 3 == 0:
            r = (3 - r[::-1]).astype(np.uint8)
        reads.append(r)
    reads.append(rng.integers(0, 4, 90, dtype=np.uint8))
    return k, sets, reads


@pytest.mark.parametrize("n_refs", [1, 2, 3, 5])
def test_masks_device_host_and_jax_agree(world, n_refs):
    k, sets, reads = world
    refs = te.RefMaskSet.build(sets[:n_refs])
    jrefs = je.RefMaskSet.build([JaxKmerSet(k, s.lo, s.hi)
                                 for s in sets[:n_refs]])
    assert np.array_equal(refs.mask, jrefs.mask)
    assert np.array_equal(refs.union.lo, jrefs.union.lo)
    assert np.array_equal(refs.union.hi, jrefs.union.hi)
    want = je.read_masks(reads, jrefs)
    host = te.read_masks(reads, refs)
    got = te.read_masks_device(reads, refs, CPU)
    assert got.dtype == np.uint64
    assert np.array_equal(host, want) and np.array_equal(got, want)
    assert int(want.max()).bit_length() == n_refs
    if k <= 30:
        assert np.array_equal(je.read_masks_device(reads, jrefs), got)
    if n_refs > 1:  # reads inside the shared piece hit every reference
        assert (te.popcount64(got) == n_refs).any()


def test_masks_with_n_stay_in_their_read(world):
    k, sets, reads = world
    refs = te.RefMaskSet.build(sets[:3])
    seqs = [r.copy() for r in reads[:40]]
    for i, s in enumerate(seqs):
        s[(7 * i) % len(s)] = 255
    got = te.read_masks_device(seqs, refs, CPU)
    assert np.array_equal(got, te.read_masks(seqs, refs))
    # each read on its own gives the same mask
    alone = np.concatenate([te.read_masks([s], refs) for s in seqs])
    assert np.array_equal(got, alone) and got.any()


def test_bit_63_and_the_limit_of_64_references():
    ks = build_kmer_set([Read("g", b"ACGTTGCAAGGCTTAACCGGATAT")], 9,
                        device=CPU, chunk=4096)[0]
    refs = te.RefMaskSet.build([ks] * 64)
    assert refs.mask.dtype == np.uint64 and int(refs.mask[0]) == 2**64 - 1
    assert te.popcount64(refs.mask)[0] == 64
    with pytest.raises(ValueError, match="at most 64"):
        te.RefMaskSet.build([ks] * 65)


@pytest.fixture(scope="module", params=[15, 40], ids=["K15", "K40"])
def cli_world(request, tmp_path_factory):
    k = request.param
    tmp = tmp_path_factory.mktemp(f"electus{k}")
    rng = np.random.default_rng(21)
    shared = rng.integers(0, 4, 120)
    refs = [np.concatenate([rng.integers(0, 4, 400), shared]) for _ in range(3)]
    for i, g in enumerate(refs):
        (tmp / f"ref{i}.fa").write_text(f">ref{i}\n{ACGT[g].tobytes().decode()}\n")
    seqs = []
    for i in range(60):
        src = refs[i % 3] if i % 4 > 1 else rng.integers(0, 4, 200)
        p = int(rng.integers(0, len(src) - 80))
        seqs.append(ACGT[src[p : p + 80]].tobytes().decode())
    for name, part in (("reads.fa", seqs), ("r1.fa", seqs[0::2]),
                       ("r2.fa", seqs[1::2])):
        (tmp / name).write_text("".join(f">r{i}\n{s}\n"
                                        for i, s in enumerate(part)))
    args = ["index", "-K", str(k)]
    for i in range(3):
        args += ["-I", str(tmp / f"ref{i}.fa")]
    assert jax_app().main(args + ["-P", str(tmp / "ij")]) == 0
    assert port_main(args + ["-P", str(tmp / "it"), "--device", "cpu"]) == 0
    return tmp, k


def test_electus_index_files_match_jax_cli(cli_world):
    tmp, _k = cli_world
    names = sorted(n[2:] for n in os.listdir(tmp) if n.startswith("ij."))
    assert names == sorted(n[2:] for n in os.listdir(tmp) if n.startswith("it."))
    assert len(names) == 3 * 3 + 1
    for suffix in names:
        a = (tmp / ("ij" + suffix)).read_bytes()
        b = (tmp / ("it" + suffix)).read_bytes()
        if suffix == ".refs":  # the JSON names the sets by their own prefix
            b = b.replace(str(tmp / "it").encode(), str(tmp / "ij").encode())
        assert a == b, suffix


@pytest.mark.parametrize("mode,threshold", [("single", 1), ("single", 2),
                                            ("pairs", 1), ("pairs", 3)])
def test_electus_classify_outputs_match_jax_cli(cli_world, mode, threshold):
    tmp, _k = cli_world
    inputs = (["-I", str(tmp / "reads.fa")] if mode == "single" else
              ["--pairs", "-I", str(tmp / "r1.fa"), "-I", str(tmp / "r2.fa")])
    outs = []
    for main, idx, tag, extra in ((jax_app().main, "ij", "j", []),
                                  (port_main, "it", "t", ["--device", "cpu"])):
        m, n = (str(tmp / f"{mode}{threshold}-{tag}-{x}") for x in "mn")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["classify", "-P", str(tmp / idx), *inputs,
                         "--ref-threshold", str(threshold),
                         "--match-prefix", m, "--non-match-prefix", n,
                         *extra]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    n_match, n_non, total = map(int, outs[1].split())
    assert total == n_match + n_non == (60 if mode == "single" else 30)
    assert n_non and (n_match or threshold == 3)
    halves = ("_1", "_2") if mode == "pairs" else ("",)
    for x in "mn":
        for half in halves:
            jf = tmp / f"{mode}{threshold}-j-{x}{half}.fasta"
            tf = tmp / f"{mode}{threshold}-t-{x}{half}.fasta"
            assert tf.read_bytes() == jf.read_bytes()


def test_port_electus_runs_with_jax_blocked(cli_world):
    tmp, k = cli_world
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gossamer_tpu'] = None\n"
        "from gossamer_tpu_torch.cli.electus import main\n"
        f"p = {str(tmp / 'ib')!r}\n"
        f"assert main(['index', '-K', '{k}', '-I', {str(tmp / 'ref0.fa')!r}, "
        f"'-I', {str(tmp / 'ref1.fa')!r}, '-P', p, '--device', 'cpu']) == 0\n"
        f"rc = main(['classify', '-P', p, '-I', {str(tmp / 'reads.fa')!r}, "
        "'--dont-write-reads', '--device', 'cpu'])\n"
        "assert not [m for m, v in sys.modules.items() if v is not None "
        "and m.split('.')[0] in ('jax', 'jaxlib', 'gossamer_tpu')]\n"
        "raise SystemExit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert (tmp / "ib.refs").exists()
