"""The slice as a whole: the port's CLI with ``--device cpu --num-devices 4``
against the JAX CLI, file for file.  ``build-graph -k 25 --chunk-size 4096``
(``--spectrum-cap 131072``: the default cap's 44,739,242 lanes would be
sorted on every flush on the CPU),
``trim-graph -C 2`` and ``xenome classify`` (N-free reads) against the JAX CLI
with ``--num-devices 4`` on its virtual CPU devices; ``prune-tips --iterate 2``
and ``pop-bubbles`` against the JAX CLI on one device (the JAX package's tests
hold its mesh walks equal to that; they are not run again here).
"""

import contextlib
import io
import os

import numpy as np
import pytest

from gossamer_tpu.cli.goss import build_app as jax_goss
from gossamer_tpu.cli.xenome import build_app as jax_xenome
from gossamer_tpu_torch.cli.goss import main as port_goss
from gossamer_tpu_torch.cli.xenome import main as port_xenome

ACGT = np.frombuffer(b"ACGT", np.uint8)
MESH = ["--num-devices", "4"]
COUNT = ["--chunk-size", "4096", "--spectrum-cap", str(1 << 17)]


def files(tmp, stem):
    """name -> bytes of every file a command wrote for ``stem``."""
    return {n[len(stem):]: (tmp / n).read_bytes() for n in sorted(os.listdir(tmp))
            if n.startswith(stem + ".") or n.startswith(stem + "-")}


def noisy_fasta(path, rng, genome, n, length=80, sub_rate=0.01):
    starts = rng.integers(0, len(genome) - length, n)
    reads = np.lib.stride_tricks.sliding_window_view(genome, length)[starts].copy()
    flip = rng.random(n) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    sub = rng.random(reads.shape) < sub_rate
    reads[sub] = (reads[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    path.write_text("".join(f">r{i}\n{ACGT[r].tobytes().decode()}\n"
                            for i, r in enumerate(reads)))


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_cli")
    rng = np.random.default_rng(2026)
    noisy_fasta(tmp / "reads.fa", rng, rng.integers(0, 4, 3000), 700)
    return tmp


def run_both(tmp, name, args, jax_args, jax_app=jax_goss, port=port_goss):
    assert jax_app().main([*args, *jax_args, "-O", str(tmp / f"{name}_j")]) == 0
    assert port([*args, *MESH, "--device", "cpu",
                 "-O", str(tmp / f"{name}_p")]) == 0
    fj, fp = files(tmp, f"{name}_j"), files(tmp, f"{name}_p")
    assert fj == fp and ".header" in fp, name
    return str(tmp / f"{name}_p")


def test_cleanup_chain_matches_jax(graphs):
    tmp = graphs
    g = run_both(tmp, "g", ["build-graph", "-k", "25", "-I",
                            str(tmp / "reads.fa"), *COUNT], MESH)
    t = run_both(tmp, "t", ["trim-graph", "-G", g, "-C", "2"], MESH)
    p = run_both(tmp, "p", ["prune-tips", "-G", t, "--iterate", "2"], [])
    b = run_both(tmp, "b", ["pop-bubbles", "-G", p], [])
    sizes = [len(files(tmp, s)[".edges-lo"]) for s in ("g_p", "t_p", "p_p", "b_p")]
    assert sizes[0] > sizes[1] > sizes[2] > sizes[3], sizes  # each removed some
    del b


def test_build_kmer_set_matches_jax(graphs):
    tmp = graphs
    run_both(tmp, "ks", ["build-kmer-set", "-k", "21", "-I",
                         str(tmp / "reads.fa"), *COUNT], MESH)


def test_xenome_classify_matches_jax(graphs):
    tmp = graphs
    rng = np.random.default_rng(5)
    graft, host = rng.integers(0, 4, 2500), rng.integers(0, 4, 2500)
    host[:300] = graft[:300]
    (tmp / "graft.fa").write_text(f">g\n{ACGT[graft].tobytes().decode()}\n")
    (tmp / "host.fa").write_text(f">h\n{ACGT[host].tobytes().decode()}\n")
    reads = []
    for i in range(400):
        src = (graft, host, rng.integers(0, 4, 200))[i % 3]
        p = int(rng.integers(0, len(src) - 60))
        reads.append(ACGT[src[p : p + 60]].tobytes().decode())
    (tmp / "x.fa").write_text("".join(f">x{i}\n{s}\n" for i, s in enumerate(reads)))
    assert port_xenome(["index", "-K", "17", "-G", str(tmp / "graft.fa"), "-H",
                        str(tmp / "host.fa"), "-P", str(tmp / "idx"),
                        "--device", "cpu"]) == 0
    outs = []
    for app, extra, stem in ((jax_xenome().main, [], "cj"),
                             (port_xenome, ["--device", "cpu"], "cp")):
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            assert app(["classify", "-P", str(tmp / "idx"), "-i",
                        str(tmp / "x.fa"), "--output-filename-prefix",
                        str(tmp / stem), *MESH, *extra]) == 0
        outs.append((stdout.getvalue(), files(tmp, stem + "_graft"),
                     files(tmp, stem + "_host"), files(tmp, stem + "_both")))
    assert outs[0] == outs[1]
    assert outs[1][1] and outs[1][2]  # reads of each class were written
