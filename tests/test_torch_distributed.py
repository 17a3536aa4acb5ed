"""Several processes in the port (``parallel/distributed.py``): the file
partition, the CLI hook, and a real two-process run over ``gloo`` (2 CPU
shards each, a 4-shard mesh; ``tests/torch_dist_worker.py``) whose count,
degrees, trim mask, prune-tips walk, segment table and classifiers must equal the JAX
package's single-device engine and host passes, on both processes.  The
CLI's ``--coordinator`` route in two processes must write the JAX CLI's
graph.  The counterpart of ``tests/test_distributed.py``.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from gossamer_tpu_torch.parallel import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_two(argv_of, timeout=240):
    """Start two processes (``argv_of(pid)``) and wait for both."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(argv_of(p), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for p in range(2)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, (o.decode()[-500:], e.decode()[-3000:])


def test_partition_files_round_robin():
    paths = [f"f{i}" for i in range(10)]
    shares = [distributed.partition_files(paths, p, 3) for p in range(3)]
    assert sorted(sum(shares, [])) == sorted(paths)
    assert all(len(s) in (3, 4) for s in shares)
    assert len(set(sum(shares, []))) == 10


def test_configure_noop_without_coordinator():
    class O:
        coordinator = None

    files = [("a.fa", "fasta"), ("b.fa", "fasta")]
    assert distributed.configure(O(), files, "cpu") == (files, None)


def test_configure_initializes_and_partitions(monkeypatch):
    calls = {}
    monkeypatch.setattr(distributed, "initialize",
                        lambda **kw: calls.update(kw))

    class O:
        coordinator = "host0:9981"
        num_processes = 2
        process_id = 1

    files = [(f"f{i}.fa", "fasta") for i in range(5)]
    logs = []
    got, n = distributed.configure(O(), files, "cpu",
                                   log=lambda lvl, m: logs.append(m))
    assert calls == dict(coordinator="host0:9981", num_processes=2,
                         process_id=1, device="cpu")
    assert [f for f, _ in got] == ["f1.fa", "f3.fa"]
    assert n == 2  # one CPU shard a process by default
    assert logs and "distributed" in logs[0]


def test_initialize_needs_the_process_count():
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize("127.0.0.1:1", 0, 0)


def test_initialize_without_a_device_needs_cuda(monkeypatch):
    import torch
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        distributed.initialize(f"127.0.0.1:{free_port()}", 2, 0)
    assert not dist.is_initialized()


def test_one_process_without_a_group():
    assert distributed.process_count() == 1 and distributed.process_index() == 0
    mesh = distributed.global_mesh("cpu", n_local=3)
    assert mesh.size == 3 and not mesh.distributed


def test_two_process_sharded_run(tmp_path):
    worker = os.path.join(REPO, "tests", "torch_dist_worker.py")
    port = str(free_port())
    run_two(lambda p: [sys.executable, worker, str(p), "2", port, str(tmp_path)])
    a, b = (np.load(tmp_path / f"out_{p}.npz") for p in (0, 1))
    for key in a.files:
        assert np.array_equal(a[key], b[key]), key

    from gossamer_tpu.algo.cleanup import prune_tips
    from gossamer_tpu.classify.device import classify_codes_device, encode_set
    from gossamer_tpu.core import kmer as K
    from gossamer_tpu.graph.graph import Graph
    from gossamer_tpu.graph.segments import decompose
    from gossamer_tpu.io.stream import pack_chunk
    from gossamer_tpu.ops.engine import SpectrumEngine
    from gossamer_tpu.ops.engine_wide import SpectrumEngineWide
    import jax.numpy as jnp

    rho, chunk = 13, 256
    rng = np.random.default_rng(77)
    chunks = [rng.integers(0, 4, chunk + rho - 1, dtype=np.uint8)
              for _ in range(9)]
    eng = SpectrumEngine(rho, "value", chunk, batch=2, cap=1 << 14, spill=False)
    for c in chunks:
        eng.add_chunk_packed(*pack_chunk(c, rho, chunk))
    lo, _hi, cnt = eng.finish_expanded()
    assert np.array_equal(a["lo"], lo) and np.array_equal(a["cnt"], cnt)

    wrho = 33
    weng = SpectrumEngineWide(wrho, "plain", chunk, cap=1 << 14)
    for c in chunks:
        weng.add_chunk(np.concatenate([c, c[: wrho - rho]]))
    wlo, whi, wcnt = weng.finish()
    assert np.array_equal(a["wlo"], wlo) and np.array_equal(a["whi"], whi)
    assert np.array_equal(a["wcnt"], wcnt)

    g = Graph(rho - 1, lo, np.zeros_like(lo), cnt)
    flo, fhi = g.from_node(g.lo, g.hi)
    assert np.array_equal(a["out_d"], np.asarray(g.out_degree(flo, fhi)))
    assert np.array_equal(a["in_d"], np.asarray(g.in_degree(flo, fhi)))
    assert np.array_equal(a["keep"], cnt >= 2) and a["kept"] == (cnt >= 2).sum()
    want = prune_tips(g, iterations=2)
    assert np.array_equal(np.asarray(g.remove_edges(a["dead"]).lo),
                          np.asarray(want.lo))
    dec = decompose(g)
    nc = ~dec.cyclic
    assert np.array_equal(a["cyclic"], dec.cyclic)
    assert np.array_equal(a["head"][nc], dec.start[nc])
    assert np.array_equal(a["pos"][nc], dec.pos[nc])

    k = rho - 1
    nodes = np.unique(lo >> np.uint64(2))
    nlo, _nhi, _ = K.normalize(nodes, np.zeros_like(nodes), k)
    uniq = np.unique(nlo)
    set_E = np.sort(encode_set(uniq, np.arange(len(uniq)) % 2 == 0,
                               np.arange(len(uniq)) % 3 == 0))
    rng2 = np.random.default_rng(5)
    reads = [chunks[i % 9][s : s + 40] for i, s in
             enumerate(rng2.integers(0, chunk - 40, 23))]
    want = np.asarray(classify_codes_device(reads, jnp.asarray(set_E), k,
                                            window=1 << 12))
    assert np.array_equal(a["blrg"], want) and np.array_equal(a["ring"], want)
    assert want.max() > 0


def test_two_process_build_graph_cli(tmp_path):
    """build-graph --coordinator in two processes, 2 CPU shards each, over
    three files split 2 + 1: each process writes the JAX CLI's graph."""
    from gossamer_tpu.cli.goss import build_app as jax_app

    rng = np.random.default_rng(31)
    genome = rng.integers(0, 4, 2000)
    names = []
    for f in range(3):
        path = tmp_path / f"r{f}.fa"
        with open(path, "w") as out:
            for i in range(60 + 30 * f):
                p = int(rng.integers(0, len(genome) - 70))
                out.write(f">r{f}_{i}\n"
                          + "".join("ACGT"[c] for c in genome[p : p + 70]) + "\n")
        names += ["-I", str(path)]
    # a small cap: the default's 44,739,242 lanes a shard would be sorted
    # on every flush on the CPU
    count = ["--chunk-size", "1024", "--spectrum-cap", str(1 << 16)]
    port = str(free_port())
    run_two(lambda p: [
        sys.executable, "-m", "gossamer_tpu_torch.cli.goss", "build-graph",
        "-k", "21", *names, "-O", str(tmp_path / f"g{p}"), *count,
        "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
        "--process-id", str(p), "--num-devices", "4", "--device", "cpu"])
    assert jax_app().main(["build-graph", "-k", "21", *names, "-O",
                           str(tmp_path / "gj"), *count]) == 0
    for suffix in (".header", ".edges-lo", ".counts", "-counts-hist.txt"):
        want = (tmp_path / f"gj{suffix}").read_bytes()
        for p in (0, 1):
            assert (tmp_path / f"g{p}{suffix}").read_bytes() == want, suffix
