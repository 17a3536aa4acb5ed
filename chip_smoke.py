#!/usr/bin/env python3
"""Smoke run of the PyTorch port of ``goss build-graph`` on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and the versions.
2. Builds the port's native code from this checkout: ``csrc/fold.cu`` with
   nvcc and ``native/gossio.cpp`` with g++ (into ``gossamer_tpu_torch/_build``).
3. Kernel phase: the merge-fold kernel against its plain PyTorch version on
   the card, exactly, on edge cases and at the path's shape (a 22M-key
   spectrum at the CLI's default cap and a batch of 8 x 2^22 lanes), both
   timed with CUDA events.
4. Slice phase: a seeded E. coli-scale read set (4.6 Mbp random genome, 30x
   coverage of 100 bp reads, 0.5% substitutions, a few reads with N) goes
   through the port's CLI, ``build-graph -k 25 --device cuda``.  The graph
   must hold 2 x the valid 26-mer windows counted on the host, be closed
   under reverse complement, equal the same count with the plain fold, and,
   on the first 20k reads, equal a numpy oracle.
5. Prints one JSON line per kernel, then ``{"ok": true, "device": ...}``.

Any failed check raises, and the script exits non-zero.  Without CUDA it
exits 2 before running anything.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RHO = 26  # build-graph -k 25
CAP = (2 << 30) // 48  # the CLI's default cap (-B 2): 44,739,242 keys
CHUNK = 1 << 22
BATCH = 8


def check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")
    print(f"  ok: {what}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


# ------------------------------------------------------------ kernel phase
def time_ms(fn, reps: int = 10) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fold_pair(a, ac, b, bc, cap):
    """(kernel result, plain result, max abs difference) on the card."""
    import torch

    from gossamer_tpu_torch.ops.fold import merge_fold, merge_fold_reference

    got = merge_fold(a, ac, b, bc, cap)
    want = merge_fold_reference(a, ac, b, bc, cap)
    torch.cuda.synchronize()
    err = max(int((g - w).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    return got, want, err


def kernel_phase(dev, smi: str) -> dict:
    import torch

    from gossamer_tpu_torch.ops import fold

    SENT = fold.SENT
    rng = np.random.default_rng(1)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev)

    def spectrum(keys, total):
        keys = np.unique(keys)
        k = np.full(total, SENT, np.int64)
        c = np.zeros(total, np.int64)
        k[: len(keys)] = keys
        c[: len(keys)] = rng.integers(1, 1 << 32, len(keys))
        return t(k), t(c)

    def batch(keys, total):
        k = np.full(total, SENT, np.int64)
        k[: len(keys)] = np.sort(keys)
        return t(k), t(k != SENT)

    sk = np.unique(rng.integers(0, 1 << 50, 30000))
    cases = {
        "group spanning block boundaries": (
            *spectrum(rng.integers(0, 1 << 20, 4000), 4096),
            *batch(np.full(9000, 777), 10000), 20000),
        "one key, count wraps mod 2^32": (
            t(np.full(40000, 42)), t(np.full(40000, 1 << 20)),
            t(np.full(50000, 42)), t(np.ones(50000)), 1000),
        "empty batch (0 lanes)": (
            *spectrum(rng.integers(0, 1 << 50, 3000), 4096),
            t([]), t([]), 4096),
        "empty batch (all sentinel)": (
            *spectrum(rng.integers(0, 1 << 50, 3000), 4096),
            *batch(np.zeros(0, np.int64), 5000), 4096),
        "spectrum at exactly cap": (
            t(sk), t(rng.integers(1, 1000, len(sk))),
            *batch(sk[rng.integers(0, len(sk), 20000)], 20000), len(sk)),
        "live > cap": (
            t(sk), t(rng.integers(1, 1000, len(sk))),
            *batch(rng.integers(0, 1 << 50, 20000), 20000), len(sk)),
    }
    worst = 0
    for name, (a, ac, b, bc, cap) in cases.items():
        got, want, err = fold_pair(a, ac, b, bc, cap)
        check(err == 0, f"kernel == plain, {name} (live {int(got[2])}, "
                        f"cap {cap})")
        worst = max(worst, err)

    # the path's shape: the spectrum at the default cap holding 22M keys;
    # a batch of 8 x 2^22 lanes, ~3/4 valid (read separators), most keys
    # already in the spectrum
    g = torch.Generator(device=dev).manual_seed(2)
    keys = torch.unique(torch.randint(0, 1 << 52, (22_000_000,), device=dev,
                                      generator=g))
    a = torch.full((CAP,), SENT, dtype=torch.int64, device=dev)
    a[: keys.numel()] = keys
    ac = torch.zeros(CAP, dtype=torch.int64, device=dev)
    ac[: keys.numel()] = torch.randint(1, 1000, (keys.numel(),), device=dev,
                                       generator=g)
    nb = BATCH * CHUNK
    n_valid = nb * 3 // 4
    old = keys[torch.randint(0, keys.numel(), (n_valid * 4 // 5,), device=dev,
                             generator=g)]
    new = torch.randint(0, 1 << 52, (n_valid - old.numel(),), device=dev,
                        generator=g)
    b = torch.full((nb,), SENT, dtype=torch.int64, device=dev)
    b[:n_valid] = torch.sort(torch.cat([old, new])).values
    bc = (b != SENT).to(torch.int64)
    got, _want, err = fold_pair(a, ac, b, bc, CAP)
    check(err == 0, f"kernel == plain at the path's shape: A {CAP} lanes "
                    f"({keys.numel()} keys), B {nb} lanes, live {int(got[2])}")
    worst = max(worst, err)

    def run_kernel():
        fold.merge_fold(a, ac, b, bc, CAP)

    def run_plain():
        fold.merge_fold_reference(a, ac, b, bc, CAP)

    def run_launch():
        fold._launch(a, ac, b, bc, CAP)

    plain = [time_ms(run_plain)]
    kern = [time_ms(run_kernel), time_ms(run_kernel)]
    plain.append(time_ms(run_plain))
    launch_ms = time_ms(run_launch)
    ms, plain_ms = min(kern), min(plain)
    gbytes = 3 * (CAP + nb) * 16 / 1e9
    print(f"merge_fold at A={CAP} B={nb} lanes on {smi}: wrapper "
          f"{ms:.3f} ms (runs {kern}), kernel launch alone {launch_ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms (runs {plain}); ~{gbytes:.2f} GB moved "
          f"-> {gbytes / (launch_ms / 1e3):.0f} GB/s", flush=True)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


# ------------------------------------------------------------- slice phase
def make_reads(rng, genome_len=4_600_000, coverage=30, read_len=100,
               sub_rate=0.005, n_with_n=200):
    """Codes (0-3, 4 = N) of a seeded read set: uint8[n_reads, read_len]."""
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    n = genome_len * coverage // read_len
    starts = rng.integers(0, genome_len - read_len, n)
    reads = np.lib.stride_tricks.sliding_window_view(genome, read_len)[starts]
    flip = rng.random(n) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    n_sub = rng.binomial(reads.size, sub_rate)
    pos = rng.integers(0, reads.size, n_sub)
    flat = reads.reshape(-1)
    flat[pos] = (flat[pos] + rng.integers(1, 4, n_sub, dtype=np.uint8)) % 4
    rows = rng.choice(n, n_with_n, replace=False)
    reads[rows, rng.integers(0, read_len, n_with_n)] = 4
    return reads


def write_fasta(path: str, reads: np.ndarray) -> None:
    n, length = reads.shape
    rec = np.empty((n, 10 + length + 1), np.uint8)
    rec[:, 0:2] = np.frombuffer(b">r", np.uint8)
    idx = np.arange(n)
    for j in range(7):
        rec[:, 2 + j] = ord("0") + (idx // 10 ** (6 - j)) % 10
    rec[:, 9] = ord("\n")
    rec[:, 10 : 10 + length] = np.frombuffer(b"ACGTN", np.uint8)[reads]
    rec[:, -1] = ord("\n")
    rec.tofile(path)


def valid_windows(reads: np.ndarray, rho: int) -> int:
    per_read = reads.shape[1] - rho + 1
    has_n = np.nonzero((reads == 4).any(axis=1))[0]
    bad = (reads[has_n] == 4).astype(np.int32)
    cs = np.concatenate([np.zeros((len(has_n), 1), np.int32),
                         np.cumsum(bad, axis=1)], axis=1)
    ok = (cs[:, rho:] - cs[:, : per_read]) == 0
    return len(reads) * per_read - (len(has_n) * per_read - int(ok.sum()))


def oracle_spectrum(reads: np.ndarray, rho: int):
    """Both orientations of every valid window, counted with np.unique."""
    keys = []
    for seq in (reads, 3 - reads[:, ::-1]):
        win = np.lib.stride_tricks.sliding_window_view(seq, rho, axis=1)
        k = np.zeros(win.shape[:2], np.uint64)
        for j in range(rho):
            k = (k << np.uint64(2)) | (win[..., j] & 3).astype(np.uint64)
        keys.append(k[(win < 4).all(axis=2)])
    return np.unique(np.concatenate(keys), return_counts=True)


def read_graph(base: str):
    from gossamer_tpu_torch.graph.graph import Graph
    from gossamer_tpu_torch.io.factory import PhysicalFileFactory

    g = Graph.read(base, PhysicalFileFactory())
    return g.lo, g.counts.astype(np.int64)


def run_build_graph(fasta: str, out: str, log: str, dev) -> tuple[float, str]:
    from gossamer_tpu_torch.cli.goss import main as goss

    t0 = time.perf_counter()
    rc = goss(["build-graph", "-k", str(RHO - 1), "-I", fasta, "-O", out,
               "--device", str(dev), "-l", log])
    wall = time.perf_counter() - t0
    check(rc == 0, f"build-graph exit code 0 ({out})")
    with open(log) as f:
        return wall, f.read()


def slice_phase(dev, smi: str, tmp: str) -> int:
    import torch

    from gossamer_tpu_torch.core import kmer as K
    from gossamer_tpu_torch.ops import fold
    from gossamer_tpu_torch.ops.count import count_rho_mers_files

    t0 = time.perf_counter()
    reads = make_reads(np.random.default_rng(2026))
    fasta = os.path.join(tmp, "reads.fa")
    write_fasta(fasta, reads)
    n_windows = valid_windows(reads, RHO)
    print(f"read set: {len(reads)} reads x {reads.shape[1]} bp, "
          f"{os.path.getsize(fasta)} B FASTA, {n_windows} valid {RHO}-mer "
          f"windows; made in {time.perf_counter() - t0:.1f} s", flush=True)

    torch.cuda.reset_peak_memory_stats(dev)
    fold.merge_fold.launches = 0
    wall, log = run_build_graph(fasta, os.path.join(tmp, "g"),
                                os.path.join(tmp, "g.log"), dev)
    launches = fold.merge_fold.launches
    peak = torch.cuda.max_memory_allocated(dev)
    print(log, end="", flush=True)
    check(launches > 0, f"merge_fold kernel launched {launches} times in "
                        f"build-graph")
    check("\treader: native" in log, "the native reader was used")
    lo, counts = read_graph(os.path.join(tmp, "g"))
    inserted = int(counts.sum())
    check(inserted == 2 * n_windows,
          f"sum of counts {inserted} == 2 x {n_windows} valid windows")
    rlo, _ = K.reverse_complement(lo, np.zeros_like(lo), RHO)
    order = np.argsort(rlo)
    check(np.array_equal(rlo[order], lo) and np.array_equal(counts[order], counts),
          f"spectrum of {len(lo)} edges closed under reverse complement")

    phases = json.loads(log.split("phases (s) ")[1].splitlines()[0])
    count_s = sum(phases.values())
    print(f"build-graph -k {RHO - 1} on {smi}: {inserted} rho-mers, "
          f"{len(lo)} distinct, wall {wall:.3f} s, count {count_s:.3f} s "
          f"-> {inserted / count_s:.0f} rho-mers/s counted, "
          f"{inserted / wall:.0f} rho-mers/s end to end; phases {phases}; "
          f"peak device memory {peak / 2**30:.2f} GiB", flush=True)

    t0 = time.perf_counter()
    plo, _phi, pc = count_rho_mers_files(
        [fasta], RHO, both_strands=True, canonical=False, device=dev,
        chunk=CHUNK, cap_entries=CAP, threads=4, fold=False)
    plain_s = time.perf_counter() - t0
    check(np.array_equal(plo, lo) and np.array_equal(pc, counts),
          f"spectrum == the plain-fold count on the same card "
          f"({plain_s:.3f} s for its count)")

    head = reads[:20000]
    small = os.path.join(tmp, "head.fa")
    write_fasta(small, head)
    run_build_graph(small, os.path.join(tmp, "h"), os.path.join(tmp, "h.log"),
                    dev)
    hlo, hc = read_graph(os.path.join(tmp, "h"))
    olo, oc = oracle_spectrum(head, RHO)
    check(np.array_equal(hlo, olo) and np.array_equal(hc, oc),
          f"first 20k reads: {len(hlo)} edges == numpy oracle")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from gossamer_tpu_torch.io import native
    from gossamer_tpu_torch.ops import fold

    dev = torch.device("cuda", 0)
    smi = card_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}",
          flush=True)

    shutil.rmtree(fold.BUILD_DIR, ignore_errors=True)
    _so, nvcc_s, ptxas = fold.build_kernel_library()
    _so, gxx_s = native.build_library()
    print(f"build: nvcc csrc/fold.cu {nvcc_s:.3f} s, g++ libgossio.so "
          f"{gxx_s:.3f} s", flush=True)
    print("\n".join(line for line in ptxas.splitlines()
                    if "registers" in line), flush=True)

    stats = kernel_phase(dev, smi)
    with tempfile.TemporaryDirectory() as tmp:
        launches = slice_phase(dev, smi, tmp)

    print(json.dumps({"kernels": [{
        "name": "merge_fold", "route": "cuda",
        "source": "gossamer_tpu_torch/csrc/fold.cu",
        "replaces": "gossamer_tpu/ops/pallas_fold.py:151",
        "launches": launches, **stats}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
