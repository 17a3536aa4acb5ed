#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: ``goss build-graph`` (narrow
and wide keys), the assembler from that graph to contigs and to a supergraph,
the ``gossple`` pipeline end to end, ``xenome index`` + ``classify`` (narrow
and wide), ``electus index`` + ``classify``, the taxonomy commands, the
long tail of ``goss`` (set algebra, read and graph utilities, variants,
fix-reads, the supergraph exports, the reference's binary format),
``translucent`` and ``espresso``, and both hand-written kernels.

    python3 chip_smoke.py
    python3 chip_smoke.py --wide-memory   # what sizes -B for wide keys
    python3 chip_smoke.py --routes        # build-graph -k 25, engine routes

``--wide-memory`` runs only this: the peak device memory of one wide
k-merize and one wide flush at 1, 2, 4 and 8 chunks into resident spectra
of 2^22, 2^24 and 44,739,242 lanes, then ``build-graph -k 55`` of the
read set sized by ``-B 2`` now and with the cap it had before, in turns
(spills, wall, peak device memory).  ``--routes`` runs only the kernels'
builds, build-graph -k 25 (4.) and the engine routes (4b.).

1. Prints the card's name and power limit (nvidia-smi) and the versions.
2. Builds the port's native code from this checkout, all compilers started
   together: ``csrc/fold.cu`` and ``csrc/merge.cu`` with nvcc,
   ``native/gossio.cpp`` with g++ (into ``gossamer_tpu_torch/_build``).
3. Kernel phases: each kernel against its plain PyTorch version on the
   card, exactly, on edge cases and at the path's shape (the merge-fold: a
   22M-key spectrum at the CLI's default cap and a batch of 8 x 2^22
   lanes, four seeds, twice each; the merge: the same spectrum and a
   sorted batch of 8 x 2^22 lanes, the classify join's shape and the rank
   join's), both
   timed with CUDA events; the merge also against the library's way to the
   same result (a stable ``torch.sort`` of the concatenation and a gather,
   checked equal, timed).  The fold's edge cases sit on its tile
   boundaries (groups over several tiles, tiles without a group end,
   lengths one off a tile multiple, runs that start 8 bytes into a
   16-byte piece); input out of order in one run only must give
   ``live = -1``.  The merge's split pass (``merge_splits``) is held
   against its plain version on every merge case and at every shape; the
   merge's cases are the tests' (``tests/merge_cases.py``): the runs'
   edges and the kernel's own (more tiles than the card holds blocks at
   once, one tile, one to three tiles +- 1 lane, one key over many tiles),
   and every case again as views that start 8 bytes into a 16-byte
   piece.  Every path that launches the merge must launch the split pass
   too.
4. build-graph: a seeded E. coli-scale read set (4.6 Mbp random genome, 30x
   coverage of 100 bp reads, 0.5% substitutions, a few reads with N) goes
   through the port's CLI, ``build-graph -k 25 --device cuda``.  The graph
   must hold 2 x the valid 26-mer windows counted on the host, be closed
   under reverse complement, equal the same count with the plain fold, and,
   on the first 20k reads, equal a numpy oracle.
4b. Engine routes, each counted on the card with the fold kernel: raw codes
   (``build-graph -k 25 --chunk-size 4194303``: not a multiple of 16, so
   ``native_flat_chunks`` and ``add_chunk``) with files == 4.'s; the packed
   route through the engine and raw chunks of 2^20 windows with several
   spills (the whole finish on the card, its peak device memory within 48 B
   a lane of twice the runs' lanes) == 4.'s graph.  The merge kernel
   against its plain version and the library at the shapes of the finish
   on the card (each merge of spilled runs, the expansion).  In 4. the
   finish must run on the card: the log names the card for each merge and
   the expansion, and ``merge_sorted`` launches once for each.
5. Wide build-graph: the same read set, ``build-graph -k 55`` (112-bit
   keys, the wide engine: PyTorch ops, no kernel launch).  The same checks
   with 128-bit keys as two uint64; its peak device memory must stay within
   the 2 GiB of ``-B 2``; then the device time of one wide flush.
6. assembly: the ``-k 25`` graph goes through the port's CLI, ``trim-graph``
   (cutoff inferred by the coverage model), ``prune-tips --iterate 4``,
   ``pop-bubbles``, ``print-contigs --min-length 100``: host code, as in the
   JAX package on one device.  The graph must equal a numpy/``torch.unique``
   count of the whole read set and the trimmed graph that count cut at the
   logged cutoff; after each stage the graph is closed under reverse
   complement and lints clean; every 26-mer of every contig is one of the
   genome's (either strand) and the contigs hold at least 95% of them;
   ``dump-graph | restore-graph`` gives byte-identical files;
   ``build-entry-edge-set``, ``build-supergraph`` and ``print-contigs``
   again: before any threading the supergraph's contigs hold the linear
   contigs' sequences (the headers name a superpath, not a segment).
6b. gossple: a seeded 1.5 Mbp genome with 25 repeats of 60 bp and 10 of
   250 bp in 4 copies each and 10 stretches of 150 bp that no read covers;
   pairs of 100 bp reads (insert 400 +- 40, 30x, 0.5% substitutions, one
   pair in 1000 with an N) through ``gossple -k 25 -C 5 --device cuda``,
   all 11 stages; the built graph == a numpy/``torch.unique`` count; every
   N-free piece of every contig, cut at the scaffold's gaps estimated at 0
   or less, is in the genome or its reverse complement; no more contigs
   and no lower N50 than the cleaned graph's linear contigs; lint-graph
   passes; the merge-fold kernel launched; each stage's wall and peak
   device memory; thread-reads' two ways to read ends, timed.
7. xenome at bacterial scale: two seeded 4.6 Mbp references sharing a
   20 kbp segment (0.5% substitutions in the host's copy), 1M reads of
   100 bp (45% graft, 45% host, 5% the segment, 5% random; 0.5%
   substitutions; one read in 1000 with an N) through the port's CLI,
   ``xenome index -K 25`` and ``xenome classify``.  The index must equal a
   numpy oracle, the device near-k-mer pass must equal the host version on
   200 kbp prefixes, and the first 20k reads' classes a per-read oracle.
8. Wide xenome: the same references and reads, ``xenome index -K 40`` and
   ``classify`` (the wide classifier: PyTorch ops, no kernel launch), the
   same oracles with 128-bit keys.
9. electus: four seeded 4.6 Mbp references (the two above and two more),
   ``electus index -K 25`` and ``electus classify`` of 500,000 reads at
   ``--ref-threshold`` 1 and 2; the matched counts must agree with the files
   and the first 20k reads' verdicts with a numpy oracle.
10. taxonomy: the four references as four species under two genera (the two
    that share the segment under one), ``build-kmer-set -k 25`` of all four,
    ``annotate-kmers``, ``classify-reads`` of the electus phase's 500,000
    reads: the set and every k-mer's annotation must equal a numpy LCA
    oracle, the report of the first 20k reads a per-read oracle, the reads
    drawn from the shared segment must land on the genus, ``merge_sorted``
    must launch once a batch, and ``join_ranks_batch`` on the card must equal
    the same call on CPU tensors.
11. long tail, on what the earlier phases left: ``build-kmer-set -k 25`` of
    the four references (== their numpy sets), ``merge-kmer-sets``,
    ``intersect-kmer-sets``, ``subtract-kmer-set`` of the first two (==
    numpy's merge of the sorted sets),
    ``merge-and-annotate-kmer-sets`` (== numpy bits) and
    ``compute-near-kmers`` on the card (== a numpy probe of every
    substitution on 20,000 sampled k-mers), ``pool-samples`` of the four;
    on the assembly cell's graphs ``estimate-errors`` (== the numpy error
    mass), ``detect-variants`` of the raw graph against the cleaned one (==
    numpy, line for line), ``trim-paths -C 5`` of the graph trimmed at 2,
    ``build-subgraph`` of 1,000 reads at radius 1 (== numpy) and
    ``dot-graph`` of it, ``extract-reads`` of 100,000 reads and
    ``filter-reads`` of 100,000 xenome reads against the graft's set (==
    per-read oracles), ``extract-core-genome`` of three graphs (== numpy),
    ``fix-reads`` of 500 reads (reads equal to the genome before and
    after); on gossple's output ``build-edge-index``, ``dot-supergraph``,
    ``clip-links``, ``build-db`` (one row per superpath) and ``upgrade-graph
    --format reference`` read back equal; ``translucent`` build-graph (==
    a count; the fold kernel), trim-graph, trim-relative, prune-tips,
    pop-bubbles, assemble on pairs of a seeded 100-gene transcriptome
    (isoforms recovered); ``espresso`` single, multi, sparse-single, query
    (== numpy and per-read oracles) and similarity.
12. several devices (``parallel/*``) on a mesh of 4 shards, all on the one
    card (the collectives are copies within it), on what the earlier phases
    left: the 4-shard count of the whole read set (``count_rho_mers_files(...,
    mesh=...)``, the fold kernel per shard) == build-graph's files byte for
    byte; ``sharded_degrees`` of that graph == the host Graph's;
    ``sharded_trim_mask`` at the inferred cutoff, ``sharded_prune_tips_masks``
    (4 iterations) and ``pop_bubbles(mesh=)`` == the assembly phase's files;
    ``ShardedClassifier`` and ``RingClassifier`` of the first 200,000 xenome
    reads (N included) on the K 25 index == ``classify_codes_device`` (the
    merge kernel per shard); the wide 4-shard count of the 20k head == its
    ``build-graph -k 55`` with no kernel launch; ``build-graph --num-devices
    2`` exits non-zero naming the cards visible when there is one card (and
    equals the head's graph when there are two); each kernel once more at
    its per-shard shape.
13. Prints for each kernel its bound (every input byte read once and every
    output byte written once at the card's memory rate), its time, its
    share of the bound and its launches on each path, then one JSON line
    with both kernels, then ``{"ok": true, ...}``.

Each path runs with every kernel's launch count set to 0 just before it
and read just after; a kernel the path runs must have launched, and a wide
path must have launched none.  Any failed check raises, and the script
exits non-zero.  Without CUDA it exits 2 before running anything.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RHO = 26  # build-graph -k 25
WIDE_RHO = 56  # build-graph -k 55: 112-bit keys, the wide engine
XK = 25  # xenome index -K 25
WIDE_XK = 40  # xenome index -K 40: 82-bit E, the wide classifier
CAP = (2 << 30) // 48  # the CLI's default cap (-B 2): 44,739,242 keys
CHUNK = 1 << 22
BATCH = 8


STARTED = time.perf_counter()


def check(ok, what: str) -> None:
    """Raise unless ``ok``; else print ``what`` with the seconds since the
    script started (the gaps between checks are the oracles' time)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")
    print(f"  ok ({time.perf_counter() - STARTED:.1f} s): {what}", flush=True)


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


# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory
# 3.35 TB/s; 67 TFLOP/s outside the tensor cores, taken for the kernels'
# compare-and-add arithmetic.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: every input byte read once and
    every output byte written once at the memory rate, or the operations at
    the peak rate, whichever is longer."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bytes": nbytes,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def fold_bound(na: int, nb: int, cap: int) -> dict:
    """merge_fold reads 16 B a lane of A and B and writes 16 B a lane of
    the ``cap`` output lanes and ``live``; one comparison and one addition
    a merged lane."""
    return bound((na + nb + cap) * 16 + 8, 2 * (na + nb))


def merge_bound(na: int, nb: int) -> dict:
    """merge_sorted reads and writes 16 B a lane; one comparison a lane."""
    return bound(2 * (na + nb) * 16, na + nb)


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


def fold_path_inputs(dev, seed: int):
    """A and B at the shape build-graph gives the fold: the spectrum at the
    default cap holding 22M keys; a batch of 8 x 2^22 lanes, ~3/4 valid
    (read separators), most keys already in the spectrum."""
    import torch

    from gossamer_tpu_torch.ops.fold import SENT

    g = torch.Generator(device=dev).manual_seed(seed)
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
    return a, ac, b, bc, keys.numel()


def fold_edge_cases(dev, tile: int):
    """-> (cases the kernel must fold exactly like the plain version,
    cases whose input is out of order and must give live = -1); each
    {name: (a_keys, a_counts, b_keys, b_counts, cap)}.  ``tile`` is the
    kernel's tile in merged lanes."""
    import torch

    from gossamer_tpu_torch.ops.fold import SENT

    rng = np.random.default_rng(1)
    T = tile

    def t(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev)

    def spectrum(keys, total):
        keys = np.unique(keys)
        k = np.full(total, SENT, np.int64)
        c = np.zeros(total, np.int64)
        k[: len(keys)] = keys
        c[: len(keys)] = rng.integers(1, 1 << 32, len(keys))
        return t(k), t(c)

    def batch(keys, total=None):
        k = np.full(len(keys) if total is None else total, SENT, np.int64)
        k[: len(keys)] = np.sort(keys)
        return t(k), t(k != SENT)

    def shifted(x):
        """The same lanes starting 8 bytes into a 16-byte piece."""
        return torch.cat([x.new_zeros(1), x])[1:]

    none = (t([]), t([]))
    sk = np.unique(rng.integers(0, 1 << 50, 30000))
    x = 1 << 30  # one key in the middle of the others
    below = rng.integers(0, x, T - 5)
    above = rng.integers(x + 1, 1 << 40, T + 7)
    cases = {
        "group spanning block boundaries": (
            *spectrum(rng.integers(0, 1 << 20, 4000), 4096),
            *batch(np.full(9000, 777), 10000), 20000),
        "one key, count wraps mod 2^32": (
            t(np.full(40000, 42)), t(np.full(40000, 1 << 20)),
            t(np.full(50000, 42)), t(np.ones(50000)), 1000),
        "empty batch (0 lanes)": (
            *spectrum(rng.integers(0, 1 << 50, 3000), 4096), *none, 4096),
        "empty batch (all sentinel)": (
            *spectrum(rng.integers(0, 1 << 50, 3000), 4096),
            *batch(np.zeros(0, np.int64), 5000), 4096),
        "spectrum at exactly cap": (
            t(sk), t(rng.integers(1, 1000, len(sk))),
            *batch(sk[rng.integers(0, len(sk), 20000)]), len(sk)),
        "live > cap": (
            t(sk), t(rng.integers(1, 1000, len(sk))),
            *batch(rng.integers(0, 1 << 50, 20000)), len(sk)),
        "nothing to fold (0 lanes, cap 0)": (*none, *none, 0),
        "a tile with no group end between two tiles that have one": (
            *none, *batch(np.concatenate([below, np.full(2 * T + 10, x),
                                          above])), 3 * T),
        "a group over more than two tiles whose count wraps": (
            t(np.concatenate([np.sort(below), np.full(3 * T + 3, x),
                              np.sort(above)])),
            t(np.concatenate([np.ones(T - 5), np.full(3 * T + 3, (1 << 31) + 5),
                              np.ones(T + 7)])),
            *batch(np.concatenate([np.full(T, x), above[:100]])), 3 * T),
        "cap below the first tile's ends": (
            *spectrum(rng.integers(0, 1 << 50, 3 * T), 3 * T),
            *batch(rng.integers(0, 1 << 50, 2 * T)), 10),
        "runs that start 8 bytes into a 16-byte piece": tuple(
            shifted(v) for v in (
                *spectrum(rng.integers(0, 1 << 50, 5 * T), 5 * T + 3),
                *batch(rng.integers(0, 1 << 50, 3 * T + 1)))) + (9 * T,),
    }
    for off in (-1, 0, 1):
        na = 2 * T + 17
        cases[f"na + nb = 5 tiles {off:+d}"] = (
            *spectrum(rng.integers(0, 1 << 50, na), na),
            *batch(rng.integers(0, 1 << 50, 3 * T - 17 + off)), 5 * T + 1)

    up = np.arange(T)
    across = np.concatenate([up + 10 * T, up, up + 20 * T])  # T-1 -> T falls
    inside = np.arange(3 * T)
    inside[T + 5] = 0
    some = spectrum(rng.integers(0, 1 << 50, 2 * T), 2 * T)
    unsorted = {
        "only B out of order, across a tile boundary (A of 0 lanes)": (
            *none, t(across), t(np.ones(3 * T)), 4 * T),
        "only B out of order, across a tile boundary": (
            *some, t(across), t(np.ones(3 * T)), 6 * T),
        "only B out of order, inside a tile": (
            *some, t(inside), t(np.ones(3 * T)), 6 * T),
        "only A out of order, across a tile boundary (B of 0 lanes)": (
            t(across), t(np.ones(3 * T)), *none, 4 * T),
        "only A out of order": (
            t(across), t(np.ones(3 * T)),
            *batch(rng.integers(0, 1 << 50, 2 * T)), 6 * T),
    }
    return cases, unsorted


def fold_phase(dev, smi: str) -> dict:
    import torch

    from gossamer_tpu_torch.ops import fold

    lib = fold._kernel_lib()
    tile = lib.gossamer_fold_tile()
    print(f"merge_fold kernel: tile {tile} lanes, "
          f"{lib.gossamer_fold_threads()} threads a block, "
          f"{lib.gossamer_fold_blocks_per_sm()} blocks an SM", flush=True)
    cases, unsorted = fold_edge_cases(dev, tile)
    worst = 0
    for name, (a, ac, b, bc, cap) in cases.items():
        got, want, err = fold_pair(a, ac, b, bc, cap)
        check(err == 0, f"kernel == plain, {name} (live {int(got[2])}, "
                        f"cap {cap})")
        worst = max(worst, err)
    for name, (a, ac, b, bc, cap) in unsorted.items():
        live = int(fold.merge_fold(a, ac, b, bc, cap)[2])
        check(live == -1, f"kernel reports live = -1, {name}")

    # the path's shape, several seeds: a race in the chained scan would show
    # as a rare mismatch, not a steady one
    for seed in (2, 12, 22, 32):
        a, ac, b, bc, n_keys = fold_path_inputs(dev, seed)
        nb = b.numel()
        for _ in range(2):
            got, _want, err = fold_pair(a, ac, b, bc, CAP)
            check(err == 0, f"kernel == plain at the path's shape, seed "
                            f"{seed}: A {CAP} lanes ({n_keys} keys), B {nb} "
                            f"lanes, live {int(got[2])}")
            worst = max(worst, err)
    a, ac, b, bc, n_keys = fold_path_inputs(dev, 2)

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
    print(f"merge_fold at A={CAP} B={nb} lanes on {smi}: wrapper "
          f"{ms:.3f} ms (runs {kern}), kernel launch alone {launch_ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms (runs {plain})", flush=True)
    return {"shape": f"A {CAP} lanes ({n_keys} keys), B {nb} lanes, cap {CAP}",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            **fold_bound(CAP, nb, CAP), "library_ms": None}


def merge_pair(a, av, b, bv):
    """(kernel result, max abs difference from the plain result) on the card."""
    import torch

    from gossamer_tpu_torch.ops.merge import merge_sorted, merge_sorted_reference

    got = merge_sorted(a, av, b, bv)
    want = merge_sorted_reference(a, av, b, bv)
    torch.cuda.synchronize()
    err = max(int((g - w).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    return got, err


def splits_err(a, b, tile: int) -> int:
    """Max abs difference of the split pass from its plain version."""
    import torch

    from gossamer_tpu_torch.ops.merge import merge_splits, merge_splits_reference

    got = merge_splits(a, b, tile)
    want = merge_splits_reference(a, b, tile)
    torch.cuda.synchronize()
    return int((got - want).abs().max())


def zero_launches() -> None:
    """Every kernel's launch count to 0, just before a path runs."""
    from gossamer_tpu_torch.ops import fold, merge

    fold.merge_fold.launches = 0
    merge.merge_sorted.launches = merge.merge_splits.launches = 0


def merge_launches(what: str) -> int:
    """merge_sorted launches since :func:`zero_launches`; each of them that
    had lanes to merge launched the split pass once."""
    from gossamer_tpu_torch.ops import merge

    n, splits = merge.merge_sorted.launches, merge.merge_splits.launches
    check((n > 0) == (splits > 0) and splits <= n,
          f"{what}: merge_splits launched {splits} times, merge_sorted {n}")
    return n


def merge_kernel_info(dev) -> dict:
    """The default build's tile and ring, and the blocks an SM holds."""
    from gossamer_tpu_torch.ops import merge

    lib = merge._kernel_lib()
    info = {"threads": lib.gossamer_merge_threads(),
            "items": lib.gossamer_merge_tile() // lib.gossamer_merge_threads(),
            "lanes": lib.gossamer_merge_tile(),
            "stages": lib.gossamer_merge_stages(),
            "smem_bytes": lib.gossamer_merge_smem_bytes(),
            "split_lanes_a_boundary": lib.gossamer_merge_split_group()}
    return {"tile": info, "blocks_per_sm": merge.blocks_per_sm(lib, dev)}


def merge_edge_cases(dev, tile: int, resident: int) -> dict:
    """{name: (a_keys, a_vals, b_keys, b_vals)} on the card that the kernel
    must merge exactly as the plain version does: the cases of the tests'
    ``tests/merge_cases.py``, the runs' edges (ties, empty and all-sentinel
    runs, one run below the other, lengths off every tile) and the kernel's
    own at its ``tile`` with ``resident`` blocks on the card at once (more
    tiles than that, one tile, one and a few tiles +- 1 lane, one key over
    many tiles); each also as views that start 8 bytes into a 16-byte piece
    (``x[1:]``)."""
    import torch

    spec = importlib.util.spec_from_file_location(
        "merge_cases", os.path.join(ROOT, "tests", "merge_cases.py"))
    mc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mc)
    cases = {name: tuple(torch.as_tensor(np.asarray(x, np.int64), device=dev)
                         for x in arrays)
             for name, *arrays in [*mc.edge_cases(),
                                   *mc.card_cases(tile, resident)]}
    for name, args in list(cases.items()):
        cases[f"{name} (views at an odd lane)"] = tuple(
            torch.cat([x.new_zeros(1), x])[1:] for x in args)
    return cases


def merge_shapes(dev, per_shard: bool = False) -> dict:
    """{what: (a_keys, a_vals, b_keys, b_vals)} at the shapes the paths give
    the merge: the fold's spectrum and batch (on no path), the classify join
    of the xenome cell, the rank join of classify-reads, and with
    ``per_shard`` a shard's classify join of the 4-shard mesh (the smoke's
    several-devices phase times the real shard; scripts/merge_bench.py asks
    for this one)."""
    import torch

    from gossamer_tpu_torch.ops.fold import SENT

    g = torch.Generator(device=dev).manual_seed(4)
    shapes = {}

    # the spectrum at the default cap holding 22M keys; a sorted batch of
    # 8 x 2^22 lanes, ~3/4 valid, most keys already in A
    keys = torch.unique(torch.randint(0, 1 << 52, (22_000_000,), device=dev,
                                      generator=g))
    a = torch.full((CAP,), SENT, dtype=torch.int64, device=dev)
    a[: keys.numel()] = keys
    av = torch.arange(CAP, dtype=torch.int64, device=dev)
    nb = BATCH * CHUNK
    n_valid = nb * 3 // 4
    old = keys[torch.randint(0, keys.numel(), (n_valid * 4 // 5,), device=dev,
                             generator=g)]
    new = torch.randint(0, 1 << 52, (n_valid - old.numel(), ), device=dev,
                        generator=g)
    b = torch.full((nb,), SENT, dtype=torch.int64, device=dev)
    b[:n_valid] = torch.sort(torch.cat([old, new])).values
    bv = -1 - torch.arange(nb, dtype=torch.int64, device=dev)
    shapes["the fold's spectrum and batch"] = (a, av, b, bv)

    def join(n_index, space, nq, n_hits):
        """A sorted index (payload -1) and a window of nq query lanes, 3/4
        valid and sorted, n_hits of them drawn from the index."""
        keys = torch.unique(torch.randint(0, space, (n_index,), device=dev,
                                          generator=g))
        qb = torch.full((nq,), SENT, dtype=torch.int64, device=dev)
        hits = keys[torch.randint(0, keys.numel(), (n_hits,), device=dev,
                                  generator=g)]
        rest = torch.randint(0, space, (nq * 3 // 4 - n_hits,), device=dev,
                             generator=g)
        qb[: nq * 3 // 4] = torch.sort(torch.cat([hits, rest])).values
        qbv = torch.randperm(nq, device=dev, generator=g)
        return keys, torch.full_like(keys, -1), qb, qbv

    # the xenome index of the xenome phase (9,182,371 lanes) and one batch
    # window of 2^19 query lanes
    shapes["the classify join"] = join(9_182_371, 1 << 52, 1 << 19, 0)
    # the k-mer set of the taxonomy phase (18,382,323 lanes) and one batch of
    # 4096 reads (2^19 query lanes, half of them in the set)
    shapes["the rank join of classify-reads"] = join(18_382_323, 1 << 50,
                                                     1 << 19, 1 << 18)
    if per_shard:  # a quarter of the xenome index, 2^20 query lanes
        shapes["per shard of 4"] = join(2_295_593, 1 << 52, 1 << 20, 0)
    return shapes


def merge_timed(a, av, b, bv, what: str, smi: str) -> dict:
    """merge_sorted on (a, av) and (b, bv): the kernel, its plain version
    and the library's way to the same result, each timed with CUDA events
    (runs in turns, the least kept), beside the bound."""
    import torch

    from gossamer_tpu_torch.ops import merge

    def run_kernel():
        merge.merge_sorted(a, av, b, bv)

    def run_plain():
        merge.merge_sorted_reference(a, av, b, bv)

    def run_library():
        """The library's way to the same function: a stable sort of the
        concatenated keys and a gather of the payloads.  A stable sort
        keeps A's lanes before B's on equal keys, as the kernel does."""
        keys, order = torch.sort(torch.cat([a, b]), stable=True)
        return keys, torch.cat([av, bv])[order]

    got, lib = merge.merge_sorted(a, av, b, bv), run_library()
    check(all(torch.equal(x, y) for x, y in zip(got, lib)),
          f"merge_sorted kernel == torch.sort(cat, stable=True) + gather "
          f"({what})")
    del got, lib
    plain = [time_ms(run_plain)]
    kern = [time_ms(run_kernel), time_ms(run_kernel)]
    plain.append(time_ms(run_plain))
    library = [time_ms(run_library), time_ms(run_library)]
    ms, plain_ms, library_ms = min(kern), min(plain), min(library)
    print(f"merge_sorted at A={a.numel()} B={b.numel()} lanes ({what}) on "
          f"{smi}: kernel {ms:.4f} ms (runs {kern}), plain {plain_ms:.3f} "
          f"ms (runs {plain}), library sort + gather {library_ms:.3f} ms "
          f"(runs {library})", flush=True)
    return {"shape": f"A {a.numel()} lanes, B {b.numel()} lanes ({what})",
            "ms": ms, "plain_ms": plain_ms,
            **merge_bound(a.numel(), b.numel()), "library_ms": library_ms}


def merge_phase(dev, smi: str) -> dict:
    import torch

    from gossamer_tpu_torch.ops import merge

    info = merge_kernel_info(dev)
    tile = info["tile"]["lanes"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    resident = info["blocks_per_sm"] * sms
    print(f"merge_sorted kernel: tile {info['tile']}, {info['blocks_per_sm']} "
          f"blocks an SM x {sms} SMs", flush=True)
    worst = 0
    for name, args in merge_edge_cases(dev, tile, resident).items():
        got, err = merge_pair(*args)
        s_err = splits_err(args[0], args[2], tile)
        check(err == 0 and s_err == 0,
              f"merge_sorted kernel == plain and merge_splits == plain, "
              f"{name} ({got[0].numel()} lanes)")
        worst = max(worst, err, s_err)

    stats = {}
    for what, (a, av, b, bv) in merge_shapes(dev).items():
        _got, err = merge_pair(a, av, b, bv)
        s_err = splits_err(a, b, tile)
        check(err == 0 and s_err == 0,
              f"merge_sorted kernel == plain and merge_splits == plain at "
              f"{what}: A {a.numel()} lanes, B {b.numel()} lanes")
        worst = max(worst, err, s_err)
        stats[what] = merge_timed(a, av, b, bv, what, smi)
        del a, av, b, bv
    wide = stats["the fold's spectrum and batch"]
    rank = stats["the rank join of classify-reads"]
    wide["paths"] = "none (not on a path)"
    rank["paths"] = "classify-reads (counted in the classify join's line)"
    return ({"max_abs_err": worst, **info, **stats["the classify join"]},
            [wide, rank])


# ------------------------------------------------------- inputs and oracles
ACGTN = np.frombuffer(b"ACGTN", np.uint8)
U64 = np.uint64


def make_reads(rng, genome_len=4_600_000, coverage=30, read_len=100,
               sub_rate=0.005, n_with_n=200):
    """A seeded genome and read set -> (genome codes uint8[genome_len], read
    codes (0-3, 4 = N) uint8[n_reads, read_len])."""
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
    return genome, reads


def write_fasta(path: str, reads: np.ndarray) -> None:
    n, length = reads.shape
    rec = np.empty((n, 10 + length + 1), np.uint8)
    rec[:, 0:2] = np.frombuffer(b">r", np.uint8)
    idx = np.arange(n)
    for j in range(7):
        rec[:, 2 + j] = ord("0") + (idx // 10 ** (6 - j)) % 10
    rec[:, 9] = ord("\n")
    rec[:, 10 : 10 + length] = ACGTN[reads]
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


def window_keys(codes: np.ndarray, k: int):
    """k-windows of the last axis as 128-bit keys -> (lo, hi uint64, valid:
    no code >= 4).  ``hi`` stays 0 up to k = 32."""
    n_win = codes.shape[-1] - k + 1
    lo = np.zeros(codes.shape[:-1] + (n_win,), U64)
    hi = np.zeros_like(lo)
    valid = np.ones(lo.shape, bool)
    for j in range(k):
        b = codes[..., j : j + n_win]
        valid &= b < 4
        hi = (hi << U64(2)) | (lo >> U64(62))
        lo = (lo << U64(2)) | (b & 3).astype(U64)
    return lo, hi, valid


def unique128(lo: np.ndarray, hi: np.ndarray, return_counts: bool = False):
    """Sorted distinct 128-bit keys (and how often each occurs)."""
    if not hi.any():
        u = np.unique(lo, return_counts=return_counts)
        u = u if return_counts else (u,)
        return (u[0], np.zeros_like(u[0]), *u[1:])
    order = np.lexsort((lo, hi))
    lo, hi = lo[order], hi[order]
    new = np.ones(len(lo), bool)
    new[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
    if not return_counts:
        return lo[new], hi[new]
    first = np.nonzero(new)[0]
    return lo[new], hi[new], np.diff(np.append(first, len(lo)))


def merged_unique(*runs: np.ndarray) -> np.ndarray:
    """Distinct keys of ascending uint64 runs: a stable sort (timsort) of
    their concatenation only merges the runs, where ``np.unique`` sorts
    10^7 keys from scratch (tens of seconds on the card's host)."""
    x = np.concatenate(runs)
    x.sort(kind="stable")
    keep = np.ones(len(x), bool)
    keep[1:] = x[1:] != x[:-1]
    return x[keep]


def lookup128(set_lo, set_hi, qlo, qhi) -> np.ndarray:
    """Index in the sorted distinct set of each query, -1 where absent."""
    n, m = len(set_lo), len(qlo)
    if not set_hi.any() and not qhi.any():
        # queries in ascending order walk the set in order; in read order
        # every probe of a set of millions of keys misses the cache
        r = np.empty(m, np.int64)
        if m < 2 or bool((qlo[1:] >= qlo[:-1]).all()):
            r[:] = np.searchsorted(set_lo, qlo)
        else:
            order = np.argsort(qlo)
            r[order] = np.searchsorted(set_lo, qlo[order])
        r = np.minimum(r, n - 1)
        return np.where(set_lo[r] == qlo, r, -1)
    lo = np.concatenate([set_lo, qlo])
    hi = np.concatenate([set_hi, qhi])
    tag = np.concatenate([np.zeros(n, np.uint8), np.ones(m, np.uint8)])
    order = np.lexsort((tag, lo, hi))
    is_set = order < n
    last = np.maximum.accumulate(np.where(is_set, order, -1))
    at = np.maximum(last, 0)
    match = (~is_set & (last >= 0) & (set_lo[at] == lo[order])
             & (set_hi[at] == hi[order]))
    out = np.full(m, -1, np.int64)
    out[order[~is_set] - n] = np.where(match, last, -1)[~is_set]
    return out


def normalized(lo: np.ndarray, hi: np.ndarray, k: int):
    from gossamer_tpu_torch.core import kmer as K

    return K.normalize(lo, hi, k)[:2]


def oracle_spectrum(reads: np.ndarray, rho: int):
    """Both orientations of every valid window, counted: (lo, hi, counts)."""
    los, his = [], []
    for seq in (reads, 3 - reads[:, ::-1]):
        lo, hi, valid = window_keys(seq, rho)
        los.append(lo[valid])
        his.append(hi[valid])
    return unique128(np.concatenate(los), np.concatenate(his), True)


def read_graph(base: str):
    from gossamer_tpu_torch.graph.graph import Graph
    from gossamer_tpu_torch.io.factory import PhysicalFileFactory

    g = Graph.read(base, PhysicalFileFactory())
    return g.lo, np.ascontiguousarray(g.hi), g.counts.astype(np.int64)


def closed_under_rc(lo, hi, counts, rho: int, dev) -> bool:
    """Every edge's reverse complement is an edge with the same count.  The
    128-bit order of the reverse complements is taken on the card (two
    stable ``torch.sort``s); 64-bit keys sort in numpy."""
    import torch

    from gossamer_tpu_torch.core import kmer as K

    rlo, rhi = K.reverse_complement(lo, hi, rho)
    if hi.any():
        t_lo = torch.from_numpy((rlo ^ U64(1 << 63)).view(np.int64)).to(dev)
        t_hi = torch.from_numpy(rhi.view(np.int64)).to(dev)
        p1 = torch.sort(t_lo, stable=True).indices
        p2 = torch.sort(t_hi[p1], stable=True).indices
        order = p1[p2].cpu().numpy()
    else:
        order = np.argsort(rlo)
    return (np.array_equal(rlo[order], lo) and np.array_equal(rhi[order], hi)
            and np.array_equal(counts[order], counts))


# ------------------------------------------------------- build-graph phases
def run_build_graph(fasta: str, out: str, log: str, dev, k: int) -> tuple[float, str]:
    from gossamer_tpu_torch.cli.goss import main as goss

    t0 = time.perf_counter()
    rc = goss(["build-graph", "-k", str(k), "-I", fasta, "-O", out,
               "--device", str(dev), "-l", log])
    wall = time.perf_counter() - t0
    check(rc == 0, f"build-graph -k {k} exit code 0 ({out})")
    with open(log) as f:
        return wall, f.read()


def graph_phase(dev, smi: str, tmp: str, reads, fasta: str,
                rho: int) -> tuple[int, int]:
    """``build-graph -k rho-1 --device cuda`` on the read set with its
    checks; -> (merge_fold, merge_sorted) launches.  rho = 26 is the narrow
    path (the fold kernel in the flushes, the merge kernel in the finish on
    the card), rho = 56 the wide one (PyTorch ops only)."""
    import torch

    from gossamer_tpu_torch.ops import fold
    from gossamer_tpu_torch.ops.count import count_rho_mers_files

    wide = 2 * rho > 62
    n_windows = valid_windows(reads, rho)
    print(f"build-graph -k {rho - 1}: {n_windows} valid {rho}-mer windows",
          flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    base = os.path.join(tmp, f"g{rho}")
    wall, log = run_build_graph(fasta, base, base + ".log", dev, rho - 1)
    launches = fold.merge_fold.launches
    merges = merge_launches(f"build-graph -k {rho - 1}")
    peak = torch.cuda.max_memory_allocated(dev)
    print(log, end="", flush=True)
    line = log.split("count: ")[1].splitlines()[0]
    spills = int(line.split(" chunks, ")[1].split(" spills")[0])
    phases = json.loads(line.split("phases (s) ")[1])
    if wide:
        check(launches == 0 and merges == 0,
              f"merge_fold launches: {launches}, merge_sorted {merges} (the "
              f"wide count is PyTorch ops, as in the JAX package)")
    else:
        check(launches > 0, f"merge_fold kernel launched {launches} times in "
                            f"build-graph")
        finish = line.split("finish: ")[1].split(", phases (s) ")[0]
        check(merges == spills + 1 and finish.count("merge of") == spills
              and "expansion of" in finish and "host" not in finish
              and finish.count(f"on {dev.type}") == spills + 1,
              f"the finish on the card: merge_sorted launched {merges} times "
              f"({spills} spilled runs merged, the expansion); {finish}")
    check("\treader: native" in log, "the native reader was used")
    lo, hi, counts = read_graph(base)
    check(bool(hi.any()) == (2 * rho > 64), f"hi plane in use: {2 * rho > 64}")
    inserted = int(counts.sum())
    check(inserted == 2 * n_windows,
          f"sum of counts {inserted} == 2 x {n_windows} valid windows")
    check(closed_under_rc(lo, hi, counts, rho, dev),
          f"spectrum of {len(lo)} edges closed under reverse complement")
    count_s = sum(phases.values())
    print(f"build-graph -k {rho - 1} on {smi}: {inserted} rho-mers, "
          f"{len(lo)} distinct, wall {wall:.3f} s, count {count_s:.3f} s "
          f"-> {inserted / count_s:.0f} rho-mers/s counted, "
          f"{inserted / wall:.0f} rho-mers/s end to end; {spills} spills; "
          f"phases {phases}; peak device memory {peak / 2**30:.2f} GiB",
          flush=True)
    if wide:
        # -B 2, the CLI's default, bounds the wide count's device memory
        print(f"build-graph -k {rho - 1} -B 2 on {smi}: {spills} spills, "
              f"torch.cuda.max_memory_allocated {peak} B "
              f"({peak / 2**30:.3f} GiB) against the 2 GiB of -B 2", flush=True)
        check(peak <= 2 << 30, f"peak device memory {peak} B <= -B 2 "
                               f"({2 << 30} B)")

    if not wide:
        t0 = time.perf_counter()
        plo, _phi, pc = count_rho_mers_files(
            [fasta], rho, both_strands=True, canonical=False, device=dev,
            chunk=CHUNK, cap_entries=CAP, threads=4, fold=False)
        plain_s = time.perf_counter() - t0
        check(np.array_equal(plo, lo) and np.array_equal(pc, counts),
              f"spectrum == the plain-fold count on the same card "
              f"({plain_s:.3f} s for its count)")

    head = reads[:20000]
    small = os.path.join(tmp, "head.fa")
    write_fasta(small, head)
    hbase = os.path.join(tmp, f"h{rho}")
    run_build_graph(small, hbase, hbase + ".log", dev, rho - 1)
    hlo, hhi, hc = read_graph(hbase)
    olo, ohi, oc = oracle_spectrum(head, rho)
    check(np.array_equal(hlo, olo) and np.array_equal(hhi, ohi)
          and np.array_equal(hc, oc),
          f"first 20k reads: {len(hlo)} edges == numpy oracle")
    return launches, merges


# ------------------------------------------------------------ engine routes
RAW_CHUNK = CHUNK - 1  # 4,194,303 windows: not a multiple of 16, raw codes
SPILL_CHUNK = 1 << 20  # the several-spills engine: the cap grows from 2^21
SPILL_CAP = 1 << 28  # wide enough that the finish runs on the card


def routes_phase(dev, smi: str, tmp: str, fasta: str, rho: int):
    """The narrow engine's two inputs on the ``-k 25`` read set, each
    counted on the card: ``build-graph --chunk-size 4194303`` (raw codes
    through ``native_flat_chunks``) == the k-25 cell's files; the packed
    route through the engine (the merge kernel's inputs in the finish kept)
    and raw chunks of 2^20 with several spills (the finish's peak device
    memory read) == its graph.  -> (merge_fold launches per path,
    merge_sorted launches per path, the merge_sorted rows at the finish's
    merge and expansion)."""
    import torch

    from gossamer_tpu_torch.cli.goss import main as goss
    from gossamer_tpu_torch.io.native import (native_flat_chunks,
                                              native_packed_chunks)
    from gossamer_tpu_torch.ops import engine as E
    from gossamer_tpu_torch.ops import fold

    g26 = os.path.join(tmp, f"g{rho}")
    want = read_graph(g26)
    fold_paths, merge_paths = {}, {}

    def path(name, fn, *args, **kw):
        """Run one path with the launch counts at 0; it must fold with the
        kernel."""
        zero_launches()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        n_fold, n_merge = fold.merge_fold.launches, merge_launches(name)
        fold_paths[name], merge_paths[name] = n_fold, n_merge
        check(n_fold > 0, f"{name}: {wall:.3f} s, merge_fold launched "
                          f"{n_fold} times, merge_sorted {n_merge}")
        return out

    finish_log = []

    def count(chunks):
        eng = E.SpectrumEngine(rho, "value", CHUNK, dev, batch=BATCH, cap=CAP)
        for item in chunks:
            eng.add_chunk_packed(*item)
        out = eng.finish_expanded()
        finish_log[:] = eng.finish_log
        print(f"  add_chunk_packed: {eng.spills} spills; finish: "
              f"{'; '.join(eng.finish_log)}; phases {eng.phases}", flush=True)
        return out

    def same_graph(got, what):
        check(all(np.array_equal(g, w) for g, w in zip(got, want)),
              f"{what}: {len(got[0])} edges == the k-25 cell's graph")

    # raw codes through the CLI: the chunk size is not a multiple of 16
    base = os.path.join(tmp, "graw")
    rc_code = path("build-graph --chunk-size 4194303 (raw codes)", goss, [
        "build-graph", "-k", str(rho - 1), "-I", fasta, "-O", base,
        "--chunk-size", str(RAW_CHUNK), "--device", str(dev), "-l",
        base + ".log"])
    with open(base + ".log") as f:
        log = f.read()
    line = log.split("count: ")[1].splitlines()[0]
    print(f"  {line}", flush=True)
    check(rc_code == 0 and "\treader: native" in log
          and graph_files_equal(base, g26) > 0,
          f"build-graph --chunk-size {RAW_CHUNK} (native raw chunks, "
          f"add_chunk): files == the k-25 cell's")

    # the packed route, keeping the merge kernel's inputs in the finish
    packed = list(native_packed_chunks([fasta], rho, chunk=CHUNK, threads=4))
    finish_inputs = []  # (the merge's inputs, its launches of merge_sorted)
    real = E.merge_sorted

    def keep(*args):
        n0 = real.launches
        out = real(*args)
        finish_inputs.append((args, real.launches - n0))
        return out

    E.merge_sorted = keep
    try:
        got = path("engine, packed chunks", count, packed)
    finally:
        E.merge_sorted = real
    same_graph(got, "packed route")
    del got, packed
    on_card = [step.split(" keys")[0] for step in finish_log
               if step.endswith(f"on {dev}")]
    check(len(on_card) == len(finish_log) == len(finish_inputs)
          and on_card[-1].startswith("expansion")
          and all(n == 1 for _args, n in finish_inputs),
          f"the packed route's finish ran on the card, one merge_sorted a "
          f"step: {'; '.join(finish_log)}")

    # several spills (raw chunks of 2^20 windows, one a flush, the cap
    # wide): the whole finish on the card, its peak device memory
    def spilled():
        """-> the graph; the device bytes are the engine's own: the peak
        over what was allocated before the engine started."""
        runs = []
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        eng = E.SpectrumEngine(rho, "value", SPILL_CHUNK, dev, batch=1,
                               cap=SPILL_CAP,
                               on_spill=lambda i, n: runs.append(n))
        for c in native_flat_chunks([fasta], rho, chunk=SPILL_CHUNK,
                                    threads=4):
            eng.add_chunk(c)
        eng._flush(final=True)
        lanes = sum(runs) + (int(eng.live_scalars[-1]) if eng.live_scalars
                             else 0)
        torch.cuda.synchronize(dev)
        count_peak = torch.cuda.max_memory_allocated(dev) - before
        start = torch.cuda.memory_allocated(dev) - before
        torch.cuda.reset_peak_memory_stats(dev)
        out = eng.finish_expanded()
        peak = torch.cuda.max_memory_allocated(dev) - before
        print(f"  {len(runs)} spills of {runs} keys, device cap {eng.cap}; "
              f"finish: {'; '.join(eng.finish_log)}; phases {eng.phases}",
              flush=True)
        check(len(runs) >= 3 and all(step.endswith(f"on {dev}")
                                     for step in eng.finish_log)
              and peak <= 48 * 2 * lanes,
              f"finish of {len(runs)} spilled runs and the spectrum "
              f"({lanes} lanes) on the card, on {smi}: peak device memory "
              f"{peak} B in the finish alone ({peak / (2 * lanes):.1f} B a "
              f"lane of twice the lanes, within 48; the finish started with "
              f"{start} B), {count_peak} B in the count before it")
        return out

    same_graph(path("engine, raw chunks of 2^20 (several spills)", spilled),
               "several spills")

    # the merge kernel at the finish's shapes in the packed route
    merge_rows = []
    for step, (args, n) in zip(on_card, finish_inputs):
        what = f"the finish's {step} keys"
        _got, err = merge_pair(*args)
        check(err == 0, f"merge_sorted kernel == plain at {what}")
        merge_rows.append({**merge_timed(*args, what, smi), "max_abs_err": err,
                           "paths": {"engine, packed chunks": n}})
    return fold_paths, merge_paths, merge_rows


def wide_flush_ms(dev, smi: str, rho: int) -> None:
    """Device time of one wide flush at the CLI's shape: 8 chunks of 2^22
    windows folded into a spectrum of CAP lanes that holds one earlier
    batch (CUDA events)."""
    import torch

    from gossamer_tpu_torch.ops import engine_wide as ew

    g = torch.Generator(device=dev).manual_seed(5)

    def batch():
        codes = torch.randint(0, 4, (BATCH, CHUNK + rho - 1), device=dev,
                              generator=g, dtype=torch.uint8)
        codes[:, ::101] = 255  # read separators
        return codes

    *spec, live = ew.batch_step_wide(batch(), *ew.empty_spec_wide(CAP, dev),
                                     rho, "value", CAP)
    codes = batch()
    ms = time_ms(lambda: ew.batch_step_wide(codes, *spec, rho, "value", CAP),
                 reps=3)
    print(f"one wide flush (rho {rho}, mode value, {BATCH} x {CHUNK} windows "
          f"into {CAP} lanes holding {int(live)} keys) on {smi}: {ms:.1f} ms "
          f"of device time", flush=True)


def wide_flush_memory(dev, smi: str, rho: int) -> None:
    """Peak device memory of one wide flush, by stage: the k-merize stage
    alone (``kmerize_planes_wide``, ``canonicalize_wide``, ``to_lanes``) per
    window of a batch of 1, 2, 4 or 8 chunks, and the whole flush
    (``batch_step_wide``) into a resident spectrum of S lanes per lane of
    the merge (S + batch): the bytes that size ``-B`` for wide keys."""
    import torch

    from gossamer_tpu_torch.ops import engine_wide as ew

    g = torch.Generator(device=dev).manual_seed(5)

    def peak_of(fn):
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn()
        torch.cuda.synchronize(dev)
        del out
        return torch.cuda.max_memory_allocated(dev) - base

    def kmerize(codes):
        *limbs, valid = ew.kmerize_planes_wide(codes, rho)
        limbs = ew.canonicalize_wide(tuple(x.reshape(-1) for x in limbs), rho,
                                     "value")
        return (*ew.to_lanes(*limbs), valid)

    for n_chunks in (1, 2, 4, 8):
        codes = torch.randint(0, 4, (n_chunks, CHUNK + rho - 1), device=dev,
                              generator=g, dtype=torch.uint8)
        codes[:, ::101] = 255  # read separators
        n = n_chunks * CHUNK
        pk = peak_of(lambda: kmerize(codes))
        print(f"wide k-merize (rho {rho}, {n} windows) on {smi}: peak {pk} B "
              f"above the codes, {pk / n:.2f} B a window", flush=True)
        for lanes in (1 << 22, 1 << 24, CAP):
            spec = ew.empty_spec_wide(lanes, dev)
            live = lanes // 2
            keys = torch.arange(live, device=dev, dtype=torch.int64) * 7919
            spec[0][:live] = keys >> 40
            spec[1][:live] = keys
            spec[2][:live] = 1
            pk = peak_of(lambda: ew.batch_step_wide(codes, *spec, rho, "value",
                                                    lanes))
            print(f"wide flush (rho {rho}, {n} windows into {lanes} lanes) on "
                  f"{smi}: peak {pk} B above spectrum and codes, "
                  f"{pk / (lanes + n):.2f} B a merged lane", flush=True)
            del spec, keys
        del codes


def wide_cap_before_after(dev, smi: str, tmp: str, fasta: str,
                          rho: int) -> None:
    """build-graph -k rho-1 of the read set as the CLI sizes it from -B 2
    now, and as it did before (a cap of (2 << 30) // 48 keys, 8 chunks a
    flush), in turns: spills, count time, peak device memory."""
    import torch

    from gossamer_tpu_torch.ops.count import count_rho_mers_files

    def old():
        return count_rho_mers_files(
            [fasta], rho, both_strands=True, canonical=False, device=dev,
            chunk=CHUNK, cap_entries=CAP, batch=BATCH, threads=4, log=logged)

    lines: list[str] = []

    def logged(level, msg):
        lines.append(msg)

    results = {}
    for name in ("-B 2 now", "before", "before", "-B 2 now"):
        torch.cuda.reset_peak_memory_stats(dev)
        lines.clear()
        if name == "before":
            t0 = time.perf_counter()
            lo, _hi, c = old()
            wall = time.perf_counter() - t0
            line = [x for x in lines if x.startswith("count: ")][-1]
        else:
            base = os.path.join(tmp, "gB")
            wall, log = run_build_graph(fasta, base, base + ".log", dev,
                                        rho - 1)
            line = "count: " + log.split("count: ")[1].splitlines()[0]
            lo, _hi, c = read_graph(base)
        peak = torch.cuda.max_memory_allocated(dev)
        spills = int(line.split(" chunks, ")[1].split(" spills")[0])
        print(f"build-graph -k {rho - 1} {name} on {smi}: wall {wall:.3f} s, "
              f"{spills} spills, peak device memory {peak} B "
              f"({peak / 2**30:.3f} GiB), {len(lo)} edges; {line}", flush=True)
        results.setdefault(name, (lo, c))
    a, b = results.values()
    check(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]),
          "the same graph either way")


# ------------------------------------------------------------ xenome phases
N_READS = 1_000_000
CLASSES = ("neither", "both", "ambiguous", "graft", "host")


def make_references(rng, length=4_600_000, seg_at=100_000, seg_len=20_000,
                    seg_sub=0.005):
    """Codes of a graft and a host reference (seeded, random) sharing one
    segment; the host's copy carries point substitutions, so that
    compute-near-kmers has marginal k-mers to find."""
    graft = rng.integers(0, 4, length, dtype=np.uint8)
    host = rng.integers(0, 4, length, dtype=np.uint8)
    seg = rng.integers(0, 4, seg_len, dtype=np.uint8)
    graft[seg_at : seg_at + seg_len] = seg
    pos = rng.choice(seg_len, int(seg_len * seg_sub), replace=False)
    hseg = seg.copy()
    hseg[pos] = (hseg[pos] + rng.integers(1, 4, len(pos), dtype=np.uint8)) % 4
    host[seg_at : seg_at + seg_len] = hseg
    return graft, host, seg


def sample_reads(rng, sources, weights, n, read_len=100, sub_rate=0.005,
                 n_every=1000, with_src=False):
    """uint8[n, read_len] codes (4 = N): reads of the sources (None: random
    sequence) in the given shares, either strand, with substitutions and
    one N in every ``n_every`` reads.  ``with_src``: also the index of each
    read's source."""
    src = rng.choice(len(sources), n, p=weights)
    reads = np.empty((n, read_len), np.uint8)
    for i, seq in enumerate(sources):
        rows = np.nonzero(src == i)[0]
        if seq is None:
            reads[rows] = rng.integers(0, 4, (len(rows), read_len), dtype=np.uint8)
            continue
        starts = rng.integers(0, len(seq) - read_len + 1, len(rows))
        reads[rows] = np.lib.stride_tricks.sliding_window_view(seq, read_len)[starts]
    flip = rng.random(n) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    n_sub = rng.binomial(reads.size, sub_rate)
    pos = rng.integers(0, reads.size, n_sub)
    flat = reads.reshape(-1)
    flat[pos] = (flat[pos] + rng.integers(1, 4, n_sub, dtype=np.uint8)) % 4
    rows = rng.choice(n, n // n_every, replace=False)
    reads[rows, rng.integers(0, read_len, len(rows))] = 4
    return (reads, src) if with_src else reads


def reference_set(ref: np.ndarray, k: int):
    """Sorted distinct FNV-normalized k-mers of an N-free reference."""
    lo, hi, _valid = window_keys(ref, k)
    return unique128(*normalized(lo, hi, k))


def index_oracle(graft, host, k):
    """Union of the FNV-normalized windows of both references + bits."""
    sets = [reference_set(graft, k), reference_set(host, k)]
    lo = np.concatenate([s[0] for s in sets])
    hi = np.concatenate([s[1] for s in sets])
    tag = np.concatenate([np.full(len(s[0]), i, np.uint8)
                          for i, s in enumerate(sets)])
    order = np.lexsort((lo, hi))
    lo, hi, tag = lo[order], hi[order], tag[order]
    new = np.ones(len(lo), bool)
    new[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
    idx = np.cumsum(new) - 1
    bits = np.zeros((2, int(new.sum())), bool)
    bits[tag, idx] = True
    return lo[new], hi[new], bits[0], bits[1]


def blrg_oracle(reads: np.ndarray, ann) -> np.ndarray:
    """Per-read blrg: each read on its own, windows holding an N skipped."""
    k = ann.kset.k
    lo, hi, valid = window_keys(reads, k)
    row = np.broadcast_to(np.arange(len(reads))[:, None], lo.shape)[valid]
    r = lookup128(ann.kset.lo, ann.kset.hi, *normalized(lo[valid], hi[valid], k))
    hit = r >= 0
    r = r[hit]
    cls = (ann.lhs[r].astype(np.uint8) << 1) | ann.rhs[r].astype(np.uint8)
    blrg = np.zeros(len(reads), np.uint8)
    np.bitwise_or.at(blrg, row[hit], (np.uint8(1) << cls).astype(np.uint8))
    return blrg


def write_reference(path: str, label: str, codes: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(b">" + label.encode() + b"\n" + ACGTN[codes].tobytes() + b"\n")


def fasta_ids(path: str) -> np.ndarray:
    """The read numbers (labels ``r0000123``) of a FASTA file, in file order."""
    with open(path, "rb") as f:
        labels = f.read().split(b"\n")[0::2]
    return np.array([int(x[2:]) for x in labels if x], np.int64)


def output_classes(prefix: str, n: int) -> np.ndarray:
    """Class file (index into CLASSES) of every read the CLI wrote."""
    out = np.full(n, 255, np.uint8)
    for c, name in enumerate(CLASSES):
        ids = fasta_ids(f"{prefix}_{name}.fasta")
        check(np.all(np.diff(ids) > 0) and (out[ids] == 255).all(),
              f"{os.path.basename(prefix)}_{name}.fasta: {len(ids)} reads, "
              f"in input order")
        out[ids] = c
    return out


def near_kmers_check(dev, graft, host, k: int) -> None:
    """Device compute-near-kmers == the host numpy version on an index of
    200 kbp prefixes of the references."""
    from gossamer_tpu_torch.classify.annotated_set import (
        AnnotatedKmerSet, compute_near_kmers, compute_near_kmers_host,
        merge_and_annotate)
    from gossamer_tpu_torch.graph.build import build_kmer_set
    from gossamer_tpu_torch.io.readers import Read

    def kset(codes):
        return build_kmer_set([Read("p", ACGTN[codes].tobytes())], k,
                              device=dev)[0]

    ann, _ = merge_and_annotate(kset(graft[:200_000]), kset(host[:200_000]))
    host_ann = AnnotatedKmerSet(ann.kset, ann.lhs.copy(), ann.rhs.copy())
    t0 = time.perf_counter()
    n_dev = compute_near_kmers(ann, dev)
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_host = compute_near_kmers_host(host_ann)
    host_s = time.perf_counter() - t0
    check(n_dev == n_host and n_dev > 0 and np.array_equal(ann.lhs, host_ann.lhs)
          and np.array_equal(ann.rhs, host_ann.rhs),
          f"200 kbp prefixes ({ann.kset.count} {k}-mers): device near-k-mers "
          f"({n_dev} marginal, {dev_s:.3f} s) == host numpy ({n_host}, "
          f"{host_s:.3f} s)")


def xenome_inputs(tmp: str) -> dict:
    t0 = time.perf_counter()
    rng = np.random.default_rng(2027)
    graft, host, seg = make_references(rng)
    reads = sample_reads(rng, [graft, host, seg, None],
                         [0.45, 0.45, 0.05, 0.05], N_READS)
    g_fa, h_fa, r_fa = (os.path.join(tmp, n) for n in ("graft.fa", "host.fa", "xreads.fa"))
    write_reference(g_fa, "graft", graft)
    write_reference(h_fa, "host", host)
    write_fasta(r_fa, reads)
    print(f"xenome inputs: 2 x {len(graft)} bp references, {len(reads)} reads "
          f"x {reads.shape[1]} bp ({int((reads == 4).any(axis=1).sum())} with "
          f"an N), {os.path.getsize(r_fa)} B FASTA; made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"graft": graft, "host": host, "seg": seg, "reads": reads,
            "g_fa": g_fa, "h_fa": h_fa, "r_fa": r_fa}


def xenome_phase(dev, smi: str, tmp: str, inp: dict, k: int) -> tuple[int, int]:
    """``xenome index -K k`` and ``classify`` with their checks -> (merge_fold
    launches in ``index``, merge_sorted launches in ``classify``).  k = 25
    runs both kernels; k = 40 is the wide path (PyTorch ops only)."""
    import torch

    from gossamer_tpu_torch.classify.annotated_set import AnnotatedKmerSet
    from gossamer_tpu_torch.classify.xenome import OUT_CLASS, classify_reads
    from gossamer_tpu_torch.cli.xenome import main as xenome
    from gossamer_tpu_torch.io.factory import PhysicalFileFactory
    from gossamer_tpu_torch.io.readers import Read
    from gossamer_tpu_torch.ops import fold
    from gossamer_tpu_torch.utils import profile

    wide = 2 * k + 2 > 62
    graft, host, reads = inp["graft"], inp["host"], inp["reads"]
    idx = os.path.join(tmp, f"idx{k}")
    log = idx + ".log"
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    t0 = time.perf_counter()
    rc = xenome(["index", "-K", str(k), "-G", inp["g_fa"], "-H", inp["h_fa"],
                 "-P", idx, "--device", str(dev), "-l", log])
    index_wall = time.perf_counter() - t0
    index_launches = fold.merge_fold.launches
    index_peak = torch.cuda.max_memory_allocated(dev)
    check(rc == 0, f"xenome index -K {k} exit code 0")
    with open(log) as f:
        index_log = f.read()
    print(index_log, end="", flush=True)
    if wide:
        check(index_launches == 0, f"merge_fold launches in xenome index -K "
                                   f"{k}: {index_launches} (wide count)")
    else:
        check(index_launches > 0, f"merge_fold kernel launched "
                                  f"{index_launches} times in xenome index")

    ann = AnnotatedKmerSet.read(idx, PhysicalFileFactory())
    ulo, uhi, lhs_o, rhs_o = index_oracle(graft, host, k)
    check(np.array_equal(ann.kset.lo, ulo) and np.array_equal(ann.kset.hi, uhi)
          and bool(uhi.any()) == (k > 32),
          f"union of {ann.kset.count} {k}-mers == numpy oracle")
    kept = ann.lhs | ann.rhs
    gray = int((~kept).sum())
    check(np.array_equal(ann.lhs[kept], lhs_o[kept])
          and np.array_equal(ann.rhs[kept], rhs_o[kept])
          and bool((lhs_o != rhs_o)[~kept].all())
          and f"marginal kmers: {gray}\n" in index_log,
          f"lhs/rhs bits == numpy oracle; the {gray} cleared k-mers were "
          f"exclusive")
    near_kmers_check(dev, graft, host, k)

    out_prefix = os.path.join(tmp, f"out{k}")
    torch.cuda.reset_peak_memory_stats(dev)
    profile.reset()
    profile.enable()
    zero_launches()
    stdout = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        rc = xenome(["classify", "-P", idx, "-I", inp["r_fa"],
                     "--output-filename-prefix", out_prefix,
                     "--device", str(dev), "-l", out_prefix + ".log"])
    classify_wall = time.perf_counter() - t0
    classify_launches = merge_launches(f"xenome classify -K {k}")
    classify_peak = torch.cuda.max_memory_allocated(dev)
    profile.enable(False)
    phases = profile.totals()
    check(rc == 0, f"xenome classify (K {k}) exit code 0")
    print(stdout.getvalue(), end="", flush=True)
    if wide:
        check(classify_launches == 0, f"merge_sorted launches in xenome "
                                      f"classify at K {k}: {classify_launches} "
                                      f"(the wide join is two stable sorts)")
    else:
        check(classify_launches > 0, f"merge_sorted kernel launched "
                                     f"{classify_launches} times in xenome classify")
    lines = stdout.getvalue().splitlines()
    counts = [int(line.split("\t")[4]) for line in lines[2:18]]
    check(sum(counts) == N_READS, f"class totals sum to {N_READS} reads")

    head = reads[:20000]
    want = blrg_oracle(head, ann)
    got = np.array([b for _r, b in classify_reads(
        (Read(f"r{i:07d}", ACGTN[c].tobytes()) for i, c in enumerate(head)),
        ann, device=dev)], np.uint8)
    n_with_n = int((head == 4).any(axis=1).sum())
    check(np.array_equal(got, want),
          f"first {len(head)} reads ({n_with_n} with an N): blrg == per-read "
          f"numpy oracle (classes {np.bincount(want, minlength=16).tolist()})")
    names = {"lhs": "graft", "rhs": "host"}
    want_cls = np.array([CLASSES.index(names.get(OUT_CLASS[b], OUT_CLASS[b]))
                         for b in want], np.uint8)
    check(np.array_equal(output_classes(out_prefix, N_READS)[: len(head)],
                         want_cls),
          f"the CLI wrote each of the first {len(head)} reads to its class file")

    scope = {name: phases.get(f"classify/{name}", 0.0)
             for name in ("encode", "pack", "launch", "wait")}
    other = classify_wall - sum(scope.values())
    print(f"xenome -K {k} on {smi}: index {ann.kset.count} k-mers ({gray} "
          f"marginal), wall {index_wall:.3f} s, peak device memory "
          f"{index_peak / 2**30:.2f} GiB; classify {N_READS} reads, wall "
          f"{classify_wall:.3f} s -> {N_READS / classify_wall:.0f} reads/s; "
          f"phases (s, host clock): encode {scope['encode']:.3f}, pack "
          f"{scope['pack']:.3f}, launch {scope['launch']:.3f}, wait for the "
          f"device {scope['wait']:.3f}, other (parse, output) {other:.3f}; "
          f"peak device memory {classify_peak / 2**30:.2f} GiB", flush=True)
    return index_launches, classify_launches


# ------------------------------------------------------------ electus phase
EK = 25  # electus index -K 25
E_READS = 500_000


def electus_phase(dev, smi: str, tmp: str, inp: dict) -> tuple[int, int]:
    """``electus index -K 25`` of four 4.6 Mbp references and ``electus
    classify`` of 500,000 reads at ``--ref-threshold`` 1 and 2 -> (merge_fold
    launches in ``index``, merge_sorted launches in the first ``classify``)."""
    import torch

    from gossamer_tpu_torch.cli.electus import main as electus
    from gossamer_tpu_torch.ops import fold

    t0 = time.perf_counter()
    rng = np.random.default_rng(2028)
    refs = [inp["graft"], inp["host"],
            rng.integers(0, 4, 4_600_000, dtype=np.uint8),
            rng.integers(0, 4, 4_600_000, dtype=np.uint8)]
    reads, src = sample_reads(rng, [*refs, inp["seg"], None],
                              [0.2, 0.2, 0.2, 0.2, 0.1, 0.1], E_READS,
                              with_src=True)
    ref_fa = [inp["g_fa"], inp["h_fa"], os.path.join(tmp, "ref2.fa"),
              os.path.join(tmp, "ref3.fa")]
    for path, codes in zip(ref_fa[2:], refs[2:]):
        write_reference(path, os.path.basename(path), codes)
    r_fa = os.path.join(tmp, "ereads.fa")
    write_fasta(r_fa, reads)
    inp.update(erefs=refs, eref_fa=ref_fa, ereads=reads, ereads_src=src,
               er_fa=r_fa)
    print(f"electus inputs: {len(refs)} x {len(refs[0])} bp references, "
          f"{len(reads)} reads x {reads.shape[1]} bp; made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    pfx = os.path.join(tmp, "eidx")
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    t0 = time.perf_counter()
    rc = electus(["index", "-K", str(EK), "-P", pfx, "--device", str(dev),
                  "-l", pfx + ".log"] + [x for p in ref_fa for x in ("-I", p)])
    index_wall = time.perf_counter() - t0
    index_launches = fold.merge_fold.launches
    index_peak = torch.cuda.max_memory_allocated(dev)
    check(rc == 0, "electus index exit code 0")
    check(index_launches > 0, f"merge_fold kernel launched {index_launches} "
                              f"times in electus index")

    # oracle: per-read mask over the references' normalized k-mer sets
    head = reads[:20000]
    lo, hi, valid = window_keys(head, EK)
    row = np.broadcast_to(np.arange(len(head))[:, None], lo.shape)[valid]
    nlo, nhi = normalized(lo[valid], hi[valid], EK)
    masks = np.zeros(len(head), U64)
    inp["eref_sets"] = [reference_set(ref, EK) for ref in refs]
    for i, ref_set in enumerate(inp["eref_sets"]):
        hit = lookup128(*ref_set, nlo, nhi) >= 0
        np.bitwise_or.at(masks, row[hit], U64(1 << i))
    n_refs_hit = np.array([bin(int(m)).count("1") for m in masks])

    matched = {}
    for t in (1, 2):
        m, n = (os.path.join(tmp, f"e{t}{x}") for x in "mn")
        torch.cuda.reset_peak_memory_stats(dev)
        zero_launches()
        stdout = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            rc = electus(["classify", "-P", pfx, "-I", r_fa, "--ref-threshold",
                          str(t), "--match-prefix", m, "--non-match-prefix", n,
                          "--device", str(dev)])
        wall = time.perf_counter() - t0
        launches = merge_launches(f"electus classify --ref-threshold {t}")
        peak = torch.cuda.max_memory_allocated(dev)
        check(rc == 0, f"electus classify --ref-threshold {t} exit code 0")
        check(launches > 0, f"merge_sorted kernel launched {launches} times "
                            f"in electus classify --ref-threshold {t}")
        n_match, n_non, total = map(int, stdout.getvalue().split())
        ids = fasta_ids(m + ".fasta")
        check(total == E_READS == n_match + n_non and len(ids) == n_match
              and np.all(np.diff(ids) > 0)
              and len(fasta_ids(n + ".fasta")) == n_non,
              f"threshold {t}: {n_match} matched + {n_non} not = {total} "
              f"reads, as the files hold them, in input order")
        verdict = np.zeros(E_READS, bool)
        verdict[ids] = True
        check(np.array_equal(verdict[: len(head)], n_refs_hit >= t),
              f"threshold {t}: the first {len(head)} reads' verdicts == numpy "
              f"oracle ({int((n_refs_hit >= t).sum())} matched)")
        matched[t] = (n_match, launches)
        print(f"electus classify --ref-threshold {t} on {smi}: {total} reads, "
              f"wall {wall:.3f} s -> {total / wall:.0f} reads/s; "
              f"{launches} merge_sorted launches; peak device memory "
              f"{peak / 2**30:.2f} GiB", flush=True)
    check(0 < matched[2][0] < matched[1][0] < E_READS,
          "fewer reads reach two references than one, some reach none")
    print(f"electus index -K {EK} on {smi}: {len(refs)} references, wall "
          f"{index_wall:.3f} s, {index_launches} merge_fold launches, peak "
          f"device memory {index_peak / 2**30:.2f} GiB", flush=True)
    return index_launches, matched[1][1]


# ----------------------------------------------------------- assembly phase
def both_strands_keys(codes: np.ndarray, k: int) -> np.ndarray:
    """Sorted distinct k-windows (k <= 32) of an N-free sequence and of its
    reverse complement."""
    return np.unique(np.concatenate([window_keys(codes, k)[0],
                                     window_keys(3 - codes[::-1], k)[0]]))


def read_set_spectrum(reads: np.ndarray, rho: int, dev):
    """:func:`oracle_spectrum` for narrow keys at the full read set: the
    windows roll along the reads in numpy (one step a base), and the 2 x
    10^8 keys are sorted and counted by ``torch.unique`` on the card.
    -> (keys uint64 ascending, counts int64)."""
    import torch

    n, length = reads.shape
    n_win = length - rho + 1
    mask = U64((1 << (2 * rho)) - 1)
    parts = []
    for seq in (reads, 3 - reads[:, ::-1]):  # an N (4) becomes 255
        cur = np.zeros(n, U64)
        since_bad = np.zeros(n, np.int32)  # valid codes since the last N
        keys = np.empty((n, n_win), U64)
        valid = np.empty((n, n_win), bool)
        for j in range(length):
            b = seq[:, j]
            cur = ((cur << U64(2)) | (b & 3).astype(U64)) & mask
            since_bad = np.where(b < 4, since_bad + 1, 0)
            if j >= rho - 1:
                keys[:, j - rho + 1] = cur
                valid[:, j - rho + 1] = since_bad >= rho
        parts.append(torch.from_numpy(keys[valid].view(np.int64)).to(dev))
    keys, counts = torch.unique(torch.cat(parts), return_counts=True)
    return keys.cpu().numpy().view(U64), counts.cpu().numpy()


def read_contigs(path: str) -> list[np.ndarray]:
    """Base codes of every record of a FASTA file."""
    lut = np.full(256, 255, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    with open(path, "rb") as f:
        records = f.read().split(b">")[1:]
    return [lut[np.frombuffer(b"".join(r.split(b"\n")[1:]), np.uint8)]
            for r in records]


def assembly_phase(dev, smi: str, tmp: str, genome, reads, rho: int) -> int:
    """The assembler from graph to contigs, on the graph of the ``build-graph
    -k rho-1`` phase: ``trim-graph`` (cutoff inferred), ``prune-tips --iterate
    4``, ``pop-bubbles``, ``print-contigs --min-length 100``, a ``lint-graph``
    after each stage, and ``dump-graph | restore-graph`` of the last graph;
    then the three cleanup stages again after a trim at 2.
    Host code on the card's machine, as in the JAX package on one device.
    -> the cutoff trim-graph inferred."""
    from gossamer_tpu_torch.cli.goss import main as goss

    k = rho - 1
    base = os.path.join(tmp, f"g{rho}")
    device = ["--device", str(dev)]

    def run(what: str, args: list[str]) -> tuple[float, str]:
        log = os.path.join(tmp, "asm.log")
        t0 = time.perf_counter()
        rc = goss([*args, *device, "-l", log])
        wall = time.perf_counter() - t0
        check(rc == 0, f"{what} exit code 0")
        with open(log) as f:
            return wall, f.read()

    def graph_checks(name: str, g) -> None:
        lo, hi, counts = g
        check(closed_under_rc(lo, hi, counts, rho, dev),
              f"{name}: {len(lo)} edges closed under reverse complement")
        _wall, log = run(f"lint-graph ({name})", ["lint-graph", "-G",
                                                  os.path.join(tmp, name)])
        check("lint-graph: ok" in log, f"{name} lints clean")

    t0 = time.perf_counter()
    olo, oc = read_set_spectrum(reads, rho, dev)
    built = read_graph(base)
    check(np.array_equal(built[0], olo) and np.array_equal(built[2], oc)
          and not built[1].any(),
          f"the graph of all {len(reads)} reads == the numpy/torch.unique "
          f"oracle ({len(olo)} edges; oracle {time.perf_counter() - t0:.1f} s)")

    def chain(tag: str, trim_opts: list[str]):
        """trim-graph, prune-tips --iterate 4, pop-bubbles with their checks
        -> (last graph's base, its edges, the three logs)."""
        src, n_in, logs = base, len(olo), {}
        for cmd, opts in (("trim-graph", trim_opts),
                          ("prune-tips", ["--iterate", "4"]),
                          ("pop-bubbles", [])):
            name = f"asm{tag}_{cmd.split('-')[0]}"
            out = os.path.join(tmp, name)
            wall, logs[cmd] = run(cmd, [cmd, "-G", src, "-O", out, *opts])
            walls[f"{cmd}{tag}"] = wall
            print("".join(f"  {line}\n" for line in logs[cmd].splitlines()
                          if f"\t{cmd}" in line), end="", flush=True)
            g = read_graph(out)
            if cmd == "trim-graph":
                cutoff = (int(trim_opts[1]) if trim_opts else int(
                    logs[cmd].split("inferred cutoff ")[1].split()[0]))
                if not trim_opts:
                    inferred.append(cutoff)
                keep = oc >= cutoff
                check(cutoff >= 2 and np.array_equal(g[0], olo[keep])
                      and np.array_equal(g[2], oc[keep]),
                      f"trimmed graph == the oracle's spectrum cut at "
                      f"{'the logged cutoff' if not trim_opts else 'cutoff'} "
                      f"{cutoff} ({int(keep.sum())} of {len(olo)} edges)")
            else:
                check(len(g[0]) <= n_in
                      and np.isin(g[0], olo, assume_unique=True).all(),
                      f"{cmd} only removed edges")
            if not tag or cmd == "pop-bubbles":
                graph_checks(name, g)
            print(f"{cmd} {' '.join(opts)} on the host of {smi}: {n_in} edges "
                  f"in, {len(g[0])} out, wall {wall:.3f} s", flush=True)
            src, n_in = out, len(g[0])
        return src, g[0], logs

    walls, inferred = {}, []
    in_genome = both_strands_keys(genome, rho)
    # the pipeline's own settings: at the inferred cutoff no error survives
    # the trim, so the later stages find little to do
    src, _edges, _logs = chain("", [])
    # the same stages after a trim at 2, which keeps every error seen twice:
    # tips and bubbles for the later stages to remove
    _src2, edges2, logs2 = chain("_c2", ["-C", "2"])
    tips = sum(int(line.split("removed ")[1].split()[0])
               for line in logs2["prune-tips"].splitlines() if "removed" in line)
    popped = int(logs2["pop-bubbles"].split("pop-bubbles: ")[1].split()[0])
    twice = olo[(oc >= 2) & np.isin(olo, in_genome, assume_unique=True)]
    kept = np.isin(twice, edges2, assume_unique=True).mean()
    extra = len(edges2) - int(np.isin(edges2, in_genome, assume_unique=True).sum())
    check(tips > 0 and popped > 0 and kept >= 0.999,
          f"after a trim at 2: {tips} tips pruned, {popped} bubbles popped, "
          f"{100 * kept:.4f}% of the genome's {len(twice)} {rho}-mers seen "
          f"twice are kept, {extra} edges of errors are left")

    fa = os.path.join(tmp, "contigs.fa")
    walls["print-contigs"], log = run(
        "print-contigs", ["print-contigs", "-G", src, "-o", fa,
                          "--min-length", "100"])
    contigs = read_contigs(fa)
    lengths = np.sort(np.array([len(c) for c in contigs], np.int64))[::-1]
    check(len(contigs) > 0 and int(lengths.min()) >= 100
          and all(bool((c < 4).all()) for c in contigs)
          and f"print-contigs: {len(contigs)} contigs" in log,
          f"{len(contigs)} contigs of at least 100 bases, as the log says")
    total = int(lengths.sum())
    n50 = int(lengths[np.searchsorted(np.cumsum(lengths), (total + 1) // 2)])
    in_contigs = np.unique(np.concatenate(
        [both_strands_keys(c, rho) for c in contigs]))
    check(np.isin(in_contigs, in_genome, assume_unique=True).all(),
          f"every {rho}-mer of every contig is a {rho}-mer of the genome or "
          f"of its reverse complement ({len(in_contigs)} distinct)")
    share = len(in_contigs) / len(in_genome)
    check(share >= 0.95, f"the contigs hold {100 * share:.3f}% of the genome's "
                         f"{len(in_genome)} distinct {rho}-mers (both strands)")
    print(f"print-contigs on the host of {smi}: {len(contigs)} contigs, "
          f"{total} bases in all, N50 {n50}, longest {int(lengths[0])}, wall "
          f"{walls['print-contigs']:.3f} s", flush=True)

    dump, back = os.path.join(tmp, "asm.dump"), os.path.join(tmp, "asm_back")
    walls["dump-graph"], _ = run("dump-graph", ["dump-graph", "-G", src,
                                                "-o", dump])
    walls["restore-graph"], _ = run("restore-graph", ["restore-graph", "-f",
                                                      dump, "-O", back])
    suffixes = (".header", ".edges-lo", ".counts", "-counts-hist.txt")
    same = []
    for suffix in suffixes:
        with open(src + suffix, "rb") as a, open(back + suffix, "rb") as b:
            same.append(a.read() == b.read())
    check(all(same) and not os.path.exists(back + ".edges-hi"),
          f"dump-graph | restore-graph: the {len(suffixes)} files are "
          f"byte-identical ({os.path.getsize(dump)} B of text)")

    # the supergraph of the cleaned graph, before any threading: one
    # superpath a linear segment, so its contigs are the linear contigs
    for cmd in ("build-entry-edge-set", "build-supergraph"):
        walls[cmd], log = run(cmd, [cmd, "-G", src])
        print(f"  {log.splitlines()[-1].split(chr(9))[-1]}", flush=True)
    sfa = os.path.join(tmp, "super-contigs.fa")
    walls["print-contigs (supergraph)"], log = run(
        "print-contigs (supergraph)", ["print-contigs", "-G", src, "-o", sfa,
                                       "--min-length", "100"])
    # the headers differ: a linear contig is named by its segment, a
    # supergraph contig by its superpath
    lin, sup = contig_stats(fa)[0], contig_stats(sfa)[0]
    with open(fa, "rb") as a, open(sfa, "rb") as b:
        same = a.read() == b.read()
    check(sorted(lin) == sorted(sup)
          and f"print-contigs: {len(contigs)} contigs (supergraph)" in log,
          f"the supergraph's {len(sup)} contigs are the linear contigs' "
          f"sequences (in the same order: {lin == sup}; files byte-identical: "
          f"{same})")
    print(f"assembly -k {k} on the host of {smi} (no device work): walls (s) "
          f"{ {name: round(w, 3) for name, w in walls.items()} }", flush=True)
    return inferred[0]


# ------------------------------------------------------------ gossple phase
GK = 25  # gossple -k 25
# the genome of the gossple cell: the assembly cell's 4.6 Mbp cut to 1.5 Mbp,
# so that the phase's host stages stay near 150 s (PERF.md section 4)
G_LEN = 1_500_000
# (length, families, copies of each) planted in the genome: few copies, so
# that no read error inside a repeat reaches the trim cutoff
REPEATS = ((60, 25, 4), (250, 10, 4))
HOLES = (10, 150)  # stretches no read covers, which pairs span: (count, bp)
# the valley of the read set's count histogram.  The coverage model infers
# 2 to 3 here (the repeats' and the holes' counts widen its fitted peak),
# which keeps read errors of count 2 to 4 in the graph, and thread-pairs then
# threads a few joins through an error segment (the JAX package does the
# same): the contigs hold a few bases that are in no genome.
G_CUTOFF = 5


def make_pairs(rng, genome_len=G_LEN, coverage=30, read_len=100, insert=400,
               insert_sd=40, sub_rate=0.005, pairs_with_n=0.001):
    """A seeded genome with planted exact repeats, and read pairs from it
    -> (genome codes, r1, r2 codes (0-3, 4 = N) uint8[n_pairs, read_len]).
    Each REPEATS family is one random sequence copied into the genome at
    random places 1 kbp apart: the 60 bp ones are longer than k and shorter
    than a read, the 250 bp ones longer than a read and shorter than the
    insert.  No read covers the HOLES, so only pairs join their two sides.
    Pairs face each other (r1 forward, r2 the reverse complement of the
    fragment's far end), from either strand; inserts are normal, mean
    ``insert``, sd ``insert_sd``; one pair in 1000 has an N."""
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    n_copies = sum(f * c for _l, f, c in REPEATS)
    slots = rng.permutation(rng.choice(genome_len // 1000 - 1,
                                       n_copies + HOLES[0], replace=False)
                            ) * 1000 + 500
    at = 0
    for length, families, copies in REPEATS:
        for _ in range(families):
            seq = rng.integers(0, 4, length, dtype=np.uint8)
            for p in slots[at : at + copies]:
                genome[p : p + length] = seq
            at += copies
    n = genome_len * coverage // (2 * read_len)
    ins = np.clip(np.rint(rng.normal(insert, insert_sd, n)).astype(np.int64),
                  read_len, None)
    starts = rng.integers(0, genome_len - ins + 1)
    keep = np.ones(n, bool)
    for h in slots[at:]:
        for s in (starts, starts + ins - read_len):
            keep &= (s + read_len <= h) | (s >= h + HOLES[1])
    starts, ins, n = starts[keep], ins[keep], int(keep.sum())
    win = np.lib.stride_tricks.sliding_window_view(genome, read_len)
    r1 = win[starts]
    r2 = 3 - win[starts + ins - read_len][:, ::-1]
    flip = rng.random(n) < 0.5  # the fragment of the other strand
    r1[flip], r2[flip] = r2[flip], r1[flip].copy()
    for reads in (r1, r2):
        flat = reads.reshape(-1)
        n_sub = rng.binomial(flat.size, sub_rate)
        pos = rng.integers(0, flat.size, n_sub)
        flat[pos] = (flat[pos] + rng.integers(1, 4, n_sub, dtype=np.uint8)) % 4
    rows = rng.choice(n, int(n * pairs_with_n), replace=False)
    half = rng.random(len(rows)) < 0.5
    for reads, mine in ((r1, rows[half]), (r2, rows[~half])):
        reads[mine, rng.integers(0, read_len, len(mine))] = 4
    return genome, r1, r2


def write_fastq(path: str, reads: np.ndarray, mate: int) -> None:
    """``@p<7-digit pair id>/<mate>``, the bases, ``+``, all qualities I."""
    n, length = reads.shape
    head = 12
    rec = np.empty((n, head + 2 * length + 4), np.uint8)
    rec[:, 0:2] = np.frombuffer(b"@p", np.uint8)
    idx = np.arange(n)
    for j in range(7):
        rec[:, 2 + j] = ord("0") + (idx // 10 ** (6 - j)) % 10
    rec[:, 9:12] = np.frombuffer(f"/{mate}\n".encode(), np.uint8)
    rec[:, head : head + length] = ACGTN[reads]
    rec[:, head + length : head + length + 3] = np.frombuffer(b"\n+\n",
                                                              np.uint8)
    rec[:, head + length + 3 : -1] = ord("I")
    rec[:, -1] = ord("\n")
    rec.tofile(path)


def contig_stats(path: str) -> tuple[list[bytes], int, int]:
    """(sequences, count, N50) of a FASTA file of contigs."""
    with open(path, "rb") as f:
        seqs = [b"".join(r.split(b"\n")[1:]) for r in f.read().split(b">")[1:]]
    lengths = np.sort(np.array([len(s) for s in seqs], np.int64))[::-1]
    if not len(lengths):
        return seqs, 0, 0
    n50 = int(lengths[np.searchsorted(np.cumsum(lengths),
                                      (int(lengths.sum()) + 1) // 2)])
    return seqs, len(seqs), n50


def genome_pieces(seq: bytes, g: bytes, grc: bytes) -> list[int]:
    """Lengths of the fewest pieces ``seq`` splits into, each in ``g`` or in
    ``grc``: the longest prefix in either, again and again (greedy is
    optimal, since every piece of a substring is a substring)."""
    out = []
    while seq:
        if seq in g or seq in grc:
            return out + [len(seq)]
        lo, hi = 0, len(seq)  # longest prefix in either, by bisection
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if seq[:mid] in g or seq[:mid] in grc:
                lo = mid
            else:
                hi = mid - 1
        out.append(max(lo, 1))
        seq = seq[max(lo, 1):]
    return out


def gossple_phase(dev, smi: str, tmp: str, genome_len: int = G_LEN) -> int:
    """``gossple -k 25 -C 5 --device <dev>`` on read pairs of a genome with
    planted repeats and coverage holes, every stage: build-graph,
    trim-graph, prune-tips x4, pop-bubbles, build-entry-edge-set,
    build-supergraph, thread-pairs, thread-reads, build-scaffold, scaffold,
    print-contigs.  gossple runs as
    a user calls it; the smoke wraps ``App.main``, which gossple calls once
    a stage, to time each stage, give it a log file, read its peak device
    memory and copy the graph after build-graph and after pop-bubbles.
    Checks: the build-graph stage's graph == a numpy/``torch.unique`` count
    of all reads; every N-free piece of every contig, cut where the scaffold
    printed a gap estimated at 0 or less, is in the genome or its reverse
    complement; no more contigs and no lower N50 than the
    linear contigs of the cleaned graph; ``lint-graph`` passes.  Then the
    two ways ``thread-reads`` can learn read ends (native blocks with a
    count of read lengths, which it takes; parsed reads) are timed.
    -> merge_fold launches of the run."""
    import torch

    from gossamer_tpu_torch.cli import framework
    from gossamer_tpu_torch.cli.goss import main as goss
    from gossamer_tpu_torch.cli.gossple import main as gossple
    from gossamer_tpu_torch.io.factory import PhysicalFileFactory
    from gossamer_tpu_torch.io.native import native_read_blocks, read_lengths
    from gossamer_tpu_torch.io.readers import read_file
    from gossamer_tpu_torch.ops import fold

    rho = GK + 1
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    genome, r1, r2 = make_pairs(np.random.default_rng(6), genome_len)
    lhs, rhs = os.path.join(tmp, "p_1.fastq"), os.path.join(tmp, "p_2.fastq")
    write_fastq(lhs, r1, 1)
    write_fastq(rhs, r2, 2)
    print(f"gossple read set: genome {genome_len} bp with "
          f"{', '.join(f'{f} {n} bp repeats in {c} copies each' for n, f, c in REPEATS)}; "
          f"{len(r1)} pairs of {r1.shape[1]} bp, "
          f"{int((r1 == 4).any(1).sum() + (r2 == 4).any(1).sum())} reads with "
          f"an N; made in {time.perf_counter() - t0:.1f} s", flush=True)

    base = os.path.join(tmp, "gossple")
    stages = []

    def copy_graph(to: str) -> None:
        for suffix in (".header", ".edges-lo", ".edges-hi", ".counts",
                       "-counts-hist.txt"):
            if os.path.exists(base + suffix):
                shutil.copyfile(base + suffix, to + suffix)

    real_main = framework.App.main

    def staged(app, argv):
        log = os.path.join(tmp, f"gossple-stage{len(stages)}.log")
        before = fold.merge_fold.launches
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.perf_counter()
        rc = real_main(app, [*argv, "-l", log])
        wall = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        with open(log) as f:
            info = [ln.split("\t")[-1] for ln in f.read().splitlines()
                    if argv[0] in ln.split("\t")[-1]]
        stages.append({"stage": argv[0], "rc": rc, "wall": wall, "peak": peak,
                       "merge_fold": fold.merge_fold.launches - before,
                       "log": info[-1] if info else ""})
        if argv[0] == "build-graph":
            copy_graph(base + "_built")
        elif argv[0] == "pop-bubbles":
            copy_graph(base + "_cleaned")
        return rc

    fold.merge_fold.launches = 0
    framework.App.main = staged
    try:
        t0 = time.perf_counter()
        rc = gossple(["-k", str(GK), "-C", str(G_CUTOFF), "-O", base, "-p",
                      lhs, rhs, "--device", str(dev)])
        wall = time.perf_counter() - t0
    finally:
        framework.App.main = real_main
    launches = fold.merge_fold.launches
    for i, st in enumerate(stages):
        print(f"  [stage {i}] {st['stage']} on {smi}: wall {st['wall']:.3f} s, "
              f"peak device memory {st['peak']} B, merge_fold launches "
              f"{st['merge_fold']}; {st['log']}", flush=True)
    check(rc == 0 and len(stages) == 11 and all(st["rc"] == 0 for st in stages),
          f"gossple ran its 11 stages, exit code 0 ({wall:.1f} s)")

    lo, hi, counts = read_graph(base + "_built")
    olo, oc = read_set_spectrum(np.concatenate([r1, r2]), rho, dev)
    check(np.array_equal(lo, olo) and np.array_equal(counts, oc)
          and not hi.any(),
          f"the build-graph stage's graph == the numpy/torch.unique count of "
          f"all {2 * len(r1)} reads ({len(olo)} edges)")
    del olo, oc, r1, r2

    seqs, n_final, n50_final = contig_stats(base + "-contigs.fa")
    # a gap that the scaffold estimated at 0 or less is printed without N:
    # the two sides abut, or overlap by -gap bases (``path_contig``), so an
    # N-free piece is cut there too.  Where the gaps sit comes from the same
    # contigs printed with --verbose-headers (the path's segments in order).
    verbose = base + "-contigs-verbose.fa"
    check(goss(["print-contigs", "-G", base, "--min-length", "100",
                "--verbose-headers", "-o", verbose, "--device", str(dev)]) == 0
          and contig_stats(verbose)[0] == seqs,
          "print-contigs --verbose-headers gives the same contigs")
    with open(verbose, "rb") as f:
        heads = [r.split(b"\n", 1)[0] for r in f.read().split(b">")[1:]]
    g = ACGTN[:4][genome].tobytes()
    grc = ACGTN[:4][3 - genome[::-1]].tobytes()
    n_pieces = n_cuts = n_bases = 0
    bad = []
    for head, seq in zip(heads, seqs):
        inside = [0]  # gaps <= 0 between two gaps printed as N
        for tok in head.split(b"[")[2].split(b"]")[0].split(b":"):
            if tok.endswith(b"g"):
                if int(tok[:-1]) > 0:
                    inside.append(0)
                else:
                    inside[-1] += 1
        parts = re.split(b"N+", seq)
        if len(parts) != len(inside):
            bad.append((head.split()[0], "N runs", len(parts) - 1, "gaps > 0",
                        len(inside) - 1))
            continue
        for part, cuts in zip(parts, inside):
            found = genome_pieces(part, g, grc)
            n_pieces, n_cuts, n_bases = (n_pieces + 1, n_cuts + cuts,
                                         n_bases + len(part))
            if len(found) > cuts + 1 or min(found) < rho:
                bad.append((head.split()[0], len(part), found, cuts))
    check(n_final > 0 and not bad,
          f"every N-free piece of the {n_final} contigs ({n_pieces} pieces, "
          f"{n_bases} bases), cut at its {n_cuts} gaps estimated at 0 or "
          f"less, is in the genome or its reverse complement, and each N run "
          f"is a gap estimated above 0 (not: {bad[:5]})")
    linear = base + "_cleaned-contigs.fa"
    check(goss(["print-contigs", "-G", base + "_cleaned", "--min-length",
                "100", "-o", linear, "--device", str(dev)]) == 0,
          "print-contigs of the cleaned graph's copy exit code 0")
    _s, n_linear, n50_linear = contig_stats(linear)
    check(n_final <= n_linear and n50_final >= n50_linear,
          f"gossple's {n_final} contigs (N50 {n50_final}) against the cleaned "
          f"graph's {n_linear} linear contigs (N50 {n50_linear}): no more, "
          f"N50 no lower")
    lint = os.path.join(tmp, "gossple-lint.log")
    rc = goss(["lint-graph", "-G", base, "--device", str(dev), "-l", lint])
    with open(lint) as f:
        check(rc == 0 and "lint-graph: ok" in f.read(),
              "lint-graph passes on gossple's graph")
    peak = max(st["peak"] for st in stages)
    print(f"gossple -k {GK} on {smi}: wall {wall:.3f} s, {n_final} contigs, "
          f"N50 {n50_final} (linear: {n_linear}, N50 {n50_linear}), peak "
          f"device memory {peak} B ({peak / 2**30:.3f} GiB); stage walls (s) "
          f"{ {st['stage']: round(st['wall'], 3) for st in stages} }",
          flush=True)

    # how thread-reads learns where reads end: native blocks (255 ends a
    # read and stands for N alike) with a count of read lengths from the
    # files, which it takes, against parsing every read in Python
    files = [lhs, rhs]
    t0 = time.perf_counter()
    n_codes = sum(len(b) for b in native_read_blocks(files, "fastq", 1))
    blocks_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_reads = sum(len(read_lengths(p, "fastq")) for p in files)
    lengths_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fac = PhysicalFileFactory()
    n_parsed = sum(1 for p in files for _r in read_file(p, fac, "fastq"))
    parsed_s = time.perf_counter() - t0
    check(n_parsed == n_reads and n_codes >= n_reads,
          f"read ends: {n_reads} read lengths counted == {n_parsed} reads "
          f"parsed")
    print(f"thread-reads' reads on the host of {smi}: native blocks "
          f"{blocks_s:.3f} s ({n_codes} codes) + read-length count "
          f"{lengths_s:.3f} s (taken) against Python parsing {parsed_s:.3f} s "
          f"for {n_reads} reads", flush=True)
    check(launches > 0, f"merge_fold kernel launched {launches} times in "
                        f"gossple")
    return launches


# ----------------------------------------------------------- taxonomy phase
# root 1; genus A (2) holds species 4 and 5, the two references that share
# the 20 kbp segment; genus B (3) holds species 6 and 7
TAXONOMY = {1: (1, "root", "root"), 2: (1, "genus", "A"), 3: (1, "genus", "B"),
            4: (2, "species", "A1"), 5: (2, "species", "A2"),
            6: (3, "species", "B1"), 7: (3, "species", "B2")}
SPECIES = (4, 5, 6, 7)


def taxo_lca(nodes) -> int:
    """Lowest common ancestor in TAXONOMY, by walking ancestor paths."""
    paths = []
    for n in nodes:
        path = [n]
        while TAXONOMY[path[-1]][0] != path[-1]:
            path.append(TAXONOMY[path[-1]][0])
        paths.append(path[::-1])
    common = 0
    for level in zip(*paths):
        if len(set(level)) != 1:
            break
        common = level[0]
    return common


def taxo_report(per_read_node: list[int]) -> str:
    """The report ``classify-reads`` prints: counts summed up the tree,
    children before their parent, then the unclassified reads."""
    own = {n: per_read_node.count(n) for n in (0, *TAXONOMY)}
    kids = {n: [c for c, (p, _k, _n) in TAXONOMY.items() if p == n and c != n]
            for n in TAXONOMY}
    lines = []

    def walk(n: int) -> int:
        s = own[n] + sum(walk(c) for c in kids[n])
        if s > 0:
            lines.append(f"{s}\t{TAXONOMY[n][1]}\t{TAXONOMY[n][2]}")
        return s

    walk(1)
    if own[0]:
        lines.append(f"{own[0]}\tunclassified\tunclassified")
    return "".join(line + "\n" for line in lines)


def taxonomy_phase(dev, smi: str, tmp: str, inp: dict,
                   n_head: int = 20000) -> tuple[int, int]:
    """``build-kmer-set -k 25``, ``annotate-kmers`` and ``classify-reads`` over
    the electus phase's four references (four species under two genera), its
    numpy sets of them and its reads -> (merge_fold launches in
    ``build-kmer-set``, merge_sorted launches in ``classify-reads``)."""
    import torch

    from gossamer_tpu_torch.classify import device as cd
    from gossamer_tpu_torch.cli.goss import main as goss
    from gossamer_tpu_torch.convert import set_from_u64
    from gossamer_tpu_torch.graph.kmer_set import KmerSet
    from gossamer_tpu_torch.io.artifacts import read_array
    from gossamer_tpu_torch.io.factory import PhysicalFileFactory
    from gossamer_tpu_torch.ops import fold, merge
    from gossamer_tpu_torch.utils import profile

    k = EK
    refs, ref_fa, reads = inp["erefs"], inp["eref_fa"], inp["ereads"]
    device = ["--device", str(dev)]
    ks = os.path.join(tmp, "taxo_ks")
    taxo, annots = os.path.join(tmp, "taxo.tsv"), os.path.join(tmp, "annots.tsv")
    with open(taxo, "w") as f:
        f.write("".join(f"{n}\t{p}\t{kind}\t{name}\n"
                        for n, (p, kind, name) in TAXONOMY.items()))
    with open(annots, "w") as f:
        f.write("".join(f"{path}\t{node}\n" for path, node in zip(ref_fa, SPECIES)))

    zero_launches()
    t0 = time.perf_counter()
    rc = goss(["build-kmer-set", "-k", str(k), "-O", ks, *device,
               *[x for p in ref_fa for x in ("-I", p)]])
    build_wall = time.perf_counter() - t0
    build_launches = fold.merge_fold.launches
    check(rc == 0 and build_launches > 0,
          f"build-kmer-set -k {k} exit code 0, merge_fold kernel launched "
          f"{build_launches} times")
    t0 = time.perf_counter()
    rc = goss(["annotate-kmers", "-G", ks, "--annot-list", annots,
               "--taxonomy", taxo, *device])
    annot_wall = time.perf_counter() - t0
    check(rc == 0, "annotate-kmers exit code 0")

    # oracle: the union of the references' sets, each k-mer annotated with
    # the LCA of the species that hold it
    fac = PhysicalFileFactory()
    kset = KmerSet.read(ks, fac)
    annot = read_array(fac, ks + ".annotation")
    sets = inp["eref_sets"]
    ulo = merged_unique(*[s[0] for s in sets])
    uhi = np.zeros_like(ulo)
    check(np.array_equal(kset.lo, ulo) and np.array_equal(kset.hi, uhi),
          f"k-mer set of {kset.count} {k}-mers == the union of the "
          f"references' numpy sets")
    held = np.zeros(len(ulo), np.int64)
    for i, s in enumerate(sets):
        held[lookup128(ulo, uhi, *s)] |= 1 << i
    want_annot = np.zeros(len(ulo), np.uint32)
    for m in np.unique(held):
        want_annot[held == m] = taxo_lca(
            [SPECIES[i] for i in range(len(SPECIES)) if m >> i & 1])
    shared = int((want_annot == 2).sum())
    check(np.array_equal(annot, want_annot) and shared > 0,
          f"annotation of every k-mer == the LCA oracle ({shared} k-mers on "
          f"genus A, {int((want_annot == 1).sum())} on the root)")
    with open(ks + ".taxo") as a, open(taxo) as b:
        check(a.read() == b.read(), "the taxonomy was copied beside the set")

    torch.cuda.reset_peak_memory_stats(dev)
    profile.reset()
    profile.enable()
    zero_launches()
    stdout = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        rc = goss(["classify-reads", "-G", ks, "-I", inp["er_fa"], *device])
    wall = time.perf_counter() - t0
    launches = merge_launches("classify-reads")
    peak = torch.cuda.max_memory_allocated(dev)
    profile.enable(False)
    phases = profile.totals()
    check(rc == 0, "classify-reads exit code 0")
    print(stdout.getvalue(), end="", flush=True)
    want_launches = -(-len(reads) // 4096)
    check(launches == want_launches,
          f"merge_sorted kernel launched {launches} times in classify-reads: "
          f"once a batch of 4096 reads")
    full = stdout.getvalue().splitlines()
    check(int(full[-2].split("\t")[0]) + int(full[-1].split("\t")[0])
          == len(reads) and full[-1].endswith("unclassified"),
          f"root and unclassified lines sum to {len(reads)} reads")

    # oracle on the first reads: windows looked up in the set, per-read LCA
    head = reads[:n_head]
    lo, hi, valid = window_keys(head, k)
    row = np.broadcast_to(np.arange(len(head))[:, None], lo.shape)[valid]
    r = lookup128(kset.lo, kset.hi, *normalized(lo[valid], hi[valid], k))
    pairs = np.unique((row[r >= 0] << 32) | want_annot[r[r >= 0]])
    nodes_of = [set() for _ in head]
    for rid, node in zip((pairs >> 32).tolist(), (pairs & 0xFFFFFFFF).tolist()):
        nodes_of[rid].add(node)
    per_read = [taxo_lca(ns) if ns else 0 for ns in nodes_of]

    def classify(name: str, rows: np.ndarray) -> str:
        path = os.path.join(tmp, name)
        write_fasta(path, rows)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = goss(["classify-reads", "-G", ks, "-I", path, *device])
        check(rc == 0, f"classify-reads of {name} exit code 0")
        return out.getvalue()

    check(classify("taxo_head.fa", head) == taxo_report(per_read),
          f"first {len(head)} reads ({int((head == 4).any(axis=1).sum())} with "
          f"an N): the report == the per-read numpy oracle (own counts "
          f"{ {n: per_read.count(n) for n in (0, *TAXONOMY)} })")
    # reads drawn from the shared segment (the first species' copy): on the
    # genus, but for the few whose every matched window spans a base where
    # the second species' copy differs, which belong to the first species
    seg_rows = np.nonzero(inp["ereads_src"][:n_head] == len(refs))[0]
    seg_nodes = [per_read[i] for i in seg_rows]
    on_genus = seg_nodes.count(2)
    check(classify("taxo_seg.fa", head[seg_rows]) == taxo_report(seg_nodes)
          and on_genus >= 0.98 * len(seg_rows) > 0
          and set(seg_nodes) <= {2, 4},
          f"of {len(seg_rows)} reads drawn from the shared segment {on_genus} "
          f"land on genus A, the LCA of the two species that share it, "
          f"{seg_nodes.count(4)} on the species they were drawn from, none "
          f"elsewhere; the CLI's report of them == the oracle")

    # one full batch: the join on the card == the same call on CPU tensors
    codes = [np.where(c < 4, c, 255).astype(np.uint8) for c in reads[:4096]]
    window = cd._default_window(codes, 1 << 22)
    flat, _starts = cd._flat_batch(codes, k, window)
    set_keys = set_from_u64(kset.lo, dev)
    before = merge.merge_sorted.launches
    on_card = cd.join_ranks_batch(torch.from_numpy(flat).to(dev), set_keys, k)
    on_cpu = cd.join_ranks_batch(torch.from_numpy(flat), set_keys.cpu(), k)
    check(merge.merge_sorted.launches == before + 1
          and torch.equal(on_card.cpu(), on_cpu) and int((on_cpu >= 0).sum()) > 0,
          f"join_ranks_batch on the card == on CPU tensors for one batch "
          f"(window {window}, {int((on_cpu >= 0).sum())} matched windows, set "
          f"{kset.count} lanes)")

    scope = {name: phases.get(f"classify/{name}", 0.0)
             for name in ("encode", "pack", "launch", "wait", "lca")}
    other = wall - sum(scope.values())
    print(f"taxonomy -k {k} on {smi}: build-kmer-set {kset.count} k-mers, wall "
          f"{build_wall:.3f} s ({build_launches} merge_fold launches); "
          f"annotate-kmers wall {annot_wall:.3f} s (host); classify-reads "
          f"{len(reads)} reads, wall {wall:.3f} s -> {len(reads) / wall:.0f} "
          f"reads/s (host-bound); phases (s, host clock): encode "
          f"{scope['encode']:.3f}, pack {scope['pack']:.3f}, launch "
          f"{scope['launch']:.3f}, wait for the device {scope['wait']:.3f}, "
          f"per-read LCA {scope['lca']:.3f}, other (parse, report) "
          f"{other:.3f}; {launches} merge_sorted launches; peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    return build_launches, launches


# ---------------------------------------------------------- long-tail phase
# what the phase cuts, against the sizes of the cells it reuses (PERF.md
# section 4): per-read Python in extract-reads, filter-reads, espresso and
# fix-reads, per-edge Python in dot-graph
LT_READS = 100_000  # extract-reads, filter-reads, espresso single/sparse-single
LT_QUERY = 10_000  # espresso query
LT_SEEDS = 1_000  # build-subgraph's seed reads (radius 1)
LT_FIX = 500  # fix-reads: ~20 ms a read of Python pairing on the card's host
TX_GENES = 100  # translucent: genes of three exons, two isoforms each
TX_RHO = 26  # translucent build-graph -k 25


def lt_runner(tmp: str, dev, walls: dict):
    """-> run(main, args, name, stdout=False) -> (log text, stdout): one call
    of a port CLI with ``--device`` and a log file, timed into ``walls``,
    exit code 0 checked."""
    device = ["--device", str(dev)]
    log = os.path.join(tmp, "lt.log")

    def run(main, args, name, stdout=False):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out) if stdout else contextlib.nullcontext():
            rc = main([*args, *device, "-l", log])
        walls[name] = time.perf_counter() - t0
        check(rc == 0, f"{name} exit code 0")
        with open(log) as f:
            return f.read(), out.getvalue()

    return run


def window_ranks(reads: np.ndarray, k: int, set_lo: np.ndarray,
                 normalize: bool, dev):
    """Each read on its own, windows holding an N skipped: (read of each
    k-window, FNV-normalized if asked; its index in the sorted narrow set,
    -1 where absent).  The windows, in read order, are looked up by
    ``torch.searchsorted`` on ``dev`` (keys below 2^62: int64 order)."""
    import torch

    lo, hi, valid = window_keys(reads, k)
    row = np.broadcast_to(np.arange(len(reads))[:, None], lo.shape)[valid]
    q = normalized(lo[valid], hi[valid], k)[0] if normalize else lo[valid]
    r = torch.searchsorted(torch.from_numpy(set_lo.view(np.int64)).to(dev),
                           torch.from_numpy(q.view(np.int64)).to(dev))
    r = r.clamp_(max=len(set_lo) - 1).cpu().numpy()
    return row, np.where(set_lo[r] == q, r, -1)


def graft_windows(inp: dict, graft_lo: np.ndarray, dev):
    """:func:`window_ranks` of the first LT_READS xenome reads' normalized
    25-windows in the graft's set, made once for filter-reads and espresso."""
    if "lt_graft_windows" not in inp:
        inp["lt_graft_windows"] = window_ranks(inp["reads"][:LT_READS], EK,
                                               graft_lo, True, dev)
    return inp["lt_graft_windows"]


def key_bases(keys: np.ndarray, k: int) -> np.ndarray:
    """uint8[n, k] ASCII bases of narrow keys."""
    shifts = U64(2) * np.arange(k - 1, -1, -1, dtype=U64)
    return ACGTN[((keys[:, None] >> shifts) & U64(3)).astype(np.uint8)]


def set_algebra_part(dev, smi: str, tmp: str, inp: dict, run, goss,
                     n_sample: int = 20_000) -> tuple[int, int]:
    """``build-kmer-set -k 25`` of the four electus references, the set
    algebra of the first two, ``merge-and-annotate-kmer-sets`` and
    ``compute-near-kmers`` on the card, ``pool-samples`` of all four ->
    (merge_fold launches of the four builds, peak device memory of
    compute-near-kmers)."""
    import torch

    from gossamer_tpu_torch.classify.annotated_set import AnnotatedKmerSet
    from gossamer_tpu_torch.graph.kmer_set import KmerSet
    from gossamer_tpu_torch.io.artifacts import read_array
    from gossamer_tpu_torch.io.factory import PhysicalFileFactory
    from gossamer_tpu_torch.ops import fold

    k, fac, on_card = EK, PhysicalFileFactory(), dev.type == "cuda"
    names = ("graft", "host", "ref2", "ref3")
    bases = [os.path.join(tmp, f"lt_{n}") for n in names]
    fold.merge_fold.launches = 0
    for base, path, name in zip(bases, inp["eref_fa"], names):
        run(goss, ["build-kmer-set", "-k", str(k), "-I", path, "-O", base],
            f"build-kmer-set {name}")
    launches = fold.merge_fold.launches
    check(launches > 0 or not on_card,
          f"merge_fold kernel launched {launches} times in the four "
          f"build-kmer-set runs")
    want = inp["eref_sets"]
    sets = [KmerSet.read(b, fac) for b in bases]
    check(all(np.array_equal(s.lo, w[0]) and not s.hi.any()
              for s, w in zip(sets, want)),
          f"the four sets ({[s.count for s in sets]} {k}-mers) == the numpy "
          f"sets of the references")
    a, b = want[0][0], want[1][0]
    a_in_b = np.isin(a, b, assume_unique=True)  # a merge sort of two runs
    union = merged_unique(a, b)
    for cmd, oracle in (("merge-kmer-sets", union),
                        ("intersect-kmer-sets", a[a_in_b]),
                        ("subtract-kmer-set", a[~a_in_b])):
        out = os.path.join(tmp, f"lt_{cmd.split('-')[0]}")
        run(goss, [cmd, "-G", bases[0], "-G", bases[1], "-O", out], cmd)
        got = KmerSet.read(out, fac)
        check(np.array_equal(got.lo, oracle) and len(oracle) > 0,
              f"{cmd}: {got.count} k-mers == numpy's merge of the sorted sets")

    ann_base = os.path.join(tmp, "lt_ann")
    run(goss, ["merge-and-annotate-kmer-sets", "-G", bases[0], "-G", bases[1],
               "-O", ann_base], "merge-and-annotate-kmer-sets")
    ann = AnnotatedKmerSet.read(ann_base, fac)
    in_a = np.isin(union, a, assume_unique=True)
    in_b = np.isin(union, b, assume_unique=True)
    check(np.array_equal(ann.kset.lo, union) and np.array_equal(ann.lhs, in_a)
          and np.array_equal(ann.rhs, in_b),
          f"merge-and-annotate: {ann.kset.count} k-mers and both bit vectors "
          f"== numpy ({int((in_a & in_b).sum())} common)")
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    log, _ = run(goss, ["compute-near-kmers", "-G", ann_base],
                 "compute-near-kmers")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    near = AnnotatedKmerSet.read(ann_base, fac)
    gray = int(log.split("compute-near-kmers: ")[1].split()[0])
    cleared = (ann.lhs != near.lhs) | (ann.rhs != near.rhs)
    excl = ann.lhs != ann.rhs
    # oracle on every cleared k-mer and a sample of the other exclusive
    # ones: every single-base substitution of the low K bits (the
    # reference's probes), normalized and looked up in the union
    rng = np.random.default_rng(5)
    rest = np.nonzero(excl & ~cleared)[0]
    idx = np.sort(np.concatenate([np.nonzero(cleared)[0],
                                  rng.choice(rest, n_sample, replace=False)]))
    x, zx, zu = union[idx], np.zeros(len(idx), U64), np.zeros_like(union)
    found = np.zeros(len(idx), bool)
    for j in range(k):
        for bit in (1, 2, 3):
            yn = normalized(x ^ U64(bit << j), zx, k)[0]
            r = lookup128(union, zu, yn, zx)
            rr = np.maximum(r, 0)
            found |= ((r >= 0) & (in_a[rr] != in_b[rr]) & (in_a[rr] != in_a[idx]))
    check(gray == int(cleared.sum()) > 0 and not (cleared & ~excl).any()
          and not (near.lhs | near.rhs)[cleared].any()
          and np.array_equal(cleared[idx], found),
          f"compute-near-kmers on the card: {gray} marginal k-mers, both bits "
          f"cleared on them only; on those and {n_sample} sampled other "
          f"exclusive k-mers, the marginal ones == a numpy probe of every "
          f"substitution ({int(found.sum())})")

    pool = os.path.join(tmp, "lt_pool")
    run(goss, ["pool-samples", *[x for b_ in bases for x in ("-G", b_)], "-O",
               pool], "pool-samples")
    pooled = KmerSet.read(pool, fac)
    mask = read_array(fac, pool + ".sample-mask")
    ulo = merged_unique(*[w[0] for w in want])
    held = np.zeros(len(ulo), U64)
    for i, w in enumerate(want):
        held[np.searchsorted(ulo, w[0])] |= U64(1 << i)
    check(np.array_equal(pooled.lo, ulo) and np.array_equal(mask, held),
          f"pool-samples: {pooled.count} k-mers x 4 samples, set and "
          f"presence masks == numpy")
    print(f"set algebra -k {k} on {smi}: sets of {[s.count for s in sets]} "
          f"k-mers, {launches} merge_fold launches in the builds; "
          f"compute-near-kmers {gray} marginal of {int(excl.sum())} exclusive, "
          f"peak device memory {peak} B ({peak / 2**30:.3f} GiB)", flush=True)
    return launches, peak


def graphs_part(dev, smi: str, tmp: str, inp: dict, genome, head, run,
                goss) -> None:
    """The assembly cell's graphs: ``estimate-errors`` and ``detect-variants``
    of the raw ``-k 25`` graph, ``trim-paths`` of the graph trimmed at 2,
    ``build-subgraph`` (radius 1) and ``dot-graph``, ``extract-reads``,
    ``fix-reads`` on the cleaned graph, ``filter-reads`` of xenome reads
    against the graft's set, ``extract-core-genome`` of three graphs."""
    from gossamer_tpu_torch.core import kmer as K
    from gossamer_tpu_torch.graph.kmer_set import KmerSet
    from gossamer_tpu_torch.io.factory import PhysicalFileFactory

    rho, k, fac = RHO, RHO - 1, PhysicalFileFactory()
    raw, clean = os.path.join(tmp, f"g{rho}"), os.path.join(tmp, "asm_pop")
    rlo, _rhi, rcounts = read_graph(raw)
    clo, _chi, _cc = read_graph(clean)

    # estimate-errors: the printed error mass == the numpy histogram's
    _log, out = run(goss, ["estimate-errors", "-G", raw], "estimate-errors",
                    stdout=True)
    vals = dict(line.split("\t") for line in out.splitlines())
    cutoff = int(vals["error-cutoff"])
    mass = float(rcounts[rcounts < cutoff].sum()) / float(rcounts.sum())
    check(list(vals) == ["estimated-coverage", "error-cutoff",
                         "error-mass-fraction"]
          and 2 <= cutoff <= 10 and 15 <= int(vals["estimated-coverage"]) <= 30
          and abs(float(vals["error-mass-fraction"]) - mass) <= 1e-5 * mass,
          f"estimate-errors of the raw graph: {vals} (numpy error mass "
          f"{mass:.6g})")

    # detect-variants: raw graph against the cleaned one == numpy
    var = os.path.join(tmp, "lt_variants.txt")
    run(goss, ["detect-variants", "--graph-ref", clean, "--graph-target", raw,
               "-o", var], "detect-variants")
    novel = lookup128(clo, np.zeros_like(clo), rlo, np.zeros_like(rlo)) < 0
    frm = (rlo >> U64(2)) << U64(2)
    anchored = np.searchsorted(clo, frm + U64(4)) > np.searchsorted(clo, frm)
    sel = np.nonzero(novel & anchored)[0]
    strs = key_bases(rlo[sel], rho)
    want = "".join(f"{s}\t{c}\n" for s, c in zip(
        (row.tobytes().decode() for row in strs), rcounts[sel].tolist()))
    with open(var) as f:
        got = f.read()
    check(got == want and len(sel) > 0,
          f"detect-variants: {len(sel)} edges of the raw graph absent from "
          f"the cleaned one with their from-node in it == numpy, line for "
          f"line")
    del strs, want, got, novel, frm, anchored

    # trim-paths of the graph trimmed at 2 (tips and bubbles left)
    c2, tp = os.path.join(tmp, "asm_c2_trim"), os.path.join(tmp, "lt_trimpaths")
    log, _ = run(goss, ["trim-paths", "-G", c2, "-O", tp, "-C", "5"], "trim-paths")
    # the cleaned graph holds the genome's 26-mers (the assembly cell's
    # check), so an edge outside it is an error
    before, after = read_graph(c2)[0], read_graph(tp)[0]
    kept = np.isin(clo, after, assume_unique=True).mean()
    err_before = len(before) - int(np.isin(before, clo, True).sum())
    err_after = len(after) - int(np.isin(after, clo, True).sum())
    check(np.isin(after, before, assume_unique=True).all() and kept >= 0.999
          and err_after < err_before and len(after) < len(before),
          f"trim-paths -C 5 of the graph trimmed at 2: {len(before)} -> "
          f"{len(after)} edges, edges off the cleaned graph {err_before} -> "
          f"{err_after}, {100 * kept:.4f}% of the cleaned graph's kept "
          f"({log.splitlines()[-1].split(chr(9))[-1]})")

    # build-subgraph from LT_SEEDS reads at radius 1 == numpy, then dot-graph
    seeds = os.path.join(tmp, "lt_seeds.fa")
    write_fasta(seeds, head[:LT_SEEDS])
    sub = os.path.join(tmp, "lt_sub")
    run(goss, ["build-subgraph", "-G", clean, "-I", seeds, "-O", sub,
               "--radius", "1"], "build-subgraph")
    wlo, _whi, valid = window_keys(head[:LT_SEEDS], rho)
    q = wlo[valid]
    qr = K.reverse_complement(q, np.zeros_like(q), rho)[0]
    z = np.zeros_like(clo)
    r = np.concatenate([lookup128(clo, z, q, np.zeros_like(q)),
                        lookup128(clo, z, qr, np.zeros_like(qr))])
    seed = np.unique(r[r >= 0])
    to = (clo[seed] & U64((1 << (2 * k)) - 1)) << U64(2)
    r0, r1 = np.searchsorted(clo, to), np.searchsorted(clo, to + U64(4))
    succ = np.concatenate([(r0 + j)[r0 + j < r1] for j in range(4)])
    rcs = K.reverse_complement(clo[seed], np.zeros(len(seed), U64), rho)[0]
    want_sub = clo[np.unique(np.concatenate(
        [seed, succ, np.searchsorted(clo, rcs)]))]
    got_sub = read_graph(sub)[0]
    check(np.array_equal(got_sub, want_sub) and len(seed) > 0,
          f"build-subgraph of {LT_SEEDS} reads at radius 1: {len(got_sub)} "
          f"edges == numpy ({len(seed)} hit by the reads)")
    dot = os.path.join(tmp, "lt_sub.dot")
    run(goss, ["dot-graph", "-G", sub, "-o", dot, "--label-edges"], "dot-graph")
    sb = key_bases(got_sub, rho)
    scounts = read_graph(sub)[2]
    want_dot = "digraph G {\n" + "".join(
        f'  "{row[:k].tobytes().decode()}" -> "{row[1:].tobytes().decode()}"'
        f' [label="{c}"];\n' for row, c in zip(sb, scounts.tolist())) + "}\n"
    with open(dot) as f:
        check(f.read() == want_dot,
              f"dot-graph of the subgraph: {len(got_sub)} labelled edges == "
              f"numpy")

    # extract-reads of assembly and xenome reads mixed, filter-reads of
    # xenome reads
    xreads = inp["reads"][:LT_READS]
    mixed = np.concatenate([head[: LT_READS // 2], xreads[: LT_READS // 2]])
    mixed = mixed[np.random.default_rng(3).permutation(len(mixed))]
    hfa = os.path.join(tmp, "lt_mixed.fa")
    write_fasta(hfa, mixed)
    ext = os.path.join(tmp, "lt_extract.fa")
    run(goss, ["extract-reads", "-G", clean, "-I", hfa, "-o", ext],
        "extract-reads")
    row, r = window_ranks(mixed, rho, clo, False, dev)
    hits = np.bincount(row[r >= 0], minlength=len(mixed))
    check(np.array_equal(fasta_ids(ext), np.nonzero(hits)[0]),
          f"extract-reads of {len(mixed)} reads, half of the genome, half "
          f"not ({int((mixed == 4).any(1).sum())} with an N): the "
          f"{int((hits > 0).sum())} reads emitted == a per-read oracle")
    xfa = os.path.join(tmp, "lt_xreads.fa")
    write_fasta(xfa, xreads)
    m, n = (os.path.join(tmp, f"lt_filter_{x}.fa") for x in "mn")
    run(goss, ["filter-reads", "-G", os.path.join(tmp, "lt_graft"), "-I", xfa,
               "--match-file", m, "--non-match-file", n], "filter-reads")
    graft_lo = KmerSet.read(os.path.join(tmp, "lt_graft"), fac).lo
    row, r = graft_windows(inp, graft_lo, dev)
    xhits = np.bincount(row[r >= 0], minlength=len(xreads))
    check(np.array_equal(fasta_ids(m), np.nonzero(xhits)[0])
          and np.array_equal(fasta_ids(n), np.nonzero(xhits == 0)[0]),
          f"filter-reads of {LT_READS} xenome reads "
          f"({int((xreads == 4).any(1).sum())} with an N) against the graft's "
          f"set: {int((xhits > 0).sum())} matched, the rest not, == a "
          f"per-read oracle")

    # extract-core-genome of the raw, cleaned and gossple graphs
    gos = os.path.join(tmp, "gossple")
    graphs = {raw: (rlo, rcounts), clean: (clo, _cc), gos: read_graph(gos)[::2]}
    _log, out = run(goss, ["extract-core-genome", "-G", raw, "-G", clean, "-G",
                           gos], "extract-core-genome", stdout=True)
    lines = [line.split("\t") for line in out.splitlines()]
    ok = len(lines) == 3
    for na, nb, d in lines:
        (alo, ac), (blo, bc) = graphs[na], graphs[nb]
        fa, fb = ac / float(ac.sum()), bc / float(bc.sum())
        r = lookup128(blo, np.zeros_like(blo), alo, np.zeros_like(alo))
        shared = np.zeros(len(blo), bool)
        shared[r[r >= 0]] = True
        d2 = (float(((fa[r >= 0] - fb[r[r >= 0]]) ** 2).sum())
              + float((fa[r < 0] ** 2).sum()) + float((fb[~shared] ** 2).sum()))
        ok &= abs(float(d) - d2) <= 1e-5 * d2
    check(ok, f"extract-core-genome: the three distances == numpy "
              f"({[round(float(x[2]), 9) for x in lines]})")
    del graphs

    # fix-reads: reads that equal the genome before and after
    fix_in, fix_out = (os.path.join(tmp, f"lt_fix_{x}.fa") for x in ("in", "out"))
    write_fasta(fix_in, head[:LT_FIX])
    run(goss, ["fix-reads", "-G", clean, "-I", fix_in, "-o", fix_out], "fix-reads")
    gkeys = window_keys(genome, rho)[0]
    order = np.argsort(gkeys)
    gsorted = gkeys[order]
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)

    def in_genome(seq: bytes) -> bool:
        """The read equals the genome or its reverse complement somewhere
        (the genome's 26-mers are distinct: random sequence)."""
        codes = lut[np.frombuffer(seq, np.uint8)]
        if len(codes) < rho or (codes == 4).any():
            return False
        for s in (codes, 3 - codes[::-1]):
            key = window_keys(s[:rho], rho)[0][0]
            at = min(int(np.searchsorted(gsorted, key)), len(gsorted) - 1)
            p = int(order[at])
            if gsorted[at] == key and np.array_equal(genome[p : p + len(s)], s):
                return True
        return False

    with open(fix_out, "rb") as f:
        recs = f.read().split(b">")[1:]
    fixed = [b"".join(r.split(b"\n")[1:]) for r in recs]
    n_corrected = sum(b" " in r.split(b"\n", 1)[0] for r in recs)
    before = sum(in_genome(ACGTN[r].tobytes()) for r in head[:LT_FIX])
    after = sum(in_genome(s) for s in fixed)
    check(len(fixed) == LT_FIX and after >= before and n_corrected > 0,
          f"fix-reads of {LT_FIX} reads: {n_corrected} corrected; reads equal "
          f"to the genome (either strand) {before} before, {after} after")
    print(f"graphs -k {k} on the host of {smi}: detect-variants {len(sel)} "
          f"edges, build-subgraph {len(got_sub)} edges, extract-reads "
          f"{int((hits > 0).sum())} of {len(mixed)}, fix-reads {before} -> "
          f"{after} of {LT_FIX} reads equal to the genome", flush=True)


def supergraph_part(dev, smi: str, tmp: str, run, goss) -> None:
    """gossple's graph, supergraph and scaffold library: ``build-edge-index``,
    ``dot-supergraph``, ``clip-links``, ``build-db``; then ``upgrade-graph
    --format reference`` of a copy of gossple's cleaned graph, read back."""
    import sqlite3

    from gossamer_tpu_torch.graph.graph import Graph
    from gossamer_tpu_torch.graph.supergraph import SuperGraph
    from gossamer_tpu_torch.io.artifacts import read_array
    from gossamer_tpu_torch.io.factory import PhysicalFileFactory

    fac = PhysicalFileFactory()
    base = os.path.join(tmp, "gossple")
    n_edges = len(read_graph(base)[0])
    sg = SuperGraph.read(base, fac)
    paths = [p for p in sorted(sg.path_ids()) if not sg.is_gap(p)]
    run(goss, ["build-edge-index", "-G", base], "build-edge-index")
    seg = read_array(fac, base + "-edge-index.edge-seg")
    check(len(seg) == -(-n_edges // 16) and (seg >= 0).mean() > 0.9,
          f"build-edge-index: {len(seg)} of {n_edges} edge ranks stored "
          f"(1/16), {100 * (seg >= 0).mean():.2f}% anchored")
    dot = os.path.join(tmp, "lt_sg.dot")
    run(goss, ["dot-supergraph", "-G", base, "-o", dot], "dot-supergraph")
    with open(dot) as f:
        lines = f.read().splitlines()
    check(lines[0] == "digraph SG {" and len(lines) == len(paths) + 2
          and lines[1].endswith(f' [label="{paths[0]}"];'),
          f"dot-supergraph: one line per superpath that is not a gap "
          f"({len(paths)})")
    with open(base + "-scaf.0.links") as f:
        links = [line for line in f.read().splitlines() if line]
    run(goss, ["clip-links", "-G", base, "-C", "10"], "clip-links")
    with open(base + "-scaf.0.links") as f:
        kept = [line for line in f.read().splitlines() if line]
    check(kept == [line for line in links if int(line.split("\t")[2]) >= 10],
          f"clip-links -C 10: {len(kept)} of {len(links)} links kept, those "
          f"with a count of 10 or more")
    db = os.path.join(tmp, "lt.db")
    run(goss, ["build-db", "-G", base, "-o", db], "build-db")
    con = sqlite3.connect(db)
    nodes = con.execute("SELECT id, length FROM nodes ORDER BY id").fetchall()
    seqs = con.execute("SELECT id, sequence FROM sequences ORDER BY id").fetchall()
    n_links = con.execute("SELECT COUNT(*) FROM links").fetchone()[0]
    con.close()
    check([i for i, _l in nodes] == paths
          and [(i, len(s)) for i, s in seqs] == nodes,
          f"build-db: one nodes row per superpath that is not a gap "
          f"({len(nodes)}), a sequence of its length each, {n_links} links")

    ref = os.path.join(tmp, "lt_ref")
    for suffix in (".header", ".edges-lo", ".counts", "-counts-hist.txt"):
        shutil.copyfile(base + "_cleaned" + suffix, ref + suffix)
    want = read_graph(ref)
    run(goss, ["upgrade-graph", "-G", ref, "--format", "reference"],
        "upgrade-graph --format reference")
    with open(ref + ".header", "rb") as f:
        binary = f.read(1) != b"{"
    back = Graph.read(ref, fac)
    check(binary and back.k == RHO - 1 and np.array_equal(back.lo, want[0])
          and np.array_equal(back.counts.astype(np.int64), want[2]),
          f"upgrade-graph --format reference of gossple's cleaned graph "
          f"({len(want[0])} edges, {sum(os.path.getsize(os.path.join(tmp, n)) for n in os.listdir(tmp) if n.startswith('lt_ref-'))} B "
          f"of reference files): read back equal")
    print(f"supergraph on the host of {smi}: {len(paths)} superpaths, "
          f"{len(kept)} links kept", flush=True)


def make_transcriptome(rng, n_genes: int = TX_GENES):
    """Genes of three random exons, 1.5-3 kbp in all, each with the isoform
    that skips the middle exon -> list of isoform codes."""
    isoforms = []
    for _ in range(n_genes):
        total = int(rng.integers(1500, 3001))
        mid = int(rng.integers(150, 400))
        first = int(rng.integers(300, total - mid - 300))
        exons = [rng.integers(0, 4, n, dtype=np.uint8)
                 for n in (first, mid, total - mid - first)]
        isoforms += [np.concatenate(exons), np.concatenate([exons[0], exons[2]])]
    return isoforms


def transcript_pairs(rng, isoforms, coverage=30, read_len=100, insert=300,
                     sub_rate=0.005):
    """Pairs of ``read_len`` reads at ``coverage`` from fragments of
    ``insert`` +- 10% of each isoform -> (lhs, rhs) uint8[n, read_len]."""
    lhs, rhs = [], []
    for t in isoforms:
        n = len(t) * coverage // (2 * read_len)
        size = np.minimum(rng.integers(int(0.9 * insert), int(1.1 * insert) + 1,
                                       n), len(t))
        start = (rng.random(n) * (len(t) - size + 1)).astype(np.int64)
        win = np.lib.stride_tricks.sliding_window_view(t, read_len)
        lhs.append(win[start])
        rhs.append(3 - win[start + size - read_len][:, ::-1])
    lhs, rhs = np.concatenate(lhs), np.concatenate(rhs)
    order = rng.permutation(len(lhs))
    lhs, rhs = lhs[order], rhs[order]
    for reads in (lhs, rhs):
        sub = rng.random(reads.shape) < sub_rate
        reads[sub] = (reads[sub] + rng.integers(1, 4, int(sub.sum()),
                                                dtype=np.uint8)) % 4
    return lhs, rhs


def translucent_part(dev, smi: str, tmp: str, run,
                     n_genes: int = TX_GENES) -> tuple[int, int]:
    """``translucent`` on paired reads of a seeded transcriptome:
    build-graph (the fold kernel), trim-graph, trim-relative, prune-tips,
    pop-bubbles, assemble -> (merge_fold launches of build-graph, its peak
    device memory)."""
    import torch

    from gossamer_tpu_torch.cli.translucent import main as translucent
    from gossamer_tpu_torch.ops import fold

    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    rng = np.random.default_rng(9)
    isoforms = make_transcriptome(rng, n_genes)
    lhs, rhs = transcript_pairs(rng, isoforms)
    r1, r2 = (os.path.join(tmp, f"tx_{m}.fastq") for m in (1, 2))
    write_fastq(r1, lhs, 1)
    write_fastq(r2, rhs, 2)
    print(f"translucent inputs: {n_genes} genes, {len(isoforms)} isoforms of "
          f"{min(map(len, isoforms))}-{max(map(len, isoforms))} bp "
          f"({sum(map(len, isoforms))} bp in all), {len(lhs)} pairs of "
          f"{lhs.shape[1]} bp; made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    g = os.path.join(tmp, "tx")
    fold.merge_fold.launches = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    run(translucent, ["build-graph", "-k", str(TX_RHO - 1), "-i", r1, "-i", r2,
                      "-O", g], "translucent build-graph")
    launches = fold.merge_fold.launches
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    check(launches > 0 or not on_card,
          f"merge_fold kernel launched {launches} times in translucent "
          f"build-graph")
    olo, oc = read_set_spectrum(np.concatenate([lhs, rhs]), TX_RHO, dev)
    built = read_graph(g)
    check(np.array_equal(built[0], olo) and np.array_equal(built[2], oc),
          f"translucent build-graph: {len(olo)} edges == the numpy/torch.unique "
          f"count of all {2 * len(lhs)} reads")
    src = g
    for cmd in ("trim-graph", "trim-relative", "prune-tips", "pop-bubbles"):
        out = f"{g}_{cmd.split('-')[1]}"
        run(translucent, [cmd, "-G", src, "-O", out], f"translucent {cmd}")
        src = out
    fa = os.path.join(tmp, "tx.fa")
    run(translucent, ["assemble", "-G", src, "-i", r1, "-i", r2, "-o", fa],
        "translucent assemble")
    seqs = [s.decode() for s in contig_stats(fa)[0]]
    fwd = [ACGTN[t].tobytes().decode() for t in isoforms]
    rev = [ACGTN[3 - t[::-1]].tobytes().decode() for t in isoforms]
    truth = np.concatenate([both_strands_keys(t, TX_RHO) for t in isoforms])
    keys = [window_keys(c, TX_RHO)[0] for c in read_contigs(fa)]
    share = np.isin(np.concatenate(keys), truth).mean() if keys else 0.0
    whole = sum(any(t in s or r in s for s in seqs) for t, r in zip(fwd, rev))
    most = sum(any(len(s) >= 0.9 * len(t) and (s in t or s in r) for s in seqs)
               for t, r in zip(fwd, rev))
    check(len(seqs) > 0 and share >= 0.99 and most > 0,
          f"translucent assemble: {len(seqs)} transcripts, "
          f"{100 * share:.3f}% of their {TX_RHO}-mers from the isoforms")
    print(f"translucent on {smi}: {len(isoforms)} isoforms, recovered whole "
          f"{whole} ({100 * whole / len(isoforms):.1f}%), at 90% of their "
          f"length or more within one transcript {most} "
          f"({100 * most / len(isoforms):.1f}%); build-graph {launches} "
          f"merge_fold launches, peak device memory {peak} B "
          f"({peak / 2**30:.3f} GiB)", flush=True)
    return launches, peak


def espresso_part(dev, smi: str, tmp: str, inp: dict, head, run) -> None:
    """``espresso single -k 10`` of LT_READS xenome reads, ``multi -k 10`` of
    two halves (xenome reads, assembly reads), ``sparse-single`` over the
    graft's set, ``query`` of LT_QUERY reads, ``similarity``."""
    from scipy.io import loadmat

    from gossamer_tpu_torch.cli.espresso import main as espresso
    from gossamer_tpu_torch.graph.kmer_set import KmerSet
    from gossamer_tpu_torch.io.factory import PhysicalFileFactory

    xreads = inp["reads"][:LT_READS]
    xfa = os.path.join(tmp, "lt_xreads.fa")
    half = LT_READS // 2
    parts = (xreads[:half], head[:half])
    pfa = [os.path.join(tmp, f"lt_half{i}.fa") for i in range(2)]
    for path, reads in zip(pfa, parts):
        write_fasta(path, reads)

    def dense(reads, k=10, split=None):
        """np.bincount of the reads' normalized k-windows (and of the
        first ``split`` reads' alone)."""
        lo, hi, valid = window_keys(reads, k)
        keys = normalized(lo[valid], hi[valid], k)[0].astype(np.int64)
        whole = np.bincount(keys, minlength=4 ** k)
        if split is None:
            return whole
        row = np.broadcast_to(np.arange(len(reads))[:, None], lo.shape)[valid]
        return whole, np.bincount(keys[row < split], minlength=4 ** k)

    single, multi = (os.path.join(tmp, f"lt_{n}.mat") for n in ("single", "multi"))
    run(espresso, ["single", "-k", "10", "-S", "x", "-I", xfa, "-o", single],
        "espresso single")
    run(espresso, ["multi", "-k", "10", "-S", "m", "-I", pfa[0], "-I", pfa[1],
                   "-o", multi], "espresso multi")
    rows = [*dense(xreads, split=half), dense(parts[1])]
    got_single, got_multi = loadmat(single)["x"], loadmat(multi)["m"]
    check(got_single.shape == (1, 4 ** 10) and np.array_equal(got_single[0], rows[0])
          and np.array_equal(got_multi, np.stack(rows[1:])),
          f"espresso single -k 10 of {LT_READS} reads and multi of two "
          f"halves == np.bincount of the normalized 10-mers "
          f"({int(rows[0].sum())} windows)")
    graft = os.path.join(tmp, "lt_graft")
    sparse = os.path.join(tmp, "lt_sparse.mat")
    run(espresso, ["sparse-single", "-G", graft, "-S", "s", "-I", xfa, "-o",
                   sparse], "espresso sparse-single")
    ks = KmerSet.read(graft, PhysicalFileFactory())
    row, r = graft_windows(inp, ks.lo, dev)
    want = np.bincount(r[r >= 0], minlength=ks.count)
    check(np.array_equal(loadmat(sparse)["s"][0], want),
          f"espresso sparse-single over the graft's {ks.count} k-mers == "
          f"numpy ({int(want.sum())} windows in the set)")
    qfa = os.path.join(tmp, "lt_query.fa")
    write_fasta(qfa, xreads[:LT_QUERY])
    _log, out = run(espresso, ["query", "-G", graft, "-I", qfa],
                    "espresso query", stdout=True)
    hits = np.bincount(row[(r >= 0) & (row < LT_QUERY)], minlength=LT_QUERY)
    check(out == "".join(f"r{i:07d}\t{c}\n" for i, c in enumerate(hits.tolist())),
          f"espresso query of {LT_QUERY} reads "
          f"({int((xreads[:LT_QUERY] == 4).any(1).sum())} with an N) == a "
          f"per-read oracle ({int((hits > 0).sum())} reads hit the set)")
    sim = os.path.join(tmp, "lt_sim.txt")
    run(espresso, ["similarity", "--matrices", single, "--matrices", multi,
                   "-o", sim], "espresso similarity")
    with open(sim) as f:
        lines = [line.split("\t") for line in f.read().splitlines()]
    vec = [v.astype(np.float64) for v in rows]
    ok = len(lines) == 3
    for (_a, _b, s), (i, j) in zip(lines, ((0, 1), (0, 2), (1, 2))):
        want_s = vec[i] @ vec[j] / (np.linalg.norm(vec[i]) * np.linalg.norm(vec[j]))
        ok &= abs(float(s) - want_s) <= 1e-5
    check(ok, f"espresso similarity of the three rows == numpy's cosine "
              f"({[x[2] for x in lines]})")


def long_tail_phase(dev, smi: str, tmp: str, inp: dict, genome,
                    head) -> dict:
    """The rest of the one-device ``goss`` and the ``translucent`` and
    ``espresso`` tools, on what the earlier phases left in ``tmp`` ->
    merge_fold launches per path."""
    from gossamer_tpu_torch.cli.goss import main as goss

    walls, parts = {}, {}
    run = lt_runner(tmp, dev, walls)
    launches, peaks = {}, {}

    def part(name, fn, *args):
        """-> fn(*args); its wall and its commands' walls into ``parts``."""
        t1, w1 = time.perf_counter(), sum(walls.values())
        out = fn(*args)
        parts[name] = (round(time.perf_counter() - t1, 3),
                       round(sum(walls.values()) - w1, 3))
        return out

    t0 = time.perf_counter()
    (launches["build-kmer-set (set algebra)"], peaks["compute-near-kmers"]) = \
        part("set algebra", set_algebra_part, dev, smi, tmp, inp, run, goss)
    part("graphs", graphs_part, dev, smi, tmp, inp, genome, head, run, goss)
    part("supergraph", supergraph_part, dev, smi, tmp, run, goss)
    (launches["translucent build-graph"], peaks["translucent build-graph"]) = \
        part("translucent", translucent_part, dev, smi, tmp, run)
    part("espresso", espresso_part, dev, smi, tmp, inp, head, run)
    print(f"long tail on {smi}: {time.perf_counter() - t0:.1f} s; by part "
          f"(wall, of which the commands) {parts}; walls (s) "
          f"{ {name: round(w, 3) for name, w in walls.items()} }; peak device "
          f"memory (B) {peaks}", flush=True)
    return launches


# ------------------------------------------------- several devices phase
MESH_SHARDS = 4  # the mesh of the several-devices phase, all on one card
SD_READS = 200_000  # reads through the sharded classifiers
GRAPH_SUFFIXES = (".header", ".edges-lo", ".edges-hi", ".counts",
                  "-counts-hist.txt")


def graph_files_equal(a: str, b: str) -> int:
    """Bytes of graph ``a``'s files when every one equals graph ``b``'s
    (the same files exist for both), else -1."""
    n = 0
    for suffix in GRAPH_SUFFIXES:
        if os.path.exists(a + suffix) != os.path.exists(b + suffix):
            return -1
        if os.path.exists(a + suffix):
            with open(a + suffix, "rb") as f, open(b + suffix, "rb") as g:
                if f.read() != g.read():
                    return -1
            n += os.path.getsize(a + suffix)
    return n


def shard_fold_stats(dev, smi: str, n_keys: int) -> dict:
    """merge_fold at the per-shard shape of the 4-shard count: the shard's
    spectrum at its cap (CAP // 4 lanes) holding ``n_keys`` keys, and the
    lanes it receives in a flush, 4 buckets of twice the even share, about
    half of them bucket padding, 3/4 of the rest valid, most keys already in
    the spectrum.  Kernel == plain, both timed."""
    import torch

    from gossamer_tpu_torch.ops import fold
    from gossamer_tpu_torch.ops.fold import SENT
    from gossamer_tpu_torch.parallel.count_sharded import bucket_size

    cap = CAP // MESH_SHARDS
    nb = MESH_SHARDS * bucket_size(CHUNK, MESH_SHARDS, 2)
    g = torch.Generator(device=dev).manual_seed(6)
    keys = torch.unique(torch.randint(0, 1 << 52, (n_keys,), device=dev,
                                      generator=g))
    a = torch.full((cap,), SENT, dtype=torch.int64, device=dev)
    a[: keys.numel()] = keys
    ac = torch.zeros(cap, dtype=torch.int64, device=dev)
    ac[: keys.numel()] = torch.randint(1, 1000, (keys.numel(),), device=dev,
                                       generator=g)
    n_valid = nb * 3 // 8
    old = keys[torch.randint(0, keys.numel(), (n_valid * 4 // 5,), device=dev,
                             generator=g)]
    new = torch.randint(0, 1 << 52, (n_valid - old.numel(),), device=dev,
                        generator=g)
    b = torch.full((nb,), SENT, dtype=torch.int64, device=dev)
    b[:n_valid] = torch.sort(torch.cat([old, new])).values
    bc = (b != SENT).to(torch.int64)
    got, _want, err = fold_pair(a, ac, b, bc, cap)
    check(err == 0, f"merge_fold kernel == plain at the per-shard shape: A "
                    f"{cap} lanes ({keys.numel()} keys), B {nb} lanes, live "
                    f"{int(got[2])}")
    kern = [time_ms(lambda: fold.merge_fold(a, ac, b, bc, cap))
            for _ in range(2)]
    plain = time_ms(lambda: fold.merge_fold_reference(a, ac, b, bc, cap))
    st = {"shape": f"per shard of 4: A {cap} lanes ({keys.numel()} keys), B "
                   f"{nb} lanes, cap {cap}", "max_abs_err": err,
          "ms": min(kern), "plain_ms": plain, **fold_bound(cap, nb, cap),
          "library_ms": None}
    print(f"merge_fold per shard on {smi}: {st['shape']}: kernel "
          f"{st['ms']:.4f} ms (runs {kern}), plain {plain:.3f} ms, bound "
          f"{st['bound_ms']:.4f} ms", flush=True)
    return st


def shard_merge_stats(dev, smi: str, set_shard) -> dict:
    """merge_sorted at each shard's classify join: its slice of the index
    (A) and one window of 2^20 query lanes, 3/4 valid, sorted (B)."""
    import torch

    from gossamer_tpu_torch.ops import merge
    from gossamer_tpu_torch.ops.fold import SENT

    g = torch.Generator(device=dev).manual_seed(7)
    a = set_shard
    av = torch.full_like(a, -1)
    nb = 1 << 20
    b = torch.full((nb,), SENT, dtype=torch.int64, device=dev)
    b[: nb * 3 // 4] = torch.sort(torch.randint(
        0, 1 << 52, (nb * 3 // 4,), device=dev, generator=g)).values
    bv = torch.arange(nb, dtype=torch.int64, device=dev)
    _got, err = merge_pair(a, av, b, bv)
    tile = merge._kernel_lib().gossamer_merge_tile()
    s_err = splits_err(a, b, tile)
    check(err == 0 and s_err == 0,
          f"merge_sorted kernel == plain and merge_splits == plain at a "
          f"shard's classify join: A {a.numel()} lanes, B {nb} lanes")

    def library():
        keys, order = torch.sort(torch.cat([a, b]), stable=True)
        return keys, torch.cat([av, bv])[order]

    check(all(torch.equal(x, y) for x, y in
              zip(merge.merge_sorted(a, av, b, bv), library())),
          "merge_sorted kernel == torch.sort(cat, stable=True) + gather at a "
          "shard's classify join")
    kern = [time_ms(lambda: merge.merge_sorted(a, av, b, bv))
            for _ in range(2)]
    st = {"shape": f"per shard of 4: A {a.numel()} lanes (a quarter of the "
                   f"index), B {nb} lanes", "max_abs_err": max(err, s_err),
          "ms": min(kern),
          "plain_ms": time_ms(lambda: merge.merge_sorted_reference(a, av, b, bv)),
          **merge_bound(a.numel(), nb), "library_ms": time_ms(library)}
    print(f"merge_sorted per shard on {smi}: {st['shape']}: kernel "
          f"{st['ms']:.4f} ms (runs {kern}), plain {st['plain_ms']:.3f} ms, "
          f"library sort + gather {st['library_ms']:.3f} ms, bound "
          f"{st['bound_ms']:.4f} ms", flush=True)
    return st


def several_devices_phase(dev, smi: str, tmp: str, inp: dict, fasta: str,
                          cutoff: int):
    """``parallel/*`` on a mesh of 4 shards, all on one card, against what
    the earlier phases wrote: the 4-shard count of the whole read set ==
    build-graph's files; the sharded trim, prune-tips walks and pop-bubbles
    == the assembly phase's files, the sharded degrees == the host Graph's;
    both sharded classifiers of 200,000 xenome reads (N included) ==
    ``classify_codes_device``; the wide 4-shard count of the 20k head ==
    its build-graph -k 55; ``build-graph --num-devices 2`` needs two cards.
    -> (merge_fold launches per path, merge_sorted launches per path, the
    kernels' per-shard stats)."""
    import torch

    from gossamer_tpu_torch.algo.tour_bus import pop_bubbles
    from gossamer_tpu_torch.classify.annotated_set import AnnotatedKmerSet
    from gossamer_tpu_torch.classify.device import (classify_codes_device,
                                                    encode_set)
    from gossamer_tpu_torch.cli.goss import main as goss
    from gossamer_tpu_torch.convert import set_from_u64
    from gossamer_tpu_torch.graph.graph import Graph
    from gossamer_tpu_torch.io.factory import PhysicalFileFactory
    from gossamer_tpu_torch.ops import fold, merge
    from gossamer_tpu_torch.ops.count import count_rho_mers_files
    from gossamer_tpu_torch.parallel import classify_sharded as CS
    from gossamer_tpu_torch.parallel.cleanup_sharded import (sharded_degrees,
                                                             sharded_trim_mask)
    from gossamer_tpu_torch.parallel.mesh import Mesh
    from gossamer_tpu_torch.parallel.walk_sharded import sharded_prune_tips_masks

    mesh = Mesh((dev,) * MESH_SHARDS)
    print(f"several devices: a mesh of {MESH_SHARDS} shards, all on {dev} "
          f"(one card): the collectives are copies within the card, and no "
          f"figure of this phase is a scaling across cards", flush=True)
    fac = PhysicalFileFactory()
    walls, fold_paths, merge_paths = {}, {}, {}

    def timed(name, fn, *args, **kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize(dev)
        walls[name] = round(time.perf_counter() - t0, 3)
        return out

    def path(name, count_of, paths, fn, *args, **kw):
        """Run ``fn`` with every kernel's count at 0 -> its result; the
        launches of ``count_of`` go to ``paths[name]``."""
        zero_launches()
        out = timed(name, fn, *args, **kw)
        paths[name] = (merge_launches(name) if count_of is merge.merge_sorted
                       else count_of.launches)
        return out

    def write_same(g, name: str, want: str, what: str) -> None:
        out = os.path.join(tmp, name)
        timed(f"write {name}", g.write, out, fac)
        n = graph_files_equal(os.path.join(tmp, want), out)
        check(n > 0, f"{what}: {g.count} edges, every file == {want}'s "
                     f"({n} B)")

    # 1. the 4-shard count of the whole read set, as build-graph -k 25 runs it
    logs = []
    torch.cuda.reset_peak_memory_stats(dev)
    name = "sharded count (4 shards on one card)"
    lo, hi, counts = path(
        name, fold.merge_fold, fold_paths, count_rho_mers_files, [fasta], RHO,
        both_strands=True, canonical=False, device=dev, chunk=CHUNK,
        cap_entries=CAP, threads=4, mesh=mesh,
        log=lambda _level, msg: logs.append(msg))
    peak = torch.cuda.max_memory_allocated(dev)
    n_fold = fold_paths[name]
    check(n_fold > 0 and n_fold % MESH_SHARDS == 0
          and merge.merge_sorted.launches == 0,
          f"merge_fold launched {n_fold} times in the 4-shard count "
          f"({n_fold // MESH_SHARDS} flushes x {MESH_SHARDS} shards)")
    inserted = int(counts.sum())
    n_live = len(lo) // 2 // MESH_SHARDS  # canonical keys a shard, about
    write_same(Graph(RHO - 1, lo, hi, counts), "mesh_g26", f"g{RHO}",
               "the 4-shard count of all reads")
    del lo, hi, counts
    line = [m for m in logs if m.startswith("count: ") and "phases" in m][0]
    phases = json.loads(line.split("phases (s) ")[1])
    print(f"sharded count on {smi}: {inserted} rho-mers, wall "
          f"{walls[name]:.3f} s -> {inserted / walls[name]:.0f} rho-mers/s; "
          f"phases (s) {phases} (merge: one torch.sort of the 4 shard spectra "
          f"on the card); peak device memory {peak / 2**30:.2f} GiB", flush=True)
    fold_shard = shard_fold_stats(dev, smi, n_live)

    # 2. cleanup on the -k 25 graph, against the assembly phase's files
    g = Graph.read(os.path.join(tmp, f"g{RHO}"), fac)
    out_d, in_d = timed("sharded_degrees", sharded_degrees, mesh, g.lo, RHO)
    t0 = time.perf_counter()
    want_out, want_in = g.node_degrees(*g.from_node(g.lo, g.hi))
    check(np.array_equal(out_d, want_out) and np.array_equal(in_d, want_in),
          f"sharded_degrees of {g.count} edges == the host Graph's (host "
          f"{time.perf_counter() - t0:.1f} s)")
    del out_d, in_d, want_out, want_in
    keep, kept = timed("sharded_trim_mask", sharded_trim_mask, mesh, g.counts,
                       cutoff)
    trimmed = g.remove_edges(~keep)
    check(trimmed.count == kept, f"trim mask keeps the {kept} edges its psum "
                                 f"counts (cutoff {cutoff})")
    write_same(trimmed, "mesh_trim", "asm_trim",
               f"sharded_trim_mask at the inferred cutoff {cutoff}")
    del g, keep, trimmed
    t = Graph.read(os.path.join(tmp, "asm_trim"), fac)
    tip_logs = []
    dead = timed("sharded_prune_tips_masks", sharded_prune_tips_masks, mesh,
                 t.lo, t.counts, RHO, iterations=4,
                 log=lambda _level, msg: tip_logs.append(msg))
    print("".join(f"  {m}\n" for m in tip_logs), end="", flush=True)
    write_same(t.remove_edges(dead), "mesh_prune", "asm_prune",
               "sharded_prune_tips_masks --iterate 4")
    del t, dead
    p = Graph.read(os.path.join(tmp, "asm_prune"), fac)
    popped, n_popped = timed("pop_bubbles(mesh=)", pop_bubbles, p, mesh=mesh)
    write_same(popped, "mesh_pop", "asm_pop",
               f"pop_bubbles(mesh=) ({n_popped} bubbles)")
    del p, popped

    # 3. both sharded classifiers against the one-device engine
    ann = AnnotatedKmerSet.read(os.path.join(tmp, f"idx{XK}"), fac)
    set_E = encode_set(ann.kset.lo, ann.lhs, ann.rhs)
    reads = inp["reads"][:SD_READS]
    codes = [np.where(r > 3, 255, r).astype(np.uint8) for r in reads]
    want = classify_codes_device(codes, set_from_u64(set_E, dev), XK)
    n_with_n = int((reads == 4).any(axis=1).sum())
    for name, cls in (("sharded classify (4 shards on one card)",
                       CS.ShardedClassifier),
                      ("ring classify (4 shards on one card)",
                       CS.RingClassifier)):
        clf = cls(mesh, set_E, XK)
        got = path(name, merge.merge_sorted, merge_paths, clf.classify_codes,
                   codes)
        check(merge_paths[name] > 0 and np.array_equal(got, want),
              f"{name}: {len(codes)} reads ({n_with_n} with an N) == "
              f"classify_codes_device; merge_sorted launched "
              f"{merge_paths[name]} times")
    merge_shard = shard_merge_stats(dev, smi, clf.shards[0])
    del clf, codes

    # 4. the wide 4-shard count of the head == its build-graph -k 55
    head_fa = os.path.join(tmp, "head.fa")
    name = "sharded count -k 55 (4 shards on one card)"
    wlo, whi, wc = path(
        name, fold.merge_fold, fold_paths, count_rho_mers_files, [head_fa],
        WIDE_RHO, both_strands=True, canonical=False, device=dev, chunk=CHUNK,
        cap_entries=CAP, threads=4, mesh=mesh)
    check(fold_paths[name] == 0, "merge_fold launches in the wide 4-shard "
                                 "count: 0 (PyTorch ops, as in the JAX package)")
    write_same(Graph(WIDE_RHO - 1, wlo, whi, wc), "mesh_h56", f"h{WIDE_RHO}",
               "the wide 4-shard count of the first 20k reads")

    # 5. the CLI: --num-devices 2 needs two cards
    n_cards = torch.cuda.device_count()
    out = os.path.join(tmp, "mesh_h26")
    args = ["build-graph", "-k", str(RHO - 1), "-I", head_fa, "-O", out,
            "--num-devices", "2", "--device", "cuda"]
    if n_cards < 2:
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = timed("build-graph --num-devices 2", goss, args)
        check(rc != 0 and f"and {n_cards} are visible" in err.getvalue()
              and not os.path.exists(out + ".header"),
              f"build-graph --num-devices 2 with {n_cards} card exits {rc}: "
              f"{err.getvalue().strip().splitlines()[-1]}")
    else:
        check(timed("build-graph --num-devices 2", goss, args) == 0
              and graph_files_equal(os.path.join(tmp, f"h{RHO}"), out) > 0,
              f"build-graph --num-devices 2 on {n_cards} cards == h{RHO}")
    print(f"several devices on {smi}: walls (s) {walls}", flush=True)
    return fold_paths, merge_paths, fold_shard, merge_shard


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from gossamer_tpu_torch.io import native
    from gossamer_tpu_torch.ops import nvcc

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = card_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}",
          flush=True)

    shutil.rmtree(nvcc.BUILD_DIR, ignore_errors=True)
    with ThreadPoolExecutor(3) as ex:
        jobs = {name: ex.submit(nvcc.build_library, name)
                for name in ("fold", "merge")}
        gxx = ex.submit(native.build_library)
        builds = {name: job.result() for name, job in jobs.items()}
        _so, gxx_s = gxx.result()
    print("build (in parallel): " + ", ".join(
        f"nvcc csrc/{name}.cu {b[1]:.3f} s" for name, b in builds.items())
          + f", g++ libgossio.so {gxx_s:.3f} s", flush=True)
    for name, b in builds.items():
        print("\n".join(f"{name}.cu {line}" for line in b[2].splitlines()
                        if "registers" in line), flush=True)

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        print(f"== {name}", flush=True)
        out = fn(*args)
        print(f"== {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    if argv == ["--wide-memory"]:
        phase("one wide flush's memory", wide_flush_memory, dev, smi,
              WIDE_RHO)
        with tempfile.TemporaryDirectory() as tmp:
            fasta = os.path.join(tmp, "reads.fa")
            write_fasta(fasta, make_reads(np.random.default_rng(2026))[1])
            phase("build-graph -k 55 sized now and before",
                  wide_cap_before_after, dev, smi, tmp, fasta, WIDE_RHO)
        return 0
    if argv == ["--routes"]:
        with tempfile.TemporaryDirectory() as tmp:
            fasta = os.path.join(tmp, "reads.fa")
            reads = make_reads(np.random.default_rng(2026))[1]
            write_fasta(fasta, reads)
            print(phase("build-graph -k 25", graph_phase, dev, smi, tmp, reads,
                        fasta, RHO), flush=True)
            for out in phase("engine routes -k 25", routes_phase, dev, smi,
                             tmp, fasta, RHO):
                print(json.dumps(out), flush=True)
        return 0
    check(not argv, f"no arguments, --wide-memory or --routes alone (got "
                    f"{argv})")
    fold_stats = phase("merge_fold kernel", fold_phase, dev, smi)
    merge_stats, merge_more = phase("merge_sorted kernel", merge_phase, dev, smi)
    fold_paths, merge_paths = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        genome, reads = make_reads(np.random.default_rng(2026))
        fasta = os.path.join(tmp, "reads.fa")
        write_fasta(fasta, reads)
        print(f"read set: {len(reads)} reads x {reads.shape[1]} bp, "
              f"{os.path.getsize(fasta)} B FASTA; made in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        fold_paths["build-graph"], merge_paths["build-graph"] = phase(
            "build-graph -k 25", graph_phase, dev, smi, tmp, reads, fasta, RHO)
        route_fold, route_merge, merge_routes = phase(
            "engine routes -k 25", routes_phase, dev, smi, tmp, fasta, RHO)
        fold_paths.update(route_fold)
        merge_paths.update(route_merge)
        merge_more.extend(merge_routes)
        (fold_paths["build-graph -k 55"],
         merge_paths["build-graph -k 55"]) = phase(
            "build-graph -k 55 (wide)", graph_phase, dev, smi, tmp, reads,
            fasta, WIDE_RHO)
        phase("one wide flush", wide_flush_ms, dev, smi, WIDE_RHO)
        cutoff = phase("assembly -k 25", assembly_phase, dev, smi, tmp, genome,
                       reads, RHO)
        head = reads[:LT_READS].copy()
        del reads
        fold_paths["gossple"] = phase("gossple -k 25", gossple_phase, dev, smi,
                                      tmp)
        inp = xenome_inputs(tmp)
        fold_paths["xenome index"], merge_paths["xenome classify"] = phase(
            "xenome -K 25", xenome_phase, dev, smi, tmp, inp, XK)
        (fold_paths["xenome index -K 40"],
         merge_paths["xenome classify -K 40"]) = phase(
            "xenome -K 40 (wide)", xenome_phase, dev, smi, tmp, inp, WIDE_XK)
        fold_paths["electus index"], merge_paths["electus classify"] = phase(
            "electus", electus_phase, dev, smi, tmp, inp)
        (fold_paths["build-kmer-set (taxonomy)"],
         merge_paths["classify-reads"]) = phase(
            "taxonomy -k 25", taxonomy_phase, dev, smi, tmp, inp)
        fold_paths.update(phase("long tail", long_tail_phase, dev, smi, tmp,
                                inp, genome, head))
        sd_fold, sd_merge, fold_shard, merge_shard = phase(
            "several devices (4 shards on one card)", several_devices_phase,
            dev, smi, tmp, inp, fasta, cutoff)
        fold_paths.update(sd_fold)
        merge_paths.update(sd_merge)
        fold_shard["paths"] = {n: c for n, c in sd_fold.items() if c}
        merge_shard["paths"] = dict(sd_merge)

    for name, st, paths in (("merge_fold", fold_stats, fold_paths),
                            ("merge_sorted", merge_stats, merge_paths),
                            *(("merge_sorted", st, st.pop("paths"))
                              for st in merge_more),
                            ("merge_fold", fold_shard, fold_shard["paths"]),
                            ("merge_sorted", merge_shard,
                             merge_shard["paths"])):
        print(f"{name} on {smi}, {st['shape']}: bound model "
              f"{st['bytes']} B (inputs once + outputs once) -> bound "
              f"{st['bound_ms']:.4f} ms by {st['bound_by']} at "
              f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s; kernel {st['ms']:.4f} ms "
              f"= {st['bytes'] / st['ms'] / 1e6:.0f} GB/s, "
              f"{100 * st['bound_ms'] / st['ms']:.1f}% of the bound; plain "
              f"{st['plain_ms']:.3f} ms; library "
              + ("none: no PyTorch call computes it" if st["library_ms"] is None
                 else f"{st['library_ms']:.3f} ms (stable sort + gather)")
              + f"; launches per path {paths}", flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": [
        {"name": "merge_fold", "route": "cuda",
         "source": "gossamer_tpu_torch/csrc/fold.cu",
         "replaces": "gossamer_tpu/ops/pallas_fold.py:151",
         "launches": sum(fold_paths.values()),
         "launches_per_path": fold_paths, **fold_stats,
         "per_shard": fold_shard},
        {"name": "merge_sorted", "route": "cuda",
         "source": "gossamer_tpu_torch/csrc/merge.cu",
         "replaces": "gossamer_tpu/ops/pallas_merge.py:116",
         "launches": sum(merge_paths.values()),
         "launches_per_path": merge_paths, **merge_stats,
         "shapes": merge_more, "per_shard": merge_shard}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
