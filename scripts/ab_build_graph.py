#!/usr/bin/env python3
"""``goss build-graph`` of this checkout against another one, in turns.

    python3 scripts/ab_build_graph.py OTHER_CHECKOUT [--rounds 2]

Makes the smoke's seeded E. coli-scale read set once, then runs the port's
``build-graph -k K --device cuda`` (``--kmer-size``, default 25) on it from this checkout and from
``OTHER_CHECKOUT`` (say, the parent commit unpacked with ``git archive``) in
the order this, other, other, this, ..., each run in a process of its own
with its native code built anew beforehand.  Prints every run's wall, count time,
phases, peak device memory and the count's log line (spills, where the
finish ran), and the two graphs must be equal.  Host phases vary between
calls by 10-20%, so two versions are compared only within one call.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

RUN = """
import json, shutil, sys, time
sys.path.insert(0, {root!r})
from gossamer_tpu_torch.cli.goss import main as goss
from gossamer_tpu_torch.io import native
from gossamer_tpu_torch.ops import nvcc
shutil.rmtree(nvcc.BUILD_DIR, ignore_errors=True)  # nothing built elsewhere
nvcc.build_library("fold")
nvcc.build_library("merge")
native.build_library()
import torch
t0 = time.perf_counter()
rc = goss(["build-graph", "-k", "{k}", "-I", {fasta!r}, "-O", {out!r},
           "--device", "cuda", "-l", {out!r} + ".log"])
wall = time.perf_counter() - t0
assert rc == 0
log = open({out!r} + ".log").read()
line = log.split("count: ")[1].splitlines()[0]
phases = json.loads(line.split("phases (s) ")[1])
print("RESULT " + json.dumps({{"wall": wall, "count": sum(phases.values()),
                              **phases,
                              "peak_bytes": torch.cuda.max_memory_allocated(),
                              "count_line": line.split(", phases")[0]}}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--kmer-size", type=int, default=chip_smoke.RHO - 1)
    args = ap.parse_args()
    trees = {"this": ROOT, "other": os.path.abspath(args.other)}
    print(chip_smoke.card_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        fasta = os.path.join(tmp, "reads.fa")
        chip_smoke.write_fasta(fasta, chip_smoke.make_reads(
            np.random.default_rng(2026))[1])
        order = ["this", "other", "other", "this"] * ((args.rounds + 1) // 2)
        for n, name in enumerate(order[: 2 * args.rounds]):
            out = os.path.join(tmp, f"g_{name}")
            proc = subprocess.run(
                [sys.executable, "-c",
                 RUN.format(root=trees[name], fasta=fasta, out=out,
                            k=args.kmer_size)],
                cwd=trees[name], capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            result = [line for line in proc.stdout.splitlines()
                      if line.startswith("RESULT ")][-1]
            print(f"run {n} {name}: {result[7:]}", flush=True)
        a = chip_smoke.read_graph(os.path.join(tmp, "g_this"))
        b = chip_smoke.read_graph(os.path.join(tmp, "g_other"))
        chip_smoke.check(all(np.array_equal(x, y) for x, y in zip(a, b)),
                         f"both checkouts wrote the same graph ({len(a[0])} edges)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
