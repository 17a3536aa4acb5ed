"""The controls of the comparison that decides ``correct``, at a cell's own
size, on the seeds given: the reference with one of the configuration's
guarantees broken (each entry's ``reference(control=True)``) put in the
program's place and judged as the program's output is.  The program does
not run.  Not part of a benchmark run.

    python3 benchmark/controls.py --workload <cell> --seeds 1,2,3

One JSON line a seed: each number compared, for the control, with its
limit, and the seconds the reference took.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

from benchmark.harness import BenchError, Cell, Context, tmp_dir  # noqa: E402


def control_numbers(cell: Cell, seed: int, workdir: Path, device: str) -> dict:
    generator = importlib.import_module(f"benchmark.traffic.{cell.mix['generator']}")
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        inputs = generator.make(cell.config, cell.mix, seed, workdir)
        entry = cell.entry_module.Entry(Context(cell, inputs, workdir, device))
        t0 = time.time()
        expected = entry.reference()
        ref_s = time.time() - t0
        got = entry.as_output(entry.reference(control=True))
        return {"seed": seed, "reference_s": ref_s,
                "checks": {k: {"value": v, "limit": lim}
                           for k, (v, lim) in entry.judge(expected, got).items()}}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    try:
        cell = Cell(a.workload)
        workdir = tmp_dir() / "gossamer-bench-controls"
    except BenchError as e:
        print(f"controls: {e}", file=sys.stderr)
        return 1
    for seed in (int(x) for x in a.seeds.split(",")):
        print(json.dumps(control_numbers(cell, seed, workdir, a.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
