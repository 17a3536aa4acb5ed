"""Run one cell of the benchmark of gossamer_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result object; the numbers
compared with the reference, each with its limit, are the last lines of
standard error.  Exits 1, printing no result, where the run cannot give one:
no card (or fewer than the cell asks for), the count off its native reader,
a failed set-up, or JAX or the JAX package loaded.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import BenchError, run  # noqa: E402


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        result = run(a.workload, a.seed, a.seconds, bool(a.trace))
    except BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
