"""``gossple`` — end-to-end assembly pipeline driver (``src/gossple.cc``;
``gossamer_tpu/cli/gossple.py``).

Sequences the canonical stage ordering (``gossple.cc:455-582``):
build-graph -> trim-graph -> prune-tips x4 -> pop-bubbles ->
build-entry-edge-set -> build-supergraph -> thread-pairs (per library) ->
thread-reads -> build-scaffold (per library) -> scaffold ->
print-contigs --min-length 100, with stage skipping for restarts
(``gossple.cc:590-609``).  ``--device`` (default ``cuda``) is passed to
every stage.
"""

from __future__ import annotations

import argparse
import sys

from .goss import build_app


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="gossple", description="simple end-to-end assembly pipeline")
    p.add_argument("-k", "--kmer-size", type=int, default=27)
    p.add_argument("-O", "--output-prefix", default="goss")
    p.add_argument("-i", "--fastq-in", action="append", default=[],
                   help="single-end FASTQ input")
    p.add_argument("-I", "--fasta-in", action="append", default=[],
                   help="single-end FASTA input")
    p.add_argument("-p", "--paired", action="append", nargs=2, default=[],
                   metavar=("LHS", "RHS"), help="paired read files")
    p.add_argument("-C", "--cutoff", type=int, default=None)
    p.add_argument("--min-length", type=int, default=100)
    p.add_argument("--min-link-count", type=int, default=10)
    p.add_argument("--prune-passes", type=int, default=4)
    p.add_argument("--start-stage", type=int, default=0,
                   help="resume from stage N (stages are logged)")
    p.add_argument("--dry-run", action="store_true",
                   help="print the stages without running")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device every stage runs on: cuda (default) "
                        "or cpu")
    o = p.parse_args(argv)

    gr = o.output_prefix
    inputs: list[str] = []
    for f in o.fasta_in:
        inputs += ["-I", f]
    for f in o.fastq_in:
        inputs += ["-i", f]
    pair_inputs: list[list[str]] = []
    for lhs, rhs in o.paired:
        fmt = "-i" if any(lhs.endswith(s) for s in
                          (".fq", ".fastq", ".fq.gz", ".fastq.gz")) else "-I"
        pair_inputs.append([fmt, lhs, fmt, rhs])
        inputs += [fmt, lhs, fmt, rhs]
    if not inputs:
        print("gossple: no inputs", file=sys.stderr)
        return 1

    common = (["-v"] if o.verbose else []) + ["--device", o.device]
    stages: list[list[str]] = []
    stages.append(["build-graph", "-k", str(o.kmer_size), "-O", gr] + inputs)
    trim = ["trim-graph", "-G", gr, "-O", gr]
    if o.cutoff is not None:
        trim += ["-C", str(o.cutoff)]
    stages.append(trim)
    stages.append(["prune-tips", "-G", gr, "-O", gr,
                   "--iterate", str(o.prune_passes)])
    stages.append(["pop-bubbles", "-G", gr, "-O", gr])
    stages.append(["build-entry-edge-set", "-G", gr])
    stages.append(["build-supergraph", "-G", gr])
    for pi in pair_inputs:
        stages.append(["thread-pairs", "-G", gr,
                       "--min-link-count", str(o.min_link_count)] + pi)
    stages.append(["thread-reads", "-G", gr,
                   "--min-link-count", str(o.min_link_count)] + inputs)
    for idx, pi in enumerate(pair_inputs):
        stages.append(["build-scaffold", "-G", gr,
                       "--scaffold-lib", f"lib{idx}",
                       "--min-link-count", str(o.min_link_count)] + pi)
    if pair_inputs:
        stages.append(["scaffold", "-G", gr,
                       "--min-link-count", str(o.min_link_count)])
    stages.append(["print-contigs", "-G", gr,
                   "--min-length", str(o.min_length),
                   "-o", gr + "-contigs.fa"])

    app = build_app()
    for i, st in enumerate(stages):
        line = f"[stage {i}] goss {' '.join(st)}"
        print(line, file=sys.stderr)
        if o.dry_run or i < o.start_stage:
            continue
        rc = app.main(st + common)
        if rc != 0:
            print(f"gossple: stage {i} failed; resume with --start-stage {i}",
                  file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
