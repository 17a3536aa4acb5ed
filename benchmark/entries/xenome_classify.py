"""``xenome classify``: every read written to the file of its class.

Set-up builds the index with ``xenome index`` (the traffic needs it); the
call is ``gossamer_tpu_torch.cli.xenome.main`` on the cell's command line.
The comparison: each read's class as the five class files written by the
last call hold it, every record byte for byte, against
``reference.xenome`` over the same references and reads (its own index).
"""

from __future__ import annotations

import contextlib
import io

import numpy as np

from benchmark.harness import BenchError, file_digest
from benchmark.reference.xenome import CLASSES, index, read_classes
from benchmark.traffic._seqio import fastq_records

SPANS = [
    {"name": "index_load", "kind": "call",
     "target": "gossamer_tpu_torch.classify.annotated_set:AnnotatedKmerSet.read"},
    {"name": "classify_batches", "kind": "call",
     "target": "gossamer_tpu_torch.classify.device:classify_codes_device"},
]


def misclassified(files: dict, records: np.ndarray, want: np.ndarray) -> int:
    """Reads whose class the files do not give: each read must be in the
    file of its class exactly once, its record unchanged.  ``files`` maps a
    class index to the file's bytes."""
    if all(files[c] == records[want == c].tobytes() for c in files):
        return 0
    n, width = records.shape
    got = np.full(n, -1, np.int64)
    bad = 0
    for c, data in files.items():
        lines = data.split(b"\n")
        if lines and lines[-1] == b"":
            lines.pop()
        bad += len(lines) % 4
        for i in range(0, len(lines) - 3, 4):
            rec = b"\n".join(lines[i : i + 4]) + b"\n"
            try:
                rid = int(lines[i][2:])
            except ValueError:
                bad += 1
                continue
            if not 0 <= rid < n or rec != records[rid].tobytes():
                bad += 1
            elif got[rid] != -1:
                got[rid] = -2  # written twice
            else:
                got[rid] = c
    return bad + int((got != want).sum())


class Entry:
    SPANS = SPANS

    def __init__(self, ctx):
        self.ctx = ctx
        self.argv = ctx.argv()
        self.prefix = f"{ctx.workdir}/out"
        self.stats = ""

    def prepare(self) -> None:
        from gossamer_tpu_torch.cli.xenome import main

        self.main = main
        with contextlib.redirect_stdout(io.StringIO()):
            rc = main(self.ctx.argv("index_argv"))
        if rc != 0:
            raise BenchError(f"xenome index exited {rc}")

    def call(self) -> int:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = self.main(self.argv)
        self.stats = out.getvalue()
        return rc

    def outputs(self) -> list[str]:
        return [f"{self.prefix}_{c}.fastq" for c in CLASSES]

    def after_call(self, rec: dict) -> None:
        rec["digest"] = file_digest(self.outputs())
        rec["work"] = self.work()

    def work(self) -> dict:
        """A call's work: reads."""
        return {"reads": float(len(self.ctx.inputs["reads"]))}

    def reference(self, control: bool = False) -> np.ndarray:
        """The index into CLASSES of each read; ``control``: the reference
        with the marginal k-mers' bits kept."""
        dev = "cuda" if self.ctx.device == "cuda" else "cpu"
        inp = self.ctx.inputs
        k = int(self.ctx.cell.config["k"])
        keys, cls = index(inp["graft"], inp["host"], k, dev, near_kmers=not control)
        return read_classes(inp["reads"], keys, cls, k, dev)

    def program_output(self) -> dict:
        files = {}
        for c, path in enumerate(self.outputs()):
            with open(path, "rb") as f:
                files[c] = f.read()
        return files

    def as_output(self, classes: np.ndarray) -> dict:
        """The class files that hold each read in the file of ``classes``."""
        records = fastq_records(self.ctx.inputs["reads"])
        return {c: records[classes == c].tobytes() for c in range(len(CLASSES))}

    def judge(self, expected: np.ndarray, got: dict) -> dict:
        records = fastq_records(self.ctx.inputs["reads"])
        return {"reads_misclassified": (misclassified(got, records, expected), 0)}

    def compare(self) -> dict:
        return self.judge(self.reference(), self.program_output())

    def notes(self) -> list[str]:
        summary = self.stats.split("Summary\n", 1)[-1].strip().replace("\n", "; ")
        return [f"classify summary: {summary}"]
