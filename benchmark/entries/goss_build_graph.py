"""``goss build-graph``: the reads' edge spectrum written as a graph.

The call is ``gossamer_tpu_torch.cli.goss.main`` on the cell's command line.
Between calls: the count's log line must name the native reader, and its
phases are kept.  The comparison: the graph's edges and counts, read back
with ``np.load`` from the files the call wrote, against
``reference.spectrum.edge_spectrum`` of the same reads.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from benchmark.harness import BenchError, file_digest
from benchmark.reference.spectrum import edge_spectrum, mismatched

SPANS = [
    {"name": "engine_add", "kind": "call",
     "target": "gossamer_tpu_torch.ops.engine:SpectrumEngine.add_chunk_packed"},
    {"name": "finish", "kind": "call",
     "target": "gossamer_tpu_torch.ops.engine:SpectrumEngine.finish_expanded"},
]


def count_line(log: str) -> str:
    for line in log.splitlines():
        if "\tcount: " in line:
            return line.split("\tcount: ", 1)[1]
    raise BenchError("the call's log has no count: line")


class Entry:
    SPANS = SPANS

    def __init__(self, ctx):
        self.ctx = ctx
        self.argv = ctx.argv()
        self.base = f"{ctx.workdir}/graph"
        self.log = f"{ctx.workdir}/call.log"
        self.last_line = ""

    def prepare(self) -> None:
        from gossamer_tpu_torch.cli.goss import main

        self.main = main

    def call(self) -> int:
        return self.main(self.argv)

    def outputs(self) -> list[str]:
        return [self.base + ".edges-lo", self.base + ".counts"]

    def after_call(self, rec: dict) -> None:
        with open(self.log) as f:
            log = f.read()
        if "\treader: native" not in log:
            raise BenchError("the count did not use the native reader: "
                             + " | ".join(l for l in log.splitlines() if "reader" in l))
        self.last_line = count_line(log)
        rec["phases"] = json.loads(self.last_line.split("phases (s) ", 1)[1])
        rec["digest"] = file_digest(self.outputs())
        rec["work"] = self.work()

    def work(self) -> dict:
        """A call's work: Mbp of read bases."""
        return {"read_mbp": self.ctx.inputs["reads"].size * 1e-6}

    def _device(self) -> str:
        return "cuda" if self.ctx.device == "cuda" else "cpu"

    def reference(self, control: bool = False):
        """(keys, counts) the graph must hold; ``control``: the reference
        with every read holding an N left out."""
        rho = int(self.ctx.cell.config["k"]) + 1
        return edge_spectrum(self.ctx.inputs["reads"], rho, self._device(),
                             drop_reads_with_n=control)

    def program_output(self):
        dev = self._device()
        got_lo = np.load(self.base + ".edges-lo")
        got_c = np.load(self.base + ".counts")
        return (torch.from_numpy(got_lo.view(np.int64)).to(dev),
                torch.from_numpy(got_c.astype(np.int64)).to(dev))

    @staticmethod
    def as_output(expected):
        return expected

    @staticmethod
    def judge(expected, got) -> dict:
        return {"edges_mismatched": (mismatched(*expected, *got), 0)}

    def compare(self) -> dict:
        return self.judge(self.reference(), self.program_output())

    def notes(self) -> list[str]:
        return [f"count: {self.last_line}"]
