"""``goss build-graph`` at a wide k (k 31 to 61): the reads' edge spectrum
written as a graph with both key planes.

The call is ``gossamer_tpu_torch.cli.goss.main`` on the cell's command line.
Between calls: the count's log line must name the native reader and no
spill (the cell's count finishes on the card), and its phases are kept.
The comparison: the graph's edges and counts, read back with ``np.load``
from the three files the call wrote and converted into the reference's
halves, against ``reference.spectrum_wide`` of the same reads.
"""

from __future__ import annotations

import json
import re

import numpy as np
import torch

from benchmark.harness import BenchError, file_digest
from benchmark.reference.spectrum_wide import (edge_spectrum_wide,
                                               mismatched_wide, split)

SPANS = [
    {"name": "engine_add", "kind": "call",
     "target": "gossamer_tpu_torch.ops.engine_wide:SpectrumEngineWide.add_chunk"},
    {"name": "finish", "kind": "call",
     "target": "gossamer_tpu_torch.ops.engine_wide:SpectrumEngineWide.finish_expanded"},
]


def count_line(log: str) -> str:
    for line in log.splitlines():
        if "\tcount: " in line:
            return line.split("\tcount: ", 1)[1]
    raise BenchError("the call's log has no count: line")


def spills(line: str) -> int:
    m = re.search(r"(\d+) spills", line)
    if m is None:
        raise BenchError(f"the count: line names no spills: {line}")
    return int(m.group(1))


def halves_from_planes(hi: np.ndarray, lo: np.ndarray, rho: int):
    """A graph's uint64 key planes (the key is ``hi * 2^64 + lo``) -> the
    reference's int64 halves ``(hi, lo)``: the key's top ``rho - rho // 2``
    bases and its last ``rho // 2``."""
    b = 2 * split(rho)[1]  # bits of the low half
    hi = torch.from_numpy(np.ascontiguousarray(hi).view(np.int64))
    lo = torch.from_numpy(np.ascontiguousarray(lo).view(np.int64))
    return ((hi << (64 - b)) | ((lo >> b) & ((1 << (64 - b)) - 1)),
            lo & ((1 << b) - 1))


class Entry:
    SPANS = SPANS

    def __init__(self, ctx):
        self.ctx = ctx
        self.argv = ctx.argv()
        self.base = f"{ctx.workdir}/graph"
        self.log = f"{ctx.workdir}/call.log"
        self.rho = int(ctx.cell.config["k"]) + 1
        self.last_line = ""

    def prepare(self) -> None:
        from gossamer_tpu_torch.cli.goss import main

        self.main = main

    def call(self) -> int:
        return self.main(self.argv)

    def outputs(self) -> list[str]:
        return [self.base + s for s in (".edges-hi", ".edges-lo", ".counts")]

    def after_call(self, rec: dict) -> None:
        with open(self.log) as f:
            log = f.read()
        if "\treader: native" not in log:
            raise BenchError("the count did not use the native reader: "
                             + " | ".join(l for l in log.splitlines() if "reader" in l))
        self.last_line = count_line(log)
        if spills(self.last_line) != 0:
            raise BenchError(f"the count spilled: {self.last_line}")
        rec["phases"] = json.loads(self.last_line.split("phases (s) ", 1)[1])
        rec["digest"] = file_digest(self.outputs())
        rec["work"] = self.work()

    def work(self) -> dict:
        """A call's work: Mbp of read bases."""
        return {"read_mbp": self.ctx.inputs["reads"].size * 1e-6}

    def _device(self) -> str:
        return "cuda" if self.ctx.device == "cuda" else "cpu"

    def reference(self, control: bool = False):
        """(hi, lo, counts) the graph must hold; ``control``: the reference
        with every read holding an N left out."""
        return edge_spectrum_wide(self.ctx.inputs["reads"], self.rho,
                                  self._device(), drop_reads_with_n=control)

    def program_output(self):
        hi, lo = halves_from_planes(np.load(self.base + ".edges-hi"),
                                    np.load(self.base + ".edges-lo"), self.rho)
        counts = torch.from_numpy(np.load(self.base + ".counts").astype(np.int64))
        return tuple(t.to(self._device()) for t in (hi, lo, counts))

    @staticmethod
    def as_output(expected):
        return expected

    @staticmethod
    def judge(expected, got) -> dict:
        return {"edges_mismatched": (mismatched_wide(expected, got), 0)}

    def compare(self) -> dict:
        return self.judge(self.reference(), self.program_output())

    def notes(self) -> list[str]:
        return [f"count: {self.last_line}"]
