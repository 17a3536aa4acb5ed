"""``xenome classify --pairs``: every pair written to the two files of its
class, mate 1 to the ``_1`` file and mate 2 to the ``_2``.

Set-up, the call and the index are those of :mod:`.xenome_classify`; the
cell's command line names the classes (``--graft-name``, ``--host-name``).
The comparison: each half's five class files, record by record, against
``reference.xenome_pairs`` over the same references and mates (its own
index).  The control classifies each pair by mate 1 alone, which breaks
the pair guarantee.
"""

from __future__ import annotations

import numpy as np

from benchmark.entries.xenome_classify import Entry as SingleEntry
from benchmark.entries.xenome_classify import misclassified
from benchmark.reference.xenome import index
from benchmark.reference.xenome_pairs import classes_of_bits, pair_classes, read_bits
from benchmark.traffic._seqio import fastq_records

HALVES = ("1", "2")


def option(argv: list[str], name: str, default: str) -> str:
    return argv[argv.index(name) + 1] if name in argv else default


class Entry(SingleEntry):
    def __init__(self, ctx):
        super().__init__(ctx)
        # the class files' names, in the order of reference.xenome.CLASSES
        self.names = ("neither", "both", "ambiguous",
                      option(self.argv, "--graft-name", "graft"),
                      option(self.argv, "--host-name", "host"))
        self.split_reference = None
        self.split_program = None

    def outputs(self) -> list[str]:
        return [f"{self.prefix}_{c}_{h}.fastq" for c in self.names for h in HALVES]

    def after_call(self, rec: dict) -> None:
        super().after_call(rec)
        prof = rec.get("profile", {})
        if "#pairs" in prof:
            self.split_program = (prof.get("#pairs_split", 0.0), prof["#pairs"])

    def work(self) -> dict:
        """A call's work: reads, both mates of every pair."""
        return {"reads": 2.0 * len(self.ctx.inputs["reads_1"])}

    def reference(self, control: bool = False) -> np.ndarray:
        """The index into CLASSES of each pair; ``control``: each pair by
        mate 1 alone."""
        dev = "cuda" if self.ctx.device == "cuda" else "cpu"
        inp = self.ctx.inputs
        k = int(self.ctx.cell.config["k"])
        keys, cls = index(inp["graft"], inp["host"], k, dev)
        bits_1 = read_bits(inp["reads_1"], keys, cls, k, dev)
        if control:
            return classes_of_bits(bits_1)
        bits_2 = read_bits(inp["reads_2"], keys, cls, k, dev)
        self.split_reference = (int(np.count_nonzero(bits_1 != bits_2)), len(bits_1))
        return pair_classes(bits_1, bits_2)

    def records(self) -> dict:
        return {h: fastq_records(self.ctx.inputs[f"reads_{h}"]) for h in HALVES}

    def program_output(self) -> dict:
        files = {}
        for c, name in enumerate(self.names):
            for h in HALVES:
                with open(f"{self.prefix}_{name}_{h}.fastq", "rb") as f:
                    files[(c, h)] = f.read()
        return files

    def as_output(self, classes: np.ndarray) -> dict:
        """Both halves' class files that hold each pair in the files of
        ``classes``."""
        recs = self.records()
        return {(c, h): recs[h][classes == c].tobytes()
                for c in range(len(self.names)) for h in HALVES}

    def judge(self, expected: np.ndarray, got: dict) -> dict:
        recs = self.records()
        bad = sum(misclassified({c: got[(c, h)] for c in range(len(self.names))},
                                recs[h], expected) for h in HALVES)
        return {"pairs_misclassified": (bad, 0)}

    def notes(self) -> list[str]:
        lines = super().notes()
        for who, split in (("reference", self.split_reference),
                           ("program #pairs_split", self.split_program)):
            if split is not None and split[1]:
                lines.append(f"split pairs ({who}): {split[0]:.0f} of {split[1]:.0f}, "
                             f"{100.0 * split[0] / split[1]:.4f}%")
        return lines
