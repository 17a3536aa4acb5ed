"""A run with the timed path broken underneath comes out not correct: for
each fault a cell can have, the program is patched after set-up (so the
warm-up call is sound) and the rest of the run goes as on the card.  The
cells run on one chip, so no exchange between chips can be left out."""

import numpy as np
import pytest

from benchmark import harness
from benchmark.tests.sizes import BUILD, CLASSIFY, SMALL


def state_unchanged_build(mp):
    from gossamer_tpu_torch.ops.engine import SpectrumEngine

    mp.setattr(SpectrumEngine, "add_chunk_packed", lambda self, words, inval: None)


def half_left_out_build(mp):
    from gossamer_tpu_torch.io import native

    orig = native.native_packed_chunks

    def every_other(*a, **kw):
        return (c for i, c in enumerate(orig(*a, **kw)) if i % 2 == 0)
    mp.setattr(native, "native_packed_chunks", every_other)


def answer_altered_build(mp):
    from gossamer_tpu_torch.graph.graph import Graph

    orig = Graph.write

    def write(self, basename, fac):
        self.counts = self.counts.copy()
        self.counts[len(self.counts) // 2] += 1
        return orig(self, basename, fac)
    mp.setattr(Graph, "write", write)


def _classify(mp, change):
    from gossamer_tpu_torch.classify import device

    orig = device.classify_codes_device

    def classify(codes_list, *a, **kw):
        return change(np.array(orig(codes_list, *a, **kw)))
    mp.setattr(device, "classify_codes_device", classify)


def state_unchanged_classify(mp):
    _classify(mp, lambda blrg: np.zeros_like(blrg))


def half_left_out_classify(mp):
    def change(blrg):
        blrg[len(blrg) // 2:] = 0
        return blrg
    _classify(mp, change)


def answer_altered_classify(mp):
    def change(blrg):
        blrg[0] ^= 0x4
        return blrg
    _classify(mp, change)


FAULTS = [(BUILD, state_unchanged_build), (BUILD, half_left_out_build),
          (BUILD, answer_altered_build), (CLASSIFY, state_unchanged_classify),
          (CLASSIFY, half_left_out_classify), (CLASSIFY, answer_altered_classify)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f.__name__ for _, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault, tmp_path, monkeypatch):
    result = harness.run(cell, 2 ** 31 + 5, 0.2, False, device="cpu",
                         workdir=tmp_path / "w", overrides=SMALL[cell],
                         fault=lambda entry: fault(monkeypatch))
    assert result["correct"] is False
    compared = {k: v for k, v in result["checks"].items() if k != "calls_unlike_last"}
    assert any(c["value"] > c["limit"] for c in compared.values()), result["checks"]
