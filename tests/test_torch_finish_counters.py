"""The narrow engine's counters of its spills and of its finish's side, and
the side rule at its boundary.

``#spill_runs`` counts each run pulled to the host; ``#finish_lanes`` the
lanes ``_finish_runs`` weighs against the cap (the spilled runs' and the
live spectrum's); ``#finish_lanes_card`` the same lanes where the finish
runs on the device, 0 where it runs on the host.  At ``req_cap = 2 x
lanes`` ``finish_expanded`` runs on the device, one lane below on the host;
both graphs equal the benchmark's plain reference
(``benchmark/reference/spectrum.py`` ``edge_spectrum``) of the same reads.
Shapes are ``tests/test_torch_finish.py``'s: rho 26, chunks of 1024.
"""

import numpy as np
import pytest
import torch

from benchmark.reference.spectrum import edge_spectrum
from benchmark.traffic.genome_reads import make_reads
from gossamer_tpu_torch.io.readers import Read
from gossamer_tpu_torch.io.stream import flat_code_chunks
from gossamer_tpu_torch.ops import engine as E
from gossamer_tpu_torch.ops.fold import SENT
from gossamer_tpu_torch.utils import profile

CPU = torch.device("cpu")
RHO = 26
CHUNK = 1024
CAP = 1 << 13  # one flush's 8 x 1024 lanes: every flush but the last spills


@pytest.fixture
def counters():
    profile.reset()
    profile.enable()
    try:
        yield profile.totals
    finally:
        profile.enable(False)
        profile.reset()


def _reads():
    """210 reads of 100 bp (21 flat chunks), 3 of them with an N."""
    _genome, reads = make_reads(np.random.default_rng(25), genome_len=3000,
                                coverage=7, read_len=100, n_with_n=3)
    return reads


def _counted(reads):
    """A build-graph engine ('value' mode) fed ``reads``, its last flush
    done: the spilled runs and the live spectrum as the finish finds them."""
    eng = E.SpectrumEngine(RHO, "value", CHUNK, CPU, cap=CAP)
    seqs = (Read(str(i), bytes(np.frombuffer(b"ACGTN", np.uint8)[r]))
            for i, r in enumerate(reads))
    for codes in flat_code_chunks(seqs, RHO, CHUNK):
        eng.add_chunk(codes)
    eng._flush(final=True)
    return eng


def _lanes(eng):
    """The spilled runs' lanes plus the live spectrum's."""
    runs = sum(n if kind == "eac" else len(a) for kind, a, n in eng.host_runs)
    return runs + int((eng.spec[0] != SENT).sum())


def test_spill_runs_counts_each_spill(counters):
    eng = _counted(_reads())
    assert eng.spills == 2 and len(eng.host_runs) == 2
    assert counters()["#spill_runs"] == eng.spills


@pytest.mark.parametrize("short,side", [(0, "on cpu"), (1, "on the host")])
def test_finish_side_at_the_cap_boundary(short, side, counters):
    reads = _reads()
    eng = _counted(reads)
    lanes = _lanes(eng)
    assert 2 * lanes > CAP  # the engine's own cap sends the finish to the host
    eng.req_cap = 2 * lanes - short
    lo, _hi, c = eng.finish_expanded()
    assert all(step.endswith(side) for step in eng.finish_log)
    got = counters()
    assert got["#finish_lanes"] == lanes
    assert got["#finish_lanes_card"] == (lanes if side == "on cpu" else 0)
    keys, counts = edge_spectrum(reads, RHO, CPU)
    assert torch.equal(torch.from_numpy(lo.view(np.int64)), keys)
    assert torch.equal(torch.from_numpy(c.astype(np.int64)), counts)
