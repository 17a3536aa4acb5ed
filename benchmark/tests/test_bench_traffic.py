"""Each traffic generator gives the same inputs for the same seed."""

import importlib

import numpy as np
import pytest

from benchmark.harness import Cell
from benchmark.tests.sizes import SMALL
from benchmark.traffic._seqio import fastq_records

SEED = 2 ** 31 + 12345  # past what 32 signed bits hold


def make(cell, seed, tmp_path):
    c = Cell(cell, SMALL[cell])
    gen = importlib.import_module(f"benchmark.traffic.{c.mix['generator']}")
    tmp_path.mkdir(parents=True, exist_ok=True)
    return gen.make(c.config, c.mix, seed, tmp_path)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_same_seed_same_inputs(cell, tmp_path):
    a = make(cell, SEED, tmp_path / "a")
    b = make(cell, SEED, tmp_path / "b")
    c = make(cell, SEED + 1, tmp_path / "c")
    assert a.keys() == b.keys()
    for key, value in a.items():
        if isinstance(value, np.ndarray):
            assert np.array_equal(value, b[key])
        else:
            with open(value, "rb") as fa, open(b[key], "rb") as fb:
                assert fa.read() == fb.read()
    assert not np.array_equal(a["reads"], c["reads"])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sizes_do_not_depend_on_the_seed(cell, tmp_path):
    a = make(cell, 1, tmp_path / "a")
    b = make(cell, 2 ** 33, tmp_path / "b")
    assert a["reads"].shape == b["reads"].shape
    assert int((a["reads"] >= 4).any(axis=1).sum()) == int((b["reads"] >= 4).any(axis=1).sum())


def test_fastq_records():
    reads = np.array([[0, 1, 2, 3], [4, 3, 2, 1]], np.uint8)
    assert fastq_records(reads).tobytes() == (
        b"@r0000000\nACGT\n+\nIIII\n@r0000001\nNTGC\n+\nIIII\n")
