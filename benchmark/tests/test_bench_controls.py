"""The control of each cell (the reference with one guarantee broken, in
the program's place) fails the comparison on three seeds; at the cells'
own size ``benchmark/controls.py`` reads it on the card."""

import pytest

from benchmark import controls, harness
from benchmark.tests.sizes import SMALL


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_fails_on_three_seeds(cell, tmp_path):
    c = harness.Cell(cell, SMALL[cell])
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        out = controls.control_numbers(c, seed, tmp_path / "w", "cpu")
        assert any(v["value"] > v["limit"] for v in out["checks"].values()), out
