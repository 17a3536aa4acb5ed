"""The command as a checker runs it: it refuses a machine without a card,
and on the card each cell runs correct."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.harness import BenchError, tmp_dir

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def command(cell, seed, seconds, trace, cwd=REPO, tmp=None):
    env = {**os.environ, "TMPDIR": str(tmp or cwd)}
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(seed),
         "--seconds", str(seconds), "--trace", str(trace)],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)


def test_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = command(CELLS[0], 1, 1, 0, tmp=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "no card" in out.stderr


def test_refuses_without_tmpdir(monkeypatch):
    monkeypatch.delenv("TMPDIR", raising=False)
    with pytest.raises(BenchError, match="TMPDIR"):
        tmp_dir()


def test_refuses_without_the_program(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = command(CELLS[0], 1, 1, 0, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_each_cell_runs_correct_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell in CELLS:
        out = command(cell, 2 ** 31 + 777, 3, 0, tmp=tmp_path)
        assert out.returncode == 0, out.stderr[-2000:]
        result = json.loads(out.stdout.splitlines()[-1])
        assert result["correct"] is True, result["checks"]
        assert result["device"]["platform"] == "gpu"
