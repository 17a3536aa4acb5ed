"""The port's array files and graph histogram on the CPU.

``write_array`` streams an array into its file, yet every factory's file
holds what ``np.save`` (through a staging buffer, as before) wrote: plain
files, ``.gz`` streams and the in-memory factory, for each dtype, the empty
array and a non-contiguous slice.  ``Graph.hist`` counts small
multiplicities and sorts the rest, and either way answers as
``np.unique`` does; ``Graph.write`` gives the JAX package's files.
"""

from __future__ import annotations

import io

import numpy as np
import pytest

from gossamer_tpu.graph import graph as jgraph
from gossamer_tpu.io.factory import StringFileFactory as JStringFileFactory
from gossamer_tpu_torch.graph.graph import Graph
from gossamer_tpu_torch.io.artifacts import read_array, write_array
from gossamer_tpu_torch.io.factory import PhysicalFileFactory, StringFileFactory
from gossamer_tpu_torch.utils import profile


@pytest.fixture(autouse=True)
def profile_on():
    profile.reset()
    profile.enable()
    yield
    profile.enable(False)
    profile.reset()


def sample(dtype, shape: str) -> np.ndarray:
    info = np.iinfo(dtype)
    rng = np.random.default_rng(7)
    a = rng.integers(info.min, info.max, 3 * 70_000, dtype=dtype, endpoint=True)
    if shape == "empty":
        return a[:0]
    if shape == "slice":  # every third item: not contiguous
        out = a[::3]
        assert not out.flags.c_contiguous
        return out
    return a


def staged_write(fac, name: str, arr: np.ndarray) -> None:
    """The former ``write_array``: ``np.save`` into a buffer, then one write."""
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    with fac.open_write(name) as f:
        f.write(buf.getvalue())


def file_bytes(fac, name: str, tmp_path) -> bytes:
    if isinstance(fac, StringFileFactory):
        return fac.read_file(name)
    data = (tmp_path / name).read_bytes()
    if name.endswith(".gz"):
        # gzip's header holds the time it was written (bytes 4-7)
        data = data[:4] + bytes(4) + data[8:]
    return data


@pytest.mark.parametrize("factory", ["plain", "gz", "memory"])
@pytest.mark.parametrize("shape", ["whole", "empty", "slice"])
@pytest.mark.parametrize("dtype", [np.uint64, np.uint32, np.int64, np.uint8])
def test_write_array_writes_np_save_bytes(dtype, shape, factory, tmp_path, monkeypatch):
    arr = sample(dtype, shape)
    if factory == "memory":
        fac, name = StringFileFactory(), "a.npy"
    else:
        monkeypatch.chdir(tmp_path)
        fac, name = PhysicalFileFactory(), "a.npy" + (".gz" if factory == "gz" else "")
    staged_write(fac, name, arr)
    before = file_bytes(fac, name, tmp_path)
    profile.reset()
    write_array(fac, name, arr)
    assert file_bytes(fac, name, tmp_path) == before
    assert profile.totals().get("#write_bytes", 0) == arr.nbytes
    saved = io.BytesIO()
    np.save(saved, arr, allow_pickle=False)
    with fac.open_read(name) as f:
        assert f.read() == saved.getvalue()
    back = read_array(fac, name)
    assert back.dtype == arr.dtype and np.array_equal(back, arr)


def counts_of(dtype, top: int, n: int, layout: str) -> np.ndarray:
    if n == 0:
        return np.zeros(0, dtype)
    rng = np.random.default_rng(top & 0xFFFF)
    c = rng.geometric(0.2, n).astype(dtype)
    c[n // 2] = top
    if top < 0:
        c[n // 3] = 0
    if layout == "read-only reversed":
        c = c[::-1]
        c.flags.writeable = False
    return c


# (dtype, largest count, edges, array layout, the route that must engage)
HIST_CASES = [
    (np.uint32, 900, 5_000, "", "counted"),
    (np.uint64, 900, 5_000, "", "counted"),
    (np.int64, 900, 5_000, "", "counted"),
    (np.int64, 900, 5_000, "read-only reversed", "counted"),
    (np.uint8, 100, 5_000, "", "counted"),
    (np.uint8, 200, 5_000, "", "sorted"),  # past int8: no signed view
    (np.int64, 100_000, 150_000, "", "counted"),  # above 2**16, below the edges
    (np.uint32, 2**32 - 1, 5_000, "", "sorted"),
    (np.uint64, 2**40, 5_000, "", "sorted"),
    (np.int64, 2**40, 5_000, "", "sorted"),
    (np.uint16, 40_000, 5_000, "", "sorted"),  # past int16: no signed view
    (np.int64, -3, 5_000, "", "sorted"),  # a negative count: no bins for it
    (np.uint32, 0, 0, "", None),
    (np.uint64, 0, 0, "", None),
    (np.int64, 0, 0, "", None),
]


@pytest.mark.parametrize(
    "dtype,top,n,layout,route", HIST_CASES,
    ids=[f"{np.dtype(c[0]).name}-{c[1]}-{c[2]}{'-' + c[3] if c[3] else ''}"
         for c in HIST_CASES])
def test_hist_counts_or_sorts_as_np_unique(dtype, top, n, layout, route):
    counts = counts_of(dtype, top, n, layout)
    lo = np.arange(n, dtype=np.uint64)
    g = Graph(15, lo, np.zeros(n, np.uint64), counts)
    profile.reset()
    mult, freq = g.hist()
    if n:
        want = np.unique(counts, return_counts=True)
    else:  # no edges: two int64 arrays, as the JAX package gives
        want = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    for got, exp in zip((mult, freq), want):
        assert got.dtype == exp.dtype and np.array_equal(got, exp)
    used = {k: v for k, v in profile.totals().items() if k.startswith("#hist_")}
    assert used == ({f"#hist_{route}": 1} if route else {})
    # every file of the write, the sidecar included, is the JAX package's
    fac, jfac = StringFileFactory(), JStringFileFactory()
    g.write("g", fac)
    jgraph.Graph(15, lo, np.zeros(n, np.uint64), counts).write("g", jfac)
    assert fac.files == jfac.files
    assert fac.read_file("g-counts-hist.txt") == "".join(
        f"{m}\t{c}\n" for m, c in zip(*want)).encode()
