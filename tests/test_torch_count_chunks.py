"""``ops.count.count_chunks``, the entry the CLI's count calls.

Its ``count:`` log line, which the benchmark parses (the JSON after
``phases (s) ``), for a both-strands count on every route of the two
engines: narrow packed and raw chunks, a narrow count that spills with its
finish on the device and one with its finish on the host, and a wide count
without and with spills.  Then a grid against the JAX package's
``count_chunks`` over the mode (``value`` for build-graph, ``ref`` for
build-kmer-set, ``plain``), the input (packed or raw chunks) and the side
of the finish (the device's cap holds the finish, or it does not and every
step runs on the host).  Outputs must be bit-identical.  Shapes are
``tests/test_engine.py``'s (rho 13, chunks of 2000), so the JAX engine's
compiled steps are shared with the other engine tests.
"""

import json

import numpy as np
import pytest
import torch

from gossamer_tpu.ops.count import count_chunks as jax_count_chunks
from gossamer_tpu_torch.io.stream import pack_chunk
from gossamer_tpu_torch.ops.count import count_chunks

CPU = torch.device("cpu")
RHO = 13
CHUNK = 2000
WIDE_RHO = 56
WIDE_CHUNK = 1024


def _chunks(rng, n_chunks, chunk=CHUNK, rho=RHO, sep_every=50):
    """``tests/test_engine.py``'s raw chunks: random bases, ~2% separators."""
    out = []
    for _ in range(n_chunks):
        c = rng.integers(0, 4, size=chunk + rho - 1, dtype=np.uint8)
        c[rng.integers(0, len(c), size=len(c) // sep_every)] = 255
        out.append(c)
    return out


def _count(chunks, rho, chunk, cap, **kw):
    """``count_chunks`` with a log -> (output, the ``count:`` line)."""
    lines = []
    out = count_chunks(iter(chunks), rho, device=CPU, chunk=chunk,
                       cap_entries=cap, log=lambda level, msg: lines.append(msg),
                       **kw)
    count = [m for m in lines if m.startswith("count: ")]
    assert len(count) == 1
    return out, count[0]


def _phases(line):
    """The benchmark's reading of the line: the JSON after ``phases (s) ``."""
    return json.loads(line.split("phases (s) ", 1)[1])


# ----------------------------------------------------- the count: log line
LOG_CASES = {
    # route: (rho, chunk, chunks, packed, cap, spilled, where the finish ran)
    "narrow packed": (RHO, CHUNK, 12, True, 1 << 16, False, "on cpu"),
    "narrow raw": (RHO, CHUNK, 12, False, 1 << 16, False, "on cpu"),
    "narrow spilled, finish on the device": (RHO, CHUNK, 24, False, 1 << 17,
                                             True, "on cpu"),
    "narrow, finish on the host": (RHO, CHUNK, 12, False, 1 << 14, True,
                                   "on the host"),
    "wide": (WIDE_RHO, WIDE_CHUNK, 6, False, 1 << 14, False, None),
    "wide spilled": (WIDE_RHO, WIDE_CHUNK, 12, False, 4096, True, None),
}


@pytest.mark.parametrize("route", list(LOG_CASES))
def test_count_line_ends_in_the_phases_json(route):
    rho, chunk, n, packed, cap, spilled, side = LOG_CASES[route]
    chunks = _chunks(np.random.default_rng(len(route)), n, chunk, rho)
    if packed:
        chunks = [pack_chunk(c, rho, chunk) for c in chunks]
    (lo, _hi, c), line = _count(chunks, rho, chunk, cap, both_strands=True,
                                canonical=False)
    assert line.startswith(f"count: {n} chunks, ")
    spills = int(line.split(" chunks, ")[1].split(" spills")[0])
    assert (spills > 0) == spilled
    phases = _phases(line)
    assert set(phases) == {"stream", "flush_tail", "pull", "expand"}
    assert all(isinstance(v, float) and v >= 0 for v in phases.values())
    assert json.dumps(phases) == line.split("phases (s) ", 1)[1]
    if side is not None:
        finish = line.split("finish: ", 1)[1].split(", phases (s) ")[0]
        steps = finish.split("; ")
        assert steps[-1].startswith("expansion of ")
        assert all(step.endswith(side) for step in steps)
    assert len(lo) > 1000 and int(c.sum()) > 0


# ------------------------------------------------- the grid against JAX
MODES = {"value": dict(both_strands=True, canonical=False),
         "ref": dict(both_strands=False, canonical=True),
         "plain": dict(both_strands=False, canonical=False)}
SIDES = {"device": (1 << 16, "on cpu"), "host": (1 << 14, "on the host")}


@pytest.mark.parametrize("side", list(SIDES))
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "raw"])
@pytest.mark.parametrize("mode", list(MODES))
def test_count_chunks_matches_jax(mode, packed, side):
    """12 chunks, a flush of 8 and the final flush of 4: within a cap of
    2^16 nothing spills and the finish runs on the device; at 2^14 the
    first flush spills and the finish runs on the host.  The same output
    as the JAX package's."""
    cap, where = SIDES[side]
    raw = _chunks(np.random.default_rng(7), 12)
    chunks = [pack_chunk(c, RHO, CHUNK) for c in raw] if packed else raw
    got, line = _count(chunks, RHO, CHUNK, cap, **MODES[mode])
    want = jax_count_chunks(iter(chunks), RHO, chunk=CHUNK, cap_entries=cap,
                            **MODES[mode])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert len(got[0]) > 10000
    assert (" 0 spills" in line) == (side == "device")
    if side == "host" or mode == "value":
        finish = line.split("finish: ", 1)[1].split(", phases (s) ")[0]
        assert all(step.endswith(where) for step in finish.split("; "))
