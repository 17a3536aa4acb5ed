"""The plain reference against a brute force in plain Python at a tiny
size, and a whole run of each cell on the port's CPU path judged by it."""

import json
from collections import Counter

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import kmers, spectrum, xenome
from benchmark.tests.sizes import BUILD, CLASSIFY, SMALL

BASES = "ACGT"
MASK = (1 << 64) - 1


def value(s: str) -> int:
    v = 0
    for ch in s:
        v = v * 4 + BASES.index(ch)
    return v


def rc(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def fnv(v: int) -> int:
    h = 14695981039346656037
    for byte in v.to_bytes(16, "little"):
        h = ((h ^ byte) * 1099511628211) & MASK
    return h


def canon(s: str) -> str:
    a, b = value(s), value(rc(s))
    return rc(s) if (fnv(b), b) < (fnv(a), a) else s


def text(codes) -> str:
    return "".join("ACGTN"[c] for c in codes)


def windows(seq: str, k: int):
    return [seq[i : i + k] for i in range(len(seq) - k + 1) if "N" not in seq[i : i + k]]


def test_canonical_and_hash_match_the_brute_force():
    rng = np.random.default_rng(7)
    seqs = ["".join(BASES[c] for c in rng.integers(0, 4, 25)) for _ in range(300)]
    keys = torch.tensor([value(s) for s in seqs])
    assert kmers.fnv1a(keys).tolist() == [fnv(value(s)) - (1 << 64) * (fnv(value(s)) >> 63)
                                          for s in seqs]
    assert kmers.canonical(keys, 25).tolist() == [value(canon(s)) for s in seqs]


def test_edge_spectrum_matches_the_brute_force():
    rng = np.random.default_rng(3)
    reads = rng.integers(0, 4, (200, 40), dtype=np.uint8)
    reads[rng.integers(0, 200, 30), rng.integers(0, 40, 30)] = 4
    want = Counter()
    for r in reads:
        for w in windows(text(r), 26):
            want[value(w)] += 1
            want[value(rc(w))] += 1
    keys, counts = spectrum.edge_spectrum(reads, 26, "cpu")
    assert dict(zip(keys.tolist(), counts.tolist())) == dict(want)
    assert keys.tolist() == sorted(want)
    ctrl = spectrum.edge_spectrum(reads, 26, "cpu", drop_reads_with_n=True)
    assert spectrum.mismatched(keys, counts, *ctrl) > 0
    assert spectrum.mismatched(keys, counts, keys, counts) == 0
    bumped = counts.clone()
    bumped[0] += 1
    assert spectrum.mismatched(keys, counts, keys, bumped) == 2


def brute_classes(graft: str, host: str, reads, k: int):
    g = {canon(w) for w in windows(graft, k)}
    h = {canon(w) for w in windows(host, k)}
    lhs = {x: x in g for x in g | h}
    rhs = {x: x in h for x in g | h}
    by_value = {value(x): x for x in lhs}
    gray = set()
    for x in lhs:
        if lhs[x] == rhs[x]:
            continue
        for j in range(k):
            for b in (1, 2, 3):
                y = value(x) ^ (b << j)
                s = "".join(BASES[(y >> (2 * (k - 1 - i))) & 3] for i in range(k))
                z = by_value.get(value(canon(s)))
                if z is not None and lhs[z] != rhs[z] and lhs[z] != lhs[x]:
                    gray.add(x)
    out = []
    for r in reads:
        bits = 0
        for w in windows(text(r), k):
            x = canon(w)
            if x in lhs:
                cls = 0 if x in gray else lhs[x] * 2 + rhs[x]
                bits |= 1 << cls
        out.append(xenome.CLASS_OF_BITS[bits])
    return out


def test_xenome_matches_the_brute_force():
    rng = np.random.default_rng(11)
    k = 25
    graft = rng.integers(0, 4, 600, dtype=np.uint8)
    host = rng.integers(0, 4, 600, dtype=np.uint8)
    host[100:300] = graft[100:300]
    host[110:300:20] = (host[110:300:20] + 1) % 4  # near k-mers on both sides
    host[420:500] = graft[220:300]
    reads = np.concatenate([
        np.lib.stride_tricks.sliding_window_view(src, 60)[rng.integers(0, 540, 80)]
        for src in (graft, host)] + [rng.integers(0, 4, (20, 60), dtype=np.uint8)])
    reads[::7, 30] = 4
    keys, cls = xenome.index(graft, host, k, "cpu")
    got = xenome.read_classes(reads, keys, cls, k, "cpu")
    want = brute_classes(text(graft), text(host), reads, k)
    assert got.tolist() == want
    assert len(set(want)) >= 4
    keys0, cls0 = xenome.index(graft, host, k, "cpu", near_kmers=False)
    assert not np.array_equal(xenome.read_classes(reads, keys0, cls0, k, "cpu"), got)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", [BUILD, CLASSIFY])
def test_a_run_on_the_port_cpu_path_is_correct(cell, trace, tmp_path):
    result = harness.run(cell, 2 ** 31 + 99, 0.5, trace, device="cpu",
                         workdir=tmp_path / "w", overrides=SMALL[cell])
    assert list(result) == (["correct", "attempted", "failed", "metrics", "device"]
                            + (["breakdown"] if "breakdown" in result else [])
                            + ["setup", "checks"])
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert all(c["value"] == 0 and c["limit"] == 0 for c in result["checks"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    cellspec = harness.Cell(cell)
    want = cellspec.per_layer if trace else cellspec.end_to_end
    units = {m["name"]: m["unit"] for m in want}
    for name, m in result["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == units[name]
    if not trace:
        assert set(result["metrics"]) == set(units)
    else:
        # device metrics are left out where the CPU ran: never a CPU number
        assert not any("roofline" in n or "idle" in n for n in result["metrics"])
    json.dumps(result)
