"""The paired classify cell (``xenome-classify.k25.pdx-pairs``) on the CPU:
its generator, its plain pair reference against a brute force in plain
Python, its two new metric files, and whole runs of the cell at a small
size on the port's CPU path, with its control and a broken pair rule."""

import importlib
import json

import numpy as np
import pytest

from benchmark import harness
from benchmark.controls import control_numbers
from benchmark.harness import load_module
from benchmark.reference import xenome, xenome_pairs
from benchmark.tests.test_bench_reference import brute_classes, text

CELL = "xenome-classify.k25.pdx-pairs"
SMALL = {"config": {"graft_length": 20_000, "host_length": 20_000,
                    "segment_at": 5_000, "segment_length": 2_000,
                    "sample_pairs": 1_500}}
SEED = 2 ** 31 + 12345  # past what 32 signed bits hold
NEW = ("mates_s.pairs", "join_fill_pct.classify")


def make(seed, tmp_path, **config):
    c = harness.Cell(CELL, SMALL)
    gen = importlib.import_module(f"benchmark.traffic.{c.mix['generator']}")
    tmp_path.mkdir(parents=True, exist_ok=True)
    return gen.make({**c.config, **config}, c.mix, seed, tmp_path)


def metric(name):
    return load_module(harness.REPO / "benchmark" / "metrics" / f"{name}.py", "m")


def test_same_seed_same_inputs(tmp_path):
    a = make(SEED, tmp_path / "a")
    b = make(SEED, tmp_path / "b")
    c = make(SEED + 1, tmp_path / "c")
    assert a.keys() == b.keys()
    for key, value in a.items():
        if isinstance(value, np.ndarray):
            assert np.array_equal(value, b[key])
        else:
            with open(value, "rb") as fa, open(b[key], "rb") as fb:
                assert fa.read() == fb.read()
    assert not np.array_equal(a["reads_1"], c["reads_1"])


def test_sizes_do_not_depend_on_the_seed(tmp_path):
    a = make(1, tmp_path / "a")
    b = make(2 ** 33, tmp_path / "b")
    for key in ("reads_1", "reads_2"):
        assert a[key].shape == b[key].shape == (1_500, 100)
        assert int((a[key] >= 4).any(axis=1).sum()) == int((b[key] >= 4).any(axis=1).sum())


def test_both_files_have_equal_counts_and_labels(tmp_path):
    inp = make(SEED, tmp_path)
    labels = []
    for half in ("1", "2"):
        with open(inp[f"reads_{half}_fastq"], "rb") as f:
            lines = f.read().split(b"\n")[:-1]
        assert len(lines) == 4 * len(inp[f"reads_{half}"])
        labels.append(lines[0::4])
    assert labels[0] == labels[1]
    assert labels[0][:2] == [b"@r0000000", b"@r0000001"]


def test_the_fragment_model(tmp_path):
    """Concordant graft pairs: one mate and the reverse complement of the
    other lie on one strand of the graft, their outer ends a fragment apart
    (mean 300, sd 30); the discordant share."""
    inp = make(SEED, tmp_path, sample_pairs=4_000)
    src = inp["sources"]
    discordant = src[:, 0] != src[:, 1]
    assert 0.01 < discordant.mean() < 0.03
    graft = text(inp["graft"])
    rc = str.maketrans("ACGTN", "TGCAN")
    spans = []
    for i in np.flatnonzero((src[:, 0] == 0) & ~discordant)[:200]:
        m1, m2 = text(inp["reads_1"][i]), text(inp["reads_2"][i])
        # forward strand: mate 1 leads; reverse strand: mate 2 does
        for a, b in ((m1, m2[::-1].translate(rc)), (m2, m1[::-1].translate(rc))):
            p, q = graft.find(a[:16]), graft.find(b[-16:])
            if p >= 0 and q >= 0:
                spans.append(q + 16 - p)
    assert len(spans) > 140
    assert all(100 <= s <= 420 for s in spans)
    assert 290 < np.mean(spans) < 310


def test_the_pair_reference_matches_the_brute_force(monkeypatch):
    rng = np.random.default_rng(13)
    k = 25
    graft = rng.integers(0, 4, 600, dtype=np.uint8)
    host = rng.integers(0, 4, 600, dtype=np.uint8)
    host[100:300] = graft[100:300]
    host[110:300:20] = (host[110:300:20] + 1) % 4  # near k-mers on both sides
    reads = np.concatenate([
        np.lib.stride_tricks.sliding_window_view(src, 60)[rng.integers(0, 540, 80)]
        for src in (graft, host)] + [rng.integers(0, 4, (20, 60), dtype=np.uint8)])
    reads[::7, 30] = 4
    mates = reads[rng.permutation(len(reads))].reshape(2, -1, 60)
    keys, cls = xenome.index(graft, host, k, "cpu")
    bits = [xenome_pairs.read_bits(m, keys, cls, k, "cpu") for m in mates]
    # the brute force's class table made the identity: it gives the bits
    monkeypatch.setattr(xenome, "CLASS_OF_BITS", tuple(range(16)))
    want = [brute_classes(text(graft), text(host), m, k) for m in mates]
    monkeypatch.undo()
    assert [b.tolist() for b in bits] == want
    got = xenome_pairs.pair_classes(*bits)
    assert got.tolist() == [xenome.CLASS_OF_BITS[a | b] for a, b in zip(*want)]
    assert len(set(got.tolist())) >= 4
    assert not np.array_equal(xenome_pairs.classes_of_bits(bits[0]), got)


@pytest.mark.parametrize("name", NEW)
def test_metric_reads_nothing_without_its_scope_or_counter(name):
    older = {"wall_s": 5.0, "spans": {},
             "profile": {"classify/read": 1.0, "#h2d_bytes": 8.0}}
    assert metric(name).read({"calls": [older], "kernels": {}, "device": None}) is None


def test_metrics_read_the_pair_scope_and_the_join_counters():
    prof = {"classify/read": 1.0, "classify/mates": 0.25, "#join_lanes": 2.0 ** 20,
            "#join_windows": 2.0 ** 19}
    records = {"calls": [{"wall_s": 5.0, "spans": {}, "profile": prof}] * 2,
               "kernels": {}, "device": None}
    assert metric("mates_s.pairs").read(records) == 0.25
    assert metric("join_fill_pct.classify").read(records) == 50.0


@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_on_the_port_cpu_path_is_correct(trace, tmp_path):
    result = harness.run(CELL, 2 ** 31 + 77, 0.5, trace, device="cpu",
                         workdir=tmp_path / "w", overrides=SMALL)
    assert result["correct"] is True, result["checks"]
    assert result["checks"]["pairs_misclassified"] == {"value": 0, "limit": 0}
    cell = harness.Cell(CELL)
    if trace:
        # every metric but the device's, which the CPU never gives
        want = {m["name"] for m in cell.per_layer} - {
            "merge_roofline.classify", "device_idle_pct.classify"}
        assert set(result["metrics"]) == want
        assert set(NEW) <= want
        # 3,000 reads of 76 windows in 2^19 lanes
        assert result["metrics"]["join_fill_pct.classify"]["value"] == pytest.approx(
            100 * 3_000 * 76 / 2 ** 19, abs=0.1)
        assert result["metrics"]["mates_s.pairs"]["value"] > 0
    else:
        assert set(result["metrics"]) == {"classify_reads_per_s",
                                          "peak_device_gib", "setup_s"}
    json.dumps(result)


def test_the_control_fails_on_three_seeds(tmp_path):
    c = harness.Cell(CELL, SMALL)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        got = control_numbers(c, seed, tmp_path / "w", "cpu")
        assert got["checks"]["pairs_misclassified"]["value"] > 0, got


def test_a_pair_rule_of_mate_1_alone_is_not_correct(tmp_path, monkeypatch):
    """The timed path broken after set-up: each mate 2's blrg replaced by its
    mate 1's, so that the OR gives mate 1's class."""
    from gossamer_tpu_torch.classify import device

    orig = device.classify_codes_device

    def mate_1_twice(codes_list, *a, **kw):
        blrg = np.array(orig(codes_list, *a, **kw))
        blrg[1::2] = blrg[0::2]
        return blrg
    result = harness.run(CELL, 2 ** 31 + 5, 0.2, False, device="cpu",
                         workdir=tmp_path / "w", overrides=SMALL,
                         fault=lambda entry: monkeypatch.setattr(
                             device, "classify_codes_device", mate_1_twice))
    assert result["correct"] is False
    assert result["checks"]["pairs_misclassified"]["value"] > 0
