"""Wide keys (31 < rho <= 63) of the PyTorch port against the JAX package.

The same seeded codes go through ``gossamer_tpu.ops.engine_wide`` and
``gossamer_tpu_torch.ops.engine_wide``; state crosses through
``gossamer_tpu_torch.convert``.  Every comparison is exact (integers,
tolerance 0): the limb functions on valid windows, one batch step, the
device expansion, the engine over several batches with forced spills in
each mode, a spectrum carried over from the JAX engine mid-stream, the
packed format's overlap limit, the all-``T`` rho-mer at rho = 63, and the
CLI's graph and k-mer-set files byte for byte.
"""

import os
import random

import numpy as np
import pytest
import torch

from gossamer_tpu.cli.goss import build_app as jax_app
from gossamer_tpu.ops import engine_wide as jw
from gossamer_tpu_torch import convert
from gossamer_tpu_torch.cli.goss import main as port_main
from gossamer_tpu_torch.graph.graph import Graph
from gossamer_tpu_torch.io.factory import PhysicalFileFactory
from gossamer_tpu_torch.io.native import (decode_spill_run128,
                                          encode_spill_run128,
                                          native_flat_chunks)
from gossamer_tpu_torch.io.readers import Read, read_files
from gossamer_tpu_torch.io.stream import flat_code_chunks, pack_chunk
from gossamer_tpu_torch.ops import engine_wide as tw
from gossamer_tpu_torch.ops.count import count_rho_mers, count_rho_mers_files

from specmodel import spectrum_build_graph

CPU = torch.device("cpu")
RHOS = (32, 40, 63)
C = 128


def limbs_np(limbs):
    return [x.numpy().astype(np.uint32) for x in limbs]


@pytest.fixture(scope="module")
def windows():
    """rho -> (codes uint8[2, 300 + rho - 1], the JAX k-merizer's planes and
    validity, the port's limbs and validity)."""
    rng = np.random.default_rng(0)
    out = {}
    for rho in RHOS:
        codes = rng.integers(0, 4, (2, 300 + rho - 1)).astype(np.uint8)
        codes[0, 50] = 255
        codes[1, 7] = 4
        codes[1, 100 : 100 + rho] = 3  # the all-T rho-mer
        j = [np.asarray(x) for x in jw.kmerize_planes_wide(codes, rho)]
        t = tw.kmerize_planes_wide(torch.from_numpy(codes), rho)
        out[rho] = (codes, j, t)
    return out


@pytest.mark.parametrize("rho", RHOS)
def test_kmerize_planes_wide_matches_jax(windows, rho):
    _codes, j, t = windows[rho]
    valid = j[4]
    assert np.array_equal(t[4].numpy(), valid) and 0 < valid.sum() < valid.size
    for a, b in zip(j[:4], limbs_np(t[:4])):
        assert np.array_equal(a[valid], b[valid])
    # through convert: lanes -> the JAX planes
    planes = convert.planes_from_wide_set(*tw.to_lanes(*t[:4]))
    for a, b in zip(j[:4], planes):
        assert np.array_equal(a[valid], b.reshape(a.shape)[valid])


@pytest.mark.parametrize("rho", RHOS)
@pytest.mark.parametrize("name", ["rc_planes_wide", "canon_value_wide",
                                  "canon_ref_wide"])
def test_canon_wide_matches_jax(windows, rho, name):
    _codes, j, t = windows[rho]
    valid = j[4]
    want = [np.asarray(x) for x in getattr(jw, name)(*j[:4], rho)]
    got = limbs_np(getattr(tw, name)(*t[:4], rho))
    for a, b in zip(want, got):
        assert np.array_equal(a[valid], b[valid])


@pytest.mark.parametrize("rho", RHOS)
def test_fnv_planes_wide_matches_jax(windows, rho):
    _codes, j, t = windows[rho]
    valid = j[4]
    want = [np.asarray(x) for x in jw.fnv_planes_wide(*j[:4])]
    got = limbs_np(tw.fnv_planes_wide(*t[:4]))
    for a, b in zip(want, got):
        assert np.array_equal(a[valid], b[valid])


def test_lanes_order_like_the_key_and_round_trip():
    rng = np.random.default_rng(3)
    vals = [0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1, 1 << 64,
            (1 << 126) - 1] + [int(x) << int(s) for x, s in zip(
                rng.integers(1, 1 << 62, 200), rng.integers(0, 64, 200))]
    vals = sorted(set(vals))
    lo = np.array([v & ((1 << 64) - 1) for v in vals], np.uint64)
    hi = np.array([v >> 64 for v in vals], np.uint64)
    perm = rng.permutation(len(vals))
    h, l = tw.lanes_from_u64(lo[perm], hi[perm], CPU)
    hs, ls, src = tw.sort_lanes(h, l, torch.from_numpy(perm))
    assert torch.equal(src, torch.arange(len(vals)))
    back_lo, back_hi = tw.u64_from_lanes(hs, ls)
    assert np.array_equal(back_lo, lo) and np.array_equal(back_hi, hi)
    # every key is below the sentinel, also the all-T rho-mer at rho = 63
    assert bool(((hs < tw.SENT) | (ls < tw.SENT)).all())
    for a, b in zip(tw.from_lanes(*tw.to_lanes(*tw.from_lanes(hs, ls))),
                    tw.from_lanes(hs, ls)):
        assert torch.equal(a, b)


def jax_empty(cap):
    z = np.full(cap, jw.SENT32, np.uint32)
    return z, z, z, z, np.zeros(cap, np.uint32)


@pytest.mark.parametrize("rho,mode", [(40, "ref"), (63, "value")])
def test_batch_step_and_expand_step_wide_match_jax(windows, rho, mode):
    codes, _j, _t = windows[rho]
    cap = 1024
    spec = jax_empty(cap)
    want = jw.batch_step_wide(codes, *spec[:4], rho, mode, cap, s_c=spec[4])
    got = tw.batch_step_wide(torch.from_numpy(codes),
                             *tw.empty_spec_wide(cap, CPU), rho, mode, cap)
    assert int(got[3]) == int(want[5]) > 0
    for a, b in zip(want[:5], convert.planes_from_wide_spectrum(*got[:3])):
        assert np.array_equal(np.asarray(a), b)
    # the JAX planes carried across give the port's lanes
    for a, b in zip(convert.wide_spectrum_from_planes(
            *map(np.asarray, want[:5]), CPU), got[:3]):
        assert torch.equal(a, b)
    ewant = jw.expand_step_wide(*want[:5], rho)
    egot = tw.expand_step_wide(*got[:3], rho)
    assert int(egot[3]) == int(ewant[5])
    for a, b in zip(ewant[:5], convert.planes_from_wide_spectrum(*egot[:3])):
        assert np.array_equal(np.asarray(a), b)


def make_reads(rng, n, length):
    reads = [Read(str(i), "".join(
        rng.choice("ACGTN") if rng.random() < 0.02 else rng.choice("ACGT")
        for _ in range(length)).encode()) for i in range(n)]
    reads.append(Read("t", b"T" * length))  # the all-T rho-mer, many times
    return reads


def run_both(reads, rho, mode, expanded, chunk=C, **kw):
    engines = (jw.SpectrumEngineWide(rho, mode, chunk, **kw),
               tw.SpectrumEngineWide(rho, mode, chunk, CPU, **kw))
    outs = []
    for eng in engines:
        for codes in flat_code_chunks(reads, rho, chunk=chunk):
            eng.add_chunk(codes)
        outs.append(eng.finish_expanded() if expanded else eng.finish())
    return engines, outs


def assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("rho,mode,expanded,cap", [
    (40, "plain", False, 1 << 11), (40, "ref", False, 1 << 11),
    (40, "value", True, 1 << 11), (63, "plain", False, 1 << 14),
    (63, "value", True, 1 << 14), (32, "value", True, 1 << 14)])
def test_engine_wide_matches_jax(rho, mode, expanded, cap):
    """Several batches; a cap of 2^11 forces spills and the host merge."""
    reads = make_reads(random.Random(rho), 120, 100)
    (jeng, eng), (want, got) = run_both(reads, rho, mode, expanded, cap=cap)
    assert len(got[0]) > 1000 and got[2].max() > 1
    assert_same(got, want)
    assert (eng.spills > 0) == (cap == 1 << 11) == (jeng.spills > 0)
    if rho == 63 and mode == "plain":  # all-T is a key, not the sentinel
        top = (int(got[1][-1]) << 64) | int(got[0][-1])
        assert top == (1 << 126) - 1 and got[2][-1] == 100 - rho + 1


def test_engine_wide_overflow_raises_like_jax():
    reads = make_reads(random.Random(9), 120, 100)
    for make in (lambda: jw.SpectrumEngineWide(40, "plain", C, cap=1 << 11,
                                               spill=False),
                 lambda: tw.SpectrumEngineWide(40, "plain", C, CPU,
                                               cap=1 << 11, spill=False)):
        eng = make()
        with pytest.raises(RuntimeError, match="exceeded cap"):
            for codes in flat_code_chunks(reads, 40, chunk=C):
                eng.add_chunk(codes)
            eng.finish()


def test_engine_wide_resumes_from_jax_spectrum():
    rho = 40
    first = list(flat_code_chunks(make_reads(random.Random(21), 40, 100), rho,
                                  chunk=C))[:16]
    second = list(flat_code_chunks(make_reads(random.Random(22), 40, 100), rho,
                                   chunk=C))
    jeng = jw.SpectrumEngineWide(rho, "value", C, cap=1 << 14)
    for codes in first:
        jeng.add_chunk(codes)
    assert not jeng.buf and not jeng.host_runs
    eng = tw.SpectrumEngineWide(rho, "value", C, CPU, cap=1 << 14)
    eng.start_from(*convert.wide_spectrum_from_planes(
        *map(np.asarray, jeng.spec), CPU))
    for e in (jeng, eng):
        for codes in second:
            e.add_chunk(codes)
    assert_same(eng.finish_expanded(), jeng.finish_expanded())


def test_spill_codec128_round_trip():
    rng = np.random.default_rng(5)
    hi = np.sort(rng.integers(0, 1 << 20, 500).astype(np.uint64))
    lo = rng.integers(0, 1 << 63, 500).astype(np.uint64) << np.uint64(1)
    order = np.lexsort((lo, hi))
    lo, hi = lo[order], hi[order]
    c = rng.integers(1, 1 << 32, 500).astype(np.int64)
    got = decode_spill_run128(encode_spill_run128(lo, hi, c), 500)
    assert_same(got, (lo, hi, c))


@pytest.mark.parametrize("k", [33, 34, 56, 63])
def test_pack_chunk_raises_past_an_overlap_of_32(k):
    """The packed format has room for 32 overlap bases: right up to there,
    a raise beyond, never a truncated tail."""
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 64 + k - 1).astype(np.uint8)
    if k - 1 <= 32:
        words, _inval = pack_chunk(codes, k, 64)
        bases = (words[:, None] >> (30 - 2 * np.arange(16))) & 3
        assert np.array_equal(bases.reshape(-1)[: len(codes)], codes)
    else:
        with pytest.raises(ValueError, match="overlap"):
            pack_chunk(codes, k, 64)


def to_dict(lo, hi, c):
    return {(int(h) << 64) | int(l): int(n) for l, h, n in zip(lo, hi, c)}


def test_all_t_rho_mer_at_rho_63_plain_mode():
    """2^126 - 1 is a key like any other: counted, not taken for the
    sentinel."""
    reads = [Read("t", b"T" * 70), Read("a", b"A" * 64), Read("t2", b"T" * 63)]
    lo, hi, c = count_rho_mers(reads, 63, both_strands=False, canonical=False,
                               device=CPU, chunk=64)
    assert to_dict(lo, hi, c) == {(1 << 126) - 1: 9, 0: 2}


@pytest.fixture
def tiny(tmp_path):
    """The fixture of tests/test_cli_goss.py, reads of 90 bases."""
    rng = random.Random(42)
    genome = "".join(rng.choice("ACGT") for _ in range(400))
    reads = []
    for _ in range(60):
        p = rng.randrange(0, len(genome) - 90)
        r = genome[p : p + 90]
        if rng.random() < 0.5:
            r = "".join("TGCA"["ACGT".index(c)] for c in reversed(r))
        reads.append(r)
    fa = tmp_path / "reads.fa"
    fa.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    return tmp_path, reads, str(fa)


def same_files(tmp, a: str, b: str) -> list[str]:
    names = sorted(n[len(a):] for n in os.listdir(tmp) if n.startswith(a))
    assert names == sorted(n[len(b):] for n in os.listdir(tmp)
                           if n.startswith(b)) and names
    for suffix in names:
        assert (tmp / (a + suffix)).read_bytes() == \
            (tmp / (b + suffix)).read_bytes(), suffix
    return names


@pytest.mark.parametrize("k", [31, 40, 62])
def test_build_graph_wide_files_match_jax_cli(tiny, k):
    tmp, reads, fa = tiny
    args = ["build-graph", "-k", str(k), "-I", fa, "--chunk-size", "1024"]
    assert jax_app().main(args + ["-O", str(tmp / "gj")]) == 0
    assert port_main(args + ["-O", str(tmp / "gt"), "--device", "cpu"]) == 0
    names = same_files(tmp, "gt", "gj")
    assert (".edges-hi" in names) == (k > 31)
    g = Graph.read(str(tmp / "gt"), PhysicalFileFactory())
    assert to_dict(g.lo, g.hi, g.counts) == spectrum_build_graph(reads, k + 1)
    assert g.lint() == []


def test_build_kmer_set_wide_files_match_jax_cli(tiny, capsys):
    tmp, _reads, fa = tiny
    args = ["build-kmer-set", "-k", "40", "-I", fa, "--chunk-size", "1024"]
    assert jax_app().main(args + ["-O", str(tmp / "kj")]) == 0
    assert port_main(args + ["-O", str(tmp / "kt"), "--device", "cpu"]) == 0
    assert ".kmers-hi" in same_files(tmp, "kt", "kj")
    capsys.readouterr()
    assert jax_app().main(["dump-kmer-set", "-G", str(tmp / "kj")]) == 0
    want = capsys.readouterr().out
    assert port_main(["dump-kmer-set", "-G", str(tmp / "kt"),
                      "--device", "cpu"]) == 0
    assert capsys.readouterr().out == want and len(want.splitlines()) > 100


def test_wide_readers_agree(tiny):
    """Native raw-code chunks and the Python reader give one spectrum."""
    _tmp, reads, fa = tiny
    kw = dict(both_strands=True, canonical=False, device=CPU, chunk=1000)
    chunks = list(native_flat_chunks([fa], 41, chunk=1000))
    assert all(len(c) == 1040 and c.dtype == np.uint8 for c in chunks)
    native = count_rho_mers_files([fa], 41, **kw)
    python = count_rho_mers(read_files([fa]), 41, **kw)
    assert_same(native, python)
    assert native[2].sum() == sum(spectrum_build_graph(reads, 41).values())
