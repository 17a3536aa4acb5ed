"""The narrow engine's raw code input against the JAX engine (``kmerize_planes``,
``batch_step``, ``batch_step_fold``, ``add_chunk``); its packed input
against the JAX engine's sparse-invalidity and periodic routes and its
smaller first flush on the same reads; and ``count_chunks`` at any chunk
size (``chunk=0``, chunks not divisible by 16) through the port's CLI.
The JAX engine runs its XLA sort path (``fold=False``), the CPU oracle of
its spectra; keys and counts must be equal.  Shapes are
``tests/test_engine.py``'s.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gossamer_tpu.cli.goss import build_app as jax_app
from gossamer_tpu.io import stream as jax_stream
from gossamer_tpu.ops import engine as JE
from gossamer_tpu.ops.count import count_chunks as jax_count_chunks
from gossamer_tpu_torch.cli.goss import main as port_main
from gossamer_tpu_torch.convert import spectrum_from_planes
from gossamer_tpu_torch.io.stream import pack_chunk, packed_code_chunks
from gossamer_tpu_torch.io.readers import Read
from gossamer_tpu_torch.ops import engine as E
from gossamer_tpu_torch.ops.count import count_chunks
from gossamer_tpu_torch.ops.kmerize import kmerize_planes

CPU = torch.device("cpu")


def _chunks(rng, n_chunks, chunk, rho, sep_every=50):
    """``tests/test_engine.py``'s raw chunks: random bases, ~2% separators."""
    out = []
    for _ in range(n_chunks):
        c = rng.integers(0, 4, size=chunk + rho - 1, dtype=np.uint8)
        c[rng.integers(0, len(c), size=len(c) // sep_every)] = 255
        out.append(c)
    return out


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _jax(chunks, rho, mode, C, add="add_chunk", expanded=False, **kw):
    eng = JE.SpectrumEngine(rho, mode, C, fold=False, **kw)
    for ch in chunks:
        getattr(eng, add)(*ch) if isinstance(ch, tuple) else eng.add_chunk(ch)
    return eng.finish_expanded() if expanded else eng.finish()


def _port(chunks, rho, mode, C, add="add_chunk", expanded=False, **kw):
    eng = E.SpectrumEngine(rho, mode, C, CPU, **kw)
    for ch in chunks:
        getattr(eng, add)(*ch) if isinstance(ch, tuple) else eng.add_chunk(ch)
    return eng, eng.finish_expanded() if expanded else eng.finish()


# ------------------------------------------------------------- raw codes
@pytest.mark.parametrize("rho", [5, 26, 31])
def test_kmerize_planes_matches_jax(rho):
    rng = np.random.default_rng(13)
    codes = np.stack(_chunks(rng, 2, 512, rho))
    l1, l0, v = JE.kmerize_planes(jnp.asarray(codes), rho)
    keys, valid = kmerize_planes(torch.from_numpy(codes), rho)
    want = (np.asarray(l1).astype(np.int64) << 32) | np.asarray(l0)
    assert np.array_equal(valid.numpy(), np.asarray(v))
    assert np.array_equal(keys.numpy(), want)


@pytest.mark.parametrize("rho", [5, 26, 31])
@pytest.mark.parametrize("mode", ["plain", "value", "ref"])
@pytest.mark.parametrize("fold", [False, True])
def test_raw_codes_match_jax(rho, mode, fold):
    rng = np.random.default_rng(3)
    chunks = _chunks(rng, 5, 400, rho)
    want = _jax(chunks, rho, mode, 400, batch=2, cap=1 << 12)
    eng, got = _port(chunks, rho, mode, 400, batch=2, cap=1 << 12, fold=fold)
    assert eng.packed is False and len(got[0]) > 100 and eng.spills == 0
    _assert_same(got, want)


def test_batch_steps_match_jax():
    """``batch_step`` (plain) and ``batch_step_fold`` on the same spectrum
    equal the JAX ``batch_step``, ``live`` included."""
    rho, cap = 26, 1 << 12
    rng = np.random.default_rng(4)
    first, second = (np.stack(_chunks(rng, 2, 500, rho)) for _ in range(2))
    spec = JE.empty_spec(cap)
    *spec, _ = JE.batch_step(jnp.asarray(first), *spec, rho, "value", cap)
    *want, want_live = JE.batch_step(jnp.asarray(second), *spec, rho,
                                     "value", cap)
    keys, counts = spectrum_from_planes(*map(np.asarray, spec), CPU)
    want_keys, want_counts = spectrum_from_planes(*map(np.asarray, want), CPU)
    codes = torch.from_numpy(second)
    for step in (E.batch_step, E.batch_step_fold):
        k, c, live = step(codes, keys, counts, rho, "value", cap)
        assert int(live) == int(want_live)
        assert torch.equal(k, want_keys) and torch.equal(c, want_counts)


def test_raw_codes_spill_and_expanded_finish_match_jax():
    """Spills to host runs, the runs merged back at finish and the
    symmetric expansion: both as the JAX engine gives them."""
    rho = 26
    rng = np.random.default_rng(10)
    chunks = _chunks(rng, 12, 500, rho)
    for expanded in (False, True):
        want = _jax(chunks, rho, "value", 500, expanded=expanded, batch=2,
                    cap=2048)
        eng, got = _port(chunks, rho, "value", 500, expanded=expanded,
                         batch=2, cap=2048)
        assert eng.spills >= 1
        assert all(step.endswith("on the host") for step in eng.finish_log)
        _assert_same(got, want)


def test_raw_codes_spill_finish_on_device_matches_jax():
    """A spill while the device cap grows, the finish's lanes (and twice
    them) within the cap: every merge and the expansion run on the device
    side, as the JAX engine's host finish gives them."""
    rho = 26
    chunks = _chunks(np.random.default_rng(12), 40, 500, rho, sep_every=1000)
    for expanded in (False, True):
        want = _jax(chunks, rho, "value", 500, expanded=expanded, batch=2,
                    cap=1 << 17)
        eng, got = _port(chunks, rho, "value", 500, expanded=expanded,
                         batch=2, cap=1 << 17)
        assert eng.spills >= 1 and len(eng.finish_log) == 1 + expanded
        assert all(step.endswith("on cpu") for step in eng.finish_log)
        _assert_same(got, want)


def test_first_batch_matches_jax():
    """The JAX engine's smaller first flush (``first_batch``) and the
    port's equal flushes count the same spectrum."""
    rho = 26
    rng = np.random.default_rng(6)
    chunks = _chunks(rng, 7, 400, rho)
    want = _jax(chunks, rho, "value", 400, batch=3, cap=1 << 14,
                first_batch=1)
    eng, got = _port(chunks, rho, "value", 400, batch=3, cap=1 << 14)
    assert eng.spills == 0 and len(got[0]) > 1000
    _assert_same(got, want)


def test_routes_do_not_mix():
    rho = 26
    codes = _chunks(np.random.default_rng(1), 1, 512, rho)[0]
    eng = E.SpectrumEngine(rho, "value", 512, CPU)
    eng.add_chunk(codes)
    with pytest.raises(ValueError, match="one input route"):
        eng.add_chunk_packed(*pack_chunk(codes, rho, 512))
    with pytest.raises(ValueError, match="expected 537"):
        eng.add_chunk(codes[:-1])


# ------------------------------------------ the JAX sparse and periodic routes
def _sparse_chunks(rho, chunk):
    """``tests/test_engine.py``'s sparse case: mid-chunk separators and a
    final chunk padded with 255."""
    chunks = _chunks(np.random.default_rng(31), 5, chunk, rho)
    chunks[-1] = chunks[-1].copy()
    chunks[-1][300:] = 255
    return chunks


@pytest.mark.parametrize("fold", [False, True])
def test_sparse_packed_matches_jax(fold):
    """The port's packed route on the reads of the JAX engine's
    sparse-invalidity route: the same spectrum."""
    rho, chunk = 26, 512
    chunks = _sparse_chunks(rho, chunk)
    sparse = [jax_stream.pack_chunk_sparse(c, rho, chunk, max_pos=chunk // 4)
              for c in chunks]
    want = _jax(sparse, rho, "value", chunk, "add_chunk_packed_sparse",
                batch=2, cap=1 << 14)
    eng, got = _port([pack_chunk(c, rho, chunk) for c in chunks], rho,
                     "value", chunk, "add_chunk_packed", batch=2, cap=1 << 14,
                     fold=fold)
    assert eng.packed and len(got[0]) > 1000
    _assert_same(got, want)


@pytest.mark.parametrize("fold", [False, True])
def test_periodic_packed_matches_jax(fold):
    """``tests/test_engine.py``'s periodic case: two passes of 50 bp reads
    (period 51) back to back, a pass boundary inside a chunk, padding.  The
    JAX engine's periodic route and the port's packed route on the same
    stream: the same spectrum."""
    rho, L, chunk = 26, 50, 512
    T = L + 1
    rng = np.random.default_rng(41)
    passes = []
    for rows in (13, 9):
        block = np.full((rows, T), 255, np.uint8)
        block[:, :L] = rng.integers(0, 4, size=(rows, L), dtype=np.uint8)
        passes.append(block.reshape(-1))
    flat = np.concatenate(passes)
    n_chunks = -(-len(flat) // chunk)
    stream = np.full(n_chunks * chunk + rho - 1, 255, np.uint8)
    stream[: len(flat)] = flat
    packed, periodic = [], []
    starts = [0, len(passes[0])]
    for i in range(n_chunks):
        p0 = i * chunk
        codes = stream[p0 : p0 + chunk + rho - 1]
        packed.append(pack_chunk(codes, rho, chunk))
        cur = max(s for s in starts if s <= p0)
        nxt = [s for s in starts if s > p0]
        bound = (nxt[0] - p0) if nxt else chunk + rho
        nwin = max(0, min(chunk, len(flat) - rho + 1 - p0))
        periodic.append((packed[-1][0], (p0 - cur) % T, bound, nwin))
    want = _jax(periodic, rho, "value", chunk, "add_chunk_packed_periodic",
                batch=2, cap=1 << 14, period=T)
    eng, got = _port(packed, rho, "value", chunk, "add_chunk_packed",
                     batch=2, cap=1 << 14, fold=fold)
    assert eng.packed and len(got[0]) > 400
    _assert_same(got, want)


# ------------------------------------------------ count_chunks and the CLI
def test_count_chunks_chunk_zero_matches_jax():
    """``chunk=0`` takes the windows from the first raw chunk."""
    rho = 26
    chunks = _chunks(np.random.default_rng(6), 4, 600, rho)
    for both, canon in ((True, False), (False, True)):
        want = jax_count_chunks(iter(chunks), rho, both_strands=both,
                                canonical=canon, cap_entries=1 << 12)
        got = count_chunks(iter(chunks), rho, both_strands=both,
                           canonical=canon, device=CPU, chunk=0,
                           cap_entries=1 << 12)
        _assert_same(got, want)
    packed = [pack_chunk(c[:512 + rho - 1], rho, 512) for c in chunks]
    with pytest.raises(ValueError, match="divisible by 16"):
        count_chunks(iter(packed), rho, both_strands=True, canonical=False,
                     device=CPU, chunk=0)


def test_packed_code_chunks_match_jax():
    rng = np.random.default_rng(5)
    reads = [Read(str(i), bytes(rng.choice(list(b"ACGTN"), 90)))
             for i in range(40)]
    got = list(packed_code_chunks(iter(reads), 12, chunk=256))
    want = list(jax_stream.packed_code_chunks(iter(reads), 12, chunk=256))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert all(np.array_equal(a, b) for a, b in zip(g, w))


@pytest.mark.parametrize("cmd,k", [("build-graph", 11), ("build-kmer-set", 12)])
def test_cli_chunk_size_1000_matches_jax_cli(tmp_path, cmd, k):
    """Fault C.15: a chunk size not divisible by 16 counts raw codes; the
    files are byte-identical to the JAX CLI's."""
    rng = np.random.default_rng(42)
    genome = rng.integers(0, 4, 400)
    reads = []
    for _ in range(60):
        p = int(rng.integers(0, 340))
        reads.append(bytes(np.frombuffer(b"ACGT", np.uint8)[genome[p:p + 60]]))
    reads[3] = reads[3][:20] + b"N" + reads[3][21:]
    fa = tmp_path / "reads.fa"
    fa.write_text("".join(f">r{i}\n{r.decode()}\n" for i, r in enumerate(reads)))
    args = [cmd, "-k", str(k), "-I", str(fa), "--chunk-size", "1000"]
    assert jax_app().main(args + ["-O", str(tmp_path / "j")]) == 0
    log = tmp_path / "port.log"
    assert port_main(args + ["-O", str(tmp_path / "t"), "--device", "cpu",
                             "-l", str(log)]) == 0
    assert "reader: native" in log.read_text()
    names = sorted(p.name[1:] for p in tmp_path.iterdir()
                   if p.name.startswith("j"))
    assert names and names == sorted(p.name[1:] for p in tmp_path.iterdir()
                                     if p.name.startswith("t"))
    for suffix in names:
        assert (tmp_path / ("t" + suffix)).read_bytes() == \
            (tmp_path / ("j" + suffix)).read_bytes(), suffix
