"""The narrow engine's other input routes against the JAX engine: raw code
chunks (``kmerize_planes``, ``batch_step``, ``batch_step_fold``,
``add_chunk``), sparse-invalidity and periodic packed chunks, grouped
flushes (``batch_steps_fold_packed_scan``) and the smaller first flush, and ``count_chunks``
at any chunk size (``chunk=0``, chunks not divisible by 16) through the
port's CLI.  The JAX engine runs its XLA sort path (``fold=False``), the
CPU oracle of its spectra; keys and counts must be equal.  Shapes are
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
from gossamer_tpu_torch.io.stream import (pack_chunk, pack_chunk_sparse,
                                          packed_code_chunks)
from gossamer_tpu_torch.io.readers import Read
from gossamer_tpu_torch.ops import engine as E
from gossamer_tpu_torch.ops.count import count_chunks
from gossamer_tpu_torch.ops.kmerize import (kmerize_packed_periodic,
                                            kmerize_packed_sparse,
                                            kmerize_planes)

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


def _natural(x, C):
    """The JAX packed k-merizers' phase-major lanes -> natural order."""
    return np.asarray(x).reshape(16, C // 16).T.reshape(-1)


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
    rho = 26
    rng = np.random.default_rng(6)
    chunks = _chunks(rng, 7, 400, rho)
    want = _jax(chunks, rho, "value", 400, batch=3, cap=1 << 14)
    eng, got = _port(chunks, rho, "value", 400, batch=3, cap=1 << 14,
                     first_batch=1)
    assert eng._nflush == 3  # 1, then 3, 3, and none left at finish
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
    with pytest.raises(ValueError, match="period"):
        E.SpectrumEngine(rho, "value", 512, CPU).add_chunk_packed_periodic(
            pack_chunk(codes, rho, 512)[0], 0, 600, 512)


# ------------------------------------------------ sparse and periodic chunks
def _sparse_chunks(rho, chunk):
    """``tests/test_engine.py``'s sparse case: mid-chunk separators and a
    final chunk padded with 255."""
    chunks = _chunks(np.random.default_rng(31), 5, chunk, rho)
    chunks[-1] = chunks[-1].copy()
    chunks[-1][300:] = 255
    return chunks


def test_pack_chunk_sparse_matches_jax():
    rho, chunk = 26, 512
    for codes in _sparse_chunks(rho, chunk):
        got = pack_chunk_sparse(codes, rho, chunk, max_pos=chunk // 4)
        want = jax_stream.pack_chunk_sparse(codes, rho, chunk,
                                            max_pos=chunk // 4)
        assert got[2] == want[2]
        assert all(np.array_equal(g, w) for g, w in zip(got[:2], want[:2]))
    codes = np.full(chunk + rho - 1, 255, np.uint8)
    codes[::2] = 1
    assert pack_chunk_sparse(codes, rho, chunk, max_pos=8) is None
    assert jax_stream.pack_chunk_sparse(codes, rho, chunk, max_pos=8) is None


def test_kmerize_sparse_and_periodic_match_jax():
    rho, C, T = 26, 512, 51
    rng = np.random.default_rng(41)
    codes = _sparse_chunks(rho, C)[-1]
    words, invpos, nwin = pack_chunk_sparse(codes, rho, C, max_pos=C // 4)
    l1, l0, v = JE.kmerize_packed_sparse(jnp.asarray(words),
                                         jnp.asarray(invpos), nwin, rho, C)
    keys, valid = kmerize_packed_sparse(
        torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(invpos.view(np.int32)), torch.tensor(nwin), rho, C)
    assert np.array_equal(valid.numpy(), _natural(v, C))
    want = (_natural(l1, C).astype(np.int64) << 32) | _natural(l0, C)
    assert np.array_equal(keys.numpy(), want)
    words = pack_chunk(rng.integers(0, 4, C + rho - 1, dtype=np.uint8),
                       rho, C)[0]
    for ph, bound, nwin in ((7, C + rho, C), (50, 200, 400), (0, 0, C)):
        _l1, _l0, v = JE.kmerize_packed_periodic(jnp.asarray(words), ph,
                                                 bound, nwin, rho, C, T)
        _keys, valid = kmerize_packed_periodic(
            torch.from_numpy(words.view(np.int32)), torch.tensor(ph),
            torch.tensor(bound), torch.tensor(nwin), rho, C, T)
        assert np.array_equal(valid.numpy(), _natural(v, C))


@pytest.mark.parametrize("fold", [False, True])
def test_sparse_packed_matches_jax(fold):
    rho, chunk = 26, 512
    chunks = _sparse_chunks(rho, chunk)
    sparse = [pack_chunk_sparse(c, rho, chunk, max_pos=chunk // 4)
              for c in chunks]
    want = _jax(chunks, rho, "value", chunk, batch=2, cap=1 << 14)
    eng, got = _port(sparse, rho, "value", chunk, "add_chunk_packed_sparse",
                     batch=2, cap=1 << 14, fold=fold)
    assert eng.sparse and len(got[0]) > 1000
    _assert_same(got, want)
    jsparse = _jax(sparse, rho, "value", chunk, "add_chunk_packed_sparse",
                   batch=2, cap=1 << 14)
    _assert_same(got, jsparse)


@pytest.mark.parametrize("fold", [False, True])
def test_periodic_packed_matches_jax(fold):
    """``tests/test_engine.py``'s periodic case: two passes of 50 bp reads
    (period 51) back to back, a pass boundary inside a chunk, padding."""
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
    raw, periodic = [], []
    starts = [0, len(passes[0])]
    for i in range(n_chunks):
        p0 = i * chunk
        codes = stream[p0 : p0 + chunk + rho - 1]
        raw.append(codes)
        cur = max(s for s in starts if s <= p0)
        nxt = [s for s in starts if s > p0]
        bound = (nxt[0] - p0) if nxt else chunk + rho
        nwin = max(0, min(chunk, len(flat) - rho + 1 - p0))
        periodic.append((pack_chunk(codes, rho, chunk)[0], (p0 - cur) % T,
                         bound, nwin))
    want = _jax(raw, rho, "value", chunk, batch=2, cap=1 << 14)
    eng, got = _port(periodic, rho, "value", chunk,
                     "add_chunk_packed_periodic", batch=2, cap=1 << 14,
                     fold=fold, period=T)
    assert eng.periodic and len(got[0]) > 400
    _assert_same(got, want)


# --------------------------------------------------- grouped and first flushes
def test_scan_groups_match_jax():
    """Two groups of 2 x 2 chunks, one whole batch and a short rest, as
    ``tests/test_engine.py``'s scan case: folded group by group with
    :func:`batch_steps_fold_packed_scan` (the rest one batch a call), the
    spectrum equals the JAX engine's; the engine keeps ``scan_groups``
    (1 with spills, as JAX) and flushes batch by batch."""
    rho, chunk, cap = 8, 64, 1 << 14
    rng = np.random.default_rng(11)
    raw = [rng.integers(0, 4, chunk + rho - 1, dtype=np.uint8)
           for _ in range(11)]
    packed = [pack_chunk(c, rho, chunk) for c in raw]
    want = _jax(raw, rho, "value", chunk, batch=2, cap=cap)

    def stack(items, i):
        return torch.from_numpy(np.stack([t[i] for t in items]))

    keys, counts = E.empty_spec(cap, CPU)
    lives = []
    for g in range(0, 8, 4):
        grp = packed[g:g + 4]
        words = stack(grp, 0).view(torch.int32).view(2, 2, -1)
        keys, counts, live = E.batch_steps_fold_packed_scan(
            words, stack(grp, 1).view(2, 2, -1), keys, counts, rho, "value",
            cap, chunk)
        lives.append(int(live))
    for g in (8, 10):
        grp = packed[g:g + 2]
        keys, counts, live = E.batch_step_packed(
            stack(grp, 0).view(torch.int32), stack(grp, 1), keys, counts, rho,
            "value", cap, chunk)
        lives.append(int(live))
    n = lives[-1]
    assert lives == sorted(lives) and n == len(want[0])
    assert np.array_equal(keys[:n].numpy().view(np.uint64), want[0])
    assert np.array_equal(counts[:n].numpy(), want[2])
    want = _jax(raw, rho, "value", chunk, expanded=True, batch=2, cap=cap)
    for groups in (1, 2):
        eng, got = _port(packed, rho, "value", chunk, "add_chunk_packed",
                         expanded=True, batch=2, cap=cap, spill=False,
                         scan_groups=groups)
        assert eng.scan_groups == groups and eng._nflush == 6
        _assert_same(got, want)
    assert E.SpectrumEngine(rho, "value", chunk, CPU,
                            scan_groups=4).scan_groups == 1  # spill=True


def test_scan_keeps_an_unordered_live():
    """The grouped step reports -1 when one fold of the group saw its
    input out of order, where a max of the lives would hide it."""
    rho, C, cap = 8, 64, 1 << 10
    rng = np.random.default_rng(2)
    packed = [pack_chunk(rng.integers(0, 4, C + rho - 1, dtype=np.uint8),
                         rho, C) for _ in range(4)]
    words = torch.from_numpy(np.stack([w for w, _ in packed]).view(np.int32))
    inval = torch.from_numpy(np.stack([v for _, v in packed]))
    keys, counts = E.empty_spec(cap, CPU)
    keys, counts, live = E.batch_steps_fold_packed_scan(
        words.view(2, 2, -1), inval.view(2, 2, -1), keys, counts, rho,
        "value", cap, C)
    assert 0 < int(live) < cap
    keys = keys.flip(0).contiguous()  # the spectrum out of order
    *_, live = E.batch_steps_fold_packed_scan(
        words.view(2, 2, -1), inval.view(2, 2, -1), keys, counts, rho,
        "value", cap, C)
    assert int(live) == -1


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
