"""SpectrumEngine of the PyTorch port against the JAX engine's XLA sort
path (``SpectrumEngine(fold=False)``) on the same packed chunks: finish,
finish_expanded, cap growth with spills, the overflow error, an empty
stream, and a run resumed from a JAX spectrum carried across with
``convert.spectrum_from_planes``.  Counts and keys must be equal.
"""

import numpy as np
import pytest
import torch

from gossamer_tpu.ops.engine import SpectrumEngine as JaxEngine
from gossamer_tpu_torch.convert import spectrum_from_planes
from gossamer_tpu_torch.io.readers import Read
from gossamer_tpu_torch.io.stream import flat_code_chunks, pack_chunk
from gossamer_tpu_torch.ops.engine import SpectrumEngine

CPU = torch.device("cpu")
C = 1024


def packed_chunks(rho: int, n_reads: int, seed: int, genome_len: int = 3000):
    """Reads with repeats and a few Ns, as packed chunks of C windows."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len)
    reads = []
    for _ in range(n_reads):
        p = int(rng.integers(0, genome_len - 80))
        seq = np.frombuffer(b"ACGT", np.uint8)[genome[p : p + 80]].copy()
        if rng.random() < 0.1:
            seq[rng.integers(0, 80)] = ord("N")
        reads.append(Read(str(len(reads)), seq.tobytes()))
    return [pack_chunk(c, rho, C) for c in flat_code_chunks(reads, rho, chunk=C)]


def run_both(chunks, rho, mode, expanded=False, **kw):
    engines = (JaxEngine(rho, mode, C, fold=False, **kw),
               SpectrumEngine(rho, mode, C, CPU, **kw))
    outs = []
    for eng in engines:
        for words, inval in chunks:
            eng.add_chunk_packed(words, inval)
        outs.append(eng.finish_expanded() if expanded else eng.finish())
    return engines, outs


def assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("rho,mode,expanded", [(26, "plain", False),
                                               (26, "value", True),
                                               (31, "value", True)])
def test_engine_matches_jax(rho, mode, expanded):
    chunks = packed_chunks(rho, 150, seed=rho)
    (_, eng), (want, got) = run_both(chunks, rho, mode, expanded, batch=2)
    assert len(got[0]) > 1000 and got[2].max() > 1
    assert_same(got, want)
    assert eng.spills == 0


def test_engine_cap_growth_and_spill_match_jax():
    rho = 26
    chunks = packed_chunks(rho, 700, seed=5, genome_len=40000)
    (jeng, eng), (want, got) = run_both(chunks, rho, "value", True, batch=2,
                                        cap=20000)
    assert eng.spills > 0 and jeng.spills > 0
    assert eng.cap == 20000
    assert_same(got, want)


def test_engine_overflow_raises_like_jax():
    rho = 26
    chunks = packed_chunks(rho, 300, seed=9, genome_len=40000)
    for eng in (JaxEngine(rho, "value", C, batch=2, cap=4096, spill=False,
                          fold=False),
                SpectrumEngine(rho, "value", C, CPU, batch=2, cap=4096,
                               spill=False)):
        for words, inval in chunks:
            eng.add_chunk_packed(words, inval)
        with pytest.raises(RuntimeError, match="exceeded cap"):
            eng.finish()


def test_engine_empty_stream():
    (_, _), (want, got) = run_both([], 26, "value", True)
    assert len(got[0]) == 0
    assert_same(got, want)


def test_engine_resumes_from_jax_spectrum():
    rho = 26
    first = packed_chunks(rho, 100, seed=21)[:4]
    second = packed_chunks(rho, 100, seed=22)
    jeng = JaxEngine(rho, "value", C, batch=2, fold=False)
    for words, inval in first:
        jeng.add_chunk_packed(words, inval)
    assert not jeng.buf and not jeng.host_runs
    keys, counts = spectrum_from_planes(*map(np.asarray, jeng.spec), CPU)
    eng = SpectrumEngine(rho, "value", C, CPU, batch=2)
    eng.start_from(keys, counts)
    for e in (jeng, eng):
        for words, inval in second:
            e.add_chunk_packed(words, inval)
    assert_same(eng.finish_expanded(), jeng.finish_expanded())
