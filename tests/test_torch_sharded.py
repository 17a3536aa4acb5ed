"""The port's sharded count (``parallel/count_sharded.py``) against the JAX
package's on the same seeded reads: ``mix_owner`` bit for bit, the narrow
engine at (26, value) and (21, ref) and the wide one at (33, value) against
the JAX sharded engines on the 8 virtual CPU devices, and the cases of
``tests/test_sharded.py`` (skewed input, a mid-stream overflow, a mesh that
is not a power of two, many flushes).  The port's mesh is
``Mesh((cpu,) * n)``.  Also the mesh's collectives, ``data_mesh`` and the
routing of ``count_chunks``.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossamer_tpu.io.stream import flat_code_chunks as jax_chunks
from gossamer_tpu.io.stream import pack_chunk as jax_pack
from gossamer_tpu.ops.count import count_rho_mers as jax_count
from gossamer_tpu.parallel import count_sharded as JS
from gossamer_tpu.parallel.mesh import data_mesh as jax_mesh
from gossamer_tpu_torch.io.readers import Read
from gossamer_tpu_torch.io.stream import flat_code_chunks, pack_chunk
from gossamer_tpu_torch.ops.count import count_chunks, count_rho_mers
from gossamer_tpu_torch.parallel import mesh as M
from gossamer_tpu_torch.parallel.count_sharded import (
    ShardedSpectrumEngine, ShardedSpectrumEngineWide, mix_owner,
    mix_owner_wide)

CPU = torch.device("cpu")


def cpu_mesh(n: int) -> M.Mesh:
    return M.Mesh((CPU,) * n)


def make_reads(rng, n, length):
    """``tests/test_sharded.py``'s reads: random bases, 2% N."""
    return [
        Read(str(i), "".join(rng.choice("ACGTN") if rng.random() < 0.02
                             else rng.choice("ACGT") for _ in range(length)).encode())
        for i in range(n)
    ]


def make_skewed_reads(n, length, rng):
    """Poly-A runs, a repeated motif and random tails: min-by-value classes
    pile into the small end of the key space."""
    motif = "ACACACACAC"
    out = []
    for i in range(n):
        kind = i % 3
        if kind == 0:
            s = "A" * (length - 10) + "".join(rng.choice("ACGT") for _ in range(10))
        elif kind == 1:
            s = (motif * (length // len(motif) + 1))[:length]
        else:
            s = "A" * (length // 2) + "".join(
                rng.choice("ACGT") for _ in range(length - length // 2))
        out.append(Read(str(i), s.encode()))
    return out


def feed_port(eng, reads, rho, chunk):
    for codes in flat_code_chunks(reads, rho, chunk=chunk):
        eng.add_chunk_packed(*pack_chunk(codes, rho, chunk))


def jax_sharded(reads, rho, mode, chunk, cap, wide=False):
    if wide:
        eng = JS.ShardedSpectrumEngineWide(jax_mesh(), rho, mode, chunk, cap=cap)
        for codes in jax_chunks(reads, rho, chunk=chunk):
            eng.add_chunk(codes)
    else:
        eng = JS.ShardedSpectrumEngine(jax_mesh(), rho, mode, chunk, cap=cap)
        for codes in jax_chunks(reads, rho, chunk=chunk):
            eng.add_chunk_packed(*jax_pack(codes, rho, chunk))
    return eng.finish_expanded() if mode == "value" else eng.finish()


def assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_mix_owner_is_the_jax_hash_bit_for_bit():
    rng = np.random.default_rng(3)
    keys = np.concatenate([rng.integers(0, 1 << 62, 20000, dtype=np.int64),
                           [0, (1 << 62) - 1, 0xFFFFFFFF, 1 << 32]])
    limbs = [rng.integers(0, 1 << 32, 20000, dtype=np.int64) for _ in range(4)]
    for n in (1, 2, 4, 8):
        want = np.asarray(JS.mix_owner(
            jnp.asarray((keys >> 32).astype(np.uint32)),
            jnp.asarray((keys & 0xFFFFFFFF).astype(np.uint32)), n))
        assert np.array_equal(mix_owner(torch.from_numpy(keys), n).numpy(), want)
        want = np.asarray(JS.mix_owner_wide(
            *(jnp.asarray(x.astype(np.uint32)) for x in limbs), n))
        got = mix_owner_wide(*(torch.from_numpy(x) for x in limbs), n)
        assert np.array_equal(got.numpy(), want)
    assert len(np.unique(want)) == 8  # every shard owns keys


@pytest.mark.parametrize("rho,mode", [(26, "value"), (21, "ref")])
def test_sharded_engine_matches_jax_sharded(rho, mode):
    assert len(jax.devices()) == 8
    reads = make_reads(random.Random(rho), 60, 70)
    eng = ShardedSpectrumEngine(cpu_mesh(8), rho, mode, 256, cap=8 << 12)
    feed_port(eng, reads, rho, 256)
    got = eng.finish_expanded() if mode == "value" else eng.finish()
    want = jax_sharded(reads, rho, mode, 256, 8 << 12)
    assert len(got[0]) > 1000
    assert_same(got, want)


def test_sharded_wide_engine_matches_jax_sharded():
    rho, mode = 33, "value"
    reads = make_reads(random.Random(rho), 40, 2 * rho + 30)
    eng = ShardedSpectrumEngineWide(cpu_mesh(8), rho, mode, 256, cap=8 << 12)
    for codes in flat_code_chunks(reads, rho, chunk=256):
        eng.add_chunk(codes)
    got = eng.finish_expanded()
    want = jax_sharded(reads, rho, mode, 256, 8 << 12, wide=True)
    assert len(got[0]) > 1000 and got[1].any()
    assert_same(got, want)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_engine_on_smaller_meshes(n):
    """Fewer shards: the same spectrum as the single-device JAX count."""
    rho = 25
    reads = make_reads(random.Random(n), 50, 80)
    eng = ShardedSpectrumEngine(cpu_mesh(n), rho, "plain", 512, cap=1 << 14)
    feed_port(eng, reads, rho, 512)
    assert_same(eng.finish(), jax_count(reads, rho, both_strands=False,
                                        canonical=False, chunk=512))


def test_sharded_skewed_input_no_overflow():
    reads = make_skewed_reads(48, 96, random.Random(77))
    rho, chunk = 26, 256
    eng = ShardedSpectrumEngine(cpu_mesh(8), rho, "value", chunk, cap=8 << 12)
    feed_port(eng, reads, rho, chunk)
    assert_same(eng.finish_expanded(), jax_count(
        reads, rho, both_strands=True, canonical=False, chunk=chunk))


def test_sharded_midstream_overflow_raises():
    """A transient per-shard cap overflow raises, even when the final
    flush's live count is back under the cap."""
    rho, chunk = 26, 256
    eng = ShardedSpectrumEngine(cpu_mesh(8), rho, "plain", chunk, cap=8 * 256)
    assert eng.cap_l == 256
    feed_port(eng, make_reads(random.Random(9), 40, 96), rho, chunk)
    for _ in range(8):  # all-N chunks: no new keys in the last flush
        eng.add_chunk_packed(*pack_chunk(
            np.full(chunk + rho - 1, 255, np.uint8), rho, chunk))
    with pytest.raises(RuntimeError, match="cap"):
        eng.finish()


def test_bucket_overflow_raises():
    """Lanes past their destination's bucket are counted and raise: one
    shard's bucket of ``per`` lanes cannot take a chunk whose keys all hash
    to it."""
    rho, chunk = 13, 256
    eng = ShardedSpectrumEngine(cpu_mesh(2), rho, "plain", chunk, cap=1 << 14,
                                slack=1)
    assert eng.per == 128
    # every window the same key: one owner gets all 256 valid lanes
    feed_port(eng, [Read("a", b"A" * 400)], rho, chunk)
    with pytest.raises(RuntimeError, match="bucket overflow"):
        eng.finish()


def test_non_pow2_mesh_rejected():
    with pytest.raises(ValueError, match="power of two"):
        ShardedSpectrumEngine(cpu_mesh(3), 26, "plain", 256, cap=1 << 14)


def test_sharded_multi_batch_fold():
    reads = make_reads(random.Random(5), 200, 80)
    rho, chunk = 26, 128  # many flushes
    eng = ShardedSpectrumEngine(cpu_mesh(8), rho, "plain", chunk, cap=8 << 12)
    feed_port(eng, reads, rho, chunk)
    assert_same(eng.finish(), jax_count(reads, rho, both_strands=False,
                                        canonical=False, chunk=chunk))


def test_count_chunks_routes_n_devices_and_a_mesh():
    """``n_devices > 1`` builds the CPU mesh from ``device``; a mesh given
    is used as it is; both equal the one-device count."""
    rho, chunk = 26, 1024
    reads = make_reads(random.Random(11), 80, 100)
    want = count_rho_mers(reads, rho, chunk=chunk, both_strands=True,
                          canonical=False, device=CPU)
    logs = []
    got = count_rho_mers(reads, rho, chunk=chunk, both_strands=True,
                         canonical=False, device=CPU, n_devices=4,
                         log=lambda lvl, m: logs.append(m))
    assert_same(got, want)
    assert any("Mesh(4 shards" in m for m in logs)
    assert any(m.startswith("count: ") and "spills" in m for m in logs)
    got = count_rho_mers(reads, rho, chunk=chunk, both_strands=True,
                         canonical=False, device=CPU, mesh=cpu_mesh(2))
    assert_same(got, want)


def test_count_chunks_sharded_chunk_checks():
    with pytest.raises(ValueError, match="divisible by 16"):
        count_chunks(iter(()), 26, both_strands=True, canonical=False,
                     device=CPU, chunk=1000, n_devices=2)
    with pytest.raises(ValueError, match="explicit chunk size"):
        count_chunks(iter(()), 40, both_strands=True, canonical=False,
                     device=CPU, chunk=0, n_devices=2)


def test_data_mesh_raises_without_the_cards():
    """No silently smaller mesh: asking for more cards than are visible
    raises and names the number visible."""
    n = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(RuntimeError, match=f"{torch.cuda.device_count()} are visible"):
        M.data_mesh(n, "cuda")
    with pytest.raises(RuntimeError, match="are visible"):
        M.data_mesh(4, torch.device("cuda"))
    mesh = M.data_mesh(4, "cpu")
    assert mesh.devices == (CPU,) * 4 and mesh.size == 4 and not mesh.distributed


def test_mesh_collectives_within_one_process():
    mesh = cpu_mesh(4)
    xs = [torch.arange(8).view(4, 2) + 100 * s for s in range(4)]
    got = M.all_to_all(mesh, xs)
    for d in range(4):
        assert torch.equal(got[d], torch.stack([xs[s][d] for s in range(4)]))
    assert torch.equal(M.all_gather(mesh, [x[0] for x in xs])[2],
                       torch.stack([x[0] for x in xs]))
    assert torch.equal(M.psum(mesh, xs)[1], sum(xs))
    perm = [(i, (i + 1) % 4) for i in range(4)]
    assert torch.equal(M.ppermute(mesh, xs, perm)[0], xs[3])
    assert int(M.pmax(mesh, [x.max() for x in xs])) == 307
    with pytest.raises(ValueError, match="do not tile"):
        M.Mesh((CPU,) * 3, size=4)
