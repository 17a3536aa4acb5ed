"""Worker of the two-process test of the port (``tests/test_torch_distributed.py``).

Each process joins a ``gloo`` group through
``gossamer_tpu_torch.parallel.distributed``, holds 2 CPU shards of a
4-shard mesh, streams its round-robin share of 9 seeded chunks (5 and 4:
unequal on purpose) into the sharded engines, and runs the sharded
degrees, trim mask, prune-tips walk, segment table and both classifiers
over the mesh; it writes what it got for the parent to compare.

    python tests/torch_dist_worker.py PROCESS_ID N_PROCESSES PORT OUT_DIR
"""

import os
import sys


def main():
    pid, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np

    from gossamer_tpu_torch.classify.device import encode_set
    from gossamer_tpu_torch.core import kmer as K
    from gossamer_tpu_torch.io.stream import pack_chunk
    from gossamer_tpu_torch.parallel import distributed
    from gossamer_tpu_torch.parallel.classify_sharded import (
        RingClassifier, ShardedClassifier)
    from gossamer_tpu_torch.parallel.cleanup_sharded import (sharded_degrees,
                                                             sharded_trim_mask)
    from gossamer_tpu_torch.parallel.count_sharded import (
        ShardedSpectrumEngine, ShardedSpectrumEngineWide)
    from gossamer_tpu_torch.parallel.walk_sharded import (
        sharded_prune_tips_masks, sharded_segment_table)

    distributed.initialize(coordinator=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid, device="cpu")
    mesh = distributed.global_mesh("cpu", n_local=2)
    assert mesh.size == 2 * nproc and mesh.offset == 2 * pid

    rho, chunk = 13, 256
    rng = np.random.default_rng(77)
    chunks = [rng.integers(0, 4, chunk + rho - 1, dtype=np.uint8)
              for _ in range(9)]
    mine = distributed.partition_files(chunks, pid, nproc)
    eng = ShardedSpectrumEngine(mesh, rho, "value", chunk, cap=1 << 14)
    for c in mine:
        eng.add_chunk_packed(*pack_chunk(c, rho, chunk))
    lo, _hi, cnt = eng.finish_expanded()

    wrho = 33
    wide = ShardedSpectrumEngineWide(mesh, wrho, "plain", chunk, cap=1 << 14)
    for c in mine:
        wide.add_chunk(np.concatenate([c, c[: wrho - rho]]))
    wlo, whi, wcnt = wide.finish()

    out_d, in_d = sharded_degrees(mesh, lo, rho)
    keep, kept = sharded_trim_mask(mesh, cnt, 2)
    dead = sharded_prune_tips_masks(mesh, lo, cnt, rho, iterations=2)
    head, pos, _end, _len, cyclic = sharded_segment_table(mesh, lo, rho)

    k = rho - 1
    nodes = np.unique(lo >> np.uint64(2))
    nlo, _nhi, _ = K.normalize(nodes, np.zeros_like(nodes), k)
    uniq = np.unique(nlo)
    set_E = np.sort(encode_set(uniq, np.arange(len(uniq)) % 2 == 0,
                               np.arange(len(uniq)) % 3 == 0))
    rng2 = np.random.default_rng(5)
    reads = [chunks[i % 9][s : s + 40] for i, s in
             enumerate(rng2.integers(0, chunk - 40, 23))]
    blrg = ShardedClassifier(mesh, set_E, k, window=1 << 12).classify_codes(reads)
    ring = RingClassifier(mesh, set_E, k, window=1 << 9).classify_codes(reads)

    np.savez(os.path.join(outdir, f"out_{pid}.npz"), lo=lo, cnt=cnt, wlo=wlo,
             whi=whi, wcnt=wcnt, out_d=out_d, in_d=in_d, keep=keep,
             kept=kept, dead=dead,
             head=head, pos=pos, cyclic=cyclic, blrg=blrg, ring=ring)
    print(f"process {pid}: {len(lo)} keys", flush=True)


if __name__ == "__main__":
    main()
