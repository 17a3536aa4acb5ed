"""Portable text round-trip for graphs (dump-graph / restore-graph; host
copy of ``gossamer_tpu/graph/text.py``).

Format parity with ``src/GossCmdDumpGraph.cc:49-61`` /
``src/GossCmdRestoreGraph.cc``::

    #<version>
    <K>\\t<count>\\t<flags>
    <rho-mer sequence>\\t<count>
    ...

flags bit 0 = asymmetric (``Graph::Header::fAsymmetric``).
"""

from __future__ import annotations

import numpy as np

from .. import GRAPH_VERSION
from ..core import kmer as K
from .graph import Graph

F_ASYMMETRIC = 1 << 0


def dump_graph(g: Graph, out) -> None:
    flags = F_ASYMMETRIC if g.asymmetric else 0
    out.write(f"#{GRAPH_VERSION}\n")
    out.write(f"{g.k}\t{g.count}\t{flags}\n")
    if g.count == 0:
        return
    mat = K.kmers_to_strings(g.rho, g.lo, g.hi)
    # rows: "<seq>\t<count>\n" — built vectorized then joined
    counts = g.counts
    lines = []
    # chunked to bound peak memory on big graphs
    step = 1 << 20
    for i in range(0, g.count, step):
        block = mat[i : i + step]
        cs = counts[i : i + step]
        body = [
            block[j].tobytes().decode() + "\t" + str(int(cs[j]))
            for j in range(len(cs))
        ]
        lines.append("\n".join(body))
    out.write("\n".join(lines) + "\n")


def restore_graph(inp) -> Graph:
    header = inp.readline()
    if not header.startswith("#"):
        raise ValueError("restore-graph: missing #version header")
    version = int(header[1:].strip())
    if version != GRAPH_VERSION:
        raise ValueError(
            f"restore-graph: version mismatch (found {version}, "
            f"expected {GRAPH_VERSION})"
        )
    k, count, flags = (int(x) for x in inp.readline().split("\t"))
    rho = k + 1
    seqs = []
    counts = np.empty(count, dtype=np.int64)
    for i in range(count):
        line = inp.readline().rstrip("\n")
        seq, c = line.split("\t")
        seqs.append(seq.encode())
        counts[i] = int(c)
    lo, hi = pack_strings(seqs, rho)
    return Graph(k, lo, hi, counts, asymmetric=bool(flags & F_ASYMMETRIC))


def pack_strings(seqs: list[bytes], k: int) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized ASCII k-mer strings -> (lo, hi) planes."""
    n = len(seqs)
    if n == 0:
        z = np.zeros(0, dtype=np.uint64)
        return z, z.copy()
    mat = np.frombuffer(b"".join(seqs), dtype=np.uint8).reshape(n, k)
    codes = K.ENCODE_LUT[mat]
    if (codes > 3).any():
        raise ValueError("restore-graph: invalid base character")
    lo = np.zeros(n, dtype=np.uint64)
    hi = np.zeros(n, dtype=np.uint64)
    for j in range(k):
        b = codes[:, j].astype(np.uint64)
        hi = (hi << np.uint64(2)) | (lo >> np.uint64(62))
        lo = (lo << np.uint64(2)) | b
    return lo, hi
