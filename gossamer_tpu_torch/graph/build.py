"""Builders: read streams -> Graph / KmerSet artifacts
(``gossamer_tpu/graph/build.py``).

Pipeline parity with ``goss build-graph`` (``src/GossCmdBuildGraph.cc:
270-491``) and ``goss build-kmer-set`` (``src/GossCmdBuildKmerSet.tcc:
213-330``) on the port's counting engine (:mod:`gossamer_tpu_torch.ops.
count`).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from ..io.readers import Read
from ..ops.count import count_rho_mers
from .graph import Graph
from .kmer_set import KmerSet


def build_graph(
    reads: Iterable[Read],
    k: int,
    *,
    device: torch.device,
    chunk: int = 1 << 20,
    cap_entries: int | None = None,
    progress=None,
) -> Graph:
    """Count (k+1)-mers of reads and their reverse complements.

    Matches build-graph semantics: every valid rho-mer window is inserted
    along with its reverse complement (``src/ReverseComplementAdapter.hh``),
    giving a symmetric graph.  ``cap_entries`` bounds the device-resident
    distinct-key working set, as for :func:`build_kmer_set`.
    """
    lo, hi, counts = count_rho_mers(
        reads, k + 1, both_strands=True, canonical=False, device=device,
        chunk=chunk, progress=progress, cap_entries=cap_entries,
    )
    return Graph(k, lo, hi, counts, asymmetric=False)


def build_kmer_set(
    reads: Iterable[Read],
    k: int,
    *,
    device: torch.device,
    chunk: int = 1 << 20,
    cap_entries: int | None = None,
    progress=None,
) -> tuple[KmerSet, np.ndarray]:
    """Canonical k-mer set (+ counts, used by spectra consumers).

    Matches build-kmer-set semantics: each window is normalized before
    insertion (``src/GossCmdBuildKmerSet.tcc:248-249``).  ``cap_entries``
    bounds the device-resident distinct-key working set (the reference's
    ``-M`` memory budget); spectra outgrowing it spill to host RAM.
    """
    lo, hi, counts = count_rho_mers(
        reads, k, both_strands=False, canonical=True, device=device,
        chunk=chunk, progress=progress, cap_entries=cap_entries,
    )
    return KmerSet(k, lo, hi), counts
