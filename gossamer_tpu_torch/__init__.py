"""gossamer_tpu_torch — the PyTorch/CUDA port of ``gossamer_tpu``.

It mirrors the JAX package's module paths; the JAX package stays the
reference the port is held against.  This package imports torch, numpy
and the standard library only: no jax and nothing of ``gossamer_tpu``.
Devices are explicit (``torch.device`` passed down from the CLI's
``--device``), and the Pallas kernels on the ported path are hand-written
CUDA kernels for Hopper under ``csrc/``.
"""

__version__ = "0.1.0"

# Reference format versions we keep output parity with.
GRAPH_VERSION = 2011101014  # src/Graph.hh:65
KMER_SET_VERSION = 2011101701  # src/KmerSet.hh:26
MAX_K = 62  # src/Graph.hh:87-89 (128-bit rho-mers)
