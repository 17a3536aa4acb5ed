"""The program's scope ``graph/write/hist`` (``graph/graph.py``
``Graph.write``: ``hist()`` and the histogram sidecar's write), mean over
the calls: a part of ``graph_write_s.build``."""

from benchmark.metrics._scopes import scope_s
from benchmark.metrics._shared import PORT_PROFILE

PROFILE = PORT_PROFILE


def read(records):
    return scope_s(records, "graph/write/hist")
