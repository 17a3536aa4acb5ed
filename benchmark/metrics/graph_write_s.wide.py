"""The program's scope ``graph/write`` (``graph/graph.py`` ``Graph.write``: the
three arrays, both key planes and the counts, and the histogram), mean
over the calls."""

from benchmark.metrics._scopes import scope_s
from benchmark.metrics._shared import PORT_PROFILE

PROFILE = PORT_PROFILE


def read(records):
    return scope_s(records, "graph/write")
