"""The program's scope ``build-graph/graph`` (``cmds/basic.py``: the
``Graph``'s construction with its counts cast to int64, before
``Graph.write``), mean over the calls."""

from benchmark.metrics._scopes import scope_s
from benchmark.metrics._shared import PORT_PROFILE

PROFILE = PORT_PROFILE


def read(records):
    return scope_s(records, "build-graph/graph")
