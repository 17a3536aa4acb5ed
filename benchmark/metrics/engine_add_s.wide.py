"""The program's scope ``count/add_chunk`` (``ops/count.py``: each chunk
handed to ``SpectrumEngineWide.add_chunk``, with the flushes it starts),
mean over the calls."""

from benchmark.metrics._scopes import scope_s
from benchmark.metrics._shared import PORT_PROFILE

PROFILE = PORT_PROFILE


def read(records):
    return scope_s(records, "count/add_chunk")
