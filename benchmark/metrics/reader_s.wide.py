"""The program's scope ``count/read`` (``ops/count.py`` ``count_chunks``: each
``next()`` of the native reader's chunk iterator, ``native_flat_chunks`` at
a wide k), mean over the calls."""

from benchmark.metrics._scopes import scope_s
from benchmark.metrics._shared import PORT_PROFILE

PROFILE = PORT_PROFILE


def read(records):
    return scope_s(records, "count/read")
