"""The share of the program's ``#d2h_bytes`` (every pull of the engine to
host memory: the spills' and the finish's) that landed in page-locked
memory, ``#d2h_pinned_bytes``, in %, over the calls.  A program without
the counter gives None."""

from benchmark.metrics._scopes import counter
from benchmark.metrics._shared import PORT_PROFILE

PROFILE = PORT_PROFILE


def read(records):
    pinned = counter(records, "d2h_pinned_bytes")
    total = counter(records, "d2h_bytes")
    if pinned is None or not total:
        return None
    return 100.0 * pinned / total
