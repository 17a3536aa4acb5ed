"""The program's scopes ``sync`` (``_read_live``, ``_sync``, the live
counts' check) and ``to_host`` (each pull to host memory) in
``ops/engine.py``: the host blocked on the card, mean over the calls."""

from benchmark.metrics._scopes import scope_s
from benchmark.metrics._shared import PORT_PROFILE

PROFILE = PORT_PROFILE


def read(records):
    return scope_s(records, "sync", "to_host")
