"""The program's scope ``spill`` (``ops/engine.py`` ``_spill_to_host``: the
spectrum's pull to host memory and its varint encode), mean over the
calls: a part of ``engine_add_s.build``."""

from benchmark.metrics._scopes import scope_s
from benchmark.metrics._shared import PORT_PROFILE

PROFILE = PORT_PROFILE


def read(records):
    return scope_s(records, "spill")
