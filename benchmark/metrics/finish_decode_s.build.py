"""The program's scope ``decode`` (``ops/engine.py`` ``_finish_runs``: the
spilled runs' varint decode at the finish), mean over the calls: a part
of ``engine_finish_s.build``."""

from benchmark.metrics._scopes import scope_s
from benchmark.metrics._shared import PORT_PROFILE

PROFILE = PORT_PROFILE


def read(records):
    return scope_s(records, "decode")
