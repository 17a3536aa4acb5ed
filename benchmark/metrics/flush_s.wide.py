"""The program's scope ``wide/flush`` (``ops/engine_wide.py`` ``_flush``:
the host's side of each ``batch_step_wide``, the final flush's too), mean
over the calls."""

from benchmark.metrics._scopes import scope_s
from benchmark.metrics._shared import PORT_PROFILE

PROFILE = PORT_PROFILE


def read(records):
    return scope_s(records, "wide/flush")
