"""The program's scope ``count/finish`` (``SpectrumEngineWide.finish_expanded``:
the final flush, the expansion and the copy to the host), mean over the
calls."""

from benchmark.metrics._scopes import scope_s
from benchmark.metrics._shared import PORT_PROFILE

PROFILE = PORT_PROFILE


def read(records):
    return scope_s(records, "count/finish")
