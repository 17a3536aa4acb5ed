"""The program's scope ``merge`` (``ops/engine.py`` ``_merge_all``: the
finish's merges of the spilled runs with the live spectrum, as the host
enqueues them), mean over the calls: a part of ``engine_finish_s.build``."""

from benchmark.metrics._scopes import scope_s
from benchmark.metrics._shared import PORT_PROFILE

PROFILE = PORT_PROFILE


def read(records):
    return scope_s(records, "merge")
