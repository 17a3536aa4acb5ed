"""The program's scope ``classify/index`` (``classify/xenome.py``
``_classifier``: the index encoded as E on the host and copied to the
card), mean over the calls: a part of ``parse_write_s.classify``."""

from benchmark.metrics._scopes import scope_s
from benchmark.metrics._shared import PORT_PROFILE

PROFILE = PORT_PROFILE


def read(records):
    return scope_s(records, "classify/index")
