"""The program's scope ``xenome/index_load`` (``cli/xenome.py``: the
index's read from disk, ``AnnotatedKmerSet.read``), mean over the calls: a
part of ``parse_write_s.classify``."""

from benchmark.metrics._scopes import scope_s
from benchmark.metrics._shared import PORT_PROFILE

PROFILE = PORT_PROFILE


def read(records):
    return scope_s(records, "xenome/index_load")
