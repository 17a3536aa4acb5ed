"""The program's scope ``xenome/write`` (``cli/xenome.py``: the
``print_read`` of each read into its class file, one scope a batch of
4096 reads), mean over the calls: a part of ``parse_write_s.classify``."""

from benchmark.metrics._scopes import scope_s
from benchmark.metrics._shared import PORT_PROFILE

PROFILE = PORT_PROFILE


def read(records):
    return scope_s(records, "xenome/write")
