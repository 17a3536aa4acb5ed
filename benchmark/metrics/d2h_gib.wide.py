"""The program's counter ``#d2h_bytes`` (every pull of the wide engine to
host memory: the expanded spectrum's three planes, a spill's), in GiB, mean
over the calls."""

from benchmark.metrics._scopes import counter
from benchmark.metrics._shared import PORT_PROFILE

PROFILE = PORT_PROFILE


def read(records):
    n = counter(records, "d2h_bytes")
    return None if n is None else n / 2**30
