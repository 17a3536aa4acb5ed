"""The program's scope ``classify/read`` (``classify/xenome.py``
``_read_batches``: the FASTQ parse, one scope a batch of 4096 reads), mean
over the calls: a part of ``parse_write_s.classify``."""

from benchmark.metrics._scopes import scope_s
from benchmark.metrics._shared import PORT_PROFILE

PROFILE = PORT_PROFILE


def read(records):
    return scope_s(records, "classify/read")
