"""The program's scope ``classify/mates`` (``classify/xenome.py``
``classify_pair_batches``: the OR of each pair's mates' blrg, one scope a
batch of 4096 pairs), mean over the calls.  A program without the scope
gives None."""

from benchmark.metrics._scopes import scope_s
from benchmark.metrics._shared import PORT_PROFILE

PROFILE = PORT_PROFILE


def read(records):
    return scope_s(records, "classify/mates")
