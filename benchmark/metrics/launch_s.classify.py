"""The program's profile scopes ``classify/pack`` + ``classify/launch``
(batching, packing, the enqueue of the join), mean over the calls."""

from benchmark.metrics._shared import PORT_PROFILE, summed_s

PROFILE = PORT_PROFILE


def read(records):
    return summed_s(records, "profile", ("classify/pack", "classify/launch"))
