"""The program's profile scope ``classify/wait``: the host's wait on the
card for the batches' results, mean over the calls."""

from benchmark.metrics._shared import PORT_PROFILE, summed_s

PROFILE = PORT_PROFILE


def read(records):
    return summed_s(records, "profile", ("classify/wait",))
