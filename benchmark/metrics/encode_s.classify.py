"""The program's profile scope ``classify/encode`` (ASCII to codes), mean
over the calls."""

from benchmark.metrics._shared import PORT_PROFILE, summed_s

PROFILE = PORT_PROFILE


def read(records):
    return summed_s(records, "profile", ("classify/encode",))
