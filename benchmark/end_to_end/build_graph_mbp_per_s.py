"""Read bases (Mbp) of every build-graph call in the window over the sum
of the calls' walls."""

from benchmark.end_to_end._shared import per_second


def read(window):
    return per_second(window, "read_mbp")
