"""The engine's finish: phases ``flush_tail`` + ``pull`` + ``expand`` of the
count's log line (the last flush, the merges of spilled runs, the
expansion and the copy to the host), mean over the calls."""

from benchmark.metrics._shared import summed_s


def read(records):
    return summed_s(records, "phases", ("flush_tail", "pull", "expand"))
