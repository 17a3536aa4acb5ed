"""The median wall of one whole CLI call over the traced window, beside the
cell's rate (all the work over all the time) as a steadier statistic."""

from benchmark.metrics._shared import median_wall_s


def read(records):
    return median_wall_s(records)
