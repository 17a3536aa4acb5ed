"""The share of the calls' time in which no operation ran on the device:
1 - (union of the device ops' intervals) / (the calls' length), from the
profiler's trace."""

from benchmark.metrics._shared import idle_pct


def read(records):
    return idle_pct(records)
