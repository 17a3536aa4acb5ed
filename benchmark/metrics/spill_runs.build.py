"""The program's counter ``#spill_runs`` (``ops/engine.py``
``_spill_to_host``: one a run of the spectrum pulled to host memory), mean
over the calls; 0 where the program counts its finish's lanes
(``#finish_lanes``) and no call spilled.  A program without the counters
gives None."""

from benchmark.metrics._scopes import counter
from benchmark.metrics._shared import PORT_PROFILE

PROFILE = PORT_PROFILE


def read(records):
    runs = counter(records, "spill_runs")
    if runs is None and counter(records, "finish_lanes") is not None:
        return 0.0
    return runs
