"""The share of the finish's lanes (``ops/engine.py`` ``_finish_runs``:
the spilled runs' and the live spectrum's, weighed against the cap) that
were finished on the card, 100 x ``#finish_lanes_card`` /
``#finish_lanes``, in %, over the calls: 100 where the finish ran on the
card, 0 where it ran on the host.  A program without the counters gives
None."""

from benchmark.metrics._scopes import counter
from benchmark.metrics._shared import PORT_PROFILE

PROFILE = PORT_PROFILE


def read(records):
    card = counter(records, "finish_lanes_card")
    total = counter(records, "finish_lanes")
    if card is None or not total:
        return None
    return 100.0 * card / total
