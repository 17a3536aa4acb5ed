"""The share of the classify join's query lanes that carry a valid window:
100 x the program's ``#join_windows`` / ``#join_lanes``
(``classify/device.py`` ``classify_codes_device``: each batch's lanes,
padding and separators included, and the windows among them whose k codes
are all bases), over the calls.  A program without the counters gives None."""

from benchmark.metrics._scopes import counter
from benchmark.metrics._shared import PORT_PROFILE

PROFILE = PORT_PROFILE


def read(records):
    windows = counter(records, "join_windows")
    lanes = counter(records, "join_lanes")
    if windows is None or not lanes:
        return None
    return 100.0 * windows / lanes
