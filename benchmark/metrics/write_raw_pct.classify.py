"""The share of the records ``xenome classify`` wrote into its class files
as the input's own bytes, ``#write_raw``, of all it wrote, ``#write_raw`` +
``#write_formatted`` (each record formatted one at a time), in %, over the
calls.  A program without the counters gives None."""

from benchmark.metrics._scopes import counter
from benchmark.metrics._shared import PORT_PROFILE

PROFILE = PORT_PROFILE


def read(records):
    raw = counter(records, "write_raw")
    formatted = counter(records, "write_formatted")
    if raw is None or formatted is None or not raw + formatted:
        return None
    return 100.0 * raw / (raw + formatted)
