"""The classify call's wall less its four profile scopes (encode, pack,
launch, wait): the Python reader, the index load and the class files'
writer, mean over the calls."""

from benchmark.metrics._shared import PORT_PROFILE, mean_over_calls

PROFILE = PORT_PROFILE
SCOPES = ("classify/encode", "classify/pack", "classify/launch", "classify/wait")


def read(records):
    return mean_over_calls(
        records, lambda c: c["wall_s"] - sum(c["profile"][s] for s in SCOPES))
