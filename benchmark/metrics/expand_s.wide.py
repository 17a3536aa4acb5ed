"""The program's scope ``expand`` (``SpectrumEngineWide.finish_expanded``: the
symmetric expansion, ``expand_step_wide`` on the card, and the reads of
its ``live``), mean over the calls: a part of ``engine_finish_s.wide``."""

from benchmark.metrics._scopes import scope_s
from benchmark.metrics._shared import PORT_PROFILE

PROFILE = PORT_PROFILE


def read(records):
    return scope_s(records, "expand")
