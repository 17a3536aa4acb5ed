"""Per-layer metrics: one file a metric, ``<metric>.py``, loaded by name.
Each has ``read(records) -> float | None`` over the traced run's records
(``calls``: per call ``wall_s``, ``spans``, ``phases``, ``profile``;
``kernels``: per kernel the (bound, device seconds) of each call;
``device``: ``busy_s``, ``window_s``) and may declare the ``SPANS`` it
needs (a ``kernel`` span carries ``bound``, the least time of one call
from its arguments) and the ``PROFILE`` module whose scopes it reads.  A reader that
finds nothing to read returns None, and the metric is left out."""
