"""End-to-end metrics: one file a metric, ``<metric>.py``, loaded by name.
Each has ``read(window) -> float | None`` over the window's records
(``calls``: per sound call ``wall_s`` and ``work``, the entry's named
quantities of one call; ``setup_s``; ``peak_bytes``, the device's peak
allocation over the window).  Every cell that the metric applies to in
``BENCHMARK.json`` reports it."""
