"""Logger + progress monitors (reference ``src/Logger.hh``,
``src/ProgressMonitor.hh:52-242``)."""

from __future__ import annotations

import sys
import time


SEVERITIES = ("debug", "info", "warning", "error")


class Logger:
    """Timestamped severity lines to stderr or a log file
    (``src/Logger.hh:31-106``)."""

    def __init__(self, log_file: str | None = None, verbose: bool = False, fac=None):
        self.verbose = verbose
        self._fh = None
        if log_file:
            if fac is not None:
                self._fh = fac.open_write_text(log_file)
            else:
                self._fh = open(log_file, "w")

    def __call__(self, severity: str, msg: str) -> None:
        if severity == "debug" and not self.verbose:
            return
        line = f"{time.strftime('%Y-%m-%d %H:%M:%S')}\t[{severity}]\t{msg}"
        if self._fh is not None:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.verbose or severity in ("warning", "error"):
            print(line, file=sys.stderr)

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class ProgressMonitor:
    """Percentage ticks like ``ProgressMonitorNew`` (``ProgressMonitor.hh``)."""

    def __init__(self, log: Logger, total: int, label: str = "progress"):
        self.log = log
        self.total = max(total, 1)
        self.label = label
        self._last = -1

    def tick(self, n: int) -> None:
        pct = int(100 * n / self.total)
        if pct != self._last:
            self._last = pct
            self.log("debug", f"{self.label}: {pct}%")

    def end(self) -> None:
        self.tick(self.total)


class UnboundedProgressMonitor:
    """Count ticks with no known total (``UnboundedProgressMonitor``,
    ``src/ProgressMonitor.hh:203-242``): logs every ``interval`` units."""

    def __init__(self, log: Logger, interval: int, unit: str = "items",
                 label: str = "progress"):
        self.log = log
        self.interval = max(int(interval), 1)
        self.unit = unit
        self.label = label
        self._next = self.interval

    def tick(self, n: int) -> None:
        if n >= self._next:
            self.log("debug", f"{self.label}: {n:,} {self.unit}")
            while self._next <= n:
                self._next += self.interval


class Timer:
    def __init__(self):
        self.t0 = time.time()

    def check(self) -> float:
        return time.time() - self.t0
