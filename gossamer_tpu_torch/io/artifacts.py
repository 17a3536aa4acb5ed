"""Named multi-file artifacts with versioned headers.

Keeps the reference's persistence contract — every structure is a named
on-disk object of several files behind a basename, with a version-checked
header (``src/Graph.hh:65-83``, ``src/KmerSet.hh:26-58``; version-mismatch
diagnostics at ``src/App.cc:342-348``) — but with TPU-friendly payloads:
JSON headers and ``.npy`` arrays instead of succinct bit files.
"""

from __future__ import annotations

import io
import json

import numpy as np

from ..utils import profile
from .factory import FileFactory


class VersionMismatch(Exception):
    def __init__(self, name: str, found, expected):
        super().__init__(
            f"{name}: version mismatch (found {found}, expected {expected}); "
            f"re-build the artifact with this version of the tools"
        )
        self.found = found
        self.expected = expected


def write_header(fac: FileFactory, basename: str, header: dict) -> None:
    fac.write_text(basename + ".header", json.dumps(header, sort_keys=True))


def read_header(fac: FileFactory, basename: str, expected_version: int | None) -> dict:
    h = json.loads(fac.read_text(basename + ".header"))
    if expected_version is not None and h.get("version") != expected_version:
        raise VersionMismatch(basename, h.get("version"), expected_version)
    return h


def write_array(fac: FileFactory, name: str, arr: np.ndarray) -> None:
    """``np.save``'s bytes, streamed into the file: numpy's format writer
    hands a real file the array's own buffer (``tofile``) and writes any
    other stream (gzip, memory, stdout) in 16 MiB chunks, so nothing stages
    a copy of the whole array.  Counts the array's bytes, the header aside
    (``#write_bytes``)."""
    arr = np.ascontiguousarray(arr)
    with fac.open_write(name) as f:
        np.lib.format.write_array(f, arr, allow_pickle=False)
    profile.count("write_bytes", arr.nbytes)


def read_array(fac: FileFactory, name: str) -> np.ndarray:
    with fac.open_read(name) as f:
        data = f.read()
    return np.load(io.BytesIO(data), allow_pickle=False)
