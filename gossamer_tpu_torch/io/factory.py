"""Virtual filesystem layer.

TPU-native analog of the reference's ``FileFactory`` hierarchy
(``src/FileFactory.hh:80-160``): every command does its IO through a
factory so tests can run hermetically against an in-memory implementation
(reference: ``src/StringFileFactory.hh`` — the pattern behind all of the
reference's command-level tests, SURVEY.md §4).

Gzip (`.gz`) transparently decompresses on read and compresses on write.
"""

from __future__ import annotations

import gzip
import io
import os
import sys
import tempfile
from typing import Iterator


class FileFactory:
    """Abstract factory for named byte streams."""

    def open_read(self, name: str):  # -> binary file-like
        raise NotImplementedError

    def open_write(self, name: str):  # -> binary file-like
        raise NotImplementedError

    def exists(self, name: str) -> bool:
        raise NotImplementedError

    def size(self, name: str) -> int:
        raise NotImplementedError

    def remove(self, name: str) -> None:
        raise NotImplementedError

    def tmp_name(self, prefix: str = "goss-tmp") -> str:
        raise NotImplementedError

    # -- text conveniences -------------------------------------------------
    def read_text(self, name: str) -> str:
        with self.open_read(name) as f:
            return f.read().decode()

    def write_text(self, name: str, text: str) -> None:
        with self.open_write(name) as f:
            f.write(text.encode())

    def open_read_text(self, name: str):
        return io.TextIOWrapper(self.open_read(name))

    def open_write_text(self, name: str):
        return io.TextIOWrapper(self.open_write(name), write_through=True)


def _maybe_gzip_read(name: str, raw):
    if name.endswith(".gz"):
        return gzip.open(raw, "rb")
    return raw


def _maybe_gzip_write(name: str, raw):
    if name.endswith(".gz"):
        return gzip.open(raw, "wb")
    return raw


class PhysicalFileFactory(FileFactory):
    """Real-filesystem factory (reference ``src/PhysicalFileFactory.cc``).

    ``"-"`` designates stdin/stdout as in the reference CLI.
    """

    def __init__(self, tmp_dir: str | None = None):
        self.tmp_dir = tmp_dir or tempfile.gettempdir()
        self._tmp_count = 0

    def open_read(self, name: str):
        if name == "-":
            return sys.stdin.buffer
        return _maybe_gzip_read(name, open(name, "rb"))

    def open_write(self, name: str):
        if name == "-":
            return _StdoutShield()
        d = os.path.dirname(name)
        if d:
            os.makedirs(d, exist_ok=True)
        return _maybe_gzip_write(name, open(name, "wb"))

    def exists(self, name: str) -> bool:
        return os.path.exists(name)

    def size(self, name: str) -> int:
        return os.path.getsize(name)

    def remove(self, name: str) -> None:
        if os.path.exists(name):
            os.remove(name)

    def tmp_name(self, prefix: str = "goss-tmp") -> str:
        self._tmp_count += 1
        return os.path.join(
            self.tmp_dir, f"{prefix}-{os.getpid()}-{self._tmp_count}"
        )


class _StdoutShield(io.RawIOBase):
    """Binary writer onto stdout that must not close the real stream."""

    def writable(self):
        return True

    def write(self, b):
        return sys.stdout.buffer.write(b)

    def flush(self):
        sys.stdout.buffer.flush()

    def close(self):
        self.flush()
        super().close()


class StringFileFactory(FileFactory):
    """In-memory factory for hermetic tests (``src/StringFileFactory.hh``)."""

    def __init__(self):
        self.files: dict[str, bytes] = {}
        self._tmp_count = 0

    def add_file(self, name: str, content: bytes | str) -> None:
        if isinstance(content, str):
            content = content.encode()
        self.files[name] = content

    def read_file(self, name: str) -> bytes:
        return self.files[name]

    def open_read(self, name: str):
        if name not in self.files:
            raise FileNotFoundError(name)
        return _maybe_gzip_read(name, io.BytesIO(self.files[name]))

    def open_write(self, name: str):
        factory = self

        class _Buf(io.BytesIO):
            def close(inner) -> None:  # noqa: N805
                factory.files[name] = inner.getvalue()
                io.BytesIO.close(inner)

        raw = _Buf()
        return _maybe_gzip_write(name, raw)

    def exists(self, name: str) -> bool:
        return name in self.files

    def size(self, name: str) -> int:
        return len(self.files[name])

    def remove(self, name: str) -> None:
        self.files.pop(name, None)

    def tmp_name(self, prefix: str = "goss-tmp") -> str:
        self._tmp_count += 1
        return f"{prefix}-{self._tmp_count}"

    def names(self) -> Iterator[str]:
        return iter(sorted(self.files))
