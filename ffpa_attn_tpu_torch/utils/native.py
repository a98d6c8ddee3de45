"""The tuned-config store's file lock.

The counterpart of the JAX package's ``utils/native.py``, with the same
``LockedStore`` API, on its ``fcntl`` path alone: an exclusive flock on
``<path>.lock``, the lock the JAX package's store takes on both of its
paths, so writers of the two packages exclude each other.
"""

from __future__ import annotations

import fcntl
import os
import tempfile
import time
from typing import Optional


class LockedStore:
    """File-locked atomic read / write of one file.

    ``with LockedStore(path) as store:`` holds the exclusive lock on
    ``<path>.lock`` (``TimeoutError`` after ``timeout_ms``); ``read_text``
    returns the file (None if missing) and ``write_text_atomic`` replaces it
    through a temporary file and a rename."""

    def __init__(self, path: os.PathLike | str, timeout_ms: int = 10_000):
        self.path = str(path)
        self.timeout_ms = timeout_ms
        self._fd: Optional[int] = None

    def __enter__(self) -> "LockedStore":
        fd = os.open(self.path + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
        deadline = time.monotonic() + self.timeout_ms / 1000.0
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() >= deadline:
                    os.close(fd)
                    raise TimeoutError(f"could not lock {self.path}") from None
                time.sleep(0.005)
        self._fd = fd
        return self

    def __exit__(self, *exc) -> None:
        if self._fd is None:
            return
        fcntl.flock(self._fd, fcntl.LOCK_UN)
        os.close(self._fd)
        self._fd = None

    def read_text(self) -> Optional[str]:
        try:
            with open(self.path) as f:
                return f.read()
        except FileNotFoundError:
            return None

    def write_text_atomic(self, data: str) -> None:
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self.path) or ".")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


__all__ = ["LockedStore"]
