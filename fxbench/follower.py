"""Follows the product CSV as the program's writer appends and flushes it,
and stamps each row with the host clock when its last byte is readable:
the file users read, with no hook in the program."""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional, Tuple

__all__ = ["RowFollower"]


class RowFollower:
    """A thread that reads ``path`` as it grows (waiting for it to exist),
    skips ``header_lines`` lines, and records each later line's byte span
    and the ``time.perf_counter()`` at which its newline was first read.
    It keeps offsets only, never the text, so following costs one read and
    one scan of the new bytes every ``poll`` seconds."""

    def __init__(self, path: str, header_lines: int, poll: float = 0.002):
        self.path = path
        self.header_lines = header_lines
        self.poll = poll
        #: (start byte, end byte, time) of each data line, in file order
        self.rows: List[Tuple[int, int, float]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def start(self) -> "RowFollower":
        self._thread = threading.Thread(target=self._guarded, daemon=True,
                                        name="fxbench-follower")
        self._thread.start()
        return self

    def stop(self):
        """Read what is already there, then stop."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            if self._thread.is_alive():
                raise RuntimeError("the CSV follower did not stop")
        if self._error is not None:
            raise RuntimeError("the CSV follower failed") from self._error

    def wait_rows(self, n: int, timeout: float) -> Optional[float]:
        """The time at which data line ``n`` (1-based) appeared, waiting up
        to ``timeout`` seconds; None when it did not come."""
        deadline = time.perf_counter() + timeout
        while True:
            with self._lock:
                if len(self.rows) >= n:
                    return self.rows[n - 1][2]
            if self._error is not None or time.perf_counter() > deadline:
                return None
            time.sleep(self.poll)

    def _guarded(self):
        try:
            self._run()
        except BaseException as exc:  # reported by stop()
            self._error = exc

    def _run(self):
        while not os.path.exists(self.path):
            if self._stop.is_set():
                return
            time.sleep(self.poll)
        fd = os.open(self.path, os.O_RDONLY)
        try:
            pos = line_start = 0
            lines = 0
            final = False
            while True:
                chunk = os.read(fd, 1 << 22)
                now = time.perf_counter()
                if chunk:
                    i = chunk.find(b"\n")
                    found = []
                    while i >= 0:
                        end = pos + i + 1
                        if lines >= self.header_lines:
                            found.append((line_start, end, now))
                        lines += 1
                        line_start = end
                        i = chunk.find(b"\n", i + 1)
                    pos += len(chunk)
                    if found:
                        with self._lock:
                            self.rows.extend(found)
                    continue
                if final:
                    return
                if self._stop.is_set():
                    final = True   # one more read after the stop
                    continue
                time.sleep(self.poll)
        finally:
            os.close(fd)
