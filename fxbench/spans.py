"""The harness's host spans in a traced run: wrappers around a few public
calls of the program, each recording ``(start, end)`` on the host clock
(``time.perf_counter``) when the call returns a result.  Installed only
with ``--trace 1`` and removed before the run's check."""

from __future__ import annotations

import functools
import threading
import time
from typing import Dict, List, Tuple

__all__ = ["SpanRecorder"]


class SpanRecorder:
    """Spans by name; :meth:`wrap` replaces ``owner.attr`` with a timed
    wrapper until :meth:`restore`."""

    def __init__(self):
        self.spans: Dict[str, List[Tuple[float, float]]] = {}
        self._lock = threading.Lock()
        self._undo = []

    def record(self, name: str, t0: float, t1: float):
        with self._lock:
            self.spans.setdefault(name, []).append((t0, t1))

    def wrap(self, owner, attr: str, name: str, *, skip_none: bool = False):
        """Time every call of ``owner.attr`` (a function of a module or a
        class) as span ``name``; with ``skip_none`` calls that return None
        (a timed-out wait) are not recorded."""
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if not (skip_none and out is None):
                self.record(name, t0, time.perf_counter())
            return out

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn))

    def restore(self):
        while self._undo:
            owner, attr, fn = self._undo.pop()
            setattr(owner, attr, fn)

    def between(self, name: str, t0: float, t1: float
                ) -> List[Tuple[float, float]]:
        """Spans of ``name`` that start inside ``[t0, t1]``."""
        with self._lock:
            return [s for s in self.spans.get(name, ()) if t0 <= s[0] <= t1]
