"""Throttle — counting budget with blocking backpressure.

Rebuild of the reference's core throttle (ref: src/common/Throttle.{h,cc}
— Throttle::get blocks while the counter would exceed max, get_or_fail
is the non-blocking probe, put releases and wakes waiters in FIFO
order; used to bound messenger dispatch bytes, objecter in-flight ops,
and recovery concurrency).

Thread-safe: the native runtime server (native/server.py) and any
multi-threaded driver can share one instance. Waiters are FIFO — a
large request at the head is not starved by small ones slipping past
(same fairness the reference implements with a cond-var per waiter).
"""

from __future__ import annotations

import threading
import time
from collections import deque


class Throttle:
    def __init__(self, name: str, max_count: int = 0):
        if max_count < 0:
            raise ValueError(f"throttle max {max_count} < 0")
        self.name = name
        self._max = max_count
        self._count = 0
        self._lock = threading.Lock()
        # FIFO of per-waiter events (the reference keeps a cond list)
        self._waiters: deque[tuple[int, threading.Event]] = deque()

    # -- introspection -------------------------------------------------------

    @property
    def max(self) -> int:
        return self._max

    def get_current(self) -> int:
        with self._lock:
            return self._count

    def past_midpoint(self) -> bool:
        with self._lock:
            return self._max > 0 and self._count >= self._max / 2

    # -- acquire / release ---------------------------------------------------

    def _fits_locked(self, c: int) -> bool:
        # max == 0 disables the throttle (reference semantics)
        return self._max == 0 or self._count + c <= self._max

    def get(self, c: int = 1, timeout: float | None = None) -> bool:
        """Take `c`; block while it would exceed max. Returns False only
        on timeout. A request larger than max is allowed through alone
        when the counter drains to 0 (the reference admits oversized
        requests rather than deadlocking)."""
        if c < 0:
            raise ValueError(f"get({c}) < 0")
        ev = None
        with self._lock:
            fits = (self._fits_locked(c)
                    or (c > self._max > 0 and self._count == 0))
            if fits and not self._waiters:
                self._count += c
                return True
            ev = threading.Event()
            self._waiters.append((c, ev))
        # one monotonic deadline for the WHOLE wait: each wakeup that
        # doesn't admit us resumes with the remaining time, so repeated
        # baton-passing can't extend the caller's timeout unboundedly
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while True:
            remaining = None if deadline is None \
                else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                timed_out = True
            else:
                timed_out = not ev.wait(remaining)
            if timed_out:
                with self._lock:
                    try:
                        self._waiters.remove((c, ev))
                    except ValueError:
                        pass  # woken concurrently; fall through and take
                    else:
                        # a departing head must pass the baton or the
                        # next waiter strands despite fitting
                        self._wake_locked()
                        return False
            with self._lock:
                if self._waiters and self._waiters[0][1] is not ev:
                    ev.clear()
                    continue
                if (self._fits_locked(c)
                        or (c > self._max > 0 and self._count == 0)):
                    self._count += c
                    if self._waiters and self._waiters[0][1] is ev:
                        self._waiters.popleft()
                    self._wake_locked()
                    return True
                ev.clear()

    def get_or_fail(self, c: int = 1) -> bool:
        """Non-blocking probe (Throttle::get_or_fail)."""
        if c < 0:
            raise ValueError(f"get_or_fail({c}) < 0")
        with self._lock:
            if self._waiters or not self._fits_locked(c):
                return False
            self._count += c
            return True

    def put(self, c: int = 1) -> int:
        """Release `c`; wakes the FIFO head if it now fits. Returns the
        new count."""
        if c < 0:
            raise ValueError(f"put({c}) < 0")
        with self._lock:
            if c > self._count:
                raise ValueError(
                    f"throttle {self.name}: put({c}) > held {self._count}")
            self._count -= c
            self._wake_locked()
            return self._count

    def reset_max(self, new_max: int) -> None:
        with self._lock:
            self._max = new_max
            self._wake_locked()

    def _wake_locked(self) -> None:
        if self._waiters:
            c, ev = self._waiters[0]
            if (self._fits_locked(c)
                    or (c > self._max > 0 and self._count == 0)):
                ev.set()
