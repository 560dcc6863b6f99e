"""OpTracker — per-operation stage timing and historic-op dumps.

Rebuild of the reference's op tracking (ref: src/common/TrackedOp.{h,cc}
— TrackedOp::mark_event stage marks, OpTracker in-flight registry,
`dump_historic_ops` / `dump_ops_in_flight` admin-socket commands, slow
op warnings past osd_op_complaint_time).

Thresholds come from the config system when a Config is provided
(osd_op_complaint_time / osd_op_history_size /
osd_op_history_duration): a committed `ceph config set
osd_op_complaint_time 5` retunes a RUNNING daemon's slow-op detector
on the next call, no restart — the md_config_obs_t behavior the
reference gets from its config observers. Constructor keywords remain
the fallback for config-less users (tests, the sim tier default).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time


class TrackedOp:
    def __init__(self, tracker: "OpTracker", op_id: int, desc: str):
        self._tracker = tracker
        self.id = op_id
        self.desc = desc
        self.t_start = time.perf_counter()
        self.events: list[tuple[float, str]] = [(0.0, "initiated")]
        self.done = False

    def mark_event(self, name: str) -> None:
        self.events.append((time.perf_counter() - self.t_start, name))

    def finish(self) -> None:
        if not self.done:
            self.mark_event("done")
            self.done = True
            self.t_end_wall = time.time()
            self._tracker._retire(self)

    @property
    def duration(self) -> float:
        if self.done:
            return self.events[-1][0]
        return time.perf_counter() - self.t_start

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *rest):
        if exc_type is not None:
            self.mark_event(f"failed: {exc_type.__name__}")
        self.finish()
        return False

    def dump(self) -> dict:
        return {
            "id": self.id,
            "description": self.desc,
            "duration": round(self.duration, 6),
            "type_data": {"events": [
                {"time": round(t, 6), "event": name}
                for t, name in self.events]},
        }


class OpTracker:
    def __init__(self, history_size: int = 20, history_duration: float = 600.0,
                 complaint_time: float = 30.0, config=None):
        self._ids = itertools.count(1)
        self._in_flight: dict[int, TrackedOp] = {}
        # unbounded deque, trimmed against the LIVE history_size: a
        # maxlen frozen at construction could not follow a runtime
        # `config set osd_op_history_size`
        self._history: collections.deque[TrackedOp] = collections.deque()
        self._slowest: list[TrackedOp] = []
        self._config = config
        self._history_size = history_size
        self._history_duration = history_duration
        self._complaint_time = complaint_time
        self._lock = threading.Lock()

    # -- config-resolved thresholds (live values, not boot snapshots) --------

    def _opt(self, name: str, fallback):
        if self._config is not None:
            try:
                return self._config.get(name)
            except KeyError:
                pass
        return fallback

    @property
    def history_size(self) -> int:
        return int(self._opt("osd_op_history_size", self._history_size))

    @property
    def history_duration(self) -> float:
        return float(self._opt("osd_op_history_duration",
                               self._history_duration))

    @property
    def complaint_time(self) -> float:
        return float(self._opt("osd_op_complaint_time",
                               self._complaint_time))

    def create_op(self, desc: str) -> TrackedOp:
        op = TrackedOp(self, next(self._ids), desc)
        with self._lock:
            self._in_flight[op.id] = op
        return op

    def _retire(self, op: TrackedOp) -> None:
        size = self.history_size
        with self._lock:
            self._in_flight.pop(op.id, None)
            self._history.append(op)
            while len(self._history) > size:
                self._history.popleft()
            self._slowest.append(op)
            self._slowest.sort(key=lambda o: -o.duration)
            del self._slowest[size:]

    def _prune_expired(self) -> None:
        """Drop completed ops older than history_duration (the
        reference's osd_op_history_duration expiry). Call with lock."""
        cutoff = time.time() - self.history_duration
        size = self.history_size
        while self._history and self._history[0].t_end_wall < cutoff:
            self._history.popleft()
        self._slowest = [o for o in self._slowest
                         if o.t_end_wall >= cutoff][:size]

    def dump_ops_in_flight(self) -> dict:
        with self._lock:
            ops = [op.dump() for op in self._in_flight.values()]
        return {"num_ops": len(ops), "ops": ops}

    def dump_historic_ops(self, by_duration: bool = False) -> dict:
        size = self.history_size
        with self._lock:
            self._prune_expired()
            src = self._slowest[:size] if by_duration \
                else list(self._history)[-size:]
            ops = [op.dump() for op in src]
        return {"num_ops": len(ops), "ops": ops}

    def recent_durations(self, limit: int | None = None) -> list[float]:
        """Completion times of the most recent retired ops (newest
        last). The cheap slice hedged-read delay tuning reads: the
        client derives its auto hedge delay from a percentile of this
        history instead of a fixed guess (see Client._hedge_delay_s)."""
        with self._lock:
            src = list(self._history)
        if limit is not None:
            src = src[-limit:]
        return [op.duration for op in src]

    def slow_ops(self) -> list[dict]:
        """In-flight ops past the complaint threshold (the
        'slow request' warning source)."""
        now = time.perf_counter()
        threshold = self.complaint_time
        with self._lock:
            return [op.dump() for op in self._in_flight.values()
                    if now - op.t_start > threshold]
