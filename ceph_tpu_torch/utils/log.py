"""Structured logging with per-subsystem gates and a crash ring.

Rebuild of the reference's logging core (ref: src/log/Log.cc — a
dedicated writer keeps an in-memory ring of MORE entries than are
written out, dumped on crash; gating ref: src/common/dout.h `dout(N)`
macros against per-subsystem levels from src/common/subsys.h).

Two levels per subsystem, like the reference: `log_level` (what goes to
the sink) and `gather_level` (what is kept in the ring for dump_recent
— typically higher, so a crash report contains debug detail that was
never printed).
"""

from __future__ import annotations

import collections
import sys
import threading
import time
from dataclasses import dataclass

# subsystem table (role of src/common/subsys.h): name -> (log, gather)
SUBSYS: dict[str, tuple[int, int]] = {
    "": (1, 5),          # default
    "ec": (1, 5),
    "crush": (1, 5),
    "osd": (1, 5),
    "recovery": (1, 5),
    "csum": (1, 5),
    "mon": (1, 5),
    "bench": (1, 5),
    "msgr": (0, 5),
    "mgr": (1, 5),
    # chaos events gather into the ring (reconstructable over `log
    # dump` on the admin socket) without printing: the Thrasher keeps
    # its own verbose switch for stdout
    "chaos": (0, 5),
}


@dataclass
class Entry:
    stamp: float
    subsys: str
    level: int
    message: str

    def format(self) -> str:
        t = time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(self.stamp))
        frac = int((self.stamp % 1) * 1e6)
        return f"{t}.{frac:06d} {self.subsys or 'none'} {self.level} {self.message}"


class Log:
    def __init__(self, max_recent: int = 1000, sink=None):
        self._ring: collections.deque[Entry] = collections.deque(
            maxlen=max_recent)
        self._lock = threading.Lock()
        self._sink = sink if sink is not None else sys.stderr
        self.levels = dict(SUBSYS)

    def set_level(self, subsys: str, log: int, gather: int | None = None):
        cur = self.levels.get(subsys, self.levels[""])
        self.levels[subsys] = (log, gather if gather is not None
                               else max(log, cur[1]))

    def should_gather(self, subsys: str, level: int) -> bool:
        log_lv, gather_lv = self.levels.get(subsys, self.levels[""])
        return level <= max(log_lv, gather_lv)

    def dout(self, subsys: str, level: int, message: str) -> None:
        """The dout(N) path: cheap when gated off."""
        log_lv, gather_lv = self.levels.get(subsys, self.levels[""])
        if level > log_lv and level > gather_lv:
            return
        e = Entry(time.time(), subsys, level, message)
        with self._lock:
            if level <= gather_lv:
                self._ring.append(e)
            if level <= log_lv and self._sink is not None:
                print(e.format(), file=self._sink)

    def error(self, subsys: str, message: str) -> None:
        self.dout(subsys, -1, message)

    def dump_recent(self, file=None) -> list[str]:
        """Crash-dump the gathered ring (most recent last) — the
        'dump_recent' behavior the reference triggers from its crash
        handler."""
        with self._lock:
            lines = [e.format() for e in self._ring]
        if file is not None:
            print("--- begin dump of recent events ---", file=file)
            for ln in lines:
                print(ln, file=file)
            print("--- end dump of recent events ---", file=file)
        return lines


g_log = Log()


def dout(subsys: str, level: int, message: str) -> None:
    g_log.dout(subsys, level, message)
