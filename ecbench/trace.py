"""What a torch.profiler trace of the traced window says.

The profiler records the card's activity alone (kernels, copies, sets:
CUPTI), which costs the host far less than recording every host op as
well. The harness keeps its own host spans meanwhile, each op's
hand-off (`submit`) and wait (`wait`), on the Unix clock in ns that the
profiler's timestamps are given in. The profile covers the traced
window and nothing else (no op runs before or after it), so busy time
is the union of all device entries' intervals: copies that overlap
kernels count once. The window's length is the harness's own clock.
"""

from __future__ import annotations

import dataclasses

import torch

SUBMIT, WAIT = "submit", "wait"
GF_KERNEL, CRC_KERNEL = "gf_apply_kernel", "crc32c_kernel"


@dataclasses.dataclass
class Trace:
    window_s: float             # the traced window, harness clock
    device: list                # (name, start us, end us)
    host: list                  # (span name, start us, end us)

    def busy(self) -> list:
        """Merged busy intervals of the device."""
        out: list = []
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def lead_us(self) -> float:
        """From the first hand-off's start to the first device entry's
        (a check that the two clocks agree: small and positive)."""
        if not self.device or not self.host:
            return float("nan")
        return min(a for _, a, _ in self.device) \
            - min(a for _, a, _ in self.host)

    def device_ms(self, match=None) -> tuple[float, int]:
        """Device ms and entry count of the entries whose name holds
        `match` (None: every entry)."""
        hits = [b - a for n, a, b in self.device
                if match is None or match in n]
        return sum(hits) / 1e3, len(hits)

    def by_name(self, top: int = 10) -> list:
        """The device entries that took most time: [[name, seconds]]."""
        tot: dict = {}
        for n, a, b in self.device:
            tot[n] = tot.get(n, 0.0) + (b - a) / 1e6
        return [[n[:160], s] for n, s in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest stretches between device entries in which the
        device ran nothing, each named by the host span it began in
        (`submit`: an op's hand-off to the port; `wait`: blocked on the
        oldest op; `harness`: the loop's own work between them):
        [[name, seconds]]."""
        busy = self.busy()
        gaps = [(busy[j][1], busy[j + 1][0]) for j in range(len(busy) - 1)]
        host = sorted(self.host, key=lambda h: h[1])
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            name = next((n for n, h0, h1 in host if h0 <= a < h1),
                        "harness")
            out.append([name, (b - a) / 1e6])
        return out


def read(prof, window_s: float, spans: list) -> Trace:
    """The device entries of a finished profile (None: no profile, no
    entry), from the profiler's raw event list (far cheaper than its
    event tree), with the harness's host spans [(name, start ns, end
    ns)]."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [] if prof is None else prof.profiler.kineto_results.events()
    device = [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
              for e in events
              if e.device_type() == cuda and not e.is_user_annotation()]
    host = [(n, a / 1e3, b / 1e3) for n, a, b in spans]
    return Trace(window_s, device, host)
