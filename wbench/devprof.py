"""A stretch of requests under ``torch.profiler``: what ran on the card,
when, and what the host was doing while the card sat idle.

The method is ``device_profile``'s in ``chip_smoke.py`` (the repo's on-card
smoke script): CPU and CUDA activities, spin kernels before and after the
stretch (a late profiler session loses its first launches without them),
and the device events taken from the trace with the spin kernels left out.
One change: the busy time is the union of the device events' intervals
inside the stretch, not the sum of their times, so events that overlap on
two streams count once.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Dict, List, Tuple

#: spin kernels launched before and after the stretch (chip_smoke's pad)
PAD_LAUNCHES = 2000
#: the record_function names the harness wraps the stretch and each request in
STRETCH, REQUEST = "wbench.stretch", "wbench.request"
#: device events of copies between host and device (the trace's names)
COPY_NAMES = ("Memcpy HtoD", "Memcpy DtoH")


@dataclasses.dataclass
class DeviceTrace:
    """``requests`` requests profiled over ``[t0_us, t1_us]`` on the
    profiler's clock; ``device`` and ``host`` are ``(name, start_us,
    end_us)`` inside it."""

    requests: int
    t0_us: float
    t1_us: float
    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    _starts: list = dataclasses.field(default=None, repr=False)

    def device_s(self, *subs: str) -> float:
        """Seconds of the device events whose name holds any of ``subs``
        (all device events when none is given)."""
        return sum(e - s for name, s, e in self.device
                   if not subs or any(x in name for x in subs)) / 1e6

    def busy_s(self) -> float:
        """Seconds in which at least one operation ran on the device."""
        busy, end = 0.0, self.t0_us
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            s = max(s, end)
            if e > s:
                busy += e - s
                end = e
        return busy / 1e6

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle intervals ``(start_us, end_us)`` of the stretch."""
        out, end = [], self.t0_us
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            if s > end:
                out.append((end, s))
            end = max(end, e)
        if self.t1_us > end:
            out.append((end, self.t1_us))
        return out

    def host_at(self, t_us: float) -> str:
        """The innermost host operation running at ``t_us``: the operator,
        runtime call or harness wrapper with the latest start that covers
        it (host operations nest), ``"host"`` where none does.  The
        request wrapper's name means the host ran the program's Python
        outside any operator."""
        if self._starts is None:
            self.host.sort(key=lambda h: h[1])
            self._starts = [h[1] for h in self.host]
        i = bisect.bisect_right(self._starts, t_us) - 1
        while i >= 0:
            name, s, e = self.host[i]
            if e >= t_us and name != STRETCH:
                return name
            i -= 1
        return "host"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the idle time by
        what the host was doing, each as ``[[name, seconds], ...]``."""
        ops: Dict[str, float] = {}
        for name, s, e in self.device:
            ops[name] = ops.get(name, 0.0) + (e - s) / 1e6
        idle: Dict[str, float] = {}
        for s, e in self.gaps():
            name = self.host_at((s + e) / 2)
            idle[name] = idle.get(name, 0.0) + (e - s) / 1e6
        return {k: [[n[:120], v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
                for k, d in (("device_ops", ops), ("idle_gaps", idle))}


def profile(requests: List[Callable[[], object]], dev) -> DeviceTrace:
    """Run each of ``requests`` in turn under ``torch.profiler``, the whole
    stretch ending in a synchronise, and return what the trace holds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function

    def pad():
        for _ in range(PAD_LAUNCHES):
            torch.cuda._sleep(100)
        torch.cuda.synchronize(dev)

    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pad()
        with record_function(STRETCH):
            for fn in requests:
                with record_function(REQUEST):
                    fn()
            torch.cuda.synchronize(dev)
        pad()
    events = prof.events()
    (stretch,) = [e for e in events
                  if e.name == STRETCH and e.device_type == DeviceType.CPU]
    t0, t1 = stretch.time_range.start, stretch.time_range.end

    def inside(e):
        return e.time_range.start >= t0 and e.time_range.end <= t1

    # the wrappers' annotations on the device's timeline are no work
    device = [(e.name, e.time_range.start, e.time_range.end) for e in events
              if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name
              and e.name not in (STRETCH, REQUEST) and inside(e)]
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == DeviceType.CPU and inside(e)]
    return DeviceTrace(len(requests), t0, t1, device, host)
