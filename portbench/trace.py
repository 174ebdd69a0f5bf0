"""Reading the profiler's traces of a traced run.

The traced window is a run of requests under ``torch.profiler`` recording
the device alone (the host-side recording of every operation would slow
the host and widen the gaps it measures): its length is taken on the
host's clock from the start of its first request to the end of its last,
and the device is busy where any device operation (kernel, copy, set)
runs; one stream, so the union of their intervals. A second, short trace
that records the host as well names the idle gaps: each by what the host
was doing at its middle, the innermost host event around that moment (the
request label itself where the host ran the client's own code inside a
request), or ``between requests`` where none is.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

REQUEST = "request"
NAME_CHARS = 100  # a breakdown entry's name is cut to this length


class Trace:
    """The device operations of the traced window and the named idle gaps."""

    def __init__(self, window_s: float, requests: int, device: list, gaps: list):
        self.window_s = window_s
        self.requests = requests
        self.ops = [(name, (end - start) / 1e6) for start, end, name in device]
        self.busy_s = _union_us(device) / 1e6
        self.gaps = gaps  # [(host activity, seconds)] of the second trace

    def seconds(self, pattern: str, exclude: str | None = None) -> float:
        """Device seconds of the operations whose name matches ``pattern``
        (and not ``exclude``)."""
        inc = re.compile(pattern, re.I)
        exc = re.compile(exclude, re.I) if exclude else None
        return sum(s for n, s in self.ops if inc.search(n) and not (exc and exc.search(n)))

    def breakdown(self) -> dict:
        return {"device_ops": _top(self.ops), "idle_gaps": _top(self.gaps)}


def _top(pairs, n=10):
    total = defaultdict(float)
    for name, s in pairs:
        total[name[:NAME_CHARS]] += s
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def _union_us(intervals) -> float:
    busy, cursor = 0.0, float("-inf")
    for start, end, _ in intervals:
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    return busy


def device_events(prof) -> list:
    """Sorted (start, end, name) of the device operations in a finished
    profile; the device copies of the request labels are annotations."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == DeviceType.CUDA and e.name != REQUEST)


def idle_gaps(prof) -> list:
    """[(host activity, seconds)] of the idle gaps between the second
    labelled request's start and the last one's end (the first pays the
    profiler's start-up), from a profile of the host and the device."""
    from torch.autograd import DeviceType

    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    requests = sorted((e for e in host if e.name == REQUEST), key=lambda e: e.time_range.start)
    requests = requests[1:] if len(requests) > 1 else requests
    if not requests:
        return []
    w0 = requests[0].time_range.start
    w1 = max(e.time_range.end for e in requests)
    host_iv = sorted((e.time_range.start, e.time_range.end, e.name) for e in host)
    starts = [s for s, _, _ in host_iv]
    gaps, cursor = [], w0
    for start, end, _ in device_events(prof) + [(w1, w1, "")]:
        if end <= w0:
            continue
        start = max(start, w0)
        if start > cursor:
            gaps.append((_doing(host_iv, starts, (cursor + start) / 2), (start - cursor) / 1e6))
        cursor = max(cursor, min(end, w1))
        if cursor >= w1:
            break
    return gaps


def _doing(host_iv, starts, t, reach=256):
    """The innermost host event around time ``t``: the latest to start of
    those that have not ended."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        if host_iv[j][1] >= t:
            return host_iv[j][2]
    return "between requests"
