"""What the metric readers under ``metrics/`` share.

A reader is ``metrics/<name>.py`` with ``read(run)``: the metric's value
from the run's record, or None where the run has nothing to read it from
(the harness then leaves the metric out of the result). ``run`` carries:
  setup_s, window_s, requests, latencies_s (one per request),
  pixels_per_request (restored output pixels, H x W per image)
and, in a traced run, ``trace`` (``trace.Trace``), ``work`` (the entry's
work count per request, ``work/<entry>.py``) and ``peaks`` (the card's row
of ``peaks.json``, None for a card the table lacks).
"""

from __future__ import annotations

import json
from pathlib import Path

# kernel groups of the device trace (the program's trace_forward.py)
CONV = r"conv|cudnn|xmma|implicit|winograd|fprop|wgrad|dgrad"
COPY = r"memcpy|memset"
_KERNELS = json.loads((Path(__file__).parent / "kernels.json").read_text())
PORT_KERNELS = "|".join(v for k, v in _KERNELS.items() if k != "about")


def kernel_pattern(name: str) -> str:
    return _KERNELS[name]


def per_request_ms(run, seconds: float):
    """Milliseconds a traced request; None where the trace holds none."""
    if run.trace is None or run.trace.requests == 0 or seconds <= 0:
        return None
    return seconds * 1e3 / run.trace.requests


def roofline(run, kernel: str):
    """Percent: the least time of the kernel's work in the traced window
    over its summed device time there."""
    if run.trace is None or run.peaks is None or kernel not in run.work["kernels"]:
        return None
    spent = run.trace.seconds(kernel_pattern(kernel))
    if spent <= 0:
        return None
    from portbench.work.solves import least_seconds

    least = least_seconds(run.work["kernels"][kernel], run.peaks) * run.trace.requests
    return 100.0 * least / spent
