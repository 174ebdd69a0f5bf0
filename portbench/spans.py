"""The span phase of a traced run: per-layer metrics read from the port's
own spans and stage clocks (``torch_admm_deconv_tpu_torch.utils.tracing``).

A reader gets only ``run``, so the readers of these metrics call ``of(run)``.
It returns ``run.spans`` and, in a traced run that has none yet, makes it
once, after everything else the run measures (the traced window, the gap
trace and the peak memory, all with the port's recording off): the cell
and seed come from the harness's own command line (``--workload``,
``--seed``), and ``phase`` builds the cell's entry anew on the card, sends
it one request, then under a device-only ``torch.profiler`` one more (the
profiler's start-up, as in the traced window) and the cell's
``trace_requests`` requests with the port's recording on, and last, with
no profiler, four blocks of as many requests with the recording on, off,
off and on (its cost, on standard error). ``run.spans`` is
None where there is nothing to read: an untraced run, a command line
without a cell, a program without the recorder (the readers then return
None).

What ``phase`` hands the readers (a namespace):
  spans       the drained spans, each also with start_us and end_us on the
              profile's clock (microseconds after its start)
  device      (start_us, end_us, name) of every device operation of the
              recorded requests
  requests    the recorded requests
  counters    the stage clocks and launches by kernel (``tracing.drain()``)
  latencies_s the recorded requests' host times
  on_off_s    host times of unprofiled requests after them, in blocks with
              the recording on and off in turns (its cost)

Idle (``idle``): over the phase's window, from the first request span's
start to the last one's end, the device is busy where any operation runs.
Each idle gap is cut where a span starts or ends, and each piece goes to
the innermost span open over it, so a gap that runs from one request's
copy out to the next one's copy in is shared by the two entries and the
time between them. A piece is put down to the request's child that holds
its span: an ``entry.*`` span, the ``solve``, ``model.forward``, another
child, or the request span itself; where no span is open it falls between
requests. These parts sum to the window's idle. A piece whose span is
``solve`` or inside one counts as solve idle too, wherever the solve sits
(in the flagship, inside the model).
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import re
import statistics
import sys
import time
import traceback
from collections import defaultdict
from types import SimpleNamespace

K2_PRODUCTS = ("product_1", "product_2", "product_3", "product_4")
K2_CHAIN = ("chain",)
PARTS = ("entry", "solve", "model", "other", "request", "between")


def of(run):
    """``run.spans``, made once by ``phase`` in a traced run (see above)."""
    if run.trace is None:
        return None
    if not hasattr(run, "spans"):
        run.spans = None  # once, even where the phase fails
        args = _command_line(sys.argv[1:])
        if args is not None:
            try:
                import torch

                from portbench.run import load_cell

                if torch.cuda.is_available():
                    run.spans = phase(load_cell(args[0]), args[1], torch.device("cuda", 0),
                                      run.latencies_s[1:])
            except Exception:  # the metrics are left out; the run's result stands
                traceback.print_exc()
    return run.spans


def _command_line(argv):
    """(cell, seed) from the harness's arguments, or None."""
    found = {}
    for key, value in zip(argv, argv[1:]):
        if key in ("--workload", "--seed"):
            found[key] = value
    if set(found) != {"--workload", "--seed"}:
        return None
    return found["--workload"], int(found["--seed"])


def phase(cell, seed: int, device, window_latencies_s=()):
    """The span phase of ``cell`` on ``device`` (see the module's text);
    None where the program has no recorder."""
    try:
        from torch_admm_deconv_tpu_torch.utils import tracing
    except ImportError:
        return None
    import torch

    from portbench import traffic
    from portbench.trace import device_events

    wl, cfg, mix = cell.workload, cell.config, cell.mix
    system = importlib.import_module(f"portbench.systems.{wl['entry']}")
    shared = system.make_shared(cfg, seed, device)
    pool = traffic.make_pool(mix, seed, psf=shared.get("psf"))
    entry = system.program(cfg, wl["args"], shared, device)
    n = wl["trace_requests"]
    entry(pool[0])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    acts = [torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU]
    latencies = []
    with torch.profiler.profile(activities=acts, schedule=torch.profiler.schedule(
            wait=0, warmup=1, active=n, repeat=1)) as prof:
        entry(pool[1 % len(pool)])
        prof.step()
        with tracing.recording():
            for i in range(n):
                t = time.perf_counter()
                entry(pool[(i + 2) % len(pool)])
                latencies.append(time.perf_counter() - t)
                prof.step()
    recorded = tracing.drain()
    # the recording's cost: blocks of requests with it on and off in turns, unprofiled
    on, off = [], []
    for times in (on, off, off, on):
        with tracing.recording() if times is on else contextlib.nullcontext():
            for i in range(n):
                t = time.perf_counter()
                entry(pool[i % len(pool)])
                times.append(time.perf_counter() - t)
    tracing.drain()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    spans = [dict(s, start_us=(s["start_ns"] - start_ns) / 1e3,
                  end_us=(s["end_ns"] - start_ns) / 1e3) for s in recorded["spans"]]
    device_ops = [e for e in device_events(prof) if not e[2].startswith("ProfilerStep")]
    found = SimpleNamespace(spans=spans, device=device_ops, requests=n,
                            counters=recorded["counters"], latencies_s=latencies,
                            on_off_s=(on, off))
    _summary(found, window_latencies_s)
    return found


def _summary(sp, window_latencies_s) -> None:
    """What the phase read, on standard error: the recording's cost (its
    requests' median against the traced window's, and on against off in
    turns), K2's stage clock against its profiled time, whether each device
    operation lies in a request's span, the idle by part and by span."""
    from portbench.readers import kernel_pattern

    def median_ms(times):
        return statistics.median(times) * 1e3

    lines = [f"spans: {len(sp.spans)} spans, {len(sp.device)} device operations, "
             f"{sp.requests} requests"]
    if len(window_latencies_s):
        mine, window = median_ms(sp.latencies_s), median_ms(window_latencies_s)
        lines.append(f"spans: request median {mine:.3f} ms recorded, {window:.3f} ms in the "
                     f"traced window ({100 * (mine / window - 1):+.2f} %)")
    on, off = (median_ms(t) for t in sp.on_off_s)
    lines.append(f"spans: recording on and off in turns, unprofiled: median {on:.3f} / "
                 f"{off:.3f} ms ({100 * (on / off - 1):+.2f} %)")
    k2 = kernel_ms(sp, kernel_pattern("k2"))
    clock = stage_ms(sp, "k2")
    if clock is not None and k2 > 0:
        lines.append(f"spans: K2 stage clock {clock:.3f} ms a request, profiled {k2:.3f} ms "
                     f"({100 * (clock / k2 - 1):+.2f} %)")
    found = idle(sp)
    if found is not None:
        outside, first, last = containment(sp)
        lines.append(f"spans: {outside} device operations outside their request's span; least "
                     f"margin {first:.1f} us after its start, {last:.1f} us before its end")
        by_span = found.pop("by_span")
        for label, parts in (("part", found), ("innermost span", by_span)):
            lines.append(f"spans: idle ms a request by {label}: " + ", ".join(
                f"{k} {v / sp.requests:.4f}" for k, v in parts.items()))
    print("\n".join(lines), file=sys.stderr, flush=True)


def containment(sp):
    """Of the device operations from the first request's start on (before
    it, only the recorder's fills of its stage clocks run): how many end
    outside the span of the request they start in, and the least margins
    in microseconds between a request's start and its first operation's
    start, and between its last operation's end and its end."""
    requests = sorted((s["start_us"], s["end_us"]) for s in sp.spans if s["name"] == "request")
    starts = [a for a, _ in requests]
    outside, first, last = 0, float("inf"), float("inf")
    for start, end, _ in sp.device:
        if start < starts[0]:
            continue
        a, b = requests[bisect.bisect_right(starts, start) - 1]
        if end > b:
            outside += 1
            continue
        first, last = min(first, start - a), min(last, b - end)
    return outside, first, last


def kernel_ms(sp, pattern: str) -> float:
    """Profiled device ms a request of the operations named by ``pattern``."""
    found = re.compile(pattern, re.I)
    us = sum(end - start for start, end, name in sp.device if found.search(name))
    return us / 1e3 / max(sp.requests, 1)


def stage_ms(sp, kernel: str, stages=None):
    """The stage clock's ms a request of ``kernel`` in ``stages`` (all of
    them by default), summed over devices; None where it did not launch."""
    clocks = [c for c in sp.counters if c["kernel"] == kernel and c["launches"]]
    if not clocks or sp.requests == 0:
        return None
    total = sum(ns for c in clocks for stage, ns in c["stage_ns"].items()
                if stages is None or stage in stages)
    return total / 1e6 / sp.requests


def _gaps(device, w0: float, w1: float) -> list:
    """(start, end) of the stretches of [w0, w1] where no operation runs."""
    gaps, cursor = [], w0
    for start, end, _ in device:
        if end <= cursor:
            continue
        if start > cursor:
            gaps.append((cursor, min(start, w1)))
        cursor = max(cursor, end)
        if cursor >= w1:
            break
    if cursor < w1:
        gaps.append((cursor, w1))
    return [(a, b) for a, b in gaps if b > a]


def idle(sp):
    """Idle ms of the phase's window by part (``PARTS``, summing to the
    window's idle), plus 'total', 'window', 'solve_any' (every piece under a
    ``solve``) and 'by_span' (by the innermost span's name, or 'between');
    None without request spans."""
    requests = [s for s in sp.spans if s["name"] == "request"]
    if not requests:
        return None
    w0 = min(s["start_us"] for s in requests)
    w1 = max(s["end_us"] for s in requests)
    ordered = sorted(sp.spans, key=lambda s: (s["start_us"], -s["end_us"]))
    starts = [s["start_us"] for s in ordered]
    cuts = sorted({t for s in sp.spans for t in (s["start_us"], s["end_us"])})
    by_id = {s["id"]: s for s in sp.spans}
    out = dict.fromkeys(PARTS, 0.0)
    out.update(total=0.0, window=(w1 - w0) / 1e3, solve_any=0.0)
    by_span = defaultdict(float)
    for a, b in _gaps(sp.device, w0, w1):
        inner = cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)]
        for lo, hi in zip([a] + inner, inner + [b]):
            ms = (hi - lo) / 1e3
            chain = _chain(_innermost(ordered, starts, (lo + hi) / 2), by_id)
            out["total"] += ms
            out[_part(chain)] += ms
            by_span[chain[0]["name"] if chain else "between"] += ms
            if any(s["name"] == "solve" for s in chain):
                out["solve_any"] += ms
    out["by_span"] = dict(by_span)
    return out


def _innermost(ordered, starts, t):
    """The innermost span open at ``t``: the latest to start of those that
    have not ended (spans of one thread nest)."""
    for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if ordered[j]["end_us"] >= t:
            return ordered[j]
    return None


def _chain(span, by_id) -> list:
    """``span`` and its ancestors, innermost first."""
    chain = []
    while span is not None:
        chain.append(span)
        span = by_id.get(span["parent"])
    return chain


def _part(chain) -> str:
    """The part of ``PARTS`` that a gap inside ``chain`` belongs to."""
    if not chain:
        return "between"
    if chain[-1]["name"] != "request":
        return "other"
    if len(chain) == 1:
        return "request"
    top = chain[-2]["name"]  # the request's child
    if top.startswith("entry."):
        return "entry"
    if top == "solve":
        return "solve"
    if top == "model.forward":
        return "model"
    return "other"


def idle_ms(run, part: str):
    """Idle ms a request put down to ``part`` ('entry', 'model', or
    'solve_any'); None where the run has no spans."""
    sp = of(run)
    found = None if sp is None else idle(sp)
    if found is None:
        return None
    return found[part] / sp.requests
