"""Spans and counters inside the port, kept in memory, off by default.

Switched on and off through this API alone::

    from torch_admm_deconv_tpu_torch.utils import tracing

    with tracing.recording():
        apply_fn(batch)            # the span sites below record
    recorded = tracing.drain()     # {"clock", "spans", "counters", "dropped"}

A span is ``with tracing.span(name, **attrs):`` at a layer boundary. Its
record holds the name, start and end, its id, its parent's id (the span
open around it on the same thread, None for a root), a request id (a root
opens a new one; its children share it) and the attributes. The sites:

  request          ``infer.classical_restorer`` / ``infer.model_restorer``'s
                   apply (batch shape)
  entry.to_device  the apply's copy of the host batch to the device
  entry.to_host    the apply's ``.cpu().numpy()``, the host's wait included
  model.forward    ``model_restorer``'s call of the model
  model.level      a level of ``DivergentRestorer.forward`` (level index)
  model.admm       ``ADMMDeconv.forward``
  solve            once a call of ``admm_tv``, ``admm_tv_adaptive``,
                   ``admm_tv_vmem`` or ``admm_tv_adaptive_vmem`` (path 'k2',
                   'k3', 'k4' or 'loop', shape, maxit, precision): ``admm_tv``
                   opens it on the loop, ``admm_tv_vmem`` on its whole solve
  solve.inputs     what the whole solve reads, built before its launch
  solve.launch     one launch of K2, K3 or K4 with its workspace (kernel)

Counters: while recording, each launch of a persistent kernel hands the
kernel the recorder's int64 buffer for that kernel and device, to which it
adds its device nanoseconds by stage (``STAGES``) as the grid's first CTA
sees them between grid barriers (K4: cluster 0's). The buffers are zeroed
when recording starts, so the device sums over every launch; ``drain()``
reads each once, with the launches recorded per kernel.

Off, a span site costs one check of a module flag (and the keyword
arguments of a site that passes attributes): ``span`` returns one shared
object that does nothing. On, a span costs two ``perf_counter_ns`` reads
and one append. Spans never enter ``torch.profiler.record_function``: under
a CUDA profile such a range is also a device-side annotation.

Clock: ``drain()`` returns Unix nanoseconds (one offset from
``perf_counter_ns`` to ``time.time_ns``, taken when recording starts),
the clock of ``torch.profiler``'s events, so a span maps onto a finished
profile as ``(ns - prof.profiler.kineto_results.trace_start_ns()) / 1000``
microseconds of its events' ``time_range``.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import Counter

import torch

# the stage clock's slots of each persistent kernel (csrc/vmem_solver.cu,
# csrc/vmem_interleaved.cu, csrc/vmem_adaptive.cu)
STAGES = {
    "k2": ("prologue", "product_1", "product_2", "product_3", "product_4", "chain"),
    "k4": ("prologue", "product_1", "product_2", "product_3", "product_4", "chain"),
    "k3": ("prologue", "product_1", "product_2", "product_3", "product_4", "residual",
           "finalize", "rhs"),
}
LIMIT = 1 << 20  # spans kept; those beyond are counted as dropped

_on = False
_offset_ns = 0
_records: list = []
_dropped = 0
_buffers: dict = {}  # (kernel, device) -> int64 stage clock
_launches: Counter = Counter()
_ids = itertools.count(1)
_requests = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()  # the counts that threads may add to at once


class _Off:
    """The span of every site while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "start", "id", "parent", "request")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = up.id if up is not None else None
        self.request = up.request if up is not None else next(_requests)
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        global _dropped
        _stack().pop()
        if len(_records) < LIMIT:
            _records.append((self.name, self.start, end, self.id, self.parent, self.request,
                             self.attrs))
        else:
            with _lock:
                _dropped += 1
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, **attrs):
    """A context manager that records ``name`` over its body while
    recording is on; the shared no-op ``OFF`` otherwise."""
    if not _on:
        return OFF
    return _Span(name, attrs)


@contextlib.contextmanager
def recording():
    """Record over the body, anew: spans and counters from zero, the
    clock's offset taken, the stage clocks of the current CUDA device
    allocated. What was recorded waits for ``drain()``."""
    global _on, _offset_ns, _dropped
    _records.clear()
    _buffers.clear()
    _launches.clear()
    _dropped = 0
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
        for kernel in STAGES:
            _buffer(kernel, dev)
    p0 = time.perf_counter_ns()
    t = time.time_ns()
    _offset_ns = t - (p0 + time.perf_counter_ns()) // 2
    _on = True
    try:
        yield
    finally:
        _on = False


def _buffer(kernel: str, device: torch.device) -> torch.Tensor:
    key = (kernel, device)
    buf = _buffers.get(key)
    if buf is None:
        buf = _buffers[key] = torch.zeros(len(STAGES[kernel]), dtype=torch.int64, device=device)
    return buf


def launch_clock(kernel: str, device: torch.device):
    """The stage clock buffer to hand one launch of ``kernel`` ('k2', 'k3'
    or 'k4') on ``device``, counting the launch; None while recording is
    off."""
    if not _on:
        return None
    with _lock:
        _launches[(kernel, device)] += 1
        return _buffer(kernel, device)


def _plain(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, (tuple, list, torch.Size)):
        return [_plain(x) for x in v]
    return str(v)


def drain() -> dict:
    """Everything recorded since recording started, then forgotten:
    'spans' (dicts of name, start_ns, end_ns on the Unix clock, id, parent,
    request, attrs), 'counters' (per kernel and device with launches: the
    launches and the stage clock's nanoseconds by stage), 'dropped' (spans
    past ``LIMIT``)."""
    global _dropped
    spans = [{"name": name, "start_ns": start + _offset_ns, "end_ns": end + _offset_ns, "id": sid,
              "parent": parent, "request": request,
              "attrs": {k: _plain(v) for k, v in attrs.items()}}
             for name, start, end, sid, parent, request, attrs in _records]
    counters = [{"kernel": kernel, "device": str(dev), "launches": _launches[(kernel, dev)],
                 "stage_ns": dict(zip(STAGES[kernel], buf.tolist()))}
                for (kernel, dev), buf in _buffers.items() if _launches[(kernel, dev)]]
    out = {"clock": "unix_ns", "spans": spans, "counters": counters, "dropped": _dropped}
    _records.clear()
    _buffers.clear()
    _launches.clear()
    _dropped = 0
    return out
