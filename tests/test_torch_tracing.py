"""The port's span and counter recorder (``utils/tracing.py``) and its span
sites, on the CPU: nesting, request ids, the off path, the solve paths, the
clock shared with ``torch.profiler`` and the exporter
(``utils.profiling.trace``)."""

from __future__ import annotations

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from torch_admm_deconv_tpu_torch import infer
from torch_admm_deconv_tpu_torch.kernels import vmem_solver
from torch_admm_deconv_tpu_torch.models.denoiser import DivergentRestorer
from torch_admm_deconv_tpu_torch.ops.solver import admm_tv, admm_tv_adaptive
from torch_admm_deconv_tpu_torch.utils import tracing
from torch_admm_deconv_tpu_torch.utils.profiling import trace

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean():
    yield
    with tracing.recording():  # a failed test leaves nothing for the next
        pass
    tracing.drain()


def _recorded(fn, *args, **kw):
    with tracing.recording():
        fn(*args, **kw)
    return tracing.drain()


def _tree(spans):
    """name of each span -> name of its parent (None for a root)."""
    by_id = {s["id"]: s for s in spans}
    return [(s["name"], by_id[s["parent"]]["name"] if s["parent"] else None) for s in spans]


def _batch(b=2, c=3, size=16, seed=0):
    return np.random.default_rng(seed).random((b, c, size, size)).astype(np.float32)


def _small_model():
    admm = {"kern_size": (), "max_iters": 3, "iso": True, "use_pallas": True}
    return DivergentRestorer([2, 2, 2], 3, 3, 8, 8, 4, output_activation=torch.sigmoid,
                             admms=[admm, dict(admm)], device="cpu",
                             generator=torch.Generator().manual_seed(1))


def test_classical_apply_nests_and_shares_a_request_id():
    apply_fn = infer.classical_restorer(0.01, 1.0, maxit=3, iso=False, device="cpu")
    batch = _batch()

    def two():
        apply_fn(batch)
        apply_fn(batch)

    spans = _recorded(two)["spans"]
    assert sorted(set(_tree(spans))) == sorted({
        ("request", None), ("entry.to_device", "request"), ("solve", "request"),
        ("solve.inputs", "solve"), ("entry.to_host", "request")})
    requests = [s for s in spans if s["name"] == "request"]
    assert len(requests) == 2 and requests[0]["request"] != requests[1]["request"]
    assert requests[0]["attrs"] == {"batch": [2, 3, 16, 16]}
    for r in requests:
        inside = [s for s in spans if s["request"] == r["request"]]
        assert len(inside) == 5
        for s in inside:
            assert r["start_ns"] <= s["start_ns"] <= s["end_ns"] <= r["end_ns"]
    by_id = {s["id"]: s for s in spans}
    for s in spans:  # a child lies inside its parent
        if s["parent"]:
            up = by_id[s["parent"]]
            assert up["start_ns"] <= s["start_ns"] <= s["end_ns"] <= up["end_ns"]


def test_model_apply_records_levels_admm_layers_and_their_solves():
    model = _small_model()
    apply_fn = infer.model_restorer(model.state_dict(), model=model, device="cpu")
    spans = _recorded(apply_fn, _batch(b=1))["spans"]
    tree = _tree(spans)
    assert tree.count(("model.forward", "request")) == 1
    assert tree.count(("model.level", "model.forward")) == 3
    assert [s["attrs"]["level"] for s in spans if s["name"] == "model.level"] == [0, 1, 2]
    assert tree.count(("solve", "model.admm")) == 2
    level0 = next(s["id"] for s in spans if s["name"] == "model.level")
    admm = [s for s in spans if s["name"] == "model.admm"]
    by_id = {s["id"]: s for s in spans}

    def ancestors(s):
        while s["parent"]:
            s = by_id[s["parent"]]
            yield s["id"]

    assert len(admm) == 2 and all(level0 in set(ancestors(s)) for s in admm)
    assert {s["attrs"]["path"] for s in spans if s["name"] == "solve"} == {"k2"}
    assert len({s["request"] for s in spans}) == 1


def test_off_span_is_one_shared_object_and_records_nothing():
    first = tracing.span("request", batch=(1, 3, 8, 8))
    assert tracing.span("solve") is first is tracing.OFF
    with tracing.span("solve"):
        admm_tv(torch.ones(1, 1, 8, 8), 0.05, 1.0, maxit=2, use_pallas=True, device="cpu")
    assert tracing.launch_clock("k2", CPU) is None
    out = tracing.drain()
    assert out["spans"] == [] and out["counters"] == [] and out["dropped"] == 0


def test_whole_solve_on_the_cpu_records_its_path_and_inputs():
    x = torch.from_numpy(_batch())
    spans = _recorded(admm_tv, x, 0.05, 0.8, None, iso=False, maxit=4, use_pallas=True,
                      device="cpu")["spans"]
    assert _tree(spans) == [("solve.inputs", "solve"), ("solve", None)]
    solve = spans[1]
    assert solve["attrs"] == {"path": "k2", "shape": [2, 3, 16, 16], "maxit": 4,
                              "precision": "high"}
    assert solve["request"] == spans[0]["request"]


@pytest.mark.parametrize("call, path, children", [
    (lambda x: admm_tv(x, 0.05, 0.8, iso=True, maxit=3, device="cpu"), "loop", []),
    (lambda x: admm_tv_adaptive(x, 0.05, 0.8, maxit=5, tol=1e-3, device="cpu"), "loop", []),
    (lambda x: vmem_solver.admm_tv_vmem(x, 0.05, 0.8, maxit=3, device="cpu"), "k2",
     ["solve.inputs"]),
    (lambda x: vmem_solver.admm_tv_vmem(x, 0.05, 0.8, maxit=3, schedule="interleaved",
                                        device="cpu"), "k4", ["solve.inputs"]),
    (lambda x: vmem_solver.admm_tv_adaptive_vmem(x, 0.05, 0.8, maxit=5, tol=1e-3,
                                                 device="cpu"), "k3", ["solve.inputs"]),
], ids=["admm_tv-loop", "admm_tv_adaptive", "admm_tv_vmem", "interleaved", "adaptive_vmem"])
def test_each_solve_entry_records_one_solve_with_its_path(call, path, children):
    spans = _recorded(call, torch.from_numpy(_batch(b=1, size=16)))["spans"]
    solves = [s for s in spans if s["name"] == "solve"]
    assert len(solves) == 1 and solves[0]["attrs"]["path"] == path
    assert [name for name, up in _tree(spans) if up == "solve"] == children


def test_launch_clock_counts_launches_and_drain_reads_each_kernel_once():
    with tracing.recording():
        a = tracing.launch_clock("k2", CPU)
        assert tracing.launch_clock("k2", CPU) is a
        a += torch.arange(6)
        tracing.launch_clock("k3", CPU).fill_(7)
    counters = {c["kernel"]: c for c in tracing.drain()["counters"]}
    assert set(counters) == {"k2", "k3"}
    assert counters["k2"]["launches"] == 2 and counters["k3"]["launches"] == 1
    assert counters["k2"]["stage_ns"] == dict(zip(tracing.STAGES["k2"], range(6)))
    assert list(counters["k3"]["stage_ns"].values()) == [7] * 8
    with tracing.recording():  # zeroed when recording starts again
        assert tracing.launch_clock("k2", CPU).tolist() == [0] * 6
    assert tracing.drain()["counters"][0]["launches"] == 1


def test_drain_forgets_and_counts_what_the_bound_drops(monkeypatch):
    monkeypatch.setattr(tracing, "LIMIT", 3)
    with tracing.recording():
        for i in range(5):
            with tracing.span("s", i=i):
                pass
    out = tracing.drain()
    assert [s["attrs"]["i"] for s in out["spans"]] == [0, 1, 2] and out["dropped"] == 2
    assert tracing.drain() == {"clock": "unix_ns", "spans": [], "counters": [], "dropped": 0}


def test_threads_keep_their_own_stacks():
    def worker(name):
        with tracing.span(name):
            time.sleep(0.01)
            with tracing.span(name + ".child"):
                pass

    with tracing.recording():
        with tracing.span("main"):
            threads = [threading.Thread(target=worker, args=(f"t{i}",)) for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
    spans = tracing.drain()["spans"]
    seen = dict(_tree(spans))
    assert seen == {"main": None, "t0": None, "t1": None, "t0.child": "t0", "t1.child": "t1"}


def test_threads_recording_at_once_lose_no_span_and_no_launch():
    threads, rounds = 16, 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(rounds):
                with tracing.span("w"):
                    tracing.launch_clock("k2", CPU)

        with tracing.recording():
            pool = [threading.Thread(target=worker) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
    out = tracing.drain()
    assert len(out["spans"]) == threads * rounds
    assert len({s["id"] for s in out["spans"]}) == threads * rounds
    assert out["counters"][0]["launches"] == threads * rounds


def test_spans_share_the_profilers_clock():
    """Drained times are Unix nanoseconds, and a span mapped onto a profile
    as (ns - trace_start_ns) / 1000 holds the operations it ran."""
    a, b = torch.ones(256, 256), torch.ones(256, 256)
    before = time.time_ns()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.recording():
            for _ in range(3):
                with tracing.span("mm"):
                    a @ b
                time.sleep(0.002)
    after = time.time_ns()
    spans = tracing.drain()["spans"]
    assert all(before <= s["start_ns"] <= s["end_ns"] <= after for s in spans)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    mms = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.name == "aten::mm")
    assert len(mms) == 3
    for s, (op_start, op_end) in zip(spans, mms):
        start, end = (s["start_ns"] - t0) / 1e3, (s["end_ns"] - t0) / 1e3
        assert start - 20 <= op_start and op_end <= end + 20, (start, end, op_start, op_end)


def test_profiling_trace_writes_spans_beside_the_chrome_trace(tmp_path):
    apply_fn = infer.classical_restorer(0.01, 1.0, maxit=2, iso=False, device="cpu")
    with trace(str(tmp_path)):
        apply_fn(_batch(b=1))
    assert tracing.span("after") is tracing.OFF
    assert (tmp_path / "trace.json").stat().st_size > 0
    saved = json.loads((tmp_path / "spans.json").read_text())
    assert saved["clock"] == "unix_ns" and saved["profile_start_ns"] > 0
    names = [s["name"] for s in saved["spans"]]
    assert names.count("request") == 1 and "solve" in names
    assert all(s["start_ns"] >= saved["profile_start_ns"] for s in saved["spans"])
