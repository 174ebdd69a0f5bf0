"""The span phase (``spans.py``) and the six readers of the port's spans and
stage clocks: on fabricated spans and device events, on the CPU at a tiny
size, and (``card``) on the card at the classical cell's size, where the
spans' clock has to agree with the profile's."""

import copy
from types import SimpleNamespace

import pytest
import torch

from portbench import run, spans
from portbench.readers import kernel_pattern

READERS = ("k2_product_ms", "k2_chain_ms", "entry_idle_ms", "entry_idle_ms.flagship",
           "solve_idle_ms", "model_idle_ms")


def _span(sid, name, start, end, parent=None, request=1):
    return {"name": name, "id": sid, "parent": parent, "request": request, "attrs": {},
            "start_ns": int(start * 1e3), "end_ns": int(end * 1e3), "start_us": start,
            "end_us": end}


def _classical():
    """Two requests, each 0-1000 us after its start: copy in 0-100, solve
    100-800 (inputs 100-200, launch 200-250), copy out 800-1000. The device
    runs 120-180 (inputs), 260-790 (the solve), 850-950 (the copy out)."""
    found, device = [], []
    for r, t in enumerate((0.0, 2000.0)):
        b = 10 * r
        found += [
            _span(b + 1, "request", t, t + 1000, None, r + 1),
            _span(b + 2, "entry.to_device", t, t + 100, b + 1, r + 1),
            _span(b + 3, "solve", t + 100, t + 800, b + 1, r + 1),
            _span(b + 4, "solve.inputs", t + 100, t + 200, b + 3, r + 1),
            _span(b + 5, "solve.launch", t + 200, t + 250, b + 3, r + 1),
            _span(b + 6, "entry.to_host", t + 800, t + 1000, b + 1, r + 1),
        ]
        device += [(t + 120, t + 180, "fft"), (t + 260, t + 790, "k2_persistent_tiled"),
                   (t + 850, t + 950, "Memcpy DtoH")]
    counters = [{"kernel": "k2", "device": "cuda:0", "launches": 2,
                 "stage_ns": {"prologue": 2e5, "product_1": 1e6, "product_2": 2e6,
                              "product_3": 3e6, "product_4": 4e6, "chain": 6e6}}]
    return SimpleNamespace(spans=found, device=sorted(device), requests=2, counters=counters,
                           latencies_s=[1e-3, 1e-3])


def _flagship():
    """One request 0-1000: copy in 0-50, model 50-900 with level 0 50-400
    holding an ADMM layer 60-300 and its solve 70-290, copy out 900-1000.
    The device runs 55-65, 100-280, 310-880, 920-980."""
    found = [
        _span(1, "request", 0, 1000),
        _span(2, "entry.to_device", 0, 50, 1),
        _span(3, "model.forward", 50, 900, 1),
        _span(4, "model.level", 50, 400, 3),
        _span(5, "model.admm", 60, 300, 4),
        _span(6, "solve", 70, 290, 5),
        _span(7, "model.level", 400, 900, 3),
        _span(8, "entry.to_host", 900, 1000, 1),
    ]
    device = [(55, 65, "conv"), (100, 280, "k2_persistent"), (310, 880, "sort"),
              (920, 980, "Memcpy DtoH")]
    return SimpleNamespace(spans=found, device=device, requests=1, counters=[], latencies_s=[1e-3])


def _read(name, sp):
    return run.reader(name)(SimpleNamespace(trace=object(), spans=sp))


def test_stage_readers_take_k2_slots_per_request():
    sp = _classical()
    assert _read("k2_product_ms", sp) == pytest.approx((1 + 2 + 3 + 4) / 2)
    assert _read("k2_chain_ms", sp) == pytest.approx(6 / 2)
    assert spans.stage_ms(sp, "k2") == pytest.approx(16.2 / 2)
    assert spans.stage_ms(sp, "k3") is None


def test_idle_readers_cut_each_gap_at_the_spans_and_take_the_innermost():
    sp = _classical()
    # entry: 0-100 (to_device), 800-850 and 950-1000 (to_host); the gap 950-2120
    # runs on into the second request: 1000-2000 between, 2000-2100 entry,
    # 2100-2120 solve. solve: 100-120, 180-200 (inputs), 200-250 (launch),
    # 250-260, 790-800 (solve itself); twice, over two requests
    assert _read("entry_idle_ms", sp) == pytest.approx((100 + 50 + 50) / 1e3)
    assert _read("entry_idle_ms.flagship", sp) == _read("entry_idle_ms", sp)
    assert _read("solve_idle_ms", sp) == pytest.approx((20 + 20 + 50 + 10 + 10) / 1e3)
    assert _read("model_idle_ms", sp) == 0.0
    fl = _flagship()
    # model: 50-55 (level 0), 65-70 (admm), 70-100 and 280-290 (its solve), 290-300
    # (admm), 300-310 (level 0), 880-900 (level 1); entry: 0-50, 900-920, 980-1000
    assert _read("model_idle_ms", fl) == pytest.approx((5 + 5 + 30 + 10 + 10 + 10 + 20) / 1e3)
    assert _read("entry_idle_ms.flagship", fl) == pytest.approx((50 + 20 + 20) / 1e3)
    assert _read("solve_idle_ms", fl) == pytest.approx((30 + 10) / 1e3)


@pytest.mark.parametrize("make", [_classical, _flagship], ids=["classical", "flagship"])
def test_parts_sum_to_the_windows_idle(make):
    sp = make()
    found = spans.idle(sp)
    busy = sum(min(e, 1000 + 2000 * (sp.requests - 1)) - s for s, e, _ in sp.device)
    window = 1000 + 2000 * (sp.requests - 1)
    assert found["window"] == pytest.approx(window / 1e3)
    assert found["total"] == pytest.approx((window - busy) / 1e3)
    assert sum(found[p] for p in spans.PARTS) == pytest.approx(found["total"])
    assert sum(found["by_span"].values()) == pytest.approx(found["total"])
    assert found["between"] == pytest.approx(1.0 if sp.requests == 2 else 0.0)


def test_containment_counts_operations_past_their_request():
    sp = _classical()
    assert spans.containment(sp) == (0, 120.0, 50.0)
    sp.device.append((2990.0, 3010.0, "late copy"))
    sp.device.append((-5.0, -1.0, "fill"))  # before the first request: not counted
    assert spans.containment(sp) == (1, 120.0, 50.0)


def test_a_gap_outside_every_span_falls_between_requests():
    sp = _classical()
    sp.spans = [s for s in sp.spans if s["name"] == "request"]
    found = spans.idle(sp)
    assert found["between"] == pytest.approx(1.0)
    assert found["request"] == pytest.approx(2 * (120 + 80 + 60 + 50) / 1e3)
    assert found["entry"] == found["solve"] == found["solve_any"] == 0.0


@pytest.mark.parametrize("name", READERS)
def test_each_reader_returns_none_without_spans(name):
    assert run.reader(name)(SimpleNamespace(trace=None)) is None
    assert run.reader(name)(SimpleNamespace(trace=object(), spans=None)) is None


def test_the_phase_needs_a_cell_and_a_seed_on_the_command_line():
    assert spans._command_line(["--workload", "a.b", "--seed", "2147483999", "--trace", "1"]) == (
        "a.b", 2147483999)
    assert spans._command_line(["-q", "portbench/tests"]) is None
    made = SimpleNamespace(trace=object(), latencies_s=[])
    assert spans.of(made) is None and made.spans is None  # pytest's own command line


def test_the_phase_runs_once_a_traced_run_and_a_failure_leaves_no_spans(monkeypatch, capsys):
    calls = []

    def fake(cell, seed, device, window):
        calls.append((cell.name, seed, str(device), list(window)))
        if len(calls) > 1:
            raise RuntimeError("phase failed")
        return "spans"

    monkeypatch.setattr(spans, "phase", fake)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(spans.sys, "argv", ["run.py", "--workload", "flagship.eval_b1",
                                            "--seed", "7", "--seconds", "25", "--trace", "1"])
    made = SimpleNamespace(trace=object(), latencies_s=[0.5, 0.1, 0.2])
    assert spans.of(made) == "spans" and spans.of(made) == "spans"
    assert calls == [("flagship.eval_b1", 7, "cuda:0", [0.1, 0.2])]
    again = SimpleNamespace(trace=object(), latencies_s=[0.5])
    assert spans.of(again) is None and spans.of(again) is None and len(calls) == 2
    assert "phase failed" in capsys.readouterr().err
    assert spans.of(SimpleNamespace(trace=None)) is None and len(calls) == 2


@pytest.mark.parametrize("name", ["classical_c1.fixed200", "flagship.eval_b1"])
def test_phase_on_the_cpu_records_every_request(name, tiny):
    cell = tiny(name)
    sp = spans.phase(cell, 2 ** 31 + 5, torch.device("cpu"), [0.01])
    n = cell.workload["trace_requests"]
    assert sp.requests == n and len(sp.latencies_s) == n
    requests = [s for s in sp.spans if s["name"] == "request"]
    assert len(requests) == n and len({s["request"] for s in requests}) == n
    assert sp.device == [] and sp.counters == []  # no card: no device operation, no launch
    assert all(0 <= s["start_us"] <= s["end_us"] for s in sp.spans)
    found = spans.idle(sp)  # nothing ran on a device: the whole window is idle
    assert found["total"] == pytest.approx(found["window"])
    assert sum(found[p] for p in spans.PARTS) == pytest.approx(found["total"])
    assert found["solve_any"] > 0 and found["entry"] > 0
    if name.startswith("flagship"):
        assert found["model"] > 0 and found["solve"] == 0


@pytest.mark.card
@pytest.mark.parametrize("name", ["classical_c1.fixed200", "flagship.eval_b1"])
def test_device_operations_fall_inside_their_requests_on_the_card(name, card):
    """Three requests at the cell's size with recording on under a
    device-only profile: each device operation lies inside one request's
    span on the shared clock (the entry waits for the device in ``.cpu()``,
    so this holds only if the clocks agree), and in the classical cell K2's
    stage clock sums to within 5 % of its profiled device time."""
    cell = copy.deepcopy(run.load_cell(name))
    cell.workload["trace_requests"] = 3
    sp = spans.phase(cell, 2 ** 31 + 77, card)
    requests = sorted(s["start_us"] for s in sp.spans if s["name"] == "request")
    assert len(requests) == 3 and sp.device
    # before the first request only the recorder zeroes its stage clocks
    assert all("Fill" in op for start, _, op in sp.device if start < requests[0])
    outside, first, last = spans.containment(sp)
    assert outside == 0 and first >= 0 and last >= 0
    assert sum(start >= requests[0] for start, _, _ in sp.device) > 3
    if name.startswith("classical"):
        clock = spans.stage_ms(sp, "k2")
        profiled = spans.kernel_ms(sp, kernel_pattern("k2"))
        assert clock == pytest.approx(profiled, rel=0.05), (clock, profiled)
