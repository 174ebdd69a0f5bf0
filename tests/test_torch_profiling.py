"""The port's timing helpers (``utils/profiling.py``), mirroring
tests/test_profiling.py: sleep-based "solvers" drive the statistics (the
A/B-interleaved median, the spread band, the non-positive-subtraction
fallback, the loud unreliable flag) without a device; the other helpers on
CPU tensors."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from torch_admm_deconv_tpu_torch.ops.solver import admm_tv_adaptive
from torch_admm_deconv_tpu_torch.utils import get_abs_path, get_x_y_paths
from torch_admm_deconv_tpu_torch.utils.profiling import (
    StepTimer,
    TimingResult,
    chained_throughput,
    iter_scaling_throughput,
    robust_iter_timing,
    solver_stats,
    timed_fetch,
    trace,
)

_OUT = torch.zeros(1)


def _sleeping_solver(per_iter_s: float, overhead_s: float = 0.0):
    """solver_of_maxit whose call time is overhead + maxit*per_iter."""

    def of_maxit(m):
        def fn(x):
            time.sleep(overhead_s + m * per_iter_s)
            return _OUT

        return fn

    return of_maxit


def test_clean_measurement_recovers_per_iter_and_overhead():
    res = robust_iter_timing(
        _sleeping_solver(2e-4, overhead_s=5e-3), None, m_small=10, m_big=60, reps=5
    )
    assert isinstance(res, TimingResult)
    assert not res.fallback and not res.unreliable
    assert res.per_iter == pytest.approx(2e-4, rel=0.35)
    assert res.overhead == pytest.approx(5e-3, rel=0.5)
    assert len(res.samples) >= 5
    assert len(res.calibration_ms) >= 3


def test_nonpositive_subtraction_falls_back_loudly():
    def of_maxit(m):
        def fn(x):
            time.sleep(4e-3 if m == 10 else 2e-3)
            return _OUT

        return fn

    res = robust_iter_timing(of_maxit, None, m_small=10, m_big=60, reps=3)
    assert res.fallback
    assert res.per_iter == pytest.approx(2e-3 / 60, rel=0.5)


def test_unreliable_raises_by_default_and_flags_on_request():
    state = {"i": 0}

    def of_maxit(m):
        def fn(x):
            if m == 60:
                state["i"] += 1
                time.sleep(1e-3 if state["i"] % 2 else 3e-2)
            else:
                time.sleep(1e-3)
            return _OUT

        return fn

    with pytest.raises(RuntimeError, match="unreliable"):
        robust_iter_timing(of_maxit, None, m_small=10, m_big=60, reps=4)

    state["i"] = 0
    res = robust_iter_timing(of_maxit, None, m_small=10, m_big=60, reps=4, on_unreliable="flag")
    assert res.unreliable
    assert res.rel_spread > 0.25


def test_step_timer_windowed_rate():
    st = StepTimer(window=4)
    assert st.tick() is None
    for _ in range(6):
        time.sleep(1e-3)
        rate = st.tick()
    assert st.total_steps == 7
    assert rate is not None and rate > 0


def test_timed_fetch_is_the_best_of_its_reps():
    """Best of 3 of a call that sleeps 2, 50 and 50 ms: about 2 ms, far
    under the others even on a loaded host that oversleeps; the result (a
    tuple of tensors and an array) is fetched whole."""
    delays = iter([2e-3, 50e-3, 50e-3])

    def fn(x):
        time.sleep(next(delays))
        return (x, [x * 2]), np.zeros(2)

    t = timed_fetch(fn, torch.ones(3), reps=3)
    assert 2e-3 <= t < 25e-3


def test_chained_throughput_subtracts_the_one_call_chain():
    """(t(6 calls) - t(1 call)) / 5 of a step that sleeps 3 ms is 3 ms."""

    def step(v):
        time.sleep(3e-3)
        return v + 1

    per = chained_throughput(step, torch.zeros(4), chain=6, reps=3)
    assert per == pytest.approx(3e-3, rel=0.35)


def test_iter_scaling_throughput_and_its_fallback():
    per = iter_scaling_throughput(_sleeping_solver(2e-4, 5e-3), None, m_small=10, m_big=60,
                                  reps=3)
    assert per == pytest.approx(2e-4, rel=0.35)

    def of_maxit(m):
        return lambda x: time.sleep(4e-3 if m == 10 else 2e-3)

    per = iter_scaling_throughput(of_maxit, None, m_small=10, m_big=60, reps=3)
    assert per == pytest.approx(2e-3 / 60, rel=0.5)


def test_solver_stats_of_an_adaptive_result():
    x = torch.from_numpy((np.random.default_rng(0).normal(size=(1, 1, 16, 16)) * 0.1 + 0.5)
                         .astype(np.float32))
    res = admm_tv_adaptive(x, 0.05, 1.0, None, maxit=50, tol=1e-3, device="cpu")
    stats = solver_stats(res)
    assert set(stats) == {"iters", "r_norm", "s_norm", "rho"}
    assert stats["iters"] == int(res.iters) and 0 < stats["iters"] <= 50
    assert stats["r_norm"] == float(res.r_norm) and stats["rho"] == float(res.rho)


def test_trace_records_and_exports(tmp_path):
    """The profiler scope sees the ops inside it and writes a Chrome trace."""
    with trace(str(tmp_path / "t")) as prof:
        torch.fft.rfft2(torch.ones(8, 8))
    names = {e.key for e in prof.key_averages()}
    assert any("fft" in n for n in names), names
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0


def test_paths_are_anchored_at_the_package():
    root = get_abs_path("")
    assert root.name == "torch_admm_deconv_tpu_torch"
    x, y = get_x_y_paths("/a", "/b")
    assert (x, y) == (root.parent / "torch_admm_deconv_tpu_torch" / "a",
                      root.parent / "torch_admm_deconv_tpu_torch" / "b")
