"""Epoch metric bookkeeping for the trainer.

Counterpart of torch_admm_deconv_tpu/train/logger.py, pure Python, with the
reference's reporting semantics:

* the epoch PSNR is derived from the epoch-MEAN MSE,
  ``10*log10(max^2 / mean_mse)``, rather than averaging per-step PSNRs;
* requesting PSNR implicitly tracks MSE;
* the CSV/log columns are ``{phase}_{metric}`` lists of per-epoch values;
* non-finite step values are counted and excluded from the epoch mean.

Per-metric streaming accumulators (running sum + count) feed a phase-keyed
epoch history; the trainer folds in sums it kept on the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence


def psnr_compute(mse: float, max_val: float = 1.0) -> float:
    """PSNR from a (mean) MSE — the reference's module-level helper."""
    return float(10.0 * math.log10(max_val**2 / mse))


@dataclass
class _Stream:
    """Streaming mean of one metric over the steps of the current epoch.

    Non-finite values are counted separately and EXCLUDED from the mean, so
    a single NaN step cannot poison the epoch average. The mean is NaN only
    when every pushed value was non-finite.
    """

    total: float = 0.0
    count: int = 0
    nonfinite: int = 0

    def push(self, value: float) -> None:
        v = float(value)
        if math.isfinite(v):
            self.total += v
            self.count += 1
        else:
            self.nonfinite += 1

    def push_sum(self, total: float, finite_count: int, nonfinite: int = 0) -> None:
        """Fold a pre-accumulated (device-side) sum into the stream."""
        self.total += float(total)
        self.count += int(finite_count)
        self.nonfinite += int(nonfinite)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")


class MetricsLogger:
    """Accumulates per-step metric values; rolls them into per-phase epoch
    averages on ``logger(phase)``.

    Trainer contract: ``reinit_step_stats()`` at phase start,
    ``update_step_metric_val(name, v)`` per step, ``logger(phase)`` at phase
    end, then ``get_avg_metrics(phase)`` / ``get_logged()`` to read back.
    """

    PHASES = ("train", "eval")

    def __init__(self, loss, metrics: Sequence):
        names = [loss.m_name] + [m.m_name for m in metrics]
        if "psnr" in names and "mse" not in names:
            # reference quirk kept: PSNR implies MSE tracking
            names.append("mse")
        self.tracked: List[str] = names
        self.history: Dict[str, Dict[str, List[float]]] = {
            phase: {n: [] for n in names} for phase in self.PHASES
        }
        self._streams: Dict[str, _Stream] = {}
        self.reinit_step_stats()

    # -- step-level ------------------------------------------------------
    def reinit_step_stats(self) -> None:
        self._streams = {n: _Stream() for n in self.tracked}

    def update_step_metric_val(self, metric_name: str, metric_val: float) -> None:
        self._streams[metric_name].push(metric_val)

    def push_step_sums(self, sums: Dict[str, float], finite_counts: Dict[str, int]) -> None:
        """Fold per-epoch on-device accumulator results (sum of finite step
        values + finite count per metric) into the current streams. Used by
        the trainer to avoid per-step host syncs."""
        for name, total in sums.items():
            if name in self._streams:
                self._streams[name].push_sum(total, finite_counts.get(name, 0))

    # -- epoch-level -----------------------------------------------------
    def __call__(self, phase: str = "train") -> None:
        """Close the current phase: append each metric's epoch value."""
        epoch = self.history[phase]
        for name, stream in self._streams.items():
            if name == "psnr" and self._streams["mse"].count:
                # PSNR from the epoch-mean MSE
                epoch[name].append(psnr_compute(self._streams["mse"].mean))
            else:
                epoch[name].append(stream.mean)

    def get_avg_metrics(self, phase: str) -> Dict[str, float]:
        return {n: vals[-1] for n, vals in self.history[phase].items() if vals}

    def get_logged(self, reformat: bool = True) -> dict:
        if not reformat:
            return self.history
        return {
            f"{phase}_{name}": vals
            for phase, per_metric in self.history.items()
            for name, vals in per_metric.items()
        }

    # -- compat ----------------------------------------------------------
    @property
    def metrics(self) -> Dict[str, Dict[str, List[float]]]:
        """Reference-named alias for the epoch history."""
        return self.history
