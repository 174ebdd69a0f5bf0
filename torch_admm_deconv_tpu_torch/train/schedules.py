"""LR schedules: cosine annealing with warm restarts.

Counterpart of torch_admm_deconv_tpu/train/schedules.py (:16-35). The
reference trains with torch's CosineAnnealingWarmRestarts(T_0=15000,
eta_min=1e-11); here it is a function from step to LR, computed on the host:
lr(t) = eta_min + (base - eta_min) * (1 + cos(pi * t_cur / T_i)) / 2 with
T_i = T_0 * T_mult^i and t_cur the steps since the last restart.
"""

from __future__ import annotations

import math


def cosine_annealing_warm_restarts(base_lr: float, t_0: int, t_mult: int = 1,
                                   eta_min: float = 0.0):
    """Returns a schedule fn: step -> lr (torch semantics, T_mult >= 1)."""

    def schedule(step) -> float:
        step = float(step)
        if t_mult == 1:
            t_cur = math.fmod(step, t_0)
            t_i = float(t_0)
        else:
            # closed form for the geometric restart index
            n = math.floor(math.log1p((t_mult - 1.0) * step / t_0) / math.log(float(t_mult)))
            start = t_0 * (t_mult**n - 1.0) / (t_mult - 1.0)
            t_cur = step - start
            t_i = t_0 * (float(t_mult) ** n)
        return eta_min + (base_lr - eta_min) * (1.0 + math.cos(math.pi * t_cur / t_i)) / 2.0

    return schedule
