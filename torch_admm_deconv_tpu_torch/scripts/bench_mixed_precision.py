"""The 'mixed' (inexact-ADMM) schedule of the whole-solve kernels against
'high', measured on the GPU.

    python -m torch_admm_deconv_tpu_torch.scripts.bench_mixed_precision [--device cpu]

Counterpart of the JAX package's ``scripts/bench_mixed_precision.py``, in
its configuration: (8, 3, 512, 512) uniform in [0.1, 0.9] from ``numpy``
seed 0, lambda 0.05, rho 0.8, anisotropic TV. It measures the card this
runs on, through the port's CUDA kernels K2 (``admm_tv_vmem``) and K3
(``admm_tv_adaptive_vmem``); with ``--device cpu`` it runs their plain
versions. Readings, each printed to stderr as one line:

* K2's cost per iteration in 'high' and 'mixed' from iteration scaling
  (t(1000) - t(200)) / 800, each call ending in a synchronize, and the
  speedup;
* max|mixed - high| after 200 iterations;
* the ``fast_frac`` sweep (0.75, 0.875, 0.9375): deviation from 'high' and
  cost per iteration;
* K3 to tol 1e-3 and 1e-5 in each precision: iterations (the most of any
  block), the marginal cost per iteration from the difference of the two
  solves' synchronized times, and the estimated solve time to 1e-5;

and one line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from torch_admm_deconv_tpu_torch._device import resolve_device
from torch_admm_deconv_tpu_torch.kernels.vmem_solver import admm_tv_adaptive_vmem, admm_tv_vmem
from torch_admm_deconv_tpu_torch.utils.profiling import iter_scaling_throughput, timed_fetch

SHAPE = (8, 3, 512, 512)
LMBD, RHO = 0.05, 0.8
FAST_FRACS = (0.75, 0.875, 0.9375)
TOLS = (1e-3, 1e-5)
MAXIT = 200  # iterations of the deviation readings


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def make_input(shape=SHAPE, seed: int = 0, device=None) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random(shape, dtype=np.float32) * 0.8 + 0.1).to(
        resolve_device(device))


def _fixed(x, maxit, precision="high", fast_frac=0.75):
    return admm_tv_vmem(x, LMBD, RHO, None, iso=False, maxit=maxit, precision=precision,
                        fast_frac=fast_frac, device=x.device)


def fixed_rates(x, m_small: int = 200, m_big: int = 1000) -> dict:
    """Seconds per K2 iteration by precision, from iteration scaling."""
    return {prec: iter_scaling_throughput(lambda m, p=prec: lambda v: _fixed(v, m, p), x,
                                          m_small=m_small, m_big=m_big)
            for prec in ("high", "mixed")}


def mixed_vs_high(x, maxit: int = MAXIT):
    """('high' output, 'mixed' output, max|mixed - high|) after ``maxit``
    iterations."""
    with torch.inference_mode():
        out_hi = _fixed(x, maxit)
        out_mx = _fixed(x, maxit, "mixed")
    return out_hi, out_mx, float((out_mx - out_hi).abs().max())


def fast_frac_sweep(x, out_hi, fracs=FAST_FRACS, maxit: int = MAXIT, m_small: int = 200,
                    m_big: int = 1000) -> list:
    """For each ``fast_frac``: max|mixed - high| after ``maxit`` iterations
    and seconds per iteration."""
    rows = []
    for frac in fracs:
        with torch.inference_mode():
            dev = float((_fixed(x, maxit, "mixed", frac) - out_hi).abs().max())
        per_iter = iter_scaling_throughput(
            lambda m, f=frac: lambda v: _fixed(v, m, "mixed", f).sum(), x,
            m_small=m_small, m_big=m_big)
        rows.append({"fast_frac": frac, "max_diff": dev, "per_iter": per_iter})
    return rows


def adaptive_readings(x, precision: str, tols=TOLS, maxit: int = 2000, reps: int = 3) -> dict:
    """K3 to each tolerance: the most iterations of any block, the largest
    exit residuals, and the best-of-``reps`` synchronized solve time; then
    the marginal seconds per iteration between the two tolerances and the
    estimated solve time to the last one."""
    def solve(v, tol):
        return admm_tv_adaptive_vmem(v, LMBD, RHO, None, iso=False, maxit=maxit, tol=tol,
                                     precision=precision, device=v.device)

    out = {"precision": precision, "iters": {}, "r_max": {}, "s_max": {}, "solve_s": {}}
    for tol in tols:
        res = solve(x, tol)
        out["iters"][tol] = int(res.iters.max())
        out["r_max"][tol] = float(res.r_norm.max())
        out["s_max"][tol] = float(res.s_norm.max())
        out["solve_s"][tol] = timed_fetch(lambda v, t=tol: solve(v, t).x, x, reps=reps)
    lo, hi = tols[0], tols[-1]
    extra = out["iters"][hi] - out["iters"][lo]
    out["per_iter"] = (out["solve_s"][hi] - out["solve_s"][lo]) / max(extra, 1)
    out["est_solve_s"] = out["iters"][hi] * out["per_iter"]
    return out


def study(x, m_small: int = 200, m_big: int = 1000, maxit: int = MAXIT,
          adaptive_maxit: int = 2000) -> dict:
    """Every reading of the study on ``x``, and under ``outputs`` K2's
    'high' and 'mixed' solves after ``maxit`` iterations."""
    rates = fixed_rates(x, m_small, m_big)
    out_hi, out_mx, diff = mixed_vs_high(x, maxit)
    return {"per_iter": rates, "mixed_vs_high": diff,
            "outputs": {"high": out_hi, "mixed": out_mx},
            "fast_frac": fast_frac_sweep(x, out_hi, maxit=maxit, m_small=m_small, m_big=m_big),
            "adaptive": {prec: adaptive_readings(x, prec, maxit=adaptive_maxit)
                         for prec in ("high", "mixed")}}


def report_lines(r: dict) -> list:
    """The study's readings as the JAX script prints them."""
    rates = {prec: 1.0 / t for prec, t in r["per_iter"].items()}
    lines = [f"fixed[{prec}]: {r['per_iter'][prec] * 1e6:.1f} us/iter = {rates[prec]:.0f} it/s"
             for prec in ("high", "mixed")]
    lines.append(f"fixed mixed/high speedup: {rates['mixed'] / rates['high']:.2f}x")
    lines.append(f"fixed mixed-vs-high max|diff| at 200 iters = {r['mixed_vs_high']:.2e}")
    for row in r["fast_frac"]:
        lines.append(f"fast_frac={row['fast_frac']}: max|diff| vs high = {row['max_diff']:.2e}, "
                     f"{row['per_iter'] * 1e6:.2f} us/iter = {1 / row['per_iter']:.0f} it/s")
    for prec, a in r["adaptive"].items():
        lines.append(f"adaptive[{prec}]: iters(1e-3)={a['iters'][1e-3]} "
                     f"iters(1e-5)={a['iters'][1e-5]}, marginal {a['per_iter'] * 1e6:.1f} us/iter; "
                     f"est solve-only t(1e-5) ~ {a['est_solve_s'] * 1e3:.1f} ms")
    return lines


def main(argv=None):
    p = argparse.ArgumentParser(description="'mixed' against 'high' on the whole-solve kernels")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    from torch_admm_deconv_tpu_torch.scripts.megapixel_bench import card_name_and_power_limit

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    log(f"card: {card_name_and_power_limit(dev)}")
    for line in report_lines(study(make_input(device=dev))):
        log(line)


if __name__ == "__main__":
    main()
