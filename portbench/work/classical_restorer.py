"""Work of one request of the classical restorer: one fixed-iteration
solve (K2) of the request's batch. Its useful flops are the solve's."""

from __future__ import annotations

from portbench.work.solves import fixed_solve, flops


def count(config: dict, mix: dict, args: dict) -> dict:
    """{'flops': useful flops a request, 'kernels': {name: work}}."""
    solve = fixed_solve(mix["batch"] * mix["channels"], mix["size"], mix["size"], args["maxit"])
    return {"flops": flops(solve), "kernels": {"k2": solve}}
