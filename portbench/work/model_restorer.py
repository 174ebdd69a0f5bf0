"""Work of one request of the model restorer: the convolutions and linear
layers of the model's plain reference, counted by
``torch.utils.flop_counter`` on the meta device at the request's shape (no
data, no device), and its ADMM layers, each one fixed-iteration solve of
the request's planes (K2), counted on the FFT basis (``work/solves.py``)."""

from __future__ import annotations

import importlib

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.work.solves import add, fixed_solve, flops


def count(config: dict, mix: dict, args: dict) -> dict:
    ref = importlib.import_module(f"portbench.reference.{config['reference']}")
    model = config["model"]
    weights = {name: torch.empty(shape, device="meta")
               for name, shape, _ in ref.weight_shapes(model)}
    x = torch.empty((mix["batch"], mix["channels"], mix["size"], mix["size"]), device="meta")
    with FlopCounterMode(display=False) as counter:
        ref.forward(weights, x, model, admm=lambda w, p, v, cfg: v)
    admm = model["admm"]
    n_layers = model["level_branches"][0]
    solves = [fixed_solve(mix["batch"] * mix["channels"], mix["size"], mix["size"],
                          admm["max_iters"]) for _ in range(n_layers)]
    k2 = add(*solves)
    return {"flops": counter.get_total_flops() + flops(k2),
            "kernels": {"k2": k2}}
