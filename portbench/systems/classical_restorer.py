"""The classical batch restorer: ``infer.classical_restorer(...)``'s apply,
a host batch in and a host batch out, through ``admm_tv``'s dispatch.

The configuration states the problem (PSF, lambda, rho, iso, precision);
the cell's ``args`` give ``maxit``. The benchmark makes the PSF and hands
the same one to the traffic, the program and the reference.

An answer is checked against the reference solve in float64 of the same
batch: ``max_gap`` is the largest absolute difference of any pixel.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import classical as ref
from portbench.systems import set_precision


class Entry:
    """A callable batch -> answer; the check needs nothing but the answer."""

    def __init__(self, apply):
        self.apply = apply

    def __call__(self, batch):
        return self.apply(batch)

    def keep_next(self):
        pass

    def kept(self):
        return None


def make_shared(config: dict, seed: int, device) -> dict:
    return {"psf": ref.psf_from_config(config["psf"]).numpy().astype(np.float32)}


def program(config: dict, args: dict, shared: dict, device) -> Entry:
    from torch_admm_deconv_tpu_torch.infer import classical_restorer

    set_precision(config)
    return Entry(classical_restorer(lmbd=config["lmbd"], rho=config["rho"], maxit=args["maxit"],
                                    iso=config["iso"], kern=shared["psf"], device=device))


def control(config: dict, args: dict, shared: dict, device) -> Entry:
    """The program's own lower-precision path: the same apply through
    ``admm_tv`` on the whole-solve kernel with ``precision='mixed'`` (bf16
    transforms, then an exact tail) where the configuration states
    float32 ('high')."""
    from torch_admm_deconv_tpu_torch.ops.solver import admm_tv

    set_precision(config)
    kern = torch.as_tensor(shared["psf"], device=device)

    def apply(batch):
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(batch), device=device)
            out = admm_tv(x, config["lmbd"], config["rho"], kern, iso=config["iso"],
                          maxit=args["maxit"], use_pallas=True, precision="mixed", device=device)
            return out.cpu().numpy()

    return Entry(apply)


def check(config: dict, args: dict, shared: dict, batch, answer, kept, device, memo: dict) -> dict:
    """The numbers compared for one answer; ``memo`` holds what was worked
    out for the same batch before."""
    if "ref" not in memo:
        y = torch.as_tensor(np.asarray(batch), device=device).to(torch.float64)
        kern = torch.as_tensor(shared["psf"], dtype=torch.float64)
        memo["ref"] = ref.solve(y, config["lmbd"], config["rho"], kern, args["maxit"],
                                config["iso"])
    gap = (torch.as_tensor(answer, device=device).to(torch.float64) - memo["ref"]).abs()
    return {"max_gap": float(gap.max())}
