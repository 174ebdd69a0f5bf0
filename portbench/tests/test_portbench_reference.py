"""The plain references against the port's plain CPU path at tiny shapes,
and the check's numbers for a sound answer."""

import numpy as np
import torch

from portbench import traffic
from portbench.reference import classical, flagship
from portbench.systems import classical_restorer, model_restorer


def _batch(seed, b=2, size=24):
    mix = {"batch": b, "channels": 3, "size": size, "pool": 1, "scene": "blocks",
           "noise_sigma": 0.02, "clip": [0.0, 1.0]}
    return torch.from_numpy(traffic.make_pool(mix, seed)[0])


def test_classical_reference_is_the_ports_loop():
    from torch_admm_deconv_tpu_torch.ops.solver import admm_tv

    y = _batch(1)
    psf = classical.gaussian_psf(9, 1.5)
    for iso in (False, True):
        ref = classical.solve(y.double(), 0.002, 0.5, psf, 15, iso)
        port = admm_tv(y, 0.002, 0.5, psf.float(), iso=iso, maxit=15, device="cpu")
        assert float((port.double() - ref).abs().max()) < 2e-6


def test_classical_tf32_control_is_coarser_than_float32():
    y = _batch(2)
    psf = classical.gaussian_psf(9, 1.5)
    ref = classical.solve(y.double(), 0.002, 0.5, psf, 20, False)
    f32 = classical.solve(y, 0.002, 0.5, psf, 20, False)
    low = classical.solve_tf32(y, 0.002, 0.5, psf, 20, False)
    gap32 = float((f32.double() - ref).abs().max())
    gap_tf32 = float((low.double() - ref).abs().max())
    assert gap32 < 1e-5 and gap_tf32 > 100 * gap32


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -12, -(1.0 + 3 * 2 ** -11), 3.0])
    assert classical.tf32(x).tolist() == [1.0 + 2 ** -10, 1.0, -(1.0 + 2 ** -9), 3.0]


def _flagship_config():
    from portbench.run import load_cell

    return load_cell("flagship.eval_b1").config


def test_flagship_reference_forward_is_the_ports_forward_module_by_module():
    """The port on the CPU (its ADMM layers on K2's plain version) through
    the check: each module recomputed from the port's own input agrees,
    the ADMM layers within float32 rounding, the wiring exactly."""
    config = _flagship_config()
    shared = model_restorer.make_shared(config, 7, torch.device("cpu"))
    entry = model_restorer.program(config, {}, shared, torch.device("cpu"))
    x = _batch(3, b=1, size=24).numpy()
    entry.keep_next()
    answer = entry(x)
    numbers = model_restorer.check(config, {}, shared, x, answer, entry.kept(), "cpu", {})
    assert numbers["admm_gap"] < 1e-5
    assert numbers["stage_gap"] < 1e-6
    assert numbers["wiring_gap"] == 0.0
    # the whole reference forward in the loop's own arithmetic, for scale
    full = flagship.forward(shared["weights"], torch.from_numpy(x), config["model"])
    assert full.shape == answer.shape and float((full - torch.from_numpy(answer)).abs().max()) < 0.1


def test_classical_check_of_a_sound_answer():
    config = {"psf": {"kind": "gaussian", "size": 9, "sigma": 1.5}, "lmbd": 0.002, "rho": 0.5,
              "iso": False, "precision": "float32"}
    shared = classical_restorer.make_shared(config, 0, "cpu")
    entry = classical_restorer.program(config, {"maxit": 10}, shared, torch.device("cpu"))
    x = _batch(4).numpy()
    numbers = classical_restorer.check(config, {"maxit": 10}, shared, x, entry(x), None, "cpu", {})
    assert numbers["max_gap"] < 1e-5
    assert np.isfinite(numbers["max_gap"])
