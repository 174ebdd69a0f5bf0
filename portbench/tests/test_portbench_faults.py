"""A run at a tiny size on the CPU, past the look for a card, with the
timed path broken underneath: ``correct`` comes out false for every fault
the cell can have, and for the control (the program's own lower-precision
path, or the reference one precision lower, in the program's place). The
sound program comes out correct. Neither cell spans chips, so no exchange
between chips can be left out; the flagship's batch of one cannot lose
half of itself, but one channel or one row of any of its modules can go
wrong."""

import numpy as np
import pytest
import torch

from portbench import run
from portbench.systems import classical_restorer, model_restorer

CPU = torch.device("cpu")


def _run(cell, seed=3, control=False):
    return run.run_cell(cell, seed, 0.3, False, CPU, control=control)


def _wrap(monkeypatch, system, fault):
    """Make ``system.program`` return its entry with ``fault(apply)``
    in place of its apply."""
    program = system.program

    def broken(*args, **kwargs):
        entry = program(*args, **kwargs)
        entry.apply = fault(entry.apply)
        return entry

    monkeypatch.setattr(system, "program", broken)


def unchanged(apply):
    return lambda batch: np.array(batch, copy=True)


def half_left_out(apply):
    def call(batch):
        out = np.array(batch, copy=True)
        half = len(batch) // 2
        out[:half] = apply(batch[:half])
        return out
    return call


def altered(apply):
    """One value of the host answer changed as it is produced."""
    def call(batch):
        out = np.array(apply(batch), copy=True)
        out[0, 0, 0, 0] += 0.01
        return out
    return call


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
def test_classical_faults(fault, tiny, monkeypatch):
    _wrap(monkeypatch, classical_restorer, fault)
    assert _run(tiny("classical_c1.fixed200"))["correct"] is False


def test_flagship_admm_layer_returns_its_state(tiny, monkeypatch):
    from torch_admm_deconv_tpu_torch.models import admm_deconv

    monkeypatch.setattr(admm_deconv, "admm_tv", lambda x, *args, **kwargs: x)
    result = _run(tiny("flagship.eval_b1"))
    assert result["correct"] is False and result["checks"]["admm_gap"]["value"] > 1e-2


def one_channel(out):
    """One output channel of a module off by 1 %."""
    out = out.clone()
    out[:, 5] *= 1.01
    return out


def border_row(out):
    """The last row of a module's output lost, as a padding fault would."""
    out = out.clone()
    out[..., -1, :] = 0.0
    return out


@pytest.mark.parametrize("module,fault", [
    ("block_1.conv_0", one_channel), ("block_1.conv_1", one_channel),
    ("block_1.conv_0", border_row), ("block_0.cbam_1.spatial_gate", border_row),
    ("block_1.convout", border_row), ("sca_0", one_channel)])
def test_flagship_module_fault(module, fault, tiny, monkeypatch):
    """A fault confined to one channel or one row of one module's output."""
    program = model_restorer.program

    def broken(*args, **kwargs):
        entry = program(*args, **kwargs)
        entry.model.get_submodule(module).register_forward_hook(lambda m, a, out: fault(out))
        return entry

    monkeypatch.setattr(model_restorer, "program", broken)
    assert _run(tiny("flagship.eval_b1"))["correct"] is False


def test_flagship_answer_altered(tiny, monkeypatch):
    _wrap(monkeypatch, model_restorer, altered)
    result = _run(tiny("flagship.eval_b1"))
    assert result["correct"] is False and result["checks"]["wiring_gap"]["value"] > 0


@pytest.mark.parametrize("name", ["classical_c1.fixed200", "flagship.eval_b1"])
def test_sound_program_and_control(name, tiny):
    assert _run(tiny(name))["correct"] is True
    assert _run(tiny(name), control=True)["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("name", ["classical_c1.fixed200", "flagship.eval_b1"])
def test_control_fails_at_the_cells_size_on_the_card(name, card):
    """The control at the cell's own sizes and load on three seeds."""
    cell = run.load_cell(name)
    for seed in (1, 2, 3):
        assert run.run_cell(cell, seed, 2.0, False, card, control=True)["correct"] is False
