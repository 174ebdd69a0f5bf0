"""The model restorer: ``infer.model_restorer(state_dict, model)``'s apply,
a host batch in and a host batch out, as the eval harness's model column
and the serving path call it.

The configuration names the plain reference of its model
(``reference/<reference>.py``), whose ``weight_shapes`` lists the model's
state dict, and the program's factory of the same model. The benchmark
draws that dict on the device from the seed and hands the same tensors to
the program and to the reference.

The model's statistics take a mode (the most frequent value, ties toward
the smallest) over the channels of each pixel in every spatial gate, and
over the pixels of each channel in every channel-wise attention. A mode
jumps where two values tie exactly, so a difference in the last bit
upstream moves it, and with it a whole plane, as far as a lower precision
does. The check therefore follows the program module by module and takes
every mode from the program's own values: for a sampled request the entry
records each ADMM layer's, block's and attention's input and output, and
each spatial gate's input (forward hooks on the timed model). The
reference recomputes each ADMM layer from the network input; each block's
branches from the block's recorded input up to their channel gates, which
it holds against the spatial gates' recorded inputs; the rest of each block
from those inputs, held against the block's output; and each attention
from its recorded input. No mode is then taken from values the reference
computed itself, so every gap is one of rounding and the largest over all
of an output's elements is compared. Numbers, the largest over the sampled
requests:
  admm_gap    largest absolute difference of an ADMM layer's output from
              the reference loop on the same input (the K2 solve)
  stage_gap   largest, over every part held (a branch up to its channel
              gate, a block's rest, an attention), of the largest absolute
              difference from the reference over the mean absolute value
              of the reference's
  wiring_gap  largest absolute difference of a module's input from what
              the model feeds it (the network input, the
              outputs before it), and of the answer from the last module's
              output: exact
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from portbench.systems import set_precision
from portbench.traffic import MASK64


def _reference(config):
    return importlib.import_module(f"portbench.reference.{config['reference']}")


class Entry:
    """A callable batch -> answer that, after ``keep_next``, records each
    named module's (input, output), or (input, None), of its next call."""

    def __init__(self, apply, names):
        self.apply, self.names = apply, names
        self._keep, self._rec, self._kept = False, {}, None

    def hook(self, name, input_only=False):
        def record(module, args, out):
            if self._keep:
                self._rec[name] = (args[0], None if input_only else out)
        return record

    def __call__(self, batch):
        out = self.apply(batch)
        if self._keep:
            self._kept, self._rec, self._keep = self._rec, {}, False
        return out

    def keep_next(self):
        self._keep, self._rec = True, {}

    def kept(self):
        return self._kept


def make_shared(config: dict, seed: int, device) -> dict:
    """The weights, drawn on ``device`` from the seed in two calls (one
    normal, one uniform draw for all of them), as float32."""
    shapes = _reference(config).weight_shapes(config["model"])
    sizes = [int(np.prod(s)) for _, s, _ in shapes]
    gen = torch.Generator(device=device).manual_seed(seed & MASK64)
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    weights, at = {}, 0
    for (name, shape, (dist, scale)), n in zip(shapes, sizes):
        if dist == "normal":
            v = normal[at : at + n] * scale
        elif dist == "uniform":
            v = (uniform[at : at + n] * 2.0 - 1.0) * scale
        elif dist == "range":
            lo, hi = scale
            v = lo + (hi - lo) * uniform[at : at + n]
        elif dist == "ones":
            v = torch.ones(n, device=device)
        elif dist == "zeros":
            v = torch.zeros(n, device=device)
        else:
            raise ValueError(f"unknown distribution {dist!r} for {name}")
        weights[name] = v.reshape(shape).clone()
        at += n
    return {"weights": weights}


def _names(config) -> list:
    ref = _reference(config)
    return ref.stage_names(config["model"]) + ref.gate_names(config["model"])


def program(config: dict, args: dict, shared: dict, device) -> Entry:
    from torch_admm_deconv_tpu_torch import models
    from torch_admm_deconv_tpu_torch.infer import model_restorer

    set_precision(config)
    factory = config["program_model"]
    model = getattr(models, factory["factory"])(**factory["args"], device=device)
    entry = Entry(None, _names(config))
    gates = set(_reference(config).gate_names(config["model"]))
    for name in entry.names:
        model.get_submodule(name).register_forward_hook(entry.hook(name, name in gates))
    entry.apply = model_restorer(shared["weights"], model=model, device=device)
    entry.model = model
    return entry


def control(config: dict, args: dict, shared: dict, device) -> Entry:
    """The reference with every convolution's and linear layer's operands,
    and its ADMM layers' transforms, in TF32."""
    ref = _reference(config)
    set_precision(config)
    weights = shared["weights"]
    entry = Entry(None, _names(config))

    def apply(batch):
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(batch), device=device)
            rec = {} if entry._keep else None
            out = ref.forward(weights, x, config["model"], conv=ref.tf32_conv,
                              admm=ref.tf32_admm, record=rec)
            if rec is not None:
                entry._rec = rec
            return out.cpu().numpy()

    entry.apply = apply
    return entry


def _rel(out, ref) -> float:
    return float((out - ref).abs().max() / ref.abs().mean())


def check(config: dict, args: dict, shared: dict, batch, answer, kept, device, memo: dict) -> dict:
    """The numbers compared for one answer and what its call recorded."""
    ref = _reference(config)
    cfg, w = config["model"], shared["weights"]
    names = ref.stage_names(cfg)
    if kept is None or set(kept) != set(_names(config)):
        raise RuntimeError(f"the entry recorded {sorted(kept or ())}, not {_names(config)}")
    outputs = {name: kept[name][1] for name in names}
    with torch.inference_mode():
        x = torch.as_tensor(np.asarray(batch), device=device)
        wiring = float((torch.as_tensor(answer, device=device) - outputs[names[-1]]).abs().max())
        admm_gap = 0.0
        per_stage = {}
        for name in names:
            v, out = kept[name]
            wiring = max(wiring, float((v - ref.stage_input(cfg, name, outputs, x)).abs().max()))
            if ".admm_" in name:
                if name not in memo:
                    memo[name] = ref.stage(w, cfg, name, x)
                admm_gap = max(admm_gap, float((out - memo[name]).abs().max()))
                continue
            if name.startswith("sca"):
                per_stage[name] = _rel(out, ref.stage(w, cfg, name, v))
                continue
            # the branches from the block's own input (block 0's from the
            # program's ADMM outputs), then the rest from the gates' inputs
            vs, gates = ref.branch_gates(w, cfg, name, v, admm=lambda w_, p, v_, c: outputs[p])
            held = [kept[ref.gate_name(name, j)][0] for j in range(len(vs))]
            gap = max(_rel(g, r) for g, r in zip(held, gates))
            per_stage[name] = max(gap, _rel(out, ref.tail(w, cfg, name, vs, held)))
    return {"admm_gap": admm_gap, "stage_gap": max(per_stage.values()), "wiring_gap": wiring,
            **{f"stage_gap.{k}": g for k, g in per_stage.items()}}
