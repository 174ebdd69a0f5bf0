"""Device-time breakdown of one flagship forward, or one training step, on
the GPU.

    python -m torch_admm_deconv_tpu_torch.trace_forward [--train]

Builds the flagship DivergentRestorer (weights from ``torch.Generator``
seed 0). Without ``--train``: ``use_pallas=True``, one warm-up forward on a
(1, 3, 256, 256) tile, then one forward under ``torch.profiler``. With
``--train``: the training configuration (unrolled 'compat' ADMM layers
under remat) on a (3, 3, 256, 256) batch, one warm-up step, then one step
under the profiler in four stages, each ending in a synchronize: forward,
loss (``SSIMLabColorLoss``), backward, and the update (gradient clip, AdamW,
clamp). Prints one JSON line: the wall time by CUDA events, the summed
device time of the kernels by group (the port's ADMM kernels, the gates'
channel pool, FFTs, convolutions, sorts, other), the device busy share
(summed kernel time over the wall time; one stream, so kernels do not
overlap), the longest kernels and, with ``--train``, the same per stage.
Fails without a GPU.
"""

from __future__ import annotations

import argparse
import json
import re
import sys

import numpy as np
import torch

GROUPS = (
    ("admm_kernels", re.compile(r"k2_persistent|k3_persistent")),
    ("channel_pool", re.compile(r"channel_pool")),
    ("fft", re.compile(r"fft", re.I)),
    ("convolution", re.compile(r"conv|cudnn|xmma|implicit|winograd|fprop|wgrad|dgrad", re.I)),
    ("sort", re.compile(r"sort|radix", re.I)),
)
STAGES = ("forward", "loss", "backward", "update")


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def _grouped(kernels) -> dict:
    groups = {name: 0.0 for name, _ in GROUPS}
    groups["other"] = 0.0
    for key, ms in kernels:
        groups[next((name for name, pat in GROUPS if pat.search(key)), "other")] += ms
    return groups


def _train_step(dev):
    """One training step of the flagship, in the four stages of STAGES."""
    from torch_admm_deconv_tpu_torch.metrics import SSIMLabColorLoss
    from torch_admm_deconv_tpu_torch.models.denoiser import flagship_divergent_restorer
    from torch_admm_deconv_tpu_torch.models.regularizers import (
        clip_grads_by_value,
        train_weight_clipper,
    )
    from torch_admm_deconv_tpu_torch.train import make_optimizer

    model = flagship_divergent_restorer(device=dev, generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(8.8e-4)(model.parameters())
    loss_fn = SSIMLabColorLoss()
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.random((3, 3, 256, 256), dtype=np.float32)).to(dev)
    x = (y + 15.0 / 255.0 * torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
         .to(dev)).clamp(0.0, 1.0)
    state = {}

    def stage(name):
        if name == "forward":
            opt.zero_grad(set_to_none=False)
            state["out"] = model(x)
        elif name == "loss":
            state["loss"] = loss_fn(state["out"], y)
        elif name == "backward":
            state["loss"].backward()
        else:
            clip_grads_by_value(model.parameters(), 1.0)
            opt.step()
            train_weight_clipper(model)

    return stage


def main(argv=None) -> int:
    from torch_admm_deconv_tpu_torch._device import resolve_device
    from torch_admm_deconv_tpu_torch.models.denoiser import flagship_divergent_restorer

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--train", action="store_true",
                        help="trace one training step at batch 3 instead of a forward")
    args = parser.parse_args(argv)
    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if args.train:
        stage = _train_step(dev)
        for name in STAGES:  # warm-up step
            stage(name)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.profiler.profile(activities=acts) as prof:
            start.record()
            for name in STAGES:
                with torch.profiler.record_function(name):
                    stage(name)
                    torch.cuda.synchronize()
            end.record()
            end.synchronize()
    else:
        model = flagship_divergent_restorer(remat=False, use_pallas=True, device=dev,
                                            generator=torch.Generator().manual_seed(0)).eval()
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.random((1, 3, 256, 256), dtype=np.float32)).to(dev)
        with torch.inference_mode():
            model(x)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                start.record()
                model(x)
                end.record()
                end.synchronize()
    wall_ms = start.elapsed_time(end)
    card = torch.autograd.DeviceType.CUDA
    # the stage labels also appear as device-side ranges: not kernels
    kernels = [(e.key, _device_us(e) / 1e3, e.count) for e in prof.key_averages()
               if _device_us(e) > 0 and e.device_type == card and e.key not in STAGES]
    busy = sum(ms for _, ms, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:12]
    result = {
        "device": torch.cuda.get_device_name(0),
        "mode": "train_step" if args.train else "forward",
        "wall_ms": wall_ms,
        "device_busy_ms": busy,
        "device_busy_share": busy / wall_ms if wall_ms else None,
        "groups_ms": _grouped([(k, ms) for k, ms, _ in kernels]),
        "top_kernels": [{"name": k[:120], "ms": ms, "calls": n} for k, ms, n in top],
    }
    if args.train:
        # a stage's kernels are the device events that start inside its
        # labelled range, which ends in a synchronize
        events = prof.events()
        cpu = torch.autograd.DeviceType.CPU
        stages = {}
        for name in STAGES:
            rng_ = next(e.time_range for e in events if e.name == name and e.device_type == cpu)
            inside = [e for e in events if e.device_type == card and e.name not in STAGES
                      and rng_.start <= e.time_range.start <= rng_.end]
            stage_busy = sum(e.time_range.elapsed_us() for e in inside) / 1e3
            stage_wall = (rng_.end - rng_.start) / 1e3
            stages[name] = {"wall_ms": stage_wall, "device_busy_ms": stage_busy,
                            "device_busy_share": stage_busy / stage_wall if stage_wall else None,
                            "kernels": len(inside),
                            "groups_ms": _grouped([(e.name, e.time_range.elapsed_us() / 1e3)
                                                   for e in inside])}
        result["stages"] = stages
        result["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
