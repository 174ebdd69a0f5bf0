"""Device-time breakdown of one flagship forward on the GPU.

    python -m torch_admm_deconv_tpu_torch.trace_forward

Builds the flagship DivergentRestorer (weights from ``torch.Generator``
seed 0, ``use_pallas=True``), runs one warm-up forward on a (1, 3, 256, 256)
tile, then one forward under ``torch.profiler``, and prints one JSON line:
the forward's wall time by CUDA events, the summed device time of its
kernels by group (the port's ADMM kernels, convolutions, sorts, other), the
device busy share (summed kernel time over the wall time; one stream, so
kernels do not overlap), and the longest kernels. Fails without a GPU.
"""

from __future__ import annotations

import json
import re
import sys

import numpy as np
import torch

GROUPS = (
    ("admm_kernels", re.compile(r"k2_persistent|k3_persistent")),
    ("convolution", re.compile(r"conv|cudnn|xmma|implicit|winograd|fprop|wgrad|dgrad", re.I)),
    ("sort", re.compile(r"sort|radix", re.I)),
)


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def main() -> int:
    from torch_admm_deconv_tpu_torch._device import resolve_device
    from torch_admm_deconv_tpu_torch.models.denoiser import flagship_divergent_restorer

    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = flagship_divergent_restorer(remat=False, use_pallas=True, device=dev,
                                        generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((1, 3, 256, 256), dtype=np.float32)).to(dev)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.profiler.profile(activities=acts) as prof:
            start.record()
            model(x)
            end.record()
            end.synchronize()
    wall_ms = start.elapsed_time(end)
    kernels = [(e.key, _device_us(e) / 1e3, e.count) for e in prof.key_averages()
               if _device_us(e) > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    groups = {name: 0.0 for name, _ in GROUPS}
    groups["other"] = 0.0
    for key, ms, _ in kernels:
        group = next((name for name, pat in GROUPS if pat.search(key)), "other")
        groups[group] += ms
    busy = sum(ms for _, ms, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:12]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "forward_wall_ms": wall_ms,
        "device_busy_ms": busy,
        "device_busy_share": busy / wall_ms if wall_ms else None,
        "groups_ms": groups,
        "top_kernels": [{"name": k[:120], "ms": ms, "calls": n} for k, ms, n in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
