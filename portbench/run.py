"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Everything is found by name: the cell in
``BENCHMARK.json``, its file ``workloads/<cell>.json`` (the entry, its
arguments, the warm-up, the sample the check compares and the limits), its
configuration's file, its traffic mix ``traffic/<mix>.json`` (made into
requests by ``traffic.py``), the entry's adapter ``systems/<entry>.py``,
its work count ``work/<entry>.py`` and one reader ``metrics/<metric>.py``
per metric (a metric split by cell, ``<quantity>.<suffix>``, may read as
its quantity).

One client sends the mix's requests back to back (a closed loop) for
``--seconds``: a host batch in, the answer back on the host. Set-up (the
process's start to the first timed request: imports, the card, the kernel
libraries, weights and inputs from the seed, the warm-up of the cell's own
shapes) is timed apart. With ``--trace 1`` the loop runs under
``torch.profiler`` (the device only) for one request and then the cell's
``trace_requests`` requests (at most ``--seconds``), the traced window,
from which the per-layer metrics are read; then ``gap_requests`` more
requests under a trace of host and device name the idle gaps.

Once the window has closed and the peak memory is read, the program is
freed and a sample of the window's answers, drawn from the seed, is checked
against the plain reference (``systems/<entry>.py``'s ``check``). The last
lines on standard error, and the result's last key, give each number
compared beside its limit. The last line on standard output is the result.
The run fails, with no result, without a CUDA card, and if ``jax``,
``jaxlib``, ``flax`` or the JAX package was imported.
"""

from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from collections import defaultdict  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "torch_admm_deconv_tpu")
# caches at fixed paths inside the checkout (the kernel libraries build
# into the program's own torch_admm_deconv_tpu_torch/_build/)
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda"}


def boot_seconds_at_start() -> float | None:
    """Seconds from boot to this process's start (/proc, 10 ms steps)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def seconds_since_start() -> float:
    start = boot_seconds_at_start()
    if start is None:
        return time.time() - T_IMPORT
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def load_cell(name: str, root: Path = ROOT) -> SimpleNamespace:
    """Everything the manifest and the cell's files say about cell ``name``."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    end_to_end = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in manifest["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return SimpleNamespace(
        name=name, chips=cell["chips"],
        config=json.loads((root / conf["file"]).read_text()),
        mix=json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
        workload=json.loads((HERE / "workloads" / f"{name}.json").read_text()),
        end_to_end=end_to_end, per_layer=per_layer)


def reader(metric: str):
    """``read`` of ``metrics/<metric>.py``; a metric split by cell
    (``<quantity>.<suffix>``) without a file of its own reads as its
    quantity's ``metrics/<quantity>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"


def peaks_for(kind: str):
    table = json.loads((HERE / "peaks.json").read_text())["cards"]
    return next((row for key, row in table.items() if key in kind), None)


def _worst(a, b):
    """The larger gap; NaN, where either is, wins."""
    if a is None or math.isnan(b):
        return b
    return a if math.isnan(a) else max(a, b)


def _name_idle_gaps(entry, pool, requests: int, device) -> list:
    """A short trace of host and device over ``requests`` more requests,
    each labelled, to name the device's idle gaps (``trace.idle_gaps``)."""
    import torch

    from portbench.trace import REQUEST, idle_gaps

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(requests):
            with torch.profiler.record_function(REQUEST):
                entry(pool[i % len(pool)])
    return idle_gaps(prof)


def run_cell(cell: SimpleNamespace, seed: int, seconds: float, trace: bool, device,
             control: bool = False) -> dict:
    """One run of ``cell``: the result's keys, plus 'numbers' (every number
    the check read) and 'latency_ms' (the requests' quantiles), which
    ``report`` prints apart. ``control`` puts the cell's control (one
    precision below the configuration's: the program's own lower-precision
    path, or the reference) in the program's place."""
    import numpy as np
    import torch

    from portbench import traffic
    from portbench.trace import Trace, device_events

    wl, cfg, mix = cell.workload, cell.config, cell.mix
    for key in ("batch", "channels", "size"):
        if key in cfg and cfg[key] != mix[key]:
            raise ValueError(f"the mix's {key} {mix[key]} is not the configuration's {cfg[key]}")
    system = importlib.import_module(f"portbench.systems.{wl['entry']}")
    shared = system.make_shared(cfg, seed, device)
    pool = traffic.make_pool(mix, seed, psf=shared.get("psf"))
    if device.type == "cuda":
        torch.zeros(1, device=device)  # the context and the allocator exist
        torch.cuda.reset_peak_memory_stats(device)
    entry = (system.control if control else system.program)(cfg, wl["args"], shared, device)
    samples = [None] * wl["sample"]
    # the warm-up keeps as many answers as the window will, so the memory
    # that sampling holds is cached before the window opens
    warm = []
    for i in range(max(wl["warmup"], len(samples))):
        entry.keep_next()
        warm.append((entry(pool[i % len(pool)]), entry.kept()))
    del warm
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    sample_rng = traffic.rng_for(seed, 1)
    latencies, failed, n = [], 0, 0
    cap = wl["trace_requests"] + 1 if trace else None  # the first starts the profiler
    profiler = nullcontext()
    if trace:
        acts = [torch.profiler.ProfilerActivity.CUDA if device.type == "cuda"
                else torch.profiler.ProfilerActivity.CPU]
        profiler = torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=cap - 1, repeat=1))

    with profiler as prof:
        setup_s = seconds_since_start()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while n == 0 or (time.perf_counter() < deadline and (cap is None or n < cap)):
            slot = n if n < len(samples) else int(sample_rng.integers(0, n + 1))
            keep = slot < len(samples)
            if keep:
                entry.keep_next()
            t_req = time.perf_counter()
            if n == 1:
                t_traced = t_req
            try:
                out = entry(pool[n % len(pool)])
            except Exception:  # a request that fails is counted and named; the loop goes on
                traceback.print_exc()
                failed, out = failed + 1, None
            t_done = time.perf_counter()
            latencies.append(t_done - t_req)
            if trace:
                prof.step()
            if keep:
                samples[slot] = (n % len(pool), out, entry.kept())
            n += 1
    window_s = t_done - t0
    traced_s = t_done - t_traced if n > 1 else window_s

    gaps = []
    if trace:
        gaps = _name_idle_gaps(entry, pool, wl["gap_requests"], device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del entry
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    run = SimpleNamespace(setup_s=setup_s, window_s=window_s, requests=n - failed,
                          latencies_s=latencies, trace=None, work=None, peaks=peaks_for(kind),
                          pixels_per_request=mix["batch"] * mix["size"] * mix["size"])
    if trace:
        run.trace = Trace(traced_s, n - 1, device_events(prof) if n > 1 else [], gaps)
        work = importlib.import_module(f"portbench.work.{wl['entry']}")
        run.work = work.count(cfg, mix, wl["args"])
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    numbers, malformed, memos = {}, 0, defaultdict(dict)
    shape = (mix["batch"], mix["channels"], mix["size"], mix["size"])
    for item in samples:
        if item is None:
            continue
        idx, out, kept = item
        if out is None or tuple(out.shape) != shape or not np.isfinite(out).all():
            malformed += 1
            continue
        found = system.check(cfg, wl["args"], shared, pool[idx], out, kept, device, memos[idx])
        for key, value in found.items():
            numbers[key] = _worst(numbers.get(key), value)
    limits = wl["checks"]
    compared = {k: numbers.get(k, math.nan) for k in limits}
    correct = (failed == 0 and malformed == 0 and bool(numbers)
               and all(v <= limits[k] for k, v in compared.items()))

    result = {"correct": correct, "attempted": n, "failed": failed + malformed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": kind, "count": 1, "memory_peak_bytes": peak}}
    if trace:
        result["device"].update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = run.trace.breakdown()
    result["card"] = card_line(device)
    result["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in compared.items()}
    result["numbers"] = numbers
    result["latency_ms"] = [float(v) * 1e3 for v in np.percentile(latencies, [0, 50, 95, 100])]
    return result


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def report(result: dict) -> None:
    """The compared numbers as the last lines on standard error, then the
    result as the last line on standard output."""
    numbers = result.pop("numbers")
    print("request ms (min, median, p95, max): " + ", ".join(
        f"{v:.3f}" for v in result.pop("latency_ms")), file=sys.stderr)
    extra = {k: v for k, v in numbers.items() if k not in result["checks"]}
    if extra:
        print("read, not compared: " + ", ".join(f"{k} {v!r}" for k, v in extra.items()),
              file=sys.stderr)
    print(f"correct {result['correct']}: attempted {result['attempted']}, "
          f"failed {result['failed']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(HERE / ".cache" / sub)
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"the run imported {', '.join(found)}: no result", file=sys.stderr)
        return 3
    report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
