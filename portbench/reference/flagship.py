"""Plain forward of the flagship DivergentRestorer, the yardstick of the
flagship cells.

A frozen, functional copy of the model's forward: every layer a plain
``torch`` call on a dict of named weights, the two ADMM front-ends as the
fixed-iteration loop of ``reference/classical.py`` on ``torch.fft``. It
imports nothing of the program under test. The names and shapes of the
weights are the model's state dict, so the benchmark makes one dict from
the seed and hands it to both sides.

The model (branches [2, 8, 32], 86 filters, gate 86, reduction 8): N levels
of divergent attention with channel-wise attention gates between them and
the input concatenated again at every level; level 0 puts an ADMM layer in
front of each of its two branches. A level of b branches runs, per branch,
a 1x1 conv (even index) or an up-down block (odd index), then CBAM (a
pooled-MLP channel gate and a spatial gate on the per-pixel std / median /
mode over the channels) plus a skip; the halves a and b of the branches
combine as conv1x1(cat(a * b, a + b)). Without ADMM layers a level builds
2b convs and runs the first b/2 and the b/2 from index b on. Median and
mode come from one ascending sort: the median is the lower middle element,
the mode the most frequent value, ties toward the smallest.

``conv`` and ``admm`` are hooks for the control: ``conv=tf32_conv`` rounds
every convolution's and linear layer's operands to TF32 with float32
accumulation, and ``admm=tf32_admm`` computes the ADMM layers' transforms
as TF32 products: one precision below the float32 the configuration
states. ``stage`` runs one module of the model by its state-dict name, and
``branch_gates`` and ``tail`` a block in two parts, split at its spatial
gates' inputs, so a comparison can follow the program module by module and
take each mode from the program's own values.
"""

from __future__ import annotations

import math
from typing import Callable, Iterator, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.classical import solve, solve_tf32, tf32

POOL_TYPES = (("avg", "max"), ("lp", "lse"))
ADMM_WEIGHTS = ("lmbda", "rho")


def _conv(x, w, b=None, padding=0, transpose=False, linear=False):
    """A convolution (OIHW weight), a transposed one ((in, out, kh, kw)
    weight) or, with ``linear``, x W^T + b."""
    if linear:
        return F.linear(x, w, b)
    if transpose:
        return F.conv_transpose2d(x, w, b)
    return F.conv2d(x, w, b, padding=padding)


def tf32_conv(x, w, b=None, padding=0, transpose=False, linear=False):
    return _conv(tf32(x), tf32(w), b, padding, transpose, linear)


# --- the names and shapes of the weights -----------------------------------


def _init(kind, cin, cout, k):
    """The model's initialisers: xavier normal, or torch's default kaiming
    uniform (a = sqrt 5), as (distribution, scale)."""
    if kind == "xavier":
        return "normal", math.sqrt(2.0 / ((cin + cout) * k * k))
    return "uniform", 1.0 / math.sqrt(cin * k * k)


def _conv_shapes(prefix, cin, cout, k, bias, init) -> Iterator[Tuple[str, tuple, tuple]]:
    yield f"{prefix}.weight", (cout, cin, k, k), _init(init, cin, cout, k)
    if bias:
        yield f"{prefix}.bias", (cout,), ("zeros", 0.0)


def _updown_shapes(p, cin, cout):
    yield from _conv_shapes(f"{p}.chx", cin, cout, 1, True, "kaiming")
    # a transposed conv's weight is (in, out, kh, kw)
    yield f"{p}.up_block.up_conv.weight", (cin, cin, 3, 3), _init("xavier", cin, cin, 3)
    yield from _conv_shapes(f"{p}.chc", cin, cin, 1, False, "kaiming")
    yield from _conv_shapes(f"{p}.down_block.down_conv", cin, cout, 3, False, "xavier")
    yield from _conv_shapes(f"{p}.chc2", cout, cout, 1, False, "kaiming")


def _cwa_shapes(p, c, n_methods=5):
    for i in range(n_methods):
        yield f"{p}.compress_weight_{i}", (1,), ("ones", 1.0)
    yield from _conv_shapes(f"{p}.conv1", c, 2 * c, 1, True, "kaiming")
    yield from _conv_shapes(f"{p}.conv2", 2 * c, c, 1, True, "kaiming")


def _cbam_shapes(p, gate, reduction):
    hidden = gate // reduction
    for name, cin, cout in (("fc1", gate, hidden), ("fc2", hidden, gate)):
        yield f"{p}.channel_gate.{name}.weight", (cout, cin), ("uniform", 1.0 / math.sqrt(cin))
        yield f"{p}.channel_gate.{name}.bias", (cout,), ("uniform", 1.0 / math.sqrt(cin))
    yield from _conv_shapes(f"{p}.spatial_gate.spatial.conv", 3, 1, 7, True, "kaiming")
    yield f"{p}.spatial_gate.spatial.norm.weight", (1,), ("ones", 1.0)
    yield f"{p}.spatial_gate.spatial.norm.bias", (1,), ("zeros", 0.0)


def _block_shapes(p, branches, cin, cout, cfg, admm: bool):
    f = cfg["filters"]
    for i in range(branches if admm else 2 * branches):
        if i % 2 == 0:
            yield from _conv_shapes(f"{p}.conv_{i}", cin, f, 1, True, "xavier")
        else:
            yield from _updown_shapes(f"{p}.conv_{i}", cin, f)
    for i in range(branches):
        yield from _cbam_shapes(f"{p}.cbam_{i}", cfg["gate_channels"], cfg["attention_reduction"])
    if admm:
        for i in range(branches):
            for name in ADMM_WEIGHTS:
                yield f"{p}.admm_{i}.{name}", (1,), ("range", tuple(cfg["admm"][f"{name}_range"]))
    yield from _conv_shapes(f"{p}.convout", f * branches, cout, 1, True, "xavier")


def weight_shapes(cfg: dict):
    """[(name, shape, (distribution, scale))] of every weight of the model
    ``cfg`` describes, in the order of its state dict. The distribution is
    'normal' (times the scale), 'uniform' (on +-scale), 'ones', 'zeros' or
    'range' (uniform on the (low, high) the configuration gives the ADMM
    layers' lambda and rho)."""
    out = []
    levels = cfg["level_branches"]
    n, c_in, f = len(levels), cfg["in_channels"], cfg["filters"]
    for i, branches in enumerate(levels):
        out += list(_cwa_shapes(f"sca_{i}", f))
        cin = c_in if i == 0 else f + c_in
        cout = cfg["final_channels"] if i == n - 1 else f
        out += list(_block_shapes(f"block_{i}", branches, cin, cout, cfg, admm=i == 0))
    return out


# --- the forward ------------------------------------------------------------


def _flat(x):
    return x.reshape(x.shape[0], x.shape[1], -1)


def mode_from_sorted(s):
    n = s.shape[-1]
    idx = torch.arange(n, device=s.device).expand_as(s)
    starts = torch.ones_like(s, dtype=torch.bool)
    starts[..., 1:] = s[..., 1:] != s[..., :-1]
    run_start = torch.cummax(torch.where(starts, idx, torch.zeros_like(idx)), dim=-1).values
    best = torch.argmax(idx - run_start + 1, dim=-1, keepdim=True)
    return torch.gather(s, -1, torch.gather(run_start, -1, best))[..., 0]


def _cwa(w, p, x, conv):
    flat = _flat(x)
    srt = torch.sort(flat, dim=-1).values
    stats = (flat.std(dim=-1, unbiased=True), srt[..., (srt.shape[-1] - 1) // 2],
             mode_from_sorted(srt), flat.amax(dim=-1), flat.mean(dim=-1))
    weighted = torch.stack([s * w[f"{p}.compress_weight_{i}"] for i, s in enumerate(stats)],
                           dim=-1).sum(dim=-1)
    h = conv(x, w[f"{p}.conv1.weight"], w[f"{p}.conv1.bias"])
    h = conv(h, w[f"{p}.conv2.weight"], w[f"{p}.conv2.bias"])
    return x * torch.sigmoid(h * weighted.reshape(x.shape[0], x.shape[1], 1, 1))


def _linear(x, wt, b, conv):
    return conv(x, wt, b, linear=True)


def _channel_gate(w, p, x, pools, conv):
    att = 0.0
    for kind in pools:
        if kind == "avg":
            pooled = x.mean(dim=(2, 3))
        elif kind == "max":
            pooled = x.amax(dim=(2, 3))
        elif kind == "lp":
            pooled = torch.sqrt((x ** 2).sum(dim=(2, 3)))
        else:
            flat = _flat(x)
            top = flat.amax(dim=2, keepdim=True)
            pooled = (top + torch.log(torch.exp(flat - top).sum(dim=2, keepdim=True)))[..., 0]
        h = F.gelu(_linear(pooled, w[f"{p}.fc1.weight"], w[f"{p}.fc1.bias"], conv))
        att = att + _linear(h, w[f"{p}.fc2.weight"], w[f"{p}.fc2.bias"], conv)
    return x * torch.sigmoid(att)[:, :, None, None]


def _spatial_gate(w, p, x, conv):
    b, c, hh, ww = x.shape
    srt = torch.sort(torch.movedim(x, 1, -1).reshape(-1, c), dim=-1).values
    pooled = torch.stack([x.std(dim=1, unbiased=True), srt[:, (c - 1) // 2].reshape(b, hh, ww),
                          mode_from_sorted(srt).reshape(b, hh, ww)], dim=1)
    y = conv(pooled, w[f"{p}.spatial.conv.weight"], w[f"{p}.spatial.conv.bias"], padding=3)
    mu = y.mean(dim=(-2, -1), keepdim=True)
    var = y.var(dim=(-2, -1), unbiased=False, keepdim=True)
    y = (y - mu) * torch.rsqrt(var + 1e-5)
    y = y * w[f"{p}.spatial.norm.weight"][None, :, None, None] \
        + w[f"{p}.spatial.norm.bias"][None, :, None, None]
    return x * torch.sigmoid(y)


def _updown(w, p, x, conv):
    up = conv(x, w[f"{p}.up_block.up_conv.weight"], transpose=True)
    y = conv(conv(up, w[f"{p}.chc.weight"]), w[f"{p}.down_block.down_conv.weight"])
    y = conv(y, w[f"{p}.chc2.weight"])
    return conv(x, w[f"{p}.chx.weight"], w[f"{p}.chx.bias"]) + y


def solve_admm(w, p, x, cfg):
    """One ADMM layer: the reference loop in ``x``'s dtype."""
    lmbd = float(w[f"{p}.lmbda"].reshape(()))
    rho = float(w[f"{p}.rho"].reshape(()))
    return solve(x, lmbd, rho, None, cfg["admm"]["max_iters"], cfg["admm"]["iso"])


def tf32_admm(w, p, x, cfg):
    """One ADMM layer with its transforms in TF32 (the control)."""
    lmbd = float(w[f"{p}.lmbda"].reshape(()))
    rho = float(w[f"{p}.rho"].reshape(()))
    return solve_tf32(x, lmbd, rho, None, cfg["admm"]["max_iters"], cfg["admm"]["iso"])


def _used(branches: int, front: bool) -> list:
    """The indices of the conv modules a level runs, in branch order."""
    half = branches // 2
    return list(range(branches)) if front else [*range(half), *range(branches, branches + half)]


def _branch(w, p, x, i, j, front, cfg, conv, admm):
    """Branch ``j`` of block ``p`` (its module conv_i) up to its channel
    gate: (the conv's output, the channel gate's output)."""
    v = admm(w, f"{p}.admm_{i}", x, cfg) if front else x
    if i % 2 == 0:
        v = conv(v, w[f"{p}.conv_{i}.weight"], w[f"{p}.conv_{i}.bias"])
    else:
        v = _updown(w, f"{p}.conv_{i}", v, conv)
    return v, _channel_gate(w, f"{p}.cbam_{j}.channel_gate", v, POOL_TYPES[j % 2], conv)


def _tail(w, p, vs, gates, activation, conv):
    """The rest of block ``p`` from its branches' conv outputs ``vs`` and
    their spatial gates' inputs ``gates``: each spatial gate plus its skip,
    then conv1x1(cat(a * b, a + b)) of the two halves."""
    feats = [_spatial_gate(w, gate_name(p, j), g, conv) + v
             for j, (v, g) in enumerate(zip(vs, gates))]
    half = len(feats) // 2
    a, b = torch.cat(feats[:half], dim=1), torch.cat(feats[half:], dim=1)
    y = conv(torch.cat([a * b, a + b], dim=1), w[f"{p}.convout.weight"], w[f"{p}.convout.bias"])
    return activation(y) if activation is not None else y


def _block(w, p, x, branches, cfg, front: bool, activation, conv, admm, record=None):
    vs, gates = [], []
    for j, i in enumerate(_used(branches, front)):
        v, g = _branch(w, p, x, i, j, front, cfg, conv, admm)
        if record is not None:
            record[gate_name(p, j)] = (g, None)
        vs.append(v)
        gates.append(g)
    return _tail(w, p, vs, gates, activation, conv)


def gate_name(block: str, j: int) -> str:
    return f"{block}.cbam_{j}.spatial_gate"


def stage_names(cfg: dict) -> list:
    """The model's modules in the order they run: the ADMM layers inside
    block_0, then block_0, sca_0, block_1, ... as the state dict names
    them."""
    n = len(cfg["level_branches"])
    names = [f"block_0.admm_{i}" for i in range(cfg["level_branches"][0])] + ["block_0", "sca_0"]
    for i in range(1, n - 1):
        names += [f"block_{i}", f"sca_{i}"]
    return names + ([f"sca_{n - 1}", f"block_{n - 1}"] if n > 1 else [])


def gate_names(cfg: dict) -> list:
    """Every spatial gate of the model, block by block."""
    return [gate_name(f"block_{i}", j) for i, b in enumerate(cfg["level_branches"])
            for j in range(b)]


def stage_input(cfg: dict, name: str, outputs: dict, x: torch.Tensor) -> torch.Tensor:
    """What the model feeds module ``name``: the network input, the output
    of the module before it, or that concatenated with the input."""
    n = len(cfg["level_branches"])
    if name.startswith("block_0"):
        return x
    kind, i = name.split("_")
    i = int(i)
    if kind == "sca":
        return outputs[f"sca_{i - 1}" if i == n - 1 else f"block_{i}"]
    return torch.cat([outputs[f"sca_{i - 1}" if i < n - 1 else f"sca_{i}"], x], dim=1)


def _activation(cfg: dict, i: int):
    last = i == len(cfg["level_branches"]) - 1
    return torch.sigmoid if last and cfg["output_activation"] == "sigmoid" else None


def stage(w: dict, cfg: dict, name: str, x: torch.Tensor, conv: Callable = _conv,
          admm: Callable = solve_admm, record: dict | None = None) -> torch.Tensor:
    """Module ``name`` of the model on its input ``x``; ``record``, where
    given, receives each of a block's spatial gates' (input, None)."""
    if ".admm_" in name:
        return admm(w, name, x, cfg)
    kind, i = name.split("_")
    i = int(i)
    if kind == "sca":
        return _cwa(w, name, x, conv)
    return _block(w, name, x, cfg["level_branches"][i], cfg, i == 0, _activation(cfg, i), conv,
                  admm, record)


def branch_gates(w: dict, cfg: dict, name: str, x: torch.Tensor,
                 admm: Callable = solve_admm) -> tuple:
    """Block ``name``'s branches on its input ``x`` up to their channel
    gates: ([conv outputs], [channel gates' outputs])."""
    i = int(name.split("_")[1])
    front = i == 0
    parts = [_branch(w, name, x, k, j, front, cfg, _conv, admm)
             for j, k in enumerate(_used(cfg["level_branches"][i], front))]
    return [v for v, _ in parts], [g for _, g in parts]


def tail(w: dict, cfg: dict, name: str, vs: list, gates: list) -> torch.Tensor:
    """Block ``name``'s output from its branches' conv outputs and its
    spatial gates' inputs."""
    i = int(name.split("_")[1])
    return _tail(w, name, vs, gates, _activation(cfg, i), _conv)


def forward(w: dict, x: torch.Tensor, cfg: dict, conv: Callable = _conv,
            admm: Callable = solve_admm, record: dict | None = None) -> torch.Tensor:
    """The model on a (B, 3, H, W) batch with the weights ``w``;
    ``record``, where given, receives each module's (input, output), and
    each spatial gate's (input, None)."""
    outputs = {}

    def run_admm(w_, p, v, cfg_):
        out = admm(w_, p, v, cfg_)
        if record is not None:
            record[p] = (v, out)
        return out

    for name in stage_names(cfg):
        if ".admm_" in name:
            continue
        v = stage_input(cfg, name, outputs, x)
        outputs[name] = stage(w, cfg, name, v, conv, run_admm, record)
        if record is not None:
            record[name] = (v, outputs[name])
    return outputs[stage_names(cfg)[-1]]
