"""The work counts against counts made by hand."""

import math

import pytest
import torch

from portbench.reference import flagship
from portbench.work import model_restorer, solves


@pytest.mark.parametrize("planes,h,w,maxit", [(24, 512, 512, 200), (3, 8, 16, 5)])
def test_fixed_solve_by_hand(planes, h, w, maxit):
    work = solves.fixed_solve(planes, h, w, maxit)
    # two real FFTs an iteration, each half of 5 n log2 n at n = h w
    n = h * w
    assert work["fft_flops"] == pytest.approx(planes * maxit * 2 * 2.5 * n * math.log2(n))
    # the chain, and the half spectrum scaled by the real diagonal
    assert work["chain_flops"] == planes * maxit * (25 * n + 2 * h * (w // 2 + 1))
    assert work["bytes"] == 4 * (2 * planes * n + h * (w // 2 + 1))


def test_config1_solve_on_the_fft_basis():
    work = solves.fixed_solve(24, 512, 512, 200)
    assert work["fft_flops"] == 113_246_208_000
    # float32 peak: (fft + chain) / 67 TFLOP/s, far above the bytes' time
    peaks = {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
    assert solves.least_seconds(work, peaks) == pytest.approx(solves.flops(work) / 67e12)
    # the dense cas transform K2 computes is 5.15 TFLOP: not credited
    assert solves.flops(work) < 0.03 * 5_153_960_755_200


TINY = {"level_branches": [2, 2], "in_channels": 3, "final_channels": 3, "filters": 4,
        "gate_channels": 4, "attention_reduction": 2, "output_activation": "sigmoid",
        "admm": {"max_iters": 3, "iso": True, "lmbda_range": [0.02, 0.1], "rho_range": [0.5, 1.5]}}


def _hand_conv_flops(cfg, s):
    """Flops (two a multiply-add) of every convolution and linear layer the
    model runs, from their shapes, at an s x s input."""
    f, c = cfg["filters"], cfg["in_channels"]
    hidden = cfg["gate_channels"] // cfg["attention_reduction"]
    px = s * s

    def conv(cin, cout, k, out_px=px):
        return 2 * cin * cout * k * k * out_px

    def updown(cin, cout):
        # a transposed 3x3 spreads each of the s x s inputs over 3 x 3
        # outputs, growing the plane by 2
        up_px = (s + 2) * (s + 2)
        return (conv(cin, cout, 1) + conv(cin, cin, 3) + conv(cin, cin, 1, up_px)
                + conv(cin, cout, 3) + conv(cout, cout, 1))

    def cbam(pools):
        return pools * 2 * (2 * f * hidden) + conv(3, 1, 7)

    def cwa():
        return conv(f, 2 * f, 1) + conv(2 * f, f, 1)

    levels = cfg["level_branches"]
    total = 0
    for i, b in enumerate(levels):
        cin = c if i == 0 else f + c
        cout = cfg["final_channels"] if i == len(levels) - 1 else f
        used = range(b) if i == 0 else [*range(b // 2), *range(b, b + b // 2)]
        total += sum(conv(cin, f, 1) if j % 2 == 0 else updown(cin, f) for j in used)
        total += b * cbam(2) + conv(f * b, cout, 1) + cwa()
    return total


@pytest.mark.parametrize("size", [16, 24])
def test_model_flops_by_hand(size):
    config = {"reference": "flagship", "model": TINY}
    mix = {"batch": 1, "channels": 3, "size": size}
    work = model_restorer.count(config, mix, {})
    admm = solves.fixed_solve(3, size, size, 3)
    assert work["kernels"]["k2"] == {k: 2 * v for k, v in admm.items()}
    conv = work["flops"] - 2 * solves.flops(admm)
    assert conv == _hand_conv_flops(TINY, size)


def test_flagship_weights_are_the_ports_state_dict():
    from torch_admm_deconv_tpu_torch.models.denoiser import flagship_divergent_restorer

    from portbench.run import load_cell

    cfg = load_cell("flagship.eval_b1").config["model"]
    model = flagship_divergent_restorer(remat=False, use_pallas=True, device="cpu",
                                        generator=torch.Generator().manual_seed(0))
    ours = [(n, tuple(s)) for n, s, _ in flagship.weight_shapes(cfg)]
    assert ours == [(n, tuple(t.shape)) for n, t in model.state_dict().items()]
