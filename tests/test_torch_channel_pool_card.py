"""The spatial gates' channel-pool kernel (``csrc/channel_pool.cu``) on a
card, held against the plain version (``attention.channel_pool_plain``, the
sort path) on the same card.

Both of the kernel's outputs are selections, so they are compared exactly:
NaN in the same places and every other value ``==`` (so -0 and +0, which the
kernel returns as +0, agree). Without a card every test skips. Run on the
card with ``python3 -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_channel_pool_card.py``.
"""

from types import SimpleNamespace

import pytest
import torch

from portbench.spans import stage_ms
from torch_admm_deconv_tpu_torch.kernels import channel_pool as cp
from torch_admm_deconv_tpu_torch.models import attention as att
from torch_admm_deconv_tpu_torch.models import denoiser as den
from torch_admm_deconv_tpu_torch.utils import tracing

KINDS = ("random", "ties", "nan", "zeros")
SHAPES = [(1, 86, 256, 256)] + [(2, c, 33, 47) for c in (1, 2, 3, 31, 32, 33, 86, 127, 128, 129, 256)]


@pytest.fixture
def card():
    """The CUDA device, or a skip where this machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _data(kind: str, shape, seed: int) -> torch.Tensor:
    """CPU float32 values of one kind: normal, five levels (heavy ties),
    normal with NaN and infinities, or {0, -0, 1, -1}; ``distinct`` is a
    permutation of 0..C-1 at every pixel."""
    g = torch.Generator().manual_seed(seed)
    if kind == "random":
        return torch.randn(shape, generator=g)
    if kind == "ties":
        return torch.tensor([-1.0, -0.5, 0.25, 0.5, 1.0])[torch.randint(0, 5, shape, generator=g)]
    if kind == "nan":
        x, u = torch.randn(shape, generator=g), torch.rand(shape, generator=g)
        x[u < 0.2] = float("nan")
        x[(u >= 0.2) & (u < 0.25)] = float("inf")
        x[(u >= 0.25) & (u < 0.3)] = -float("inf")
        return x
    if kind == "zeros":
        return torch.tensor([0.0, -0.0, 1.0, -1.0])[torch.randint(0, 4, shape, generator=g)]
    if kind == "distinct":
        return torch.argsort(torch.rand(shape, generator=g), dim=1).float()
    raise ValueError(kind)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    nan = a.isnan()
    return bool(torch.equal(nan, b.isnan()) and torch.equal(a[~nan], b[~nan]))


@pytest.mark.card
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_pool_equals_the_plain_pool(card, shape, kind):
    x = _data(kind, shape, shape[1]).to(card)
    before = cp.LAUNCHES.n
    got = att.channel_pool(x)
    assert cp.LAUNCHES.n == before + 1  # one launch a call
    assert _same(got, att.channel_pool_plain(x))
    if kind == "zeros":
        assert got[:, 1:].isfinite().all() and bool((got[:, 1:] == 0).any())


@pytest.mark.card
def test_more_channels_than_the_kernel_takes_raise(card):
    x = torch.zeros((1, cp.MAX_CHANNELS + 1, 4, 4), device=card)
    with pytest.raises(ValueError, match="1 to 256 channels"):
        att.channel_pool(x)


@pytest.mark.card
@pytest.mark.parametrize("kind", ["distinct", "ties"])
@pytest.mark.parametrize("c", [86, 200])
def test_gradient_goes_where_the_sort_sends_it(card, kind, c):
    """The two selections' gradients land on the sort's channels, exactly;
    with the std, whose gradient is added in another order, to rtol 1e-6."""
    x = _data(kind, (2, c, 17, 23), c).to(card)
    w = torch.randn((2, 3, 17, 23), generator=torch.Generator().manual_seed(1)).to(card)
    for channels, rtol in ((slice(1, 3), 0.0), (slice(0, 3), 1e-6)):
        grads = []
        for pool in (att.channel_pool, att.channel_pool_plain):
            xg = x.clone().requires_grad_()
            before = cp.LAUNCHES.n
            (pool(xg)[:, channels] * w[:, channels]).sum().backward()
            assert cp.LAUNCHES.n - before == (1 if pool is att.channel_pool else 0)
            grads.append(xg.grad)
        got, want = grads
        if rtol == 0.0:
            assert torch.equal(got, want)
        else:
            assert torch.equal(got != 0, want != 0)
            torch.testing.assert_close(got, want, rtol=rtol, atol=0.0)


@pytest.mark.card
def test_drain_counts_the_pool_and_leaves_k2s_clock_alone(card):
    x = _data("random", (1, 86, 32, 32), 0).to(card)
    with tracing.recording():
        att.channel_pool(x)
        att.channel_pool(x)
        tracing.launch_clock("k2", card).add_(torch.arange(1, 7, device=card))
    counters = tracing.drain()["counters"]
    by_kernel = {c["kernel"]: c for c in counters}
    assert by_kernel["channel_pool"] == {"kernel": "channel_pool", "device": str(card),
                                         "launches": 2, "stage_ns": {}}
    without = [c for c in counters if c["kernel"] != "channel_pool"]
    k2 = stage_ms(SimpleNamespace(counters=counters, requests=1), "k2")
    assert k2 == stage_ms(SimpleNamespace(counters=without, requests=1), "k2") == 21 / 1e6


def _reduced(device):
    admm = {"kern_size": (), "max_iters": 10, "iso": True, "use_pallas": True}
    return den.DivergentRestorer([2, 4], 3, 3, 16, 16, 8, output_activation=torch.sigmoid,
                                 admms=[dict(admm), dict(admm)], device=device,
                                 generator=torch.Generator().manual_seed(0))


@pytest.mark.card
@pytest.mark.parametrize("which", ["reduced", "flagship"])
def test_model_through_the_kernel_equals_the_plain_pool(card, monkeypatch, which):
    """The whole forward under ``inference_mode``, the gates' pool through
    the kernel and through the plain version, on the same weights and input:
    bit for bit where two plain runs are (cuDNN deterministic), else within
    the gap two plain runs show."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    if which == "reduced":
        model, shape = _reduced(card), (1, 3, 64, 128)
    else:
        model = den.flagship_divergent_restorer(remat=False, use_pallas=True, device=card,
                                                generator=torch.Generator().manual_seed(0))
        shape = (1, 3, 256, 256)
    model.eval()
    gates = sum(isinstance(m, att.SpatialGate) for m in model.modules())
    assert which == "reduced" or gates == 42
    x = torch.rand(shape, generator=torch.Generator().manual_seed(2)).to(card)
    with torch.inference_mode():
        before = cp.LAUNCHES.n
        got = model(x)
        assert cp.LAUNCHES.n - before == gates
        monkeypatch.setattr(att, "channel_pool", att.channel_pool_plain)
        plain = [model(x) for _ in range(2)]
        assert cp.LAUNCHES.n - before == gates
    torch.cuda.synchronize()
    if torch.equal(plain[0], plain[1]):
        assert torch.equal(got, plain[0])
    else:
        gap = float((plain[0] - plain[1]).abs().max())
        assert float((got - plain[0]).abs().max()) <= gap
