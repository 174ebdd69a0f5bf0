"""The spatial gates' per-pixel pool, plain version (``channel_pool_plain``,
which a CPU tensor runs and the card's kernel is held against), on the CPU:
against a NumPy per-pixel spec and against the JAX package's
``channel_pool``.

The median is the element at (C - 1) // 2 of the ascending order and the
mode the value of the longest run of ``==``-equal values there, ties toward
the smallest; NaN sorts after +inf and is a run of its own; -0 and +0 are
one run. Both are selections: compared exactly (NaN in the same places,
every other value ``==``). The std is a float32 reduction: 1e-5 against
float64. Last, the kernel's launch counter in the port's recorder.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench.spans import stage_ms
from torch_admm_deconv_tpu_torch.models import attention as t_att
from torch_admm_deconv_tpu_torch.utils import tracing

jnp = pytest.importorskip("jax.numpy")

from torch_admm_deconv_tpu.models import attention as j_att  # noqa: E402

KINDS = ("distinct", "ties", "nan", "zeros", "equal")


def _values(kind: str, shape, rng) -> np.ndarray:
    """float32 (B, C, H, W) of one kind: a permutation of distinct values at
    every pixel, five levels (heavy ties), normal with NaN and infinities,
    {0, -0, 1, -1}, or one value in every channel."""
    b, c, h, w = shape
    if kind == "distinct":
        x = np.argsort(rng.random(shape), axis=1) * 0.37 - 5.0
    elif kind == "ties":
        x = rng.choice([-1.0, -0.5, 0.25, 0.5, 1.0], size=shape)
    elif kind == "nan":
        x = rng.normal(size=shape)
        u = rng.random(shape)
        x[u < 0.2] = np.nan
        x[(u >= 0.2) & (u < 0.25)] = np.inf
        x[(u >= 0.25) & (u < 0.3)] = -np.inf
    elif kind == "zeros":
        x = rng.choice([0.0, -0.0, 1.0, -1.0], size=shape)
    else:
        x = np.broadcast_to(rng.normal(size=(b, 1, h, w)), shape)
    return np.ascontiguousarray(x, dtype=np.float32)


def _spec(x: np.ndarray):
    """(median, mode) of every pixel, one pixel at a time."""
    b, c, h, w = x.shape
    med = np.empty((b, h, w), np.float32)
    mode = np.empty((b, h, w), np.float32)
    for i in np.ndindex(b, h, w):
        row = x[i[0], :, i[1], i[2]]
        s = np.concatenate([np.sort(row[~np.isnan(row)]), row[np.isnan(row)]])
        med[i] = s[(c - 1) // 2]
        best, best_len, start = s[0], 0, 0
        for j in range(1, c + 1):
            if j == c or not s[j] == s[j - 1]:
                if j - start > best_len:
                    best, best_len = s[start], j - start
                start = j
        mode[i] = best
    return med, mode


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("c", [1, 2, 3, 7, 86])
def test_plain_pool_is_the_per_pixel_spec_and_jax(rng, c, kind):
    x = _values(kind, (2, c, 5, 6), rng)
    got = t_att.channel_pool_plain(torch.from_numpy(x)).numpy()
    med, mode = _spec(x)
    np.testing.assert_array_equal(got[:, 1], med)
    np.testing.assert_array_equal(got[:, 2], mode)
    with np.errstate(invalid="ignore", divide="ignore"):
        std = x.astype(np.float64).std(axis=1, ddof=1) if c > 1 else np.full(med.shape, np.nan)
    np.testing.assert_allclose(got[:, 0], std, rtol=1e-5, atol=1e-6)
    want = np.asarray(j_att.channel_pool(jnp.asarray(x)))
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5, atol=1e-6)
    if kind == "equal":
        np.testing.assert_array_equal(got[:, 1], x[:, 0])
        np.testing.assert_array_equal(got[:, 2], x[:, 0])


def test_channel_pool_runs_the_plain_version_on_the_cpu(rng):
    x = torch.from_numpy(_values("ties", (1, 300, 3, 4), rng))
    torch.testing.assert_close(t_att.channel_pool(x), t_att.channel_pool_plain(x), rtol=0, atol=0)


def test_the_pool_counts_launches_and_leaves_k2s_clock_alone():
    """``tracing.count_launch`` (the kernel's counter) gives an empty
    ``stage_ns``; the benchmark's stage reading of K2 is the same with and
    without it."""
    cpu = torch.device("cpu")
    tracing.count_launch("channel_pool", cpu)  # off: not counted
    with tracing.recording():
        for _ in range(3):
            tracing.count_launch("channel_pool", cpu)
        tracing.launch_clock("k2", cpu).add_(torch.arange(1, 7))
    counters = tracing.drain()["counters"]
    assert {"kernel": "channel_pool", "device": "cpu", "launches": 3, "stage_ns": {}} in counters
    without = [c for c in counters if c["kernel"] != "channel_pool"]
    assert [c["kernel"] for c in without] == ["k2"]
    k2 = stage_ms(SimpleNamespace(counters=counters, requests=3), "k2")
    assert k2 == stage_ms(SimpleNamespace(counters=without, requests=3), "k2") == 21 / 1e6 / 3
