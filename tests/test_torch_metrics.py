"""The port's metrics and losses held against the JAX package's, values and
gradients (``jax.grad``), on the CPU, with inputs made from a numpy seed
and cast to float32.

Tolerances: values to 1e-5 relative (the same float32 formulas; sums and
window convolutions in other orders); gradients to 1e-4 of the largest
gradient entry, elementwise (float32 backward passes through other
convolution and reduction orders).
"""

import numpy as np
import pytest
import torch

from torch_admm_deconv_tpu_torch.metrics import color as t_color
from torch_admm_deconv_tpu_torch.metrics import functional as t_fn
from torch_admm_deconv_tpu_torch.metrics import losses as t_losses

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from torch_admm_deconv_tpu.metrics import color as j_color  # noqa: E402
from torch_admm_deconv_tpu.metrics import functional as j_fn  # noqa: E402
from torch_admm_deconv_tpu.metrics import losses as j_losses  # noqa: E402


def _pair(rng, shape):
    target = rng.random(shape).astype(np.float32)
    pred = np.clip(target + 0.1 * rng.standard_normal(shape), 0.0, 1.0).astype(np.float32)
    return pred, target


def _cotangent(fn_out_shape, rng):
    return rng.standard_normal(fn_out_shape).astype(np.float32)


def _both(j_fn_, t_fn_, pred, target, w=None):
    """Value and gradient w.r.t. ``pred`` on both sides; a non-scalar output
    is reduced as sum(out * w)."""

    def j_scalar(p):
        out = j_fn_(p, jnp.asarray(target))
        return out if w is None else jnp.sum(out * jnp.asarray(w))

    jv, jg = jax.value_and_grad(j_scalar)(jnp.asarray(pred))
    p = torch.from_numpy(pred.copy()).requires_grad_(True)
    out = t_fn_(p, torch.from_numpy(target))
    tv = out if w is None else torch.sum(out * torch.from_numpy(w))
    tv.backward()
    return (float(tv.detach()), p.grad.numpy()), (float(jv), np.asarray(jg))


def _check(got, want, atol=1e-7, grad_tol=1e-4):
    (tv, tg), (jv, jg) = got, want
    assert np.isfinite(tv) and np.isfinite(tg).all()
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=grad_tol * float(np.abs(jg).max()))


FUNCTIONS = {
    "mse": (j_fn.mse, t_fn.mse),
    "mae": (j_fn.mae, t_fn.mae),
    "psnr": (j_fn.psnr, t_fn.psnr),
    "ssim": (j_fn.ssim, t_fn.ssim),
    "ssim_k7": (lambda p, t: j_fn.ssim(p, t, 1.0, 7), lambda p, t: t_fn.ssim(p, t, 1.0, 7)),
    "uiq": (j_fn.uiq, t_fn.uiq),
    "scc": (j_fn.scc, t_fn.scc),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_functional_matches_jax(rng, name):
    pred, target = _pair(rng, (2, 3, 32, 32))
    j, t = FUNCTIONS[name]
    _check(*_both(j, t, pred, target))


def test_ms_ssim_matches_jax(rng):
    """Five scales of kernel 11 need 176 pixels (11 at the coarsest)."""
    pred, target = _pair(rng, (2, 3, 176, 176))
    _check(*_both(j_fn.ms_ssim, t_fn.ms_ssim, pred, target))


@pytest.mark.parametrize("name", ["rgb_to_lab", "rgb_to_grayscale"])
def test_color_matches_jax(rng, name):
    pred, target = _pair(rng, (2, 3, 32, 32))
    j, t = getattr(j_color, name), getattr(t_color, name)
    out_shape = (2, 3 if name == "rgb_to_lab" else 1, 32, 32)
    w = _cotangent(out_shape, rng)
    want = np.asarray(j(jnp.asarray(pred)))
    got = t(torch.from_numpy(pred)).numpy()
    # Lab spans [-100, 100]: 1e-5 relative to its range
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))
    _check(*_both(lambda p, _: j(p), lambda p, _: t(p), pred, target, w))


LOSSES = ["MSE", "MAELoss", "SSIMLoss", "SSIMMetric", "MSSSIMLoss", "MSSSIMMetric",
          "PSNRMetric", "UIQMetric", "SCCMetric", "PSNRLoss", "SSIMLabColorLoss"]


@pytest.mark.parametrize("name", LOSSES)
def test_metric_classes_match_jax(rng, name):
    """Every Metric class: the same m_name (the CSV columns), value and
    gradient. A loss of the form 1 - SSIM is held to 1e-5 of the SSIM it
    subtracts (absolute), not of the small difference."""
    size = 176 if "MSSSIM" in name else 32
    pred, target = _pair(rng, (2, 3, size, size))
    j, t = getattr(j_losses, name)(None), getattr(t_losses, name)(None)
    assert t.m_name == j.m_name
    one_minus = name in ("SSIMLoss", "MSSSIMLoss", "SSIMLabColorLoss")
    _check(*_both(j, t, pred, target), atol=1e-5 if one_minus else 1e-7)


@pytest.mark.parametrize("kwargs", [{"to_y": True}, {"color_weight_l": 0.0}])
def test_loss_options_match_jax(rng, kwargs):
    name = "PSNRLoss" if "to_y" in kwargs else "SSIMLabColorLoss"
    pred, target = _pair(rng, (2, 3, 32, 32))
    j, t = getattr(j_losses, name)(None, **kwargs), getattr(t_losses, name)(None, **kwargs)
    _check(*_both(j, t, pred, target), atol=1e-5 if name == "SSIMLabColorLoss" else 1e-7)


def test_metric_names_keep_the_reference_typo():
    assert t_losses.MSSSIMLoss.m_name == "mssssim_loss"
    assert t_losses.SSIMLabColorLoss.m_name == "color_lab_loss"


@pytest.mark.parametrize("name", ["SSIMLabColorLoss", "SCCMetric"])
def test_gradient_at_the_clip_bounds_matches_jax(rng, name):
    """A sigmoid output rounds to exactly 1.0 in float32: with pixels at
    exactly 0 and 1, rgb_to_lab's clip and scc's maximum must split the
    gradient at the tie as JAX does (0.5 / 0.5), not pass all of it as
    ``torch.clamp`` would."""
    pred, target = _pair(rng, (2, 3, 32, 32))
    pred[:, :, :8] = 1.0
    pred[:, :, 8:12] = 0.0
    pred[0, 1, 20:, 20:] = 1.0  # a flat patch: zero variance, scc's max(var, 0) tie
    target[0, 1, 20:, 20:] = 0.5
    j, t = getattr(j_losses, name)(None), getattr(t_losses, name)(None)
    got, want = _both(j, t, pred, target)
    _check(got, want, atol=1e-5 if name == "SSIMLabColorLoss" else 1e-7)
    if name == "SSIMLabColorLoss":
        # the clip's tie really is split: the 1.0 pixels carry the Lab half
        # of the gradient that a full-pass clamp would double
        assert np.abs(want[1][:, :, :8]).max() > 0


def test_clip_gradient_splits_ties():
    x = torch.tensor([0.0, 1.0, 0.5], requires_grad=True)
    t_color.clip(x, 0.0, 1.0).sum().backward()
    want = jax.grad(lambda v: jnp.clip(v, 0.0, 1.0).sum())(jnp.asarray([0.0, 1.0, 0.5],
                                                                      jnp.float32))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(x.grad.numpy(), [0.5, 0.5, 1.0])


@pytest.mark.parametrize("name", ["SSIMLabColorLoss", "UIQMetric", "SCCMetric"])
def test_windows_run_in_float32_with_tf32_enabled(rng, monkeypatch, name):
    """With TF32 enabled globally, every window convolution (forward and
    backward) runs with cuDNN's TF32 off, the flags are restored after, and
    the values and gradients equal those computed with TF32 off. On the CPU
    this checks the code path; chip_smoke.py checks the numbers on the
    card."""
    pred, target = _pair(rng, (2, 3, 32, 32))
    t = getattr(t_losses, name)(None)

    def run():
        p = torch.from_numpy(pred.copy()).requires_grad_(True)
        v = t(p, torch.from_numpy(target))
        v.backward()
        return float(v.detach()), p.grad.numpy().copy()

    seen = []
    conv2d, conv2d_input = torch.nn.functional.conv2d, torch.nn.grad.conv2d_input

    def spy(fn):
        def wrapped(*args, **kwargs):
            seen.append(torch.backends.cudnn.allow_tf32)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    v_off, g_off = run()
    monkeypatch.setattr(torch.nn.functional, "conv2d", spy(conv2d))
    monkeypatch.setattr(torch.nn.grad, "conv2d_input", spy(conv2d_input))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    v_on, g_on = run()
    assert len(seen) > 0 and not any(seen), seen
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    assert v_on == v_off
    np.testing.assert_array_equal(g_on, g_off)
