"""The flagship's training gradients held against ``jax.grad``.

The reduced flagship of ``__graft_entry__.py:66-76`` (the JAX package's
sharded training dry run): [2, 4] branches, 16 filters, reduction 4, two
20-iteration isotropic 'compat' ADMM layers, remat of the iterations and
the levels on both sides, (2, 3, 128, 128) images, not cut further. The
loss is ``SSIMLabColorLoss``; the JAX parameters are converted by
``flax_to_torch`` (never two independent inits).

Precision. The gates (``ChannelWiseAttention``) take the spatial mode of
each channel, which counts exactly equal values. In float32, 16384 values
of one channel hold some 30-100 pairs of accidentally equal floats, and the
ulp-level differences between two correct implementations decide which
pairs exist, so the mode (and every gradient that flows through it: the
ADMM layers' lambda and rho among them) differs between the packages by up
to 90 %. In float64 those collisions vanish and both packages take the same
branch: there every gradient is held tightly. In float32 the loss and the
parameters after the last gate are held.
"""

import numpy as np
import pytest
import torch

from torch_admm_deconv_tpu_torch.convert import flax_to_torch
from torch_admm_deconv_tpu_torch.metrics import SSIMLabColorLoss as TLoss
from torch_admm_deconv_tpu_torch.models import denoiser as t_den

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from torch_admm_deconv_tpu.metrics import SSIMLabColorLoss as JLoss  # noqa: E402
from torch_admm_deconv_tpu.models import denoiser as j_den  # noqa: E402

ADMM_PARAMS = [f"block_0.admm_{i}.{p}" for i in range(2) for p in ("lmbda", "rho")]


def _reduced(module, act, **kw):
    admm = {"kern_size": (), "max_iters": 20, "iso": True, "remat": True}
    return module.DivergentRestorer(
        level_branches=[2, 4], in_channels=3, final_channels=3, filters=16, gate_channels=16,
        attention_reduction=4, output_activation=act, admms=[dict(admm), dict(admm)],
        remat_levels=True, **kw)


@pytest.fixture(scope="module")
def flagship():
    """The JAX model, its float32 parameters (initialised on a small input:
    no parameter shape depends on the image size) and a batch-2 pair."""
    model = _reduced(j_den, jax.nn.sigmoid)
    rng = np.random.default_rng(0)
    y = rng.random((2, 3, 128, 128)).astype(np.float32)
    x = np.clip(y + rng.normal(0.0, 15.0 / 255.0, y.shape), 0.0, 1.0).astype(np.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x[:, :, :16, :16]))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    return model, params, x, y


def _grads(flagship, dtype):
    """Loss and gradients of both packages at ``dtype``, as numpy by the
    port's parameter names (a parameter the port's graph does not reach,
    whose JAX gradient is 0, counts as 0)."""
    j_model, params, x, y = flagship
    params = jax.tree_util.tree_map(lambda a: a.astype(dtype), params)
    x, y = x.astype(dtype), y.astype(dtype)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: JLoss()(j_model.apply(p, jnp.asarray(x)), jnp.asarray(y))))(params)
    want = {k: v.numpy().astype(np.float64) for k, v in
            flax_to_torch(jax.tree_util.tree_map(np.asarray, j_grads)).items()}

    t_model = _reduced(t_den, torch.sigmoid, device="cpu")
    t_model.load_state_dict(flax_to_torch(params))
    t_model.to(torch.float64 if dtype == np.float64 else torch.float32)
    t_loss = TLoss()(t_model(torch.from_numpy(x)), torch.from_numpy(y))
    t_loss.backward()
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).double().numpy()
           for n, p in t_model.named_parameters()}
    assert set(got) == set(want)
    return float(t_loss.detach()), float(j_loss), got, want


def _rel_l2(got, want, floor):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), floor))


def test_flagship_gradients_match_jax_float64(flagship):
    """Every gradient, float64 on both sides: lambda and rho of both ADMM
    layers to 1e-6 relative, every other tensor to 1e-6 by relative L2
    (measured: 5e-8 at most). The spatial-gate conv biases have gradient 0
    (an InstanceNorm follows them; both sides read ~1e-17): their norm is
    held against 1e-9 of the largest gradient norm."""
    t_loss, j_loss, got, want = _grads(flagship, np.float64)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-12)
    for name in ADMM_PARAMS:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6, err_msg=name)
        assert abs(float(want[name][0])) > 0, name
    floor = 1e-9 * max(np.linalg.norm(g) for g in want.values())
    errs = {n: _rel_l2(got[n], want[n], floor) for n in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-6, (worst, errs[worst])


def test_flagship_loss_and_last_level_match_jax_float32(flagship):
    """float32, the training precision: the loss to 1e-4 relative (the gates'
    mode moves the output; measured 1.2e-5) and the gradients of the last
    level, behind both gates, to 2e-2 by relative L2 (a gate whose mode
    changes rescales a whole channel of the last level's input; measured
    6.6e-3); the spatial-gate biases (gradient 0 in exact arithmetic, float32
    noise of ~1e-9 on both sides) are held against 1e-4 of the largest
    gradient norm. Every gradient is finite."""
    t_loss, j_loss, got, want = _grads(flagship, np.float32)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-4)
    assert all(np.isfinite(g).all() for g in got.values())
    floor = 1e-4 * max(np.linalg.norm(g) for g in want.values())
    errs = {n: _rel_l2(got[n], want[n], floor) for n in want if n.startswith("block_1.")}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 2e-2, (worst, errs[worst])
