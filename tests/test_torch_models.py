"""The port's models held against the JAX package's Flax modules, with the
JAX parameters converted by ``convert.flax_to_torch`` (never two
independent inits), on the CPU.
"""

import numpy as np
import pytest
import torch

from torch_admm_deconv_tpu_torch.convert import flax_to_torch
from torch_admm_deconv_tpu_torch.models import admm_deconv as t_admm
from torch_admm_deconv_tpu_torch.models import attention as t_att
from torch_admm_deconv_tpu_torch.models import denoiser as t_den

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
flax_nn = pytest.importorskip("flax.linen")

from torch_admm_deconv_tpu.models import admm_deconv as j_admm  # noqa: E402
from torch_admm_deconv_tpu.models import attention as j_att  # noqa: E402
from torch_admm_deconv_tpu.models import denoiser as j_den  # noqa: E402


def _both(j_module, t_module, x):
    """Init the Flax module, load its converted params into the port's
    module (strict), and return both outputs as numpy."""
    xj = jnp.asarray(x, jnp.float32)
    params = j_module.init(jax.random.PRNGKey(0), xj)
    t_module.load_state_dict(flax_to_torch(jax.tree_util.tree_map(np.asarray, params)))
    want = np.asarray(j_module.apply(params, xj))
    got = t_module(torch.from_numpy(x)).detach().numpy()
    return got, want


def _img(rng, shape):
    return np.clip(rng.normal(size=shape) * 0.1 + 0.5, 0.0, 1.0).astype(np.float32)


@pytest.mark.parametrize("case", ["learned_psf_loop", "whole_solve"])
def test_admm_deconv_matches_jax(rng, case):
    """Loop path with a learned 5x5 PSF and bias (compat iso at batch 2):
    two float32 FFT libraries over 10 iterations, 1e-4. Whole-solve path
    (batch 1, no PSF): float32 products against JAX's bf16x3, the K2 bar
    of tests/test_vmem_solver.py:30, 3e-4."""
    if case == "learned_psf_loop":
        kw = dict(kern_size=(5, 5), max_iters=10, bias=True)
        x, atol = _img(rng, (2, 3, 16, 32)), 1e-4
    else:
        kw = dict(max_iters=10, use_pallas=True)
        x, atol = _img(rng, (1, 3, 16, 128)), 3e-4
    got, want = _both(j_admm.ADMMDeconv(**kw), t_admm.ADMMDeconv(**kw, device="cpu"), x)
    np.testing.assert_allclose(got, want, atol=atol)


# attention: the same float32 formulas; sums in other orders: 1e-5
@pytest.mark.parametrize("pools", [("avg", "max"), ("lp", "lse")])
def test_cbam_matches_jax(rng, pools):
    x = rng.normal(size=(2, 16, 8, 8)).astype(np.float32)
    got, want = _both(j_att.CBAM(16, 4, pools, use_spatial=True),
                      t_att.CBAM(16, 4, pools, use_spatial=True, device="cpu"), x)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("flags", [{}, {"probas_only": True, "reduce_mean": True},
                                   {"reduce_probas_space": True}])
def test_channel_wise_attention_matches_jax(rng, flags):
    x = rng.normal(size=(2, 8, 6, 6)).astype(np.float32)
    got, want = _both(j_att.ChannelWiseAttention(8, **flags),
                      t_att.ChannelWiseAttention(8, **flags, device="cpu"), x)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_mode_breaks_ties_toward_smallest():
    x = np.array([[1.0, 2.0, 2.0, 3.0, 3.0, 3.0, 0.5], [5.0, 5.0, 1.0, 1.0, 9.0, 7.0, 8.0]],
                 np.float32)
    got = t_att.mode_along_last(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_att.mode_along_last(jnp.asarray(x))))
    np.testing.assert_array_equal(got, [3.0, 1.0])
    pooled = t_att.channel_pool(torch.from_numpy(x[None, :, :, None].repeat(2, 0)))
    np.testing.assert_array_equal(
        pooled.numpy(), np.asarray(j_att.channel_pool(jnp.asarray(x[None, :, :, None].repeat(2, 0)))))


def _reduced(module, **extra):
    admm = {"kern_size": (), "max_iters": 10, "iso": True, "use_pallas": True}
    sig = flax_nn.sigmoid if module is j_den else torch.sigmoid
    return module.DivergentRestorer([2, 4], 3, 3, 16, 16, 8, output_activation=sig,
                                    admms=[dict(admm), dict(admm)], **extra)


def test_reduced_divergent_restorer_matches_jax(rng):
    """[2, 4] branches, 16 filters, 10-iteration ADMM at batch 1, through
    the whole solve on both sides (JAX: K2 in interpret mode).

    Level 0 (the ADMM layers and the branches behind them): 1e-4, float32
    against bf16x3 products (measured 1.2e-5). The output: 2e-3. The
    ChannelWiseAttention gates take the spatial mode of each channel, which
    counts exactly equal values; the TV solves leave flat regions, and
    ulp-level differences there change the counts (measured 6.5e-4, and
    4.6e-4 with both sides on the FFT loop instead of the kernels)."""
    x = _img(rng, (1, 3, 16, 128))
    xj = jnp.asarray(x, jnp.float32)
    j_model, t_model = _reduced(j_den), _reduced(t_den, device="cpu")
    params = j_model.init(jax.random.PRNGKey(0), xj)
    t_model.load_state_dict(flax_to_torch(jax.tree_util.tree_map(np.asarray, params)))
    want, state = j_model.apply(params, xj, capture_intermediates=True, mutable=["intermediates"])
    level0 = {}
    t_model.block_0.register_forward_hook(lambda m, i, o: level0.__setitem__("out", o))
    got = t_model(torch.from_numpy(x))
    np.testing.assert_allclose(level0["out"].detach().numpy(),
                               np.asarray(state["intermediates"]["block_0"]["__call__"][0]),
                               atol=1e-4)
    assert got.shape == want.shape == (1, 3, 16, 128)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-3)
    # the kernel path is forward-only: inference works without no_grad,
    # a backward pass raises
    with pytest.raises(RuntimeError, match="inference-only"):
        got.sum().backward()


def test_flagship_builds_the_published_config():
    model = t_den.flagship_divergent_restorer(remat=False, use_pallas=True, device="cpu",
                                              generator=torch.Generator().manual_seed(0))
    names = dict(model.named_parameters())
    assert names["block_0.conv_0.weight"].shape == (86, 3, 1, 1)
    assert names["block_2.convout.weight"].shape == (3, 86 * 32, 1, 1)
    assert "block_2.conv_63.chx.weight" in names and "block_0.conv_2.weight" not in names
    assert model.block_0.admm_0.use_pallas and model.block_0.admm_0.max_iters == 100
