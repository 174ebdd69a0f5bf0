"""The port's NAFNet, its shared layers and the spatial-domain H^T, held
against the JAX package on the CPU; and ``scripts/train.py --arch nafnet``.

NAFNet's parameters come from one Flax init converted by
``flax_to_torch`` (never two inits), with ``beta`` and ``gamma`` drawn
nonzero: at their zero init every block is the identity. Inputs come from
numpy seeds and are cast to float32 for JAX explicitly (tests/conftest.py
turns on x64); the gradients are compared in float64 on both sides.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests._threads import one_torch_thread, single_thread_env  # noqa: F401 (autouse)
from tests.test_torch_train_cli import _corpus
from torch_admm_deconv_tpu_torch.convert import flax_to_torch
from torch_admm_deconv_tpu_torch.models import layers_common as t_lc
from torch_admm_deconv_tpu_torch.models import nafnet as t_naf
from torch_admm_deconv_tpu_torch.ops import fdops as t_fd
from torch_admm_deconv_tpu_torch.train import load_checkpoint

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from torch_admm_deconv_tpu.models import layers_common as j_lc  # noqa: E402
from torch_admm_deconv_tpu.models import nafnet as j_naf  # noqa: E402
from torch_admm_deconv_tpu.ops import fdops as j_fd  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# the reduced model: width 8, one block a level, one middle block; TLSC with
# a train size whose windows are smaller than the maps at every level
REDUCED = dict(img_channel=3, width=8, middle_blk_num=1, enc_blk_nums=[1, 1],
               dec_blk_nums=[1, 1])
TRAIN_SIZES = {"plain": None, "tlsc": (10, 14)}


def _params(model, x, rng):
    """Flax params of one init, numpy float32, beta and gamma drawn from
    N(0, 0.5^2)."""
    params = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(0), x))

    def nonzero(path, a):
        if path[-1].key in ("beta", "gamma"):
            return rng.normal(0.0, 0.5, a.shape).astype(np.float32)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(nonzero, params)


def _pair(kind, rng, x):
    kw = dict(REDUCED, train_size=TRAIN_SIZES[kind])
    j_model = j_naf.NAFNet(**kw)
    params = _params(j_model, jnp.asarray(x, jnp.float32), rng)
    t_model = t_naf.NAFNet(**kw, device="cpu")
    t_model.load_state_dict(flax_to_torch(params))
    return j_model, params, t_model


@pytest.mark.parametrize("kind", sorted(TRAIN_SIZES))
def test_nafnet_forward_matches_jax(rng, kind):
    """Odd-sized input (padded to a multiple of 4 and cropped back): the
    port's forward within 1e-5 of JAX's in float32 (measured ~4e-7). TLSC
    takes the local pool in every block."""
    x = rng.random((2, 3, 21, 27)).astype(np.float32)
    j_model, params, t_model = _pair(kind, rng, x)
    want = np.asarray(jax.jit(j_model.apply)(params, jnp.asarray(x, jnp.float32)))
    with torch.no_grad():
        got = t_model(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(want - x).max() > 0.1  # the blocks act: beta and gamma are not 0
    if kind == "tlsc":
        kernels = [m.sca_local_kernel for m in t_model.modules() if isinstance(m, t_naf.NAFBlock)]
        assert all(k is not None for k in kernels)


@pytest.mark.parametrize("kind", sorted(TRAIN_SIZES))
def test_nafnet_gradients_match_jax_float64(rng, kind):
    """The gradient of a squared error against a target, with respect to
    every parameter and the input, in float64 on both sides: 1e-9 relative
    to each tensor's largest entry."""
    x = rng.random((1, 3, 13, 18))
    target = rng.random(x.shape)
    j_model, params, t_model = _pair(kind, rng, x)
    params64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)

    def j_loss(p, xin):
        return jnp.mean((j_model.apply(p, xin) - jnp.asarray(target)) ** 2)

    j_gp, j_gx = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(params64, jnp.asarray(x))
    # by the port's names, in float64 (flax_to_torch casts to float32); no
    # layout changes: NAFNet has only Conv2d kernels (OIHW on both sides)
    want = {}
    for path, g in jax.tree_util.tree_flatten_with_path(j_gp["params"])[0]:
        *parents, leaf = (k.key for k in path)
        want[".".join([*parents, "weight" if leaf == "kernel" else leaf])] = np.asarray(g)

    t_model.double()
    xt = torch.from_numpy(x).requires_grad_(True)
    torch.mean((t_model(xt) - torch.from_numpy(target)) ** 2).backward()
    got = {n: p.grad.numpy() for n, p in t_model.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        scale = max(np.abs(want[name]).max(), 1e-30)
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-9 * scale,
                                   err_msg=name)
    gx = np.asarray(j_gx)
    np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=0, atol=1e-9 * np.abs(gx).max())


@pytest.mark.parametrize("train_size", [(256, 256), (58, 44), (10, 14)])
def test_tlsc_windows_match_jax(train_size):
    """The calibration arithmetic of ``_sca_kernel``, at every level of the
    comparison configuration (58 is not a multiple of 16: the padding)."""
    cfg = dict(img_channel=3, width=8, middle_blk_num=1, enc_blk_nums=[2, 2, 4, 8],
               dec_blk_nums=[2, 2, 2, 2], train_size=train_size)
    t_model = t_naf.NAFNet(**cfg, device="cpu")
    j_model = j_naf.NAFNet(**cfg)
    assert [t_model._sca_kernel(level) for level in range(5)] == [
        j_model._sca_kernel(level) for level in range(5)]


@pytest.mark.parametrize("kernel", [(3, 3), (4, 7), (1, 1), (30, 5), (64, 64)])
def test_local_avg_pool2d_matches_jax(rng, kernel):
    """Windows smaller and larger than the 11 x 20 map, even and odd: the
    cumsum pool and its edge padding, 1e-5 (a window's mean is a difference
    of 2-D cumulative sums up to ~50 here, summed in another order on each
    side: measured 3.8e-6 for the 1 x 1 window, ~1e-7 for the others)."""
    x = rng.normal(size=(2, 3, 11, 20)).astype(np.float32)
    want = np.asarray(j_naf.local_avg_pool2d(jnp.asarray(x, jnp.float32), kernel))
    got = t_naf.local_avg_pool2d(torch.from_numpy(x), kernel).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_shared_layers_match_jax(rng):
    """simple_gate, pixel_shuffle, avg_pool2d and adaptive_avg_pool2d_1
    exactly; LayerNorm2d (eps 1e-6, with its affine) to 1e-6."""
    x = rng.normal(size=(2, 8, 6, 10)).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.float32), torch.from_numpy(x)
    np.testing.assert_array_equal(t_naf.simple_gate(xt).numpy(), np.asarray(j_naf.simple_gate(xj)))
    np.testing.assert_array_equal(t_lc.pixel_shuffle(xt, 2).numpy(),
                                  np.asarray(j_lc.pixel_shuffle(xj, 2)))
    np.testing.assert_allclose(t_lc.avg_pool2d(xt, 2).numpy(), np.asarray(j_lc.avg_pool2d(xj, 2)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_lc.avg_pool2d(xt, (3, 2), (1, 2)).numpy(),
                               np.asarray(j_lc.avg_pool2d(xj, (3, 2), (1, 2))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_lc.adaptive_avg_pool2d_1(xt).numpy(),
                               np.asarray(j_lc.adaptive_avg_pool2d_1(xj)), rtol=0, atol=1e-6)

    norm = j_lc.LayerNorm2d(8)
    params = jax.tree_util.tree_map(np.asarray, norm.init(jax.random.PRNGKey(0), xj))
    params = {"params": {k: rng.normal(size=v.shape).astype(np.float32)
                         for k, v in params["params"].items()}}
    t_norm = t_lc.LayerNorm2d(8, device="cpu")
    t_norm.load_state_dict(flax_to_torch(params))
    with torch.no_grad():
        got = t_norm(xt).numpy()
    np.testing.assert_allclose(got, np.asarray(norm.apply(params, xj)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("pads,out_ch", [((1, 1, 1, 1), 1), ((0, 2, 1, 0), 3), ((3, 1, 2, 2), 1)])
def test_conv_circular_matches_jax(rng, pads, out_ch):
    """The depthwise circular correlation, one kernel shared by the
    channels or one per channel, asymmetric pads: 1e-6."""
    x = rng.normal(size=(2, 3, 12, 15)).astype(np.float32)
    w = rng.normal(size=(out_ch, 1, 3, 4)).astype(np.float32)
    want = np.asarray(j_fd.conv_circular(jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32),
                                         pads))
    got = t_fd.conv_circular(torch.from_numpy(x), torch.from_numpy(w), pads).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("ksize", [None, (5, 5), (4, 6), (3, 2)])
def test_htran_operator_matches_jax(rng, ksize):
    """H^T as the flipped-PSF circular correlation with the half-pads, for
    random normalised PSFs, square or not, even or odd: 2e-6, a few float32
    ulps of outputs up to ~4; no PSF is the identity."""
    x = rng.normal(size=(1, 3, 16, 20)).astype(np.float32)
    xt = torch.from_numpy(x)
    if ksize is None:
        assert t_fd.htran_operator(None)(xt) is xt
        assert t_fd.htran_operator(torch.zeros(0))(xt) is xt
        return
    k = rng.random((1, 1, *ksize)).astype(np.float32)
    k /= k.sum()
    want = np.asarray(j_fd.htran_operator(jnp.asarray(k, jnp.float32))(jnp.asarray(x, jnp.float32)))
    got = t_fd.htran_operator(torch.from_numpy(k))(xt).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("size,sigma", [(9, 1.5), (4, 1.0), (7, 2.0)])
def test_htran_operator_matches_the_oracle_and_the_fft_form(rng, size, sigma):
    """For the Gaussian PSFs of tests/test_fdops.py: the spatial H^T against
    the float64 oracle and against the solver's FFT form, 1e-5 in float32."""
    from tests.oracles import numpy_admm as oracle

    x = rng.normal(size=(2, 3, 16, 16))
    kern = oracle.gaussian_psf(size, sigma)
    want = oracle.htran(x, kern)
    xt, kt = torch.from_numpy(x.astype(np.float32)), torch.from_numpy(kern.astype(np.float32))
    got = t_fd.htran_operator(kt)(xt).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    via_fft = t_fd.htran_fft(xt, t_fd.psf_otf_centered(kt, (16, 16)), (16, 16)).numpy()
    np.testing.assert_allclose(got, via_fft, rtol=0, atol=1e-5)


def test_train_script_trains_nafnet_one_epoch_on_the_cpu(tmp_path):
    """``scripts.train --arch nafnet --nafnet_width 8 --device cpu`` trains
    one epoch and writes a NAFNet checkpoint that the port's NAFNet loads."""
    root = _corpus(tmp_path, n_train=2, n_eval=2)
    cfg = {
        "train": {"ckpt": None, "x_path": str(root / "train" / "x"),
                  "y_path": str(root / "train" / "y"), "batch_size": 2},
        "eval": {"x_path": str(root / "test" / "x"), "y_path": str(root / "test" / "y"),
                 "batch_size": 2},
        "im_shape": [32, 32], "lr": 1e-3, "epochs": 1,
    }
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    env = single_thread_env(PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "torch_admm_deconv_tpu_torch.scripts.train", "--device", "cpu",
         "-c", "cfg.json", "-m", "0", "-M", "15", "-s", "runs", "-n", "naf", "--arch", "nafnet",
         "--nafnet_width", "8"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "EPOCH: 0" in out.stdout and "eval_color_lab_loss" in out.stdout
    (ckpt,) = (tmp_path / "runs" / "naf").glob("*/naf_epoch00_vloss*.tar")
    state = load_checkpoint(ckpt)["model_state_dict"]
    model = t_naf.NAFNet(img_channel=3, width=8, middle_blk_num=12, enc_blk_nums=(2, 2, 4, 8),
                         dec_blk_nums=(2, 2, 2, 2), device="cpu")
    model.load_state_dict(state)
    assert all(torch.isfinite(v).all() for v in state.values())
    assert float(state["enc_0_0.beta"].abs().max()) > 0  # trained away from 0
