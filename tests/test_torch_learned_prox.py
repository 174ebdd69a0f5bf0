"""The learned-prox ADMM (BASELINE.json config 4) held against the JAX
package on the CPU: forward and gradients in float64 in its three PSF modes,
with and without remat; the fresh model as the classical anisotropic solve;
the shared factory's state dict; and the train and eval scripts'
``learned_prox`` paths against the JAX eval script (run in a subprocess).
Weights come from one Flax init through ``convert.flax_to_torch``, inputs
from numpy seeds."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests._threads import one_torch_thread, single_thread_env  # noqa: F401 (autouse)
from torch_admm_deconv_tpu_torch.convert import flax_to_torch
from torch_admm_deconv_tpu_torch.data import gaussian_psf_np
from torch_admm_deconv_tpu_torch.models import learned_prox as t_lp
from torch_admm_deconv_tpu_torch.ops.solver import admm_tv
from torch_admm_deconv_tpu_torch.scripts import eval_algs as t_eval
from torch_admm_deconv_tpu_torch.scripts import train as t_train

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from torch_admm_deconv_tpu.models import learned_prox as j_lp  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PSF5 = tuple(float(v) for v in gaussian_psf_np(5, 1.0).reshape(-1))
# kern_size and psf_fixed of the three PSF modes
MODES = {"denoise": ((), None), "learned_psf": ((5, 5), None), "fixed_psf": ((5, 5), PSF5)}


def _img(rng, shape, dtype=np.float32):
    return (rng.normal(size=shape) * 0.1 + 0.5).astype(dtype)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("mode", list(MODES))
def test_forward_and_gradients_match_jax_in_float64(rng, mode, remat):
    """3 stages, hidden 8, (2, 3, 12, 16), float64 on both sides. The output
    conv is set to small random weights (at its zero init the prox net's
    inner convs get no gradient). Forward to 1e-10; the gradient of
    mean((out - 0.5)^2) for lambda, rho, the PSF ``w`` and every prox-net
    weight to 1e-6 of the leaf's largest entry."""
    kern_size, psf = MODES[mode]
    kw = dict(steps=3, channels=3, kern_size=kern_size, hidden=8, remat=remat, psf_fixed=psf)
    x = _img(rng, (2, 3, 12, 16), np.float64)
    j_model = j_lp.LearnedProxADMM(**kw)
    params = jax.tree_util.tree_map(np.asarray, j_model.init(jax.random.PRNGKey(0),
                                                             jnp.asarray(x, jnp.float32)))
    conv_out = params["params"]["prox"]["conv_out"]
    # float32 values: flax_to_torch hands the port float32 copies
    conv_out["kernel"] = (0.05 * rng.normal(size=conv_out["kernel"].shape)).astype(np.float32)
    conv_out["bias"] = (0.01 * rng.normal(size=conv_out["bias"].shape)).astype(np.float32)
    params = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float64), params)
    assert ("w" in params["params"]) == (mode == "learned_psf")

    def loss(p):
        out = j_model.apply(p, jnp.asarray(x))
        return jnp.mean((out - 0.5) ** 2), out

    (_, want_out), want = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    want = flax_to_torch(jax.tree_util.tree_map(lambda v: np.asarray(v, np.float64), want))

    t_model = t_lp.LearnedProxADMM(**kw, device="cpu").double()
    t_model.load_state_dict(flax_to_torch(params))
    out = t_model(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=0, atol=1e-10)
    torch.mean((out - 0.5) ** 2).backward()
    grads = dict((n, p.grad) for n, p in t_model.named_parameters())
    assert set(grads) == set(want)
    assert {"lmbda", "rho", "prox.conv_in.weight", "prox.conv_0.weight"} <= set(grads)
    for name, g in grads.items():
        w = want[name].double()
        scale = float(w.abs().max())
        assert scale > 0, name
        assert float((g - w).abs().max()) <= 1e-6 * scale, name


@pytest.mark.parametrize("use_pallas", [False, True], ids=["loop", "whole_solve"])
@pytest.mark.parametrize("kern", [0, 9])
def test_fresh_model_is_the_classical_aniso_solve(rng, kern, use_pallas):
    """At init the output conv is zero, so each stage's prox is the soft
    threshold: the fresh model (10 stages, hidden 32, seed-0 weights) equals
    ``admm_tv(x, 0.05, 1.0, psf, iso=False, maxit=10)`` within 1e-5 in
    float32, denoising (kern 0) and with a fixed 9x9 Gaussian (kern 9), on
    the FFT loop and on the whole-solve kernel's plain version (the solve
    chip_smoke phase 15 runs on K2)."""
    psf = gaussian_psf_np(9, 1.5) if kern else None
    model = t_lp.default_learned_prox(kern=kern, psf=psf, device="cpu",
                                      generator=torch.Generator().manual_seed(0))
    assert "w" not in dict(model.named_parameters())
    x = torch.from_numpy(_img(rng, (1, 3, 32, 40)))
    with torch.no_grad():
        got = model(x)
    kern_t = None if psf is None else torch.from_numpy(psf.reshape(1, 1, 9, 9))
    want = admm_tv(x, 0.05, 1.0, kern_t, iso=False, maxit=10, use_pallas=use_pallas,
                   device="cpu")
    assert float((got - want).abs().max()) <= 1e-5


def test_factory_gives_one_state_dict_on_both_sides():
    """``build_model("learned_prox", ...)`` (the train script) and
    ``default_learned_prox`` with ``learned_prox_psf`` (the eval script)
    give the same state-dict keys and shapes as the JAX factory's tree:
    denoising, a learnable 9x9 PSF ``w``, and a fixed one (no ``w``)."""
    x = jnp.zeros((1, 3, 16, 16), jnp.float32)
    for kern, sigma in ((0, 0.0), (9, 0.0), (9, 1.5)):
        psf = t_train.learned_prox_psf(kern, sigma)
        train_side = t_train.build_model("learned_prox", lp_kern=kern, lp_psf_sigma=sigma,
                                         device="cpu").state_dict()
        eval_side = t_lp.default_learned_prox(kern=kern, psf=psf, device="cpu").state_dict()
        jax_tree = j_lp.default_learned_prox(kern=kern, psf=psf).init(jax.random.PRNGKey(0), x)
        want = {k: tuple(v.shape) for k, v in flax_to_torch(
            jax.tree_util.tree_map(np.asarray, jax_tree)).items()}
        for side in (train_side, eval_side):
            assert {k: tuple(v.shape) for k, v in side.items()} == want
        assert ("w" in want) == (kern == 9 and sigma == 0.0)


def _to_flax(state_dict):
    """The port's learned-prox state dict as the JAX module's param tree
    (convs are OIHW on both sides; only the leaf names differ)."""
    tree = {}
    for name, value in state_dict.items():
        *parents, leaf = name.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[{"weight": "kernel"}.get(leaf, leaf) if parents else leaf] = value.numpy()
    return {"params": tree}


def test_train_and_eval_scripts_match_jax(tmp_path, monkeypatch):
    """``scripts.train --arch learned_prox --lp_kern 5 --lp_psf_sigma 1.0
    --blur_gaussian 1.0 --blur_ksize 5 --device cpu`` trains one epoch and
    writes a checkpoint; ``scripts.eval_algs --model learned_prox`` reads it
    with the same flags, and the JAX eval script reads the same weights: the
    ``model`` column's rows agree, SSIM, SCC, UIQ and MSE to 1e-4 relative,
    PSNR to 1e-4 dB (one float32 solve in each package)."""
    from flax import serialization

    from tests.test_torch_train_cli import _config, _corpus
    from torch_admm_deconv_tpu_torch.train import load_checkpoint

    root = _corpus(tmp_path, n_train=2, n_eval=2, size=(40, 48))
    cfg = _config(root)
    lp = ["--lp_kern", "5", "--lp_psf_sigma", "1.0", "--blur_gaussian", "1.0",
          "--blur_ksize", "5"]
    monkeypatch.chdir(tmp_path)
    t_train.main(["-c", str(cfg), "--device", "cpu", "--arch", "learned_prox", "-m", "0",
                  "-M", "15", "-s", "runs", "-n", "lp", *lp])
    (ckpt,) = (tmp_path / "runs" / "lp").glob("*/lp_epoch00_vloss*.tar")
    state = load_checkpoint(ckpt)["model_state_dict"]
    assert "w" not in state and {"lmbda", "rho", "prox.conv_out.weight"} <= set(state)
    jax_ckpt = tmp_path / "lp_jax.tar"
    jax_ckpt.write_bytes(serialization.msgpack_serialize(
        {"epoch": 0, "model_state_dict": _to_flax(state), "loss": 0.0}))

    common = ["--x_dir", str(root / "train" / "x"), "--y_dir", str(root / "train" / "y"),
              "--model", "learned_prox", "--no-bm3d", "--crop", "32", "--device", "cpu", *lp]
    t_eval.main([*common, "--ckpt", str(ckpt), "--save_path", str(tmp_path / "port")])
    env = single_thread_env(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, str(REPO / "scripts" / "eval_algs.py"), *common,
                          "--ckpt", str(jax_ckpt), "--save_path", str(tmp_path / "jax")],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]

    def rows(path):
        import csv

        with open(path) as f:
            return list(csv.DictReader(f))

    got, want = rows(tmp_path / "port" / "metrics.csv"), rows(tmp_path / "jax" / "metrics.csv")
    assert [(r["image"], r["method"]) for r in got] == [(r["image"], r["method"]) for r in want]
    assert len(got) == 2 and {r["method"] for r in got} == {"model"}
    for g, w in zip(got, want):
        for key in ("ssim", "scc", "uiq", "mse"):
            np.testing.assert_allclose(float(g[key]), float(w[key]), rtol=1e-4, err_msg=key)
        assert abs(float(g["psnr"]) - float(w["psnr"])) <= 1e-4
