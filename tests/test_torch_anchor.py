"""The port's single-image anchor (``scripts.single_image_anchor``) on the
CPU: the arrays-in function against the JAX script's computation (a reduced
``DivergentRestorer`` from converted Flax params, ``model.apply`` with its
ADMM layers on K2 in interpret mode, and ``admm_tv``), held as the flagship
tests hold the model: its ADMM level tightly, its output loosely (the
gates' ties); then the CLI with ``--device cpu``."""

import json
import re

import numpy as np
import pytest
import torch

from tests._threads import one_torch_thread  # noqa: F401 (autouse)
from torch_admm_deconv_tpu_torch.convert import flax_to_torch
from torch_admm_deconv_tpu_torch.scripts import single_image_anchor as t_anchor

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
Image = pytest.importorskip("PIL.Image")

from torch_admm_deconv_tpu.metrics import functional as jF  # noqa: E402
from torch_admm_deconv_tpu.models import denoiser as j_den  # noqa: E402
from torch_admm_deconv_tpu.ops.solver import admm_tv as j_admm_tv  # noqa: E402

# the --model_cfg of a reduced flagship: [2, 4] branches, 16 filters, 10 iterations
CFG = {"level_branches": [2, 4], "filters": 16, "attention_reduction": 8, "admm_iters": 10}


def _jax_model():
    """The JAX script's DivergentRestorer for ``CFG`` (single_image_anchor.py:75-90)."""
    admm = {"kern_size": (), "max_iters": CFG["admm_iters"], "iso": True, "remat": False,
            "use_pallas": True}
    return j_den.DivergentRestorer(
        level_branches=CFG["level_branches"], in_channels=3, final_channels=3,
        filters=CFG["filters"], gate_channels=CFG["filters"],
        attention_reduction=CFG["attention_reduction"], output_activation=jax.nn.sigmoid,
        admms=[dict(admm), dict(admm)])


def _clean(rng, shape):
    coarse = rng.uniform(0.1, 0.9, (1, 3, shape[0] // 8, shape[1] // 8))
    return coarse.repeat(8, 2).repeat(8, 3).astype(np.float32)


def test_anchor_matches_jax(rng):
    """(1, 3, 16, 128), AWGN 15 from seed 0, lambda 0.2, rho 0.5: the noisy
    input is the JAX script's; the model's ADMM level within 1e-4 of JAX's
    and its output within 2e-3 (the flagship tests' bars); the admm column
    within 1e-5 of JAX ``admm_tv``; each row's PSNR and SSIM as JAX's metrics
    read the outputs (noisy and admm 1e-4 dB / 1e-5; model 0.05 dB / 2e-4)."""
    clean = _clean(rng, (16, 128))
    noisy = t_anchor.add_noise(clean, 15.0, 0)
    want_noisy = np.clip(clean + (15.0 / 255.0) * np.random.default_rng(0).standard_normal(
        clean.shape), 0.0, 1.0).astype(np.float32)
    np.testing.assert_array_equal(noisy, want_noisy)

    xj, yj = jnp.asarray(noisy, jnp.float32), jnp.asarray(clean, jnp.float32)
    j_model = _jax_model()
    params = j_model.init(jax.random.PRNGKey(0), xj)
    model = t_anchor.build_model(CFG, "cpu")
    model.load_state_dict(flax_to_torch(jax.tree_util.tree_map(np.asarray, params)))
    model.eval()
    level0 = {}
    model.block_0.register_forward_hook(lambda m, i, o: level0.__setitem__("out", o))
    outs, rows = t_anchor.anchor(clean, noisy, model, 0.2, 0.5, "cpu")

    want, state = j_model.apply(params, xj, capture_intermediates=True,
                                mutable=["intermediates"])
    np.testing.assert_allclose(level0["out"].numpy(),
                               np.asarray(state["intermediates"]["block_0"]["__call__"][0]),
                               atol=1e-4)
    np.testing.assert_allclose(outs["model"], np.asarray(want), atol=2e-3)
    want_admm = np.asarray(j_admm_tv(xj, 0.2, 0.5, None, iso=True, maxit=100))
    np.testing.assert_allclose(outs["admm"], want_admm, atol=1e-5)
    np.testing.assert_array_equal(outs["noisy"], noisy)

    assert [r["method"] for r in rows] == ["noisy", "model", "admm"]
    for row in rows:
        out = jnp.asarray(outs[row["method"]])
        p_tol, s_tol = (0.05, 2e-4) if row["method"] == "model" else (1e-4, 1e-5)
        assert abs(row["psnr"] - float(jF.psnr(out, yj))) <= p_tol, row
        assert abs(row["ssim"] - float(jF.ssim(out, yj))) <= s_tol, row
    by = {r["method"]: r for r in rows}
    assert by["admm"]["psnr"] > by["noisy"]["psnr"]


def test_default_model_is_the_flagship_on_k2():
    model = t_anchor.build_model(None, "cpu")
    assert model.block_0.admm_0.use_pallas and model.block_0.admm_1.max_iters == 100
    assert not model.remat_levels
    assert dict(model.named_parameters())["block_0.conv_0.weight"].shape == (86, 3, 1, 1)


def test_anchor_cli_writes_the_summary(tmp_path, capsys):
    """``--model_cfg`` (the reduced flagship), a checkpoint in the trainer's
    format and a 280 x 300 PNG, with ``--device cpu``: the four PNGs, and
    ``summary.md`` with the three rows that the script prints."""
    rng = np.random.default_rng(5)
    img = tmp_path / "clean.png"
    Image.fromarray((_clean(rng, (280, 304))[0, :, :, :300].transpose(1, 2, 0) * 255).astype(
        np.uint8)).save(img)
    torch.manual_seed(0)
    model = t_anchor.build_model(CFG, "cpu")
    torch.save({"epoch": 0, "model_state_dict": model.state_dict(), "loss": 0.0},
               tmp_path / "ckpt.tar")
    (tmp_path / "cfg.json").write_text(json.dumps(CFG))
    save = tmp_path / "out"
    t_anchor.main(["--ckpt", str(tmp_path / "ckpt.tar"), "--image", str(img), "--save_path",
                   str(save), "--model_cfg", str(tmp_path / "cfg.json"), "--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    assert sorted(p.name for p in save.glob("*.png")) == ["admm.png", "clean.png", "model.png",
                                                          "noisy.png"]
    assert Image.open(save / "model.png").size == (256, 256)
    summary = (save / "summary.md").read_text()
    assert summary.startswith("# Single-image anchor")
    assert "(center 256^2 crop), AWGN sigma=15.0/255, seed 0" in summary
    table = re.findall(r"^\| (\w+) \| (\S+) \| (\S+) \|$", summary, re.M)
    assert [t[0] for t in table] == ["noisy", "model", "admm"]
    for (name, p, s), line in zip(table, printed):
        assert line == f"{name}: PSNR={p} dB SSIM={s}"
        assert np.isfinite(float(p)) and 0 < float(s) <= 1
    assert float(table[2][1]) > float(table[0][1])
    assert printed[3] == f"wrote {save}/summary.md"
    loaded = t_anchor.load_model(tmp_path / "ckpt.tar", CFG, "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v)
