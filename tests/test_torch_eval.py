"""The port's eval harness and serving script on the CPU: the BM3D copy,
``scripts.eval_algs`` against the JAX package's ``scripts/eval_algs.py``
(run in a subprocess on the CPU) on a tiny PNG corpus written here, and
``scripts.infer`` in ``--device cpu`` mode against the JAX package's
``scripts/infer.py``. Inputs come from numpy seeds."""

import csv
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests._threads import one_torch_thread, single_thread_env  # noqa: F401 (autouse)
from tests.test_torch_train_cli import _corpus
from torch_admm_deconv_tpu_torch.models.denoiser import flagship_divergent_restorer
from torch_admm_deconv_tpu_torch.models.nafnet import NAFNet
from torch_admm_deconv_tpu_torch.ops import bm3d as t_bm3d
from torch_admm_deconv_tpu_torch.scripts import eval_algs as t_eval
from torch_admm_deconv_tpu_torch.scripts import infer as t_infer

REPO = Path(__file__).resolve().parent.parent
PIL = pytest.importorskip("PIL.Image")
j_bm3d = pytest.importorskip("torch_admm_deconv_tpu.ops.bm3d")


def _run_jax_script(script, args, cwd):
    env = single_thread_env(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, str(REPO / "scripts" / script), *args], cwd=cwd,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_bm3d_copy_matches_jax_exactly(rng):
    """The copy is the same NumPy code: sigma estimate and both stages equal
    bit for bit on a 48 x 48 RGB image with AWGN sigma 15/255."""
    clean = np.clip(0.5 + 0.2 * rng.standard_normal((6, 6, 3)).repeat(8, 0).repeat(8, 1), 0, 1)
    noisy = np.clip(clean + 15 / 255 * rng.standard_normal(clean.shape), 0, 1).astype(np.float32)
    sigma = t_bm3d.estimate_sigma(noisy, channel_axis=-1)
    assert sigma == j_bm3d.estimate_sigma(noisy, channel_axis=-1)
    for stages in (1, 2):
        got = t_bm3d.bm3d(noisy, sigma, stages=stages)
        np.testing.assert_array_equal(got, j_bm3d.bm3d(noisy, sigma, stages=stages))
    mse = lambda a: float(np.mean((a - clean) ** 2))  # noqa: E731
    assert mse(got) < mse(noisy)


@pytest.mark.parametrize("protocol", [[], ["--blur_gaussian", "1.5"]], ids=["denoise", "deblur"])
def test_eval_script_matches_jax(tmp_path, protocol):
    """``--model classical --no-bm3d``, crop 32, maxit 10, AWGN 15 (and in
    the deblur protocol a circular 9 x 9 Gaussian blur, solved aniso with
    the true PSF), the same files and seed: every row of metrics.csv, SSIM,
    SCC and UIQ to 1e-5 relative, PSNR to 1e-4 dB, MSE to 1e-4 relative.
    Deblurring, UIQ to 2e-5: its windowed variances cancel in float32, so
    the two packages' UIQ of one and the same image differ by up to 2.8e-6
    here, and the deblurred crops (solves 6e-7 apart) read 1.05e-5."""
    root = _corpus(tmp_path, n_train=3, n_eval=0, size=(40, 48))
    common = ["--x_dir", str(root / "train" / "x"), "--y_dir", str(root / "train" / "y"),
              "--model", "classical", "--no-bm3d", "--crop", "32", "--maxit", "10",
              "--device", "cpu", *protocol]
    _run_jax_script("eval_algs.py", [*common, "--save_path", str(tmp_path / "jax")], tmp_path)
    t_eval.main([*common, "--save_path", str(tmp_path / "port")])
    want, got = _rows(tmp_path / "jax" / "metrics.csv"), _rows(tmp_path / "port" / "metrics.csv")
    assert [(r["image"], r["method"]) for r in got] == [(r["image"], r["method"]) for r in want]
    assert len(got) == 3 and {r["method"] for r in got} == {"admm"}
    uiq_rtol = 2e-5 if protocol else 1e-5
    for g, w in zip(got, want):
        for key, rtol in (("ssim", 1e-5), ("scc", 1e-5), ("uiq", uiq_rtol), ("mse", 1e-4)):
            np.testing.assert_allclose(float(g[key]), float(w[key]), rtol=rtol, err_msg=key)
        assert abs(float(g["psnr"]) - float(w["psnr"])) <= 1e-4
    assert (tmp_path / "port" / "002_admm.png").exists()


def test_evaluate_pair_columns_and_the_summary(rng):
    """The per-image function with the admm and bm3d columns on arrays: each
    column beats the noisy input's PSNR; the summary's PSNR is that of the
    mean MSE; an unported column raises with its roadmap item."""
    clean = np.clip(0.5 + 0.2 * rng.standard_normal((1, 3, 6, 6)).repeat(8, 2).repeat(8, 3), 0, 1)
    noisy = (clean + 15 / 255 * rng.standard_normal(clean.shape)).astype(np.float32)
    columns = {"admm": t_eval.admm_column(0.05, 1.0, 50, device="cpu"),
               "bm3d": t_eval.bm3d_column}
    outs, rows, seconds = t_eval.evaluate_pair(noisy, clean.astype(np.float32), columns,
                                               device="cpu")
    assert [r["method"] for r in rows] == ["admm", "bm3d"] and set(seconds) == set(columns)
    p_noisy = 10 * np.log10(1 / np.mean((noisy - clean) ** 2))
    for r in rows:
        assert outs[r["method"]].shape == clean.shape
        assert r["psnr"] > p_noisy, (r, p_noisy)
        np.testing.assert_allclose(r["psnr"], 10 * np.log10(1 / r["mse"]), rtol=1e-5)
    (line,) = [s for s in t_eval.summary([{"image": 0, **rows[0]}], 1.0)]
    assert f"PSNR(from mean MSE)={10 * np.log10(1 / rows[0]['mse']):.3f} dB" in line
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        t_eval.main(["--x_dir", ".", "--y_dir", ".", "--model", "learned_prox", "--device", "cpu"])


def test_eval_script_model_and_nafnet_columns(tmp_path):
    """``--ckpt`` (the flagship from a checkpoint in the saver's format)
    and ``--nafnet_ckpt`` at ``--nafnet_width 8``: each column's row, with
    finite metrics, and its PNG."""
    root = _corpus(tmp_path, n_train=1, n_eval=0, size=(40, 48))
    gen = torch.Generator().manual_seed(0)
    flagship = flagship_divergent_restorer(device="cpu", generator=gen)
    nafnet = NAFNet(img_channel=3, width=8, middle_blk_num=12, enc_blk_nums=(2, 2, 4, 8),
                    dec_blk_nums=(2, 2, 2, 2), device="cpu", generator=gen)
    with torch.no_grad():
        for name, p in nafnet.named_parameters():
            if name.endswith(("beta", "gamma")):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    for name, model in (("flagship", flagship), ("nafnet", nafnet)):
        torch.save({"epoch": 0, "model_state_dict": model.state_dict(), "loss": 0.0},
                   tmp_path / f"{name}.tar")
    t_eval.main(["--x_dir", str(root / "train" / "x"), "--y_dir", str(root / "train" / "y"),
                 "--ckpt", str(tmp_path / "flagship.tar"), "--nafnet_ckpt",
                 str(tmp_path / "nafnet.tar"), "--nafnet_width", "8", "--no-bm3d", "--crop",
                 "32", "--device", "cpu", "--save_path", str(tmp_path / "out")])
    rows = _rows(tmp_path / "out" / "metrics.csv")
    assert [r["method"] for r in rows] == ["model", "nafnet"]
    assert all(np.isfinite(float(r[k])) for r in rows for k in t_eval.METRICS)
    for name in ("clean", "noisy", "model", "nafnet"):
        assert (tmp_path / "out" / f"000_{name}.png").exists()


def _png(path, rng, h=40, w=52):
    img = (rng.random((3, h // 4, w // 4)) * 255).repeat(4, 1).repeat(4, 2)
    img = np.clip(img + rng.normal(0, 15, img.shape), 0, 255)
    PIL.fromarray(img.transpose(1, 2, 0).astype(np.uint8)).save(path)


def test_infer_script_matches_jax_and_reports_its_path(tmp_path, rng, capsys):
    """Default isotropic 'compat' TV at batch 2: the FFT loop in both
    packages, outputs within one grey level of the JAX script's; --aniso,
    with and without a Gaussian PSF, reports the whole-solve kernel (its
    plain version here)."""
    _png(tmp_path / "noisy.png", rng)
    flags = ["--input", str(tmp_path / "noisy.png"), "--maxit", "10", "--tile", "32",
             "--margin", "4", "--max_batch", "2"]
    _run_jax_script("infer.py", [*flags, "--output", str(tmp_path / "jax")], tmp_path)
    t_infer.main([*flags, "--output", str(tmp_path / "port"), "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    batches = [ln for ln in lines if ": batch " in ln]
    assert batches and all(ln.endswith("FFT loop") for ln in batches), lines
    got = np.asarray(PIL.open(tmp_path / "port" / "noisy_restored.png"), np.int16)
    want = np.asarray(PIL.open(tmp_path / "jax" / "noisy_restored.png"), np.int16)
    assert got.shape == want.shape == (40, 52, 3)
    assert np.abs(got - want).max() <= 1

    for extra in ([], ["--psf_gaussian", "5", "1.0"]):
        t_infer.main([*flags, "--output", str(tmp_path / "aniso"), "--device", "cpu", "--aniso",
                      *extra])
        batches = [ln for ln in capsys.readouterr().out.splitlines() if ": batch " in ln]
        assert batches and all(ln.endswith("K2 (aniso)") for ln in batches)


def test_infer_script_serves_a_port_checkpoint(tmp_path, rng, capsys):
    """--model divergent loads a checkpoint of the port's saver format into
    the flagship and serves it; at batch 2 its 'compat' layers take the FFT
    loop; at batch 1 the whole-solve kernel ('sample')."""
    _png(tmp_path / "noisy.png", rng, 24, 24)
    model = flagship_divergent_restorer(device="cpu", generator=torch.Generator().manual_seed(0))
    torch.save({"epoch": 0, "model_state_dict": model.state_dict(), "loss": 0.0},
               tmp_path / "flagship.tar")
    flags = ["--input", str(tmp_path / "noisy.png"), "--model", "divergent", "--ckpt",
             str(tmp_path / "flagship.tar"), "--tile", "32", "--margin", "4", "--device", "cpu"]
    for batch, path in (("2", "FFT loop"), ("1", "K2 (sample)")):
        t_infer.main([*flags, "--output", str(tmp_path / batch), "--max_batch", batch])
        batches = [ln for ln in capsys.readouterr().out.splitlines() if ": batch " in ln]
        assert batches and all(ln.endswith(path) for ln in batches), batches
        out = np.asarray(PIL.open(tmp_path / batch / "noisy_restored.png"))
        assert out.shape == (24, 24, 3)
