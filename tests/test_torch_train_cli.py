"""The port's data loading and training script on the CPU: batches
bit-identical to the JAX package's under one seed, one epoch of
``python -m torch_admm_deconv_tpu_torch.scripts.train --device cpu`` on a
tiny PNG corpus written here, the CUDA default, and imports without PIL."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_admm_deconv_tpu_torch import data as t_data
from torch_admm_deconv_tpu_torch.scripts import train as t_script
from torch_admm_deconv_tpu_torch.train import load_checkpoint

REPO = Path(__file__).resolve().parent.parent
PIL = pytest.importorskip("PIL.Image")


def _corpus(root: Path, n_train=4, n_eval=2, size=(40, 48), seed=0):
    """Paired PNG folders: y a smooth image, x a noisy copy."""
    rng = np.random.default_rng(seed)
    for phase, n in (("train", n_train), ("test", n_eval)):
        for sub in ("x", "y"):
            (root / phase / sub).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            y = (rng.random((3, 5, 6)) * 255).repeat(8, 1).repeat(8, 2)[:, : size[0], : size[1]]
            x = np.clip(y + rng.normal(0, 20, y.shape), 0, 255)
            for sub, img in (("x", x), ("y", y)):
                PIL.fromarray(img.transpose(1, 2, 0).astype(np.uint8)).save(
                    root / phase / sub / f"im{i:02d}.png")
    return root


def _config(root: Path, **extra):
    cfg = {
        "train": {"ckpt": None, "x_path": str(root / "train" / "x"),
                  "y_path": str(root / "train" / "y"), "batch_size": 2},
        "eval": {"x_path": str(root / "test" / "x"), "y_path": str(root / "test" / "y"),
                 "batch_size": 2},
        "im_shape": [32, 32], "lr": 1e-3, "epochs": 1,
        "model": {"level_branches": [2, 2], "filters": 4, "attention_reduction": 2,
                  "admm_iters": 2},
    }
    cfg.update(extra)
    path = root / "cfg.json"
    path.write_text(json.dumps(cfg))
    return path


@pytest.mark.parametrize("compat_unsorted", [False, True])
def test_loader_batches_match_jax(tmp_path, compat_unsorted):
    """The same files, transforms and seed give bit-identical batches, two
    epochs running (the loader's generator carries over)."""
    j_data = pytest.importorskip("torch_admm_deconv_tpu.data")
    root = _corpus(tmp_path)
    psf = t_data.gaussian_psf_np(5, 1.0)
    np.testing.assert_array_equal(psf, j_data.gaussian_psf_np(5, 1.0))

    def loader(pkg):
        transforms = [pkg.RandCrop((32, 24)), pkg.Scale(), pkg.CircBlur(psf),
                      pkg.AddAWGN(std_range=(0, 15))]
        dset = pkg.ImageDataset(root / "train" / "x", root / "train" / "y", transforms,
                                compat_unsorted=compat_unsorted)
        return pkg.DataLoader(dset, batch_size=3, shuffle=True, seed=7, drop_last=False)

    got, want = loader(t_data), loader(j_data)
    assert len(got) == len(want) == 2
    for _ in range(2):
        pairs = list(zip(got, want))
        assert len(pairs) == 2
        for (gx, gy), (wx, wy) in pairs:
            assert gx.dtype == np.float32 and gx.shape[1:] == (3, 32, 24)
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def test_train_script_one_epoch_on_the_cpu(tmp_path, monkeypatch):
    """``python -m ...scripts.train --device cpu`` with the config's model
    override trains one epoch and writes a checkpoint and the metric CSV;
    the config's ``train.ckpt`` then starts a second run from it."""
    root = _corpus(tmp_path)
    cfg = _config(root)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "torch_admm_deconv_tpu_torch.scripts.train", "--device", "cpu",
         "-c", str(cfg), "-m", "0", "-M", "15", "-s", "runs", "-n", "tiny"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "EPOCH: 0" in out.stdout and "eval_color_lab_loss" in out.stdout
    (run_dir,) = (tmp_path / "runs" / "tiny").iterdir()
    (ckpt,) = run_dir.glob("tiny_epoch00_vloss*.tar")
    header = (run_dir / "logged_metrics.csv").read_text().splitlines()[0].split(",")
    assert {"train_color_lab_loss", "eval_psnr", "eval_scc", "eval_ssim", "eval_mae_loss",
            "eval_uiq", "eval_mse"} <= set(header)
    state = load_checkpoint(ckpt)
    assert state["epoch"] == 0 and np.isfinite(state["loss"])
    assert "block_0.admm_0.lmbda" in state["model_state_dict"]

    cfg2 = _config(root, train={**json.loads(cfg.read_text())["train"], "ckpt": str(ckpt)},
                   epochs=0)
    monkeypatch.chdir(tmp_path)
    trainer = t_script.init_training(str(cfg2), 0, 15, "runs2", "tiny", device="cpu")
    for name, value in state["model_state_dict"].items():
        torch.testing.assert_close(trainer.model.state_dict()[name], value, rtol=0, atol=0)


def test_entry_points_need_a_card_or_the_cpu(tmp_path, monkeypatch):
    """Without ``--device cpu`` and without a card the script raises; with
    ``--device cpu`` ``--arch learned_prox`` trains its epoch there and
    writes a checkpoint."""
    root = _corpus(tmp_path, n_train=2, n_eval=2)
    cfg = _config(root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_script.main(["-c", str(cfg)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_script.init_training(str(cfg), 0, 15, "runs", "tiny")
    t_script.main(["-c", str(cfg), "--device", "cpu", "--arch", "learned_prox", "-s", "runs",
                   "-n", "lp"])
    (ckpt,) = (tmp_path / "runs" / "lp").glob("*/lp_epoch00_vloss*.tar")
    assert {"lmbda", "rho", "prox.conv_out.weight"} <= set(load_checkpoint(ckpt)["model_state_dict"])


def test_training_modules_import_without_pil_or_jax():
    """PIL is needed only to read image files: the data, metrics and
    training modules and the script import with PIL (and JAX, flax, the JAX
    package) blocked, and reading an image raises ImportError."""
    code = (
        "import sys, importlib\n"
        "for name in ('PIL', 'jax', 'flax', 'torch_admm_deconv_tpu'):\n"
        "    sys.modules[name] = None\n"
        "for m in ('torch_admm_deconv_tpu_torch', 'torch_admm_deconv_tpu_torch.data',\n"
        "          'torch_admm_deconv_tpu_torch.metrics', 'torch_admm_deconv_tpu_torch.train',\n"
        "          'torch_admm_deconv_tpu_torch.scripts.train'):\n"
        "    importlib.import_module(m)\n"
        "from torch_admm_deconv_tpu_torch.data import read_image_chw\n"
        "try:\n"
        "    read_image_chw('missing.png')\n"
        "except ImportError:\n"
        "    print('needs PIL')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "needs PIL"
