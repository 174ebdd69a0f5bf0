"""The port's two multi-device scripts, each launched as a user would: through
``python -m torch.distributed.run --nproc_per_node 2`` with ``--device cpu``
(two gloo ranks), at a small size, read through their printed lines and the
saved checkpoint. The megapixel bench's lines are held against the JAX
script's on a 2-device CPU mesh (a subprocess), both from the same seeded
scene."""

import json
import math
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tests._threads import one_torch_thread, single_thread_env  # noqa: F401 (autouse)
from tests._torch_dist import free_port

REPO = Path(__file__).resolve().parent.parent


def _torchrun(module: str, args, cwd: Path, timeout: float = 240.0) -> str:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node",
           "2", "--master_addr", "localhost", "--master_port", str(free_port()), "-m", module,
           "--device", "cpu", *args]
    out = subprocess.run(cmd, cwd=cwd, env=single_thread_env(PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout


def _json_lines(stdout: str) -> dict:
    return {d["metric"]: d for d in (json.loads(line) for line in stdout.splitlines()
                                     if line.startswith("{"))}


@pytest.mark.parametrize("mode,bar", [("halo", 1e-3), ("pencil", 5e-4)])
def test_megapixel_bench_two_ranks(tmp_path, mode, bar):
    """``scripts.megapixel_bench --size 128 --x_update_mode MODE`` on 2
    ranks: rank 0 prints the rate line, the oracle line and the device line;
    the restored PSNR beats the blurred one; the error against the
    unsharded ``admm_tv`` is within JAX's bar for the mode
    (tests/test_spatial.py); and both PSNRs are the JAX script's at 2
    shards, to its 3 printed decimals."""
    args = ["--size", "128", "--x_update_mode", mode]
    lines = _json_lines(_torchrun("torch_admm_deconv_tpu_torch.scripts.megapixel_bench", args,
                                  tmp_path))
    rate = lines[f"megapixel_128x128_spatial_{mode}_2shards"]
    assert rate["unit"] == "iterations/s" and rate["value"] > 0 and rate["solve_s"] > 0
    assert rate["halo"] == 32
    assert rate["psnr_restored"] > rate["psnr_blurred"] + 1.0
    oracle = lines["megapixel_max_err_vs_unsharded_oracle"]
    assert oracle["value"] <= bar and oracle["oracle_solve_s"] > 0
    assert lines["megapixel_device"]["card"] == "cpu" and lines["megapixel_device"]["ranks"] == 2

    env = single_thread_env(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    env["XLA_FLAGS"] = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                              env["XLA_FLAGS"]) + " --xla_force_host_platform_device_count=2"
    out = subprocess.run([sys.executable, str(REPO / "scripts" / "megapixel_bench.py"),
                          "--platform", "cpu", *args], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    want = _json_lines(out.stdout)[f"megapixel_128x128_spatial_{mode}_2shards"]
    for key in ("psnr_blurred", "psnr_restored"):
        assert abs(rate[key] - want[key]) <= 1e-3, (key, rate[key], want[key])


def test_train_dp_two_ranks(tmp_path):
    """``scripts.train_dp`` on 2 ranks, 2 stages, 1 epoch, global batch 2
    on 4 tiny PNGs: 2 data-parallel steps, finite global-mean losses, the
    best checkpoint saved by rank 0 with the state dict of
    ``default_learned_prox`` for the deblur protocol (fixed 9x9 PSF, no
    ``w``), lambda and rho inside the clamp."""
    from tests.test_torch_train_cli import _corpus
    from torch_admm_deconv_tpu_torch.models.learned_prox import default_learned_prox
    from torch_admm_deconv_tpu_torch.train import load_checkpoint

    root = _corpus(tmp_path / "data", n_train=4, n_eval=2)
    stdout = _torchrun("torch_admm_deconv_tpu_torch.scripts.train_dp", [
        "--train_dir", str(root / "train" / "y"), "--eval_dir", str(root / "test" / "y"),
        "--crop", "32", "--epochs", "1", "--steps", "2", "--global_batch", "2",
        "--save_dir", "runs"], tmp_path)
    assert "[dp] mesh: 2 ranks on axis 'data' (gloo); global batch 2 (1/rank)" in stdout
    m = re.search(r"\[dp\] epoch 0: train_loss (\S+) \((\d+) dp steps\), eval_loss (\S+), "
                  r"eval_psnr (\S+) dB", stdout)
    assert m, stdout
    train_loss, steps, eval_loss, psnr = float(m[1]), int(m[2]), float(m[3]), float(m[4])
    assert steps == 2 and all(math.isfinite(v) for v in (train_loss, eval_loss, psnr))
    assert f"[dp] done; best eval loss {eval_loss:.4f}" in stdout
    (ckpt,) = (tmp_path / "runs" / "learned_prox_deblur_dp").glob("*/*_epoch00_vloss*.tar")
    state = load_checkpoint(ckpt)
    assert state["epoch"] == 0 and abs(state["loss"] - eval_loss) <= 5e-5
    want = default_learned_prox(kern=9, steps=2, psf=torch.ones(81).numpy() / 81,
                                device="cpu").state_dict()
    got = state["model_state_dict"]
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape)
                                                           for k, v in want.items()}
    assert "w" not in got
    assert all(1e-12 <= float(got[k]) <= 5.0 for k in ("lmbda", "rho"))


@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed", "adaptive"])
def test_megapixel_demo_two_ranks(tmp_path, adaptive):
    """``examples.megapixel_demo --size 128`` (and ``--adaptive``) on 2
    ranks against JAX ``spatial_admm_tv(_adaptive)`` on a 2-device mesh in
    this process, on the same seeded checkerboard: the restored image (rank
    0's ``--save``) within 1e-5, the adaptive iterations within 1, and the
    printed lines."""
    import numpy as np

    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from torch_admm_deconv_tpu.parallel import make_mesh, spatial_admm_tv, spatial_admm_tv_adaptive
    from torch_admm_deconv_tpu_torch.examples.megapixel_demo import scene
    from torch_admm_deconv_tpu_torch.metrics.functional import psnr_np as psnr

    args = ["--size", "128", "--save", str(tmp_path / "out.npy")] + (
        ["--adaptive"] if adaptive else [])
    lines = _torchrun("torch_admm_deconv_tpu_torch.examples.megapixel_demo", args,
                      tmp_path).splitlines()
    got = np.load(tmp_path / "out.npy")

    img, noisy = scene(128)  # examples/megapixel_demo.py:48-53
    rng = np.random.default_rng(0)
    want_noisy = np.clip(img + 0.05 * rng.normal(size=img.shape), 0, 1).astype(np.float32)
    np.testing.assert_array_equal(noisy, want_noisy)
    mesh = make_mesh((2,), ("space",), devices=jax.devices()[:2])
    x = jnp.asarray(noisy[None, None], jnp.float32)
    if adaptive:
        res = spatial_admm_tv_adaptive(x, 0.05, 1.0, None, maxit=50, tol=1e-4, mesh=mesh)
        want = np.asarray(res.x)[0, 0]
        m = re.match(r"adaptive spatial solve: (\d+) iters, r=(\S+), ", lines[1])
        assert m and abs(int(m[1]) - int(res.iters)) <= 1 and float(m[2]) <= 1e-4
    else:
        want = np.asarray(spatial_admm_tv(x, 0.05, 1.0, None, maxit=50, mesh=mesh))[0, 0]
        assert lines[1].startswith("fixed spatial solve: 50 iters, ")
    assert lines[0] == "devices: 2 x cpu"
    assert np.abs(got - want).max() <= 1e-5
    assert lines[2] == f"PSNR {psnr(noisy, img):.2f} -> {psnr(got, img):.2f} dB on 128x128"
    assert psnr(got, img) > psnr(noisy, img) + 10.0
