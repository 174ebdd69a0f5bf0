"""The port's classical scripts on the CPU against the JAX package: the
rho/lambda grid sweep (``scripts.grid_sweep``) against the JAX script's
``solve_and_score`` and against the script itself (a subprocess), the solver
demo (``examples.solver_demo``) against the JAX example's computation and
its printed lines, the mixed-precision study's functions at a tiny shape,
and K2 'mixed' at the study's longer ``fast_frac`` settings against JAX
``admm_tv_vmem`` in interpret mode. Inputs come from numpy seeds."""

import csv
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests._threads import one_torch_thread, single_thread_env  # noqa: F401 (autouse)
from torch_admm_deconv_tpu_torch.examples import solver_demo as t_demo
from torch_admm_deconv_tpu_torch.kernels import vmem_solver as t_vmem
from torch_admm_deconv_tpu_torch.scripts import bench_mixed_precision as t_bmp
from torch_admm_deconv_tpu_torch.scripts import grid_sweep as t_grid

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
Image = pytest.importorskip("PIL.Image")

from tests.oracles import numpy_admm as oracle  # noqa: E402
from torch_admm_deconv_tpu.kernels.vmem_solver import admm_tv_vmem as j_vmem  # noqa: E402
from torch_admm_deconv_tpu.metrics import functional as jF  # noqa: E402
from torch_admm_deconv_tpu.ops.solver import admm_tv as j_admm_tv  # noqa: E402
from torch_admm_deconv_tpu.ops.solver import admm_tv_adaptive as j_adaptive  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
AWGN = {"denoise": 15.0, "deblur": 5.0}


def _clean(rng, n=4, size=32):
    """Piecewise-constant RGB images in [0.1, 0.9], (n, 3, size, size)."""
    coarse = rng.uniform(0.1, 0.9, (n, 3, size // 8, size // 8))
    return coarse.repeat(8, 2).repeat(8, 3).astype(np.float32)


def _jax_degrade(clean, mode, awgn, crop, seed):
    """scripts/grid_sweep.py:67-82, on arrays."""
    rng = np.random.default_rng(seed)
    kern, degraded = None, clean
    if mode == "deblur":
        k = oracle.gaussian_psf(9, 1.5)[0, 0].astype(np.float32)
        kern = k[None, None]
        K = np.fft.rfft2(np.roll(np.pad(k, ((0, crop - 9),) * 2), (-4, -4), (0, 1)))
        degraded = np.fft.irfft2(np.fft.rfft2(clean, axes=(2, 3)) * K, s=clean.shape[2:],
                                 axes=(2, 3)).astype(np.float32)
    noisy = np.clip(degraded + (awgn / 255.0) * rng.standard_normal(degraded.shape), 0.0,
                    1.0).astype(np.float32)
    return noisy, kern


def _jax_rows(clean, noisy, kern, lmbds, rhos, maxit):
    """scripts/grid_sweep.py:84-106: one jitted solve with traced scalars."""
    x, y = jnp.asarray(noisy, jnp.float32), jnp.asarray(clean, jnp.float32)
    k = None if kern is None else jnp.asarray(kern, jnp.float32)

    @jax.jit
    def solve_and_score(lmbd, rho):
        out = jnp.clip(j_admm_tv(x, lmbd, rho, k, iso=True, maxit=maxit), 0.0, 1.0)
        per_im_mse = jnp.mean((out - y) ** 2, axis=(1, 2, 3))
        return {"ssim": jF.ssim(out, y), "uiq": jF.uiq(out, y), "scc": jF.scc(out, y),
                "mean_mse": jnp.mean(per_im_mse)}

    rows = []
    for lmbd in lmbds:
        for rho in rhos:
            s = {k_: float(v) for k_, v in solve_and_score(jnp.float32(lmbd),
                                                           jnp.float32(rho)).items()}
            s["psnr_from_mean_mse"] = 10.0 * np.log10(1.0 / s.pop("mean_mse"))
            rows.append({"lmbd": lmbd, "rho": rho, **s})
    return rows


def _same_rows(got, want):
    """SSIM, UIQ and SCC within 1e-5, PSNR within 1e-4 dB, row by row."""
    assert [(r["lmbd"], r["rho"]) for r in got] == [(r["lmbd"], r["rho"]) for r in want]
    for g, w in zip(got, want):
        for key in ("ssim", "uiq", "scc"):
            assert abs(float(g[key]) - float(w[key])) <= 1e-5, (key, g, w)
        assert abs(float(g["psnr_from_mean_mse"]) - float(w["psnr_from_mean_mse"])) <= 1e-4


@pytest.mark.parametrize("mode", ["denoise", "deblur"])
def test_sweep_matches_jax_solve_and_score(rng, mode):
    """4 images of 32^2 as one batch (the 'compat' norm couples them), a
    2 x 2 grid, 20 iterations: ``degrade`` equal to the JAX script's
    degradation, and each row of ``sweep`` within the tolerances of
    ``_same_rows`` of the JAX script's ``solve_and_score``."""
    clean = _clean(rng)
    noisy, kern = t_grid.degrade(clean, mode, AWGN[mode], 32, 0)
    want_noisy, want_kern = _jax_degrade(clean, mode, AWGN[mode], 32, 0)
    np.testing.assert_array_equal(noisy, want_noisy)
    assert (kern is None) == (want_kern is None)
    if kern is not None:
        np.testing.assert_array_equal(kern, want_kern)
    lmbds, rhos = [0.01, 0.05], [0.5, 2.0]
    got = t_grid.sweep(clean, noisy, kern, lmbds, rhos, 20, device="cpu")
    _same_rows(got, _jax_rows(clean, noisy, kern, lmbds, rhos, 20))
    noisy_psnr = 10 * np.log10(1 / np.mean((noisy - clean) ** 2))
    assert max(r["psnr_from_mean_mse"] for r in got) > noisy_psnr


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_grid_cli_matches_the_jax_script(tmp_path, rng):
    """``--mode deblur --awgn 5 --crop 32 --maxit 10`` on 3 PNGs with
    ``--device cpu``: the CSV (same columns, rows within ``_same_rows``'s
    tolerances) and the three ``[grid]`` lines of the JAX script."""
    y_dir = tmp_path / "clean"
    y_dir.mkdir()
    for i in range(3):
        arr = (_clean(rng, 1, 48)[0, :, :40].transpose(1, 2, 0) * 255).astype(np.uint8)
        Image.fromarray(arr).save(y_dir / f"im_{i}.png")
    args = ["--y_dir", str(y_dir), "--mode", "deblur", "--awgn", "5", "--crop", "32", "--maxit",
            "10", "--lmbd_grid", "0.01,0.05", "--rho_grid", "0.5,1.0", "--device", "cpu"]
    env = single_thread_env(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-m", "torch_admm_deconv_tpu_torch.scripts.grid_sweep",
                          *args, "--save_path", str(tmp_path / "port")], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = subprocess.run([sys.executable, str(REPO / "scripts" / "grid_sweep.py"), *args,
                          "--save_path", str(tmp_path / "jax")], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    got = _read_csv(tmp_path / "port" / "grid_deblur_awgn5.csv")
    want = _read_csv(tmp_path / "jax" / "grid_deblur_awgn5.csv")
    assert list(got[0]) == list(want[0]) == ["lmbd", "rho", "scc", "ssim", "uiq",
                                             "psnr_from_mean_mse"]
    _same_rows([{**r, "lmbd": float(r["lmbd"]), "rho": float(r["rho"])} for r in got],
               [{**r, "lmbd": float(r["lmbd"]), "rho": float(r["rho"])} for r in want])
    g_lines, w_lines = out.stdout.strip().splitlines(), ref.stdout.strip().splitlines()
    assert len(g_lines) == len(w_lines) == 3
    head = r"\[grid\] deblur awgn=5.0 images=3 grid=2x2 wall=\S+s -> (\S+)$"
    assert re.match(head, g_lines[0]) and re.match(head, w_lines[0])
    assert re.match(head, g_lines[0])[1].endswith("port/grid_deblur_awgn5.csv")
    assert g_lines[1] == w_lines[1]
    num = r"[-+0-9.e]+"
    best = (rf"\[grid\] best: lmbd=({num}) rho=({num}) SSIM=({num}) UIQ=({num}) SCC=({num}) "
            rf"PSNR\(from mean MSE\)=({num}) dB")
    g, w = re.match(best, g_lines[2]).groups(), re.match(best, w_lines[2]).groups()
    assert g[:2] == w[:2]
    np.testing.assert_allclose([float(v) for v in g[2:]], [float(v) for v in w[2:]],
                               atol=1.5e-4)


def _jax_example():
    spec = importlib.util.spec_from_file_location("jax_solver_demo",
                                                  REPO / "examples" / "solver_demo.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_solver_demo_matches_jax():
    """64^2 synthetic image, 50 iterations: the same scene, PSF and
    degraded input as the JAX example (its ``htran`` from the oracle); the
    fixed and adaptive PSNRs within 0.01 dB of JAX's, the adaptive
    iterations within 1."""
    j_demo = _jax_example()
    clean = t_demo.synthetic_image(64, 64)
    np.testing.assert_array_equal(clean, j_demo.synthetic_image(64, 64))
    psf = t_demo.gaussian_psf_np(*t_demo.PSF)[None, None]
    np.testing.assert_array_equal(psf, j_demo.gaussian_psf())
    got = t_demo.run(clean, maxit=50, device="cpu")
    blurred = oracle.htran(clean[None], np.flip(psf, axis=(-2, -1)))[0]
    noisy = np.clip(blurred + 0.01 * np.random.default_rng(0).normal(size=blurred.shape), 0,
                    1).astype(np.float32)
    np.testing.assert_array_equal(got["noisy"], noisy)
    xin, kern = jnp.asarray(noisy[None], jnp.float32), jnp.asarray(psf, jnp.float32)
    fixed = np.asarray(j_admm_tv(xin, 0.002, 0.5, kern, iso=True, maxit=50))[0]
    res = j_adaptive(xin, 0.002, 0.5, kern, tol=1e-4, maxit=50)
    psnr = t_demo.psnr  # the port's NumPy PSNR, on the JAX outputs too
    assert abs(got["psnr_restored"] - psnr(fixed, clean)) <= 0.01
    assert abs(got["psnr_adaptive"] - psnr(np.asarray(res.x)[0], clean)) <= 0.01
    assert abs(got["adaptive_iters"] - int(res.iters)) <= 1
    assert got["psnr_restored"] > got["psnr_degraded"]


def test_solver_demo_cli_prints_the_jax_lines(tmp_path):
    """The demo on a 64^2 PNG at ``--maxit 50 --device cpu``: the three
    readings of the JAX example (a subprocess on the CPU) at their printed
    precision, and the three PNGs."""
    img = tmp_path / "in.png"
    Image.fromarray((t_demo.synthetic_image(64, 64).transpose(1, 2, 0) * 255).astype(
        np.uint8)).save(img)
    env = single_thread_env(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    runs = {}
    for name, cmd in (("port", ["-m", "torch_admm_deconv_tpu_torch.examples.solver_demo"]),
                      ("jax", [str(REPO / "examples" / "solver_demo.py")])):
        out = subprocess.run([sys.executable, *cmd, str(img), "--maxit", "50", "--out",
                              str(tmp_path / name)]
                             + (["--device", "cpu"] if name == "port" else []),
                             cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        runs[name] = out.stdout.splitlines()
    pattern = [r"degraded PSNR:  (\S+) dB", r"restored PSNR:  (\S+) dB \(50 fixed iters\)",
               r"adaptive:       (\S+) dB \((\d+) iters to r=(\S+)\)"]
    got = [re.match(p, line).groups() for p, line in zip(pattern, runs["port"])]
    want = [re.match(p, line).groups() for p, line in zip(pattern, runs["jax"])]
    assert got[0] == want[0]
    assert abs(float(got[1][0]) - float(want[1][0])) <= 0.015
    assert abs(float(got[2][0]) - float(want[2][0])) <= 0.015
    assert abs(int(got[2][1]) - int(want[2][1])) <= 1
    assert runs["port"][3] == f"images written to {tmp_path / 'port'}"
    assert sorted(p.name for p in (tmp_path / "port").glob("*.png")) == [
        "clean.png", "degraded.png", "restored.png"]


def test_mixed_precision_study_functions_at_a_tiny_shape(monkeypatch, capsys):
    """The study's readings on (1, 3, 32, 32) (K2 and K3 run their plain
    versions here): positive costs, the three ``fast_frac`` rows, K3 exit
    residuals within each tol and more iterations at 1e-5 than at 1e-3;
    ``main --device cpu`` prints the card line and the JAX script's nine
    readings; the input is the JAX configuration's."""
    x = t_bmp.make_input((1, 3, 32, 32), device="cpu")
    r = t_bmp.study(x, m_small=5, m_big=10, maxit=20, adaptive_maxit=300)
    assert set(r["per_iter"]) == {"high", "mixed"} and min(r["per_iter"].values()) > 0
    assert 0 < r["mixed_vs_high"] < 1e-2
    assert [row["fast_frac"] for row in r["fast_frac"]] == [0.75, 0.875, 0.9375]
    assert r["fast_frac"][0]["max_diff"] == r["mixed_vs_high"]  # 0.75 is the default
    for prec, a in r["adaptive"].items():
        for tol in t_bmp.TOLS:
            assert a["r_max"][tol] <= tol and a["s_max"][tol] <= tol, (prec, tol)
        assert a["iters"][1e-5] > a["iters"][1e-3]
        assert a["est_solve_s"] > 0
    lines = t_bmp.report_lines(r)
    assert len(lines) == 9 and lines[0].startswith("fixed[high]: ")
    assert lines[3].startswith("fixed mixed-vs-high max|diff| at 200 iters = ")
    high = r["adaptive"]["high"]["iters"]
    assert lines[7].startswith(f"adaptive[high]: iters(1e-3)={high[1e-3]} iters(1e-5)={high[1e-5]}")

    full = t_bmp.make_input(device="cpu")
    want = np.random.default_rng(0).random((8, 3, 512, 512), dtype=np.float32) * 0.8 + 0.1
    np.testing.assert_array_equal(full.numpy(), want)
    study = t_bmp.study
    monkeypatch.setattr(t_bmp, "study", lambda v: study(v[:1, :, :32, :32], 5, 10, 20, 300))
    t_bmp.main(["--device", "cpu"])
    err = capsys.readouterr().err.splitlines()
    assert err[0] == "card: cpu" and len(err) == 10


@pytest.mark.parametrize("fast_frac,maxit", [(0.875, 240), (0.9375, 480)])
def test_k2_mixed_fast_frac_matches_jax(rng, fast_frac, maxit):
    """K2 'mixed' at the study's longer fast phases against JAX
    ``admm_tv_vmem`` (interpret mode), with the same 30-iteration exact tail
    as the existing 'mixed' test, and its bar, 2.5e-4 (measured 0.8e-4 to
    1.8e-4 over three seeds). With a shorter tail the bf16 ulp flips of the
    two summation orders survive: at 200 iterations (a 12-iteration tail at
    0.9375) the packages sat 3.4e-4 to 7.3e-4 apart. 'mixed' itself sits
    4.8e-4 to 7.4e-4 from 'high' here."""
    x = (rng.normal(size=(1, 2, 16, 128)) * 0.1 + 0.5).astype(np.float32)
    kw = dict(iso=False, maxit=maxit, precision="mixed", fast_frac=fast_frac)
    want = np.asarray(j_vmem(jnp.asarray(x, jnp.float32), 0.05, 0.8, None, **kw))
    got = t_vmem.admm_tv_vmem(torch.from_numpy(x), 0.05, 0.8, None, device="cpu", **kw).numpy()
    assert t_vmem.fast_iterations("mixed", fast_frac, maxit) == maxit - 30
    np.testing.assert_allclose(got, want, atol=2.5e-4)
    high = t_vmem.admm_tv_vmem(torch.from_numpy(x), 0.05, 0.8, None, iso=False, maxit=maxit,
                               device="cpu").numpy()
    assert np.abs(got - high).max() > 2.5e-4


@pytest.mark.parametrize("fast_frac", [0.875, 0.9375])
def test_k2_mixed_fast_frac_at_the_study_depth_matches_jax(rng, fast_frac):
    """K2 'mixed' at the study's 200 iterations, where the bf16 ulp flips
    leave the two packages' max|diff| as large as 'mixed' itself sits from
    'high'. So this holds the whole field: the rms of port - JAX is under
    half the rms of JAX's own 'mixed' - 'high' (measured 0.14 to 0.41 over
    16 seeds), while the port at either other ``fast_frac`` of the study
    sits 0.57 or more of it from JAX: a schedule one step off fails."""
    x = (rng.normal(size=(1, 2, 16, 128)) * 0.1 + 0.5).astype(np.float32)
    kw = dict(iso=False, maxit=t_bmp.MAXIT)
    j_high = np.asarray(j_vmem(jnp.asarray(x, jnp.float32), 0.05, 0.8, None, **kw))
    want = np.asarray(j_vmem(jnp.asarray(x, jnp.float32), 0.05, 0.8, None, precision="mixed",
                             fast_frac=fast_frac, **kw))

    def rms_from_jax(frac):
        got = t_vmem.admm_tv_vmem(torch.from_numpy(x), 0.05, 0.8, None, precision="mixed",
                                  fast_frac=frac, device="cpu", **kw).numpy()
        return float(np.sqrt(np.mean((got - want) ** 2) / np.mean((want - j_high) ** 2)))

    assert rms_from_jax(fast_frac) < 0.5
    for other in t_bmp.FAST_FRACS:
        if other != fast_frac:
            assert rms_from_jax(other) > 0.5, other


def test_entry_points_need_a_card_or_the_cpu(monkeypatch, rng):
    """device=None means CUDA: without a card each new entry point raises;
    the scripts' ``--device`` takes cuda (the default) or cpu."""
    from torch_admm_deconv_tpu_torch.scripts import single_image_anchor as t_anchor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    clean = _clean(rng, 1, 16)
    for call in (
        lambda: t_grid.sweep(clean, clean, None, [0.01], [1.0], 2),
        lambda: t_demo.run(clean[0], maxit=2),
        lambda: t_bmp.make_input((1, 3, 8, 8)),
        lambda: t_anchor.build_model(None),
        lambda: t_anchor.anchor(clean, clean, None, 0.2, 0.5),
        lambda: t_grid.main(["--y_dir", "missing"]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    for parser in (t_grid.build_parser(), t_anchor.build_parser()):
        assert parser.get_default("device") == "cuda"
