"""The port's inference entry points, its device rule and its import
boundary, on the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_admm_deconv_tpu_torch import infer as t_infer
from torch_admm_deconv_tpu_torch.ops.solver import admm_tv as t_admm_tv

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "torch_admm_deconv_tpu_torch"


def _box3(batch):
    """3x3 box filter with reflect boundaries on a (B, C, H, W) batch."""
    p = np.pad(batch, ((0, 0), (0, 0), (1, 1), (1, 1)), mode="reflect")
    h, w = batch.shape[-2:]
    return sum(p[..., dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)) / 9.0


@pytest.mark.parametrize("fn", ["identity", "box3"])
def test_tiled_apply_matches_jax(rng, fn):
    j_infer = pytest.importorskip("torch_admm_deconv_tpu.infer")
    img = rng.random((3, 150, 221)).astype(np.float32)
    apply_fn = (lambda b: b) if fn == "identity" else _box3
    kw = dict(tile=64, margin=8, max_batch=3)
    got = t_infer.tiled_apply(apply_fn, img, **kw)
    np.testing.assert_array_equal(got, j_infer.tiled_apply(apply_fn, img, **kw))
    if fn == "identity":
        np.testing.assert_array_equal(got, img)


def test_classical_restore_matches_jax(rng):
    """Tiles of 128 through the whole solve on both sides (JAX: K2 in
    interpret mode); the K2 bar of tests/test_vmem_solver.py:30, 3e-4."""
    j_infer = pytest.importorskip("torch_admm_deconv_tpu.infer")
    img = np.clip(rng.normal(size=(1, 150, 200)) * 0.1 + 0.5, 0, 1).astype(np.float32)
    kw = dict(tile=128, margin=16, max_batch=4)
    solver = dict(lmbd=0.05, rho=1.0, maxit=10, iso=False)
    got = t_infer.restore_image(t_infer.classical_restorer(**solver, device="cpu"), img, **kw)
    want = j_infer.restore_image(j_infer.classical_restorer(**solver), img, **kw)
    np.testing.assert_allclose(got, want, atol=3e-4)


def test_model_restorer_applies_the_state_dict(rng):
    from torch_admm_deconv_tpu_torch.models.denoiser import DivergentRestorer

    def build():
        admm = {"kern_size": (), "max_iters": 3, "iso": True, "use_pallas": True}
        return DivergentRestorer([2, 2], 3, 3, 8, 8, 4, output_activation=torch.sigmoid,
                                 admms=[admm, dict(admm)], device="cpu",
                                 generator=torch.Generator().manual_seed(1))

    ref = build().eval()
    model = build()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)  # differs until the state dict is loaded
    apply_fn = t_infer.model_restorer(ref.state_dict(), model=model, device="cpu")
    batch = rng.random((2, 3, 16, 16)).astype(np.float32)
    with torch.inference_mode():
        want = ref(torch.from_numpy(batch)).numpy()
    np.testing.assert_array_equal(apply_fn(batch), want)


def test_entry_points_default_to_cuda(monkeypatch):
    """device=None means CUDA: without a card every entry point raises."""
    from torch_admm_deconv_tpu_torch.kernels.vmem_solver import admm_tv_vmem
    from torch_admm_deconv_tpu_torch.models.denoiser import flagship_divergent_restorer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.zeros(1, 1, 8, 8)
    for call in (
        lambda: t_admm_tv(x, 0.05, 0.8),
        lambda: admm_tv_vmem(x, 0.05, 0.8),
        lambda: flagship_divergent_restorer(),
        lambda: t_infer.classical_restorer(),
        lambda: t_infer.model_restorer({}),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port imports with jax, flax, the JAX package and
    the tests (``tests/oracles``) blocked; chip_smoke.py imports none of
    them either."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).replace(".__init__", "")
        for p in PACKAGE.rglob("*.py")
        if "_build" not in p.relative_to(PACKAGE).parts  # kernel build outputs
    )
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'flax', 'torch_admm_deconv_tpu', 'tests'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print(len([m for m in sys.modules if m.startswith('torch_admm_deconv_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= len(modules)

    banned = {"jax", "flax", "torch_admm_deconv_tpu", "tests"}
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(n.split(".")[0] in banned for n in names), names
