"""The port's implicit (fixed-point) gradients held against the JAX package
on the CPU: ``admm_tv_implicit`` (forward and the Neumann-series gradients
for xin, lambda, rho and the PSF), the ``ADMMDeconv`` layer in implicit mode
with parameters converted by ``flax_to_torch``, and the reduced flagship in
implicit mode.

Inputs are made with numpy from a seed and cast to float32 explicitly for
JAX (tests/conftest.py turns on x64).
"""

import numpy as np
import pytest
import torch

from torch_admm_deconv_tpu_torch.convert import flax_to_torch
from torch_admm_deconv_tpu_torch.kernels import vmem_solver as t_vmem
from torch_admm_deconv_tpu_torch.models import admm_deconv as t_admm
from torch_admm_deconv_tpu_torch.models import denoiser as t_den
from torch_admm_deconv_tpu_torch.ops import implicit as t_imp

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
flax_nn = pytest.importorskip("flax.linen")

from torch_admm_deconv_tpu.models import admm_deconv as j_admm  # noqa: E402
from torch_admm_deconv_tpu.models import denoiser as j_den  # noqa: E402
from torch_admm_deconv_tpu.ops.implicit import admm_tv_implicit as j_implicit  # noqa: E402


def _gauss_psf(size=5, sigma=1.2):
    ax = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(ax**2) / (2 * sigma**2))
    k = np.outer(g, g)
    return (k / k.sum()).reshape(1, 1, size, size).astype(np.float32)


# name: (shape, iso, iso_mode, psf, lmbd, rho, maxit, tol); both packages'
# forwards take the loop on the 16x16 and PSF cases and K3 on the
# (1, 3, 16, 128) 'sample' case
IMPLICIT_CASES = {
    "aniso": ((1, 1, 16, 16), False, "sample", False, 0.05, 1.0, 600, 1e-12),
    "joint": ((1, 1, 16, 16), True, "joint", False, 0.05, 1.0, 600, 1e-12),
    "sample_whole_solve": ((1, 3, 16, 128), True, "sample", False, 0.05, 1.0, 400, 1e-7),
    "gauss_psf": ((1, 1, 16, 16), False, "sample", True, 0.02, 0.8, 600, 1e-12),
}
BWD = 200


@pytest.mark.parametrize("case", sorted(IMPLICIT_CASES))
def test_implicit_matches_jax(case):
    """Forward x within 1e-4 (K3 at a 1e-7 stop against JAX's bf16x3 K3;
    the loop cases agree to ~1e-6), and each gradient within 1e-3 of its
    largest entry plus 1e-5. rho's gradient is zero at the fixed point (the
    solution does not depend on rho); each side returns its forward's
    roundoff there (JAX's K3 runs bf16x3 products, measured 7.6e-4 against
    the port's 6e-5 on the 'sample' case), so it is held to 1e-5 of the
    lambda gradient instead."""
    shape, iso, iso_mode, with_psf, lmbd, rho, maxit, tol = IMPLICIT_CASES[case]
    rng = np.random.default_rng(0)
    x = rng.random(shape).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    kern = _gauss_psf() if with_psf else None
    kw = dict(iso=iso, maxit=maxit, tol=tol, iso_mode=iso_mode, backward_iters=BWD)

    def loss_j(xin, lm, rh, *k):
        out = j_implicit(xin, lm, rh, *(k or (None,)), **kw)
        return jnp.sum(out * jnp.asarray(w)), out

    j_args = [jnp.asarray(x), jnp.float32(lmbd), jnp.float32(rho)]
    if with_psf:
        j_args.append(jnp.asarray(kern))
    (_, out_j), grads_j = jax.value_and_grad(loss_j, argnums=tuple(range(len(j_args))),
                                             has_aux=True)(*j_args)

    t_args = [torch.from_numpy(x), torch.tensor(lmbd), torch.tensor(rho)]
    if with_psf:
        t_args.append(torch.from_numpy(kern))
    t_args = [a.requires_grad_() for a in t_args]
    out_t = t_imp.admm_tv_implicit(*t_args[:3], t_args[3] if with_psf else None, device="cpu",
                                   **kw)
    (out_t * torch.from_numpy(w)).sum().backward()

    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=1e-4)
    names = ("xin", "lmbd", "rho", "kern")
    for name, a, g in zip(names, grads_j, t_args):
        a, b = np.asarray(a), g.grad.numpy()
        assert b.shape == a.shape, name
        scale = np.abs(np.asarray(grads_j[1])).max() * 1e-2 if name == "rho" else np.abs(a).max()
        assert np.abs(a - b).max() <= 1e-3 * scale + 1e-5, (name, a.ravel()[:4], b.ravel()[:4])


def test_implicit_forward_dispatch(monkeypatch):
    """K3 runs (with residual balancing off) exactly where JAX's jitted
    dispatch takes the kernel: no PSF, a whole-solve mode and the TPU
    kernel's shape gates. A PSF, the 'compat' mode, a plane that is not
    tile-aligned, or a block over the TPU's VMEM budget takes the loop."""
    calls = []
    real = t_vmem.admm_tv_adaptive_vmem

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(t_vmem, "admm_tv_adaptive_vmem", spy)
    x = torch.from_numpy(np.random.default_rng(1).random((1, 3, 8, 128), dtype=np.float32))
    t_imp.admm_tv_implicit(x, 0.05, 1.0, None, iso=True, iso_mode="sample", maxit=20,
                           device="cpu")
    assert len(calls) == 1 and calls[0]["rho_mu"] == 1e30 and calls[0]["return_state"]
    t_imp.admm_tv_implicit(x, 0.05, 1.0, torch.from_numpy(_gauss_psf()), maxit=20,
                           device="cpu")
    t_imp.admm_tv_implicit(x, 0.05, 1.0, None, iso=True, iso_mode="compat", maxit=20,
                           device="cpu")
    t_imp.admm_tv_implicit(x[..., :100], 0.05, 1.0, None, maxit=20, device="cpu")
    assert len(calls) == 1
    # the same gates as the JAX package's availability check
    from torch_admm_deconv_tpu.kernels.vmem_solver import adaptive_vmem_available

    for shape, g in (((1, 3, 8, 128), 3), ((1, 1, 8, 100), 1), ((1, 3, 512, 512), 3),
                     ((1, 3, 1024, 1024), 3), ((1, 1, 1024, 1024), 1)):
        iso = g > 1
        want = adaptive_vmem_available(shape, jnp.float32, None, iso, "sample",
                                       return_state=True)
        assert t_imp._tpu_takes_kernel(shape, g) == want, shape


def test_implicit_accepts_chw_and_defaults_to_cuda():
    x = torch.from_numpy(np.random.default_rng(3).random((3, 16, 16), dtype=np.float32))
    out = t_imp.admm_tv_implicit(x, 0.05, 1.0, maxit=50, tol=1e-6, device="cpu")
    assert out.shape == x.shape and torch.isfinite(out).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_imp.admm_tv_implicit(x, 0.05, 1.0)


def _layer_pair(kw, x):
    xj = jnp.asarray(x, jnp.float32)
    j_layer = j_admm.ADMMDeconv(**kw)
    params = j_layer.init(jax.random.PRNGKey(0), xj)
    t_layer = t_admm.ADMMDeconv(**kw, device="cpu")
    t_layer.load_state_dict(flax_to_torch(jax.tree_util.tree_map(np.asarray, params)))
    return j_layer, params, t_layer


@pytest.mark.parametrize("case", ["sample_whole_solve", "learned_psf_loop"])
def test_admm_deconv_implicit_matches_jax(case):
    """The implicit-mode layer's params are the unroll layer's leaves
    (lmbda, rho, w, b), so flax_to_torch converts them unchanged. Forward
    and parameter gradients against the Flax layer: the no-PSF 'sample'
    layer (K3 forward on both sides) and a learned 5x5 PSF with a bias (the
    loop on both sides). Tolerances as in
    test_implicit_matches_jax; rho's gradient there is held to 1e-5 of
    lambda's."""
    rng = np.random.default_rng(4)
    x = rng.random((1, 3, 16, 128 if case == "sample_whole_solve" else 16), dtype=np.float32)
    target = np.clip(x + 0.02, 0.0, 1.0)
    kw = dict(max_iters=150, iso=True, iso_mode="sample", gradient_mode="implicit",
              implicit_tol=1e-10, implicit_backward_iters=100)
    if case == "learned_psf_loop":
        kw.update(kern_size=(5, 5), bias=True, iso=False)
    j_layer, params, t_layer = _layer_pair(kw, x)

    def loss(p):
        out = j_layer.apply(p, jnp.asarray(x))
        return jnp.mean((out - jnp.asarray(target)) ** 2), out

    (_, out_j), grads = jax.value_and_grad(loss, has_aux=True)(params)
    out_t = t_layer(torch.from_numpy(x))
    torch.mean((out_t - torch.from_numpy(target)) ** 2).backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=1e-4)
    want = flax_to_torch(jax.tree_util.tree_map(np.asarray, grads))
    got = {name: p.grad for name, p in t_layer.named_parameters()}
    assert set(got) == set(want) and "lmbda" in got and "rho" in got
    lmbd_scale = np.abs(want["lmbda"].numpy()).max()
    for name, g in want.items():
        a, b = g.numpy(), got[name].numpy()
        scale = lmbd_scale * 1e-2 if name == "rho" else np.abs(a).max()
        assert np.abs(a - b).max() <= 1e-3 * scale + 1e-5, (name, a.ravel()[:4], b.ravel()[:4])


def test_admm_deconv_rejects_unknown_gradient_mode():
    with pytest.raises(ValueError, match="gradient_mode"):
        t_admm.ADMMDeconv(gradient_mode="adjoint", device="cpu")


def _reduced_implicit(module, **extra):
    """The dryrun config of __graft_entry__.py:66-76 in implicit mode."""
    admm = {"kern_size": (), "max_iters": 20, "iso": True, "remat": True,
            "gradient_mode": "implicit"}
    sig = flax_nn.sigmoid if module is j_den else torch.sigmoid
    return module.DivergentRestorer([2, 4], 3, 3, 16, 16, 4, output_activation=sig,
                                    admms=[dict(admm), dict(admm)], remat_levels=True, **extra)


def test_reduced_flagship_implicit_matches_jax():
    """Forward against JAX (the 'compat' layers take the loop on both
    sides): level 0 within 1e-4 and the output within 2e-3, the bars of
    tests/test_torch_models.py (the gates' spatial mode counts exact ties).
    Every parameter gradient is finite and some are nonzero; the branch
    convolutions that DivergentAttention builds without using (the JAX
    module's parameter tree) get none."""
    rng = np.random.default_rng(5)
    x = np.clip(rng.normal(size=(1, 3, 16, 32)) * 0.1 + 0.5, 0.0, 1.0).astype(np.float32)
    xj = jnp.asarray(x)
    j_model, t_model = _reduced_implicit(j_den), _reduced_implicit(t_den, device="cpu")
    params = j_model.init(jax.random.PRNGKey(0), xj)
    t_model.load_state_dict(flax_to_torch(jax.tree_util.tree_map(np.asarray, params)))
    assert t_model.block_0.admm_0.gradient_mode == "implicit"
    want, state = j_model.apply(params, xj, capture_intermediates=True, mutable=["intermediates"])
    level0 = {}
    t_model.block_0.register_forward_hook(lambda m, i, o: level0.__setitem__("out", o))
    got = t_model(torch.from_numpy(x))
    np.testing.assert_allclose(level0["out"].detach().numpy(),
                               np.asarray(state["intermediates"]["block_0"]["__call__"][0]),
                               atol=1e-4)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-3)
    torch.mean((got - torch.from_numpy(np.clip(x + 0.05, 0.0, 1.0))) ** 2).backward()
    grads = {n: p.grad for n, p in t_model.named_parameters() if p.grad is not None}
    unused = {n.split(".")[1] for n, p in t_model.named_parameters() if p.grad is None}
    assert unused == {"conv_2", "conv_3", "conv_6", "conv_7"}  # block_1's idle branches
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert any(float(g.abs().max()) > 0 for g in grads.values())
    # the ADMM layers' lambda and rho get gradients through the fixed point
    assert {n for n in grads if ".admm_" in n} == {
        f"block_0.admm_{i}.{leaf}" for i in (0, 1) for leaf in ("lmbda", "rho")}


def test_flagship_passes_gradient_mode():
    model = t_den.flagship_divergent_restorer(remat=False, gradient_mode="implicit", device="cpu",
                                              generator=torch.Generator().manual_seed(0))
    assert model.block_0.admm_0.gradient_mode == "implicit"
    assert model.block_0.admm_1.implicit_tol == 1e-6
