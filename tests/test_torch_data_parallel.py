"""The port's data-parallel paths (``parallel/data_parallel.py``,
``parallel/mesh.py`` and ``admm_tv``/``admm_tv_adaptive`` with
``psum_axis``) on 4 gloo ranks, held against the single-process port and the
JAX package on a 4-device ``data`` mesh; it mirrors
tests/test_data_parallel.py. The ranks run every case once, in one group
(tests/_torch_dist.py). Inputs come from numpy seeds; the train step starts
both sides from one Flax init through ``convert.flax_to_torch``."""

from pathlib import Path

import numpy as np
import pytest
import torch

from tests._threads import one_torch_thread  # noqa: F401 (autouse)
from tests._torch_dist import run_ranks
from torch_admm_deconv_tpu_torch.convert import flax_to_torch
from torch_admm_deconv_tpu_torch.data import gaussian_psf_np
from torch_admm_deconv_tpu_torch.ops.solver import admm_tv, admm_tv_adaptive

N = 4  # ranks on the data axis, and devices of the JAX mesh
PSF5 = tuple(float(v) for v in gaussian_psf_np(5, 1.0).reshape(-1))
LP = dict(steps=3, channels=3, kern_size=(5, 5), hidden=8, remat=True, psf_fixed=PSF5)

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")


def _img(rng, shape, dtype=np.float32):
    return (rng.normal(size=shape) * 0.1 + 0.5).astype(dtype)


def _lp_params(rng):
    """One Flax init of the small learned prox, its output conv set to small
    random float32 values (at its zero init the inner convs get no
    gradient), as float64 leaves."""
    from torch_admm_deconv_tpu.models import learned_prox as j_lp

    params = j_lp.LearnedProxADMM(**LP).init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, 3, 12, 16), jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, params)
    conv_out = params["params"]["prox"]["conv_out"]
    conv_out["kernel"] = (0.05 * rng.normal(size=conv_out["kernel"].shape)).astype(np.float32)
    conv_out["bias"] = (0.01 * rng.normal(size=conv_out["bias"].shape)).astype(np.float32)
    return jax.tree_util.tree_map(lambda v: np.asarray(v, np.float64), params)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The inputs, the Flax params, and every rank's results."""
    rng = np.random.default_rng(42)
    params = _lp_params(rng)
    inputs = {
        "solve_x": _img(rng, (16, 3, 32, 32)),
        "compat_x": _img(rng, (16, 3, 16, 16)),
        "compat_target": _img(rng, (16, 3, 16, 16)),
        "adapt_x": _img(rng, (8, 1, 32, 32)),
        "train_x": _img(rng, (8, 3, 12, 16), np.float64),
        "train_y": _img(rng, (8, 3, 12, 16), np.float64),
        "train_psf": np.asarray(PSF5),
    }
    for k, v in flax_to_torch(params).items():
        inputs[f"param:{k}"] = v.double().numpy()
    workdir = tmp_path_factory.mktemp("dp_ranks")
    np.savez(workdir / "inputs.npz", **inputs)
    return inputs, params, run_ranks("data_parallel", N, Path(workdir))


def _flat64(tree, prefix=()):
    """The JAX learned prox's param tree as the port's state-dict names, in
    float64 (both sides keep convs in OIHW; Flax's ``kernel`` is
    ``weight``)."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat64(value, prefix + (key,)))
        else:
            leaf = "weight" if key == "kernel" and prefix else key
            out[".".join(prefix + (leaf,))] = np.asarray(value, np.float64)
    return out


def _mesh():
    from torch_admm_deconv_tpu.parallel import make_mesh

    return make_mesh((N,), ("data",))


def _single(x, *args, **kwargs):
    return admm_tv(torch.from_numpy(x), *args, device="cpu", **kwargs).numpy()


def _err(a, b) -> float:
    return float(np.max(np.abs(a - b)))


def test_dp_solve_matches_single_device_and_jax(ranks):
    """(16, 3, 32, 32) over 4 ranks, aniso, 20 iterations: the
    single-process port solve and JAX's ``data_parallel_solve`` within
    1e-5 (JAX's bar)."""
    from torch_admm_deconv_tpu.parallel import data_parallel_solve

    inputs, _, outs = ranks
    x = inputs["solve_x"]
    got = outs[0]["dp_aniso"]
    assert _err(got, _single(x, 0.05, 0.8, None, maxit=20)) <= 1e-5
    want = data_parallel_solve(jnp.asarray(x), 0.05, 0.8, None, mesh=_mesh(), maxit=20)
    assert _err(got, np.asarray(want)) <= 1e-5


def test_dp_compat_couples_the_global_batch(ranks):
    """Iso 'compat' over 4 ranks of 4 images: the norm over (B, C) sums
    across the ranks, so the result is the single-process solve of all 16
    images within 1e-5 (JAX's bar), and JAX's ``data_parallel_solve``
    within 1e-5."""
    from torch_admm_deconv_tpu.parallel import data_parallel_solve

    inputs, _, outs = ranks
    x = inputs["compat_x"]
    got = outs[0]["dp_compat"]
    assert _err(got, _single(x, 0.05, 0.8, None, iso=True, iso_mode="compat", maxit=10)) <= 1e-5
    want = data_parallel_solve(jnp.asarray(x), 0.05, 0.8, None, mesh=_mesh(), iso=True,
                               iso_mode="compat", maxit=10)
    assert _err(got, np.asarray(want)) <= 1e-5


def test_dp_compat_per_rank_norm_is_off(ranks):
    """The negative control: each rank's 'compat' norm over its own 4 images
    only is the per-rank single solve, and sits more than 100x the 1e-5 bar
    from the global-batch solve."""
    inputs, _, outs = ranks
    x = inputs["compat_x"]
    got = outs[0]["dp_compat_per_rank"]
    per_rank = np.concatenate([_single(x[i:i + 4], 0.05, 0.8, None, iso=True,
                                       iso_mode="compat", maxit=10) for i in range(0, 16, 4)])
    assert _err(got, per_rank) <= 1e-6
    assert _err(got, outs[0]["dp_compat"]) > 1e-3


def test_dp_compat_gradient_is_the_global_one(ranks):
    """Under autograd the summed norm's all-reduce passes the gradient back
    to every rank: in float64, the gradient of sum((out - target)^2) over
    the global batch by lambda (summed over the ranks) and by each rank's
    rows equals the single-process gradient to 1e-10 of its largest
    entry."""
    inputs, _, outs = ranks
    x = torch.from_numpy(inputs["compat_x"]).double().requires_grad_()
    lmbd = torch.tensor(0.05, dtype=torch.float64, requires_grad=True)
    out = admm_tv(x, lmbd, 0.8, None, iso=True, iso_mode="compat", maxit=10, device="cpu")
    torch.sum((out - torch.from_numpy(inputs["compat_target"]).double()) ** 2).backward()
    for got, want in ((outs[0]["dp_compat_grad_lmbd"], lmbd.grad.numpy()),
                      (outs[0]["dp_compat_grad_x"], x.grad.numpy())):
        assert _err(got, want) <= 1e-10 * np.abs(want).max()


def test_adaptive_psum_axis_stops_jointly(ranks):
    """``admm_tv_adaptive(psum_axis=(mesh, "data"))`` on 2 images a rank:
    the element count and residuals sum over the ranks, so all 4 ranks stop
    at one iteration with the same residuals and rho; the iterations are
    within 1 of the single-process solve of the 8 images and of JAX's
    ``admm_tv_adaptive(psum_axis="data")`` under ``shard_map``, and x within
    1e-5 of both."""
    from jax.sharding import PartitionSpec as P

    from torch_admm_deconv_tpu.ops.solver import admm_tv_adaptive as j_adaptive

    inputs, _, outs = ranks
    x = inputs["adapt_x"]
    stats = [o["adaptive_stats"] for o in outs]
    assert all(np.array_equal(s, stats[0]) for s in stats)
    iters, r, s, _ = stats[0]
    assert iters < 300 and r <= 1e-4 and s <= 1e-4
    got = outs[0]["adaptive"]
    ref = admm_tv_adaptive(torch.from_numpy(x), 0.05, 1.0, None, maxit=300, tol=1e-4,
                           device="cpu")
    assert abs(iters - int(ref.iters)) <= 1
    assert _err(got, ref.x.numpy()) <= 1e-5

    def local(v):
        res = j_adaptive(v, 0.05, 1.0, None, maxit=300, tol=1e-4, psum_axis="data")
        return res.x, res.iters

    fn = jax.jit(jax.shard_map(local, mesh=_mesh(), in_specs=P("data"),
                               out_specs=(P("data"), P())))
    want_x, want_iters = fn(jnp.asarray(x, jnp.float32))
    assert abs(iters - int(want_iters)) <= 1
    assert _err(got, np.asarray(want_x)) <= 1e-5


@pytest.mark.parametrize("rank", range(N))
def test_process_batch_bounds(ranks, rank):
    """Each rank's rows of a global batch of 8 are [2r, 2r + 2); a batch of
    6 over 4 ranks raises JAX's error, as does splitting 6 rows."""
    _, _, outs = ranks
    out = outs[rank]
    assert out["bounds8"].tolist() == [2 * rank, 2 * rank + 2]
    assert str(out["err_bounds6"]) == "global batch 6 must divide over 4 processes"
    assert "must divide over 4 shards" in str(out["err_shard6"])


def test_dp_train_step_matches_jax(ranks):
    """Three DDP steps of the learned prox (3 stages, hidden 8, a fixed 5x5
    PSF, remat) on 2 rows a rank of an (8, 3, 12, 16) float64 batch, MSE,
    AdamW at 1e-2, clip 1, the lambda/rho clamp, against JAX's
    ``make_dp_train_step`` on a 4-device mesh from the same converted
    params, in float64: the global-mean losses to 1e-10 (the forward bar of
    tests/test_torch_learned_prox.py) and every parameter, on every rank, to
    1e-6 of its leaf's largest entry (that file's gradient bar; measured
    5e-13 and 2.3e-8)."""
    from torch_admm_deconv_tpu.models import learned_prox as j_lp
    from torch_admm_deconv_tpu.parallel import make_dp_train_step, shard_batch
    from torch_admm_deconv_tpu.train import make_optimizer

    inputs, params, outs = ranks
    mesh = _mesh()
    tx = make_optimizer(1e-2)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(p)
    step = make_dp_train_step(j_lp.LearnedProxADMM(**LP), tx,
                              lambda o, y: jnp.mean((o - y) ** 2), mesh)
    x = shard_batch(jnp.asarray(inputs["train_x"]), mesh)
    y = shard_batch(jnp.asarray(inputs["train_y"]), mesh)
    losses = []
    for _ in range(3):
        p, opt_state, lv = step(p, opt_state, x, y, 1e-2)
        losses.append(float(lv))
    np.testing.assert_allclose(outs[0]["train_losses"], losses, rtol=0, atol=1e-10)
    want = _flat64(p["params"])
    assert set(want) == {k[len("param:"):] for k in outs[0] if k.startswith("param:")}
    for name, w in want.items():
        scale = np.abs(w).max()
        for out in outs:
            assert _err(out[f"param:{name}"], w) <= 1e-6 * scale, name
