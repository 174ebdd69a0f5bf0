"""One gloo rank of the port's multi-process tests (see tests/_torch_dist.py).

    python tests/_torch_dist_worker.py {spatial|data_parallel} WORKDIR

with RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT set. Imports torch and
the port only. Reads ``WORKDIR/inputs.npz``, runs every case of the suite
and writes this rank's results to ``WORKDIR/out_rank{RANK}.npz``: full
arrays gathered from the ranks, per-rank values, and the messages of the
errors a case expects.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from torch_admm_deconv_tpu_torch.ops.solver import admm_tv, admm_tv_adaptive
from torch_admm_deconv_tpu_torch.parallel import (
    data_parallel_solve,
    gather,
    gather_rows,
    init_distributed,
    irfft2_sharded,
    make_dp_train_step,
    make_mesh,
    process_batch_bounds,
    rfft2_sharded,
    shard_batch,
    shard_rows,
    spatial_admm_tv,
    spatial_admm_tv_adaptive,
)


def _error(fn) -> np.ndarray:
    """The message of the ValueError ``fn`` raises (empty if none)."""
    try:
        fn()
    except ValueError as e:
        return np.array(str(e))
    return np.array("")


def _stats(res) -> np.ndarray:
    return np.array([float(res.iters), float(res.r_norm), float(res.s_norm), float(res.rho)])


def spatial(inp: dict, world: int) -> dict:
    """4 ranks on a ``space`` mesh; the one-shard case on a (4, 1)
    ``(data, space)`` mesh, where each space group is one rank."""
    mesh = make_mesh((world,), ("space",))
    group = mesh.get_group("space")
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    out = {}

    def rows(x):
        return shard_rows(x, mesh)

    for name, x in (("24", t["fft_x"]), ("16", t["fft_x16"])):
        w = x.shape[-1]
        spec = rfft2_sharded(rows(x), group, world, w)
        out[f"fft_spec{name}"] = gather(spec, -1, mesh, "space").numpy()
        back = irfft2_sharded(spec, group, world, x.shape[-2] // world, w)
        out[f"fft_roundtrip{name}"] = gather_rows(back, mesh).numpy()

    for iso, mode, key in ((False, "compat", "aniso"), (True, "compat", "compat"),
                           (True, "sample", "sample"), (True, "joint", "joint")):
        got = spatial_admm_tv(rows(t["denoise_x"]), 0.05, 0.8, None, iso=iso, maxit=30,
                              mesh=mesh, iso_mode=mode)
        out[f"pencil_{key}"] = gather_rows(got, mesh).numpy()
    got = spatial_admm_tv(rows(t["deblur_x"]), 0.01, 1.0, t["psf"], maxit=40, mesh=mesh)
    out["pencil_deblur"] = gather_rows(got, mesh).numpy()

    for iso, mode, key in ((False, "compat", "aniso"), (True, "joint", "joint")):
        got = spatial_admm_tv(rows(t["halo_x"]), 0.05, 0.8, None, iso=iso, maxit=30, mesh=mesh,
                              iso_mode=mode, x_update_mode="halo", halo=16)
        out[f"halo_{key}"] = gather_rows(got, mesh).numpy()
    got = spatial_admm_tv(rows(t["halo_deblur_x"]), 0.01, 1.0, t["psf"], maxit=40, mesh=mesh,
                          x_update_mode="halo", halo=16)
    out["halo_deblur"] = gather_rows(got, mesh).numpy()
    for halo in (2, 8, 16):
        got = spatial_admm_tv(rows(t["decay_x"]), 0.05, 0.8, None, maxit=30, mesh=mesh,
                              x_update_mode="halo", halo=halo)
        out[f"decay_{halo}"] = gather_rows(got, mesh).numpy()

    mesh1 = make_mesh((world, 1), ("data", "space"))
    out["one_shard"] = spatial_admm_tv(t["one_x"], 0.05, 0.8, None, maxit=30, mesh=mesh1,
                                       x_update_mode="halo", halo=16).numpy()

    for mode, key, halo in (("pencil", "adapt_x", 32), ("halo", "adapt_halo_x", 16)):
        res = spatial_admm_tv_adaptive(rows(t[key]), 0.05, 1.0, None, maxit=300, tol=1e-4,
                                       mesh=mesh, x_update_mode=mode, halo=halo)
        out[f"adaptive_{mode}"] = gather_rows(res.x, mesh).numpy()
        out[f"adaptive_{mode}_stats"] = _stats(res)

    # the three shape errors, raised before any collective
    out["err_rows"] = _error(lambda: shard_rows(t["decay_x"][..., :30, :], mesh))
    for key, halo in (("err_halo0", 0), ("err_halo_big", 33)):
        out[key] = _error(lambda halo=halo: spatial_admm_tv(
            rows(t["decay_x"]), 0.05, 0.8, None, maxit=1, mesh=mesh, x_update_mode="halo",
            halo=halo))
    return out


def data_parallel(inp: dict, world: int) -> dict:
    """4 ranks on a ``data`` mesh."""
    mesh = make_mesh((world,), ("data",))
    t = {k: torch.from_numpy(v) for k, v in inp.items() if not k.startswith("param:")}
    out = {}

    def rows(x):
        return shard_batch(x, mesh)

    got = data_parallel_solve(rows(t["solve_x"]), 0.05, 0.8, None, mesh=mesh, maxit=20,
                              device="cpu")
    out["dp_aniso"] = gather(got, 0, mesh).numpy()
    got = data_parallel_solve(rows(t["compat_x"]), 0.05, 0.8, None, mesh=mesh, iso=True,
                              iso_mode="compat", maxit=10, device="cpu")
    out["dp_compat"] = gather(got, 0, mesh).numpy()
    # the negative control: each rank's norm over its own rows only
    got = admm_tv(rows(t["compat_x"]), 0.05, 0.8, None, iso=True, iso_mode="compat", maxit=10,
                  device="cpu")
    out["dp_compat_per_rank"] = gather(got, 0, mesh).numpy()

    # the gradient through the summed norm: sum((out - target)^2) over the
    # global batch, by lambda (summed over the ranks) and by each rank's rows
    x = rows(t["compat_x"]).double().requires_grad_()
    lmbd = torch.tensor(0.05, dtype=torch.float64, requires_grad=True)
    got = data_parallel_solve(x, lmbd, 0.8, None, mesh=mesh, iso=True, iso_mode="compat",
                              maxit=10, device="cpu")
    torch.sum((got - rows(t["compat_target"]).double()) ** 2).backward()
    g_lmbd = lmbd.grad.clone()
    dist.all_reduce(g_lmbd)
    out["dp_compat_grad_lmbd"] = g_lmbd.numpy()
    out["dp_compat_grad_x"] = gather(x.grad, 0, mesh).numpy()

    res = admm_tv_adaptive(rows(t["adapt_x"]), 0.05, 1.0, None, maxit=300, tol=1e-4,
                           psum_axis=(mesh, "data"), device="cpu")
    out["adaptive"] = gather(res.x, 0, mesh).numpy()
    out["adaptive_stats"] = _stats(res)

    sl = process_batch_bounds(8)
    out["bounds8"] = np.array([sl.start, sl.stop])
    out["err_bounds6"] = _error(lambda: process_batch_bounds(6))
    out["err_shard6"] = _error(lambda: shard_batch(t["solve_x"][:6], mesh))

    # the DP train step of a small learned prox from converted Flax params
    from torch_admm_deconv_tpu_torch.models.learned_prox import LearnedProxADMM
    from torch_admm_deconv_tpu_torch.train import make_optimizer

    psf = tuple(float(v) for v in inp["train_psf"].reshape(-1))
    model = LearnedProxADMM(steps=3, channels=3, kern_size=(5, 5), hidden=8, remat=True,
                            psf_fixed=psf, device="cpu").double()
    model.load_state_dict({k[len("param:"):]: torch.from_numpy(v)
                           for k, v in inp.items() if k.startswith("param:")})
    step = make_dp_train_step(model, make_optimizer(1e-2), lambda o, y: torch.mean((o - y) ** 2),
                              mesh)
    x, y = rows(t["train_x"]), rows(t["train_y"])
    out["train_losses"] = np.array([step(x, y, 1e-2) for _ in range(3)])
    for k, v in model.state_dict().items():
        out[f"param:{k}"] = v.numpy()
    return out


SUITES = {"spatial": spatial, "data_parallel": data_parallel}


def main() -> None:
    suite, workdir = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    rank, world = init_distributed(device="cpu", timeout_s=120)
    try:
        inp = dict(np.load(workdir / "inputs.npz"))
        out = SUITES[suite](inp, world)
        np.savez(workdir / f"out_rank{rank}.npz", **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
