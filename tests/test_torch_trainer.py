"""The port's trainer, optimizer, clamps, schedule, logger and saver, held
against the JAX package's ``train/`` on the CPU (the behaviours of
tests/test_train.py), with inputs made from a numpy seed and cast to
float32."""

import math

import numpy as np
import pytest
import torch
from torch import nn

from torch_admm_deconv_tpu_torch.convert import flax_to_torch
from torch_admm_deconv_tpu_torch.metrics import losses as t_losses
from torch_admm_deconv_tpu_torch.models import admm_deconv as t_admm
from torch_admm_deconv_tpu_torch.models import layers_common as t_lc
from torch_admm_deconv_tpu_torch.models import regularizers as t_reg
from torch_admm_deconv_tpu_torch.train import (
    MetricsLogger,
    NNSaver,
    NNTrainer,
    SaveMode,
    cosine_annealing_warm_restarts,
    load_checkpoint,
    make_optimizer,
)

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
flax_nn = pytest.importorskip("flax.linen")

from torch_admm_deconv_tpu import train as j_train  # noqa: E402
from torch_admm_deconv_tpu.metrics import losses as j_losses  # noqa: E402
from torch_admm_deconv_tpu.models import admm_deconv as j_admm  # noqa: E402
from torch_admm_deconv_tpu.models import layers_common as j_lc  # noqa: E402
from torch_admm_deconv_tpu.models import regularizers as j_reg  # noqa: E402


class _Loader:
    """Deterministic denoising toy: y clean, x noisy (float32 numpy)."""

    def __init__(self, n_batches=3, batch=2, ch=3, size=16, seed=0):
        rng = np.random.default_rng(seed)
        self.batches = []
        for _ in range(n_batches):
            y = rng.random((batch, ch, size, size)).astype(np.float32)
            x = np.clip(y + 0.1 * rng.standard_normal(y.shape), 0, 1).astype(np.float32)
            self.batches.append((x, y))

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


class _Lin(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.ones(1))

    def forward(self, x):
        return x * self.w


def _conv(seed=0):
    return t_lc.Conv2d(3, 3, 1, device="cpu", generator=torch.Generator().manual_seed(seed))


def _state(trainer):
    """Parameters and optimizer state, as numpy, for bitwise comparison."""
    params = {n: p.detach().numpy().copy() for n, p in trainer.model.named_parameters()}
    opt = {(i, k): v.numpy().copy() if torch.is_tensor(v) else v
           for i, st in trainer.optimizer.state_dict()["state"].items() for k, v in st.items()}
    return params, opt


def _assert_same_state(a, b):
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=str(k))


# -- optimizer, clamps, schedule ------------------------------------------


def test_adamw_matches_optax_on_identical_gradients(rng):
    """Five AdamW steps with a changing LR on the same gradients: the port's
    torch.optim.AdamW (decay as p * (1 - lr wd)) against optax.adamw (decay
    added to the update): to 1e-6."""
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 1, 3, 3)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    lrs = [1e-2, 8.8e-3, 5e-3, 2e-3, 1e-3]

    tx = j_train.make_optimizer(lrs[0])
    j_params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(j_params)
    t_params = {k: nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = make_optimizer(lrs[0])(list(t_params.values()))
    for g, lr in zip(grads, lrs):
        state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, j_params)
        j_params = jax.tree_util.tree_map(lambda p, u: p + u, j_params, updates)
        for k, p in t_params.items():
            p.grad = torch.from_numpy(g[k])
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(t_params[k].detach().numpy(), np.asarray(j_params[k]),
                                   rtol=1e-6, atol=1e-6)


class _Tree(nn.Module):
    """Parameters named as an ADMM layer's (lmbda, rho, w, b) beside a conv's
    (weight), in two nested modules."""

    def __init__(self, values):
        super().__init__()
        for outer, inner in values.items():
            sub = nn.Module()
            for name, v in inner.items():
                setattr(sub, name, nn.Parameter(torch.from_numpy(v.copy())))
            setattr(self, outer, sub)


@pytest.mark.parametrize("clamp", ["train_weight_clipper", "admm_clipper", "admm_weight_clipper",
                                   "clip_grads_by_value"])
def test_clamps_match_jax_on_a_parameter_tree(rng, clamp):
    values = {
        outer: {name: (rng.standard_normal(shape) * 8).astype(np.float32)
                for name, shape in (("lmbda", (1,)), ("rho", (1,)), ("w", (1, 1, 3, 3)),
                                    ("b", (1,)), ("weight", (2, 2, 1, 1)))}
        for outer in ("admm_0", "admm_1")
    }
    values["admm_0"]["lmbda"][0] = -1.0
    values["admm_1"]["rho"][0] = 9.0
    values["admm_1"]["w"][0, 0, 0, :2] = [np.nan, np.inf]
    tree = _Tree(values)
    j_tree = {o: {n: jnp.asarray(v) for n, v in inner.items()} for o, inner in values.items()}
    if clamp == "clip_grads_by_value":
        for p, (o, n) in zip(tree.parameters(), [(o, n) for o in values for n in values[o]]):
            p.grad = torch.from_numpy(values[o][n].copy())
        t_reg.clip_grads_by_value(tree.parameters(), 1.0)
        got = {f"{o}.{n}": p.grad.numpy() for (o, n), p in
               zip([(o, n) for o in values for n in values[o]], tree.parameters())}
        want = j_reg.clip_grads_by_value(j_tree, 1.0)
    else:
        args = {"admm_clipper": (2.0,), "admm_weight_clipper": ((-0.5, 0.5),)}.get(clamp, ())
        getattr(t_reg, clamp)(tree, *args)
        got = {n: p.detach().numpy() for n, p in tree.named_parameters()}
        want = getattr(j_reg, clamp)(j_tree, *args)
    for o, inner in want.items():
        for n, v in inner.items():
            np.testing.assert_array_equal(got[f"{o}.{n}"], np.asarray(v), err_msg=f"{o}.{n}")


@pytest.mark.parametrize("t_mult", [1, 2])
def test_schedule_matches_jax(t_mult):
    """The JAX schedule computes in float32, the port's on the host in
    float64: to 1e-6 of the base LR."""
    args = (8.8e-4, 10, t_mult, 1e-11)
    t_sched = cosine_annealing_warm_restarts(*args)
    j_sched = j_train.cosine_annealing_warm_restarts(*args)
    got = [t_sched(s) for s in range(101)]
    want = [float(j_sched(s)) for s in range(101)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * 8.8e-4)
    assert got[0] == pytest.approx(8.8e-4) and got[10] == pytest.approx(8.8e-4)


# -- logger and saver (tests/test_train.py:36-118) ---------------------------


def test_logger_psnr_from_mean_mse():
    loss = t_losses.SSIMLoss("cpu")
    logger = MetricsLogger(loss, [t_losses.PSNRMetric("cpu")])
    assert "mse" in logger.tracked
    for name, v in (("mse", 0.01), ("mse", 0.04), ("psnr", 20.0), ("psnr", 14.0),
                    (loss.m_name, 0.5)):
        logger.update_step_metric_val(name, v)
    logger("train")
    np.testing.assert_allclose(logger.get_avg_metrics("train")["psnr"],
                               10 * np.log10(1 / 0.025), rtol=1e-6)


def test_logger_nonfinite_step_excluded_from_mean():
    loss = t_losses.SSIMLoss("cpu")
    logger = MetricsLogger(loss, [])
    for v in (0.5, float("nan"), 0.7):
        logger.update_step_metric_val(loss.m_name, v)
    logger("train")
    np.testing.assert_allclose(logger.get_avg_metrics("train")[loss.m_name], 0.6, rtol=1e-6)
    logger.reinit_step_stats()
    logger.update_step_metric_val(loss.m_name, float("inf"))
    logger("train")
    assert math.isnan(logger.get_avg_metrics("train")[loss.m_name])


def test_logger_push_step_sums():
    loss = t_losses.SSIMLoss("cpu")
    logger = MetricsLogger(loss, [t_losses.PSNRMetric("cpu")])
    logger.push_step_sums({loss.m_name: 1.2, "mse": 0.05, "psnr": 34.0},
                          {loss.m_name: 2, "mse": 2, "psnr": 2})
    logger("train")
    avg = logger.get_avg_metrics("train")
    np.testing.assert_allclose(avg[loss.m_name], 0.6, rtol=1e-6)
    np.testing.assert_allclose(avg["psnr"], 10 * np.log10(1 / 0.025), rtol=1e-6)
    assert logger.get_logged()["train_psnr"] == [avg["psnr"]]


def test_saver_strictly_best_and_nonfinite_never_best(tmp_path):
    saver = NNSaver(str(tmp_path), "m", SaveMode.Best, use_time_date=False)
    state = {"w": torch.ones(2)}
    for epoch, loss in enumerate([float("nan"), 1.0, 1.5, float("inf"), 0.5, 0.7, 0.5]):
        saver.save_on_epoch_end(epoch, state, {}, loss)
    files = sorted(p.name for p in (tmp_path / "m").glob("*.tar"))
    assert files == ["m_epoch01_vloss1.0000.tar", "m_epoch04_vloss0.5000.tar"]


def test_saver_checkpoint_roundtrip_and_csv(tmp_path):
    saver = NNSaver(str(tmp_path), "m", SaveMode.Each)
    model = _conv()
    opt = make_optimizer(1e-3)(list(model.parameters()))
    saver.save_on_epoch_end(3, model.state_dict(), opt.state_dict(), 0.25,
                            {"train_loss": [0.5, 0.25], "eval_loss": [0.4]})
    (ckpt_dir,) = (tmp_path / "m").iterdir()  # <dir>/<name>/<timestamp>/
    (path,) = ckpt_dir.glob("*.tar")
    assert path.name == "m_epoch03_vloss0.2500.tar"
    restored = load_checkpoint(path)
    assert restored["epoch"] == 3 and restored["loss"] == 0.25
    for k, v in model.state_dict().items():
        torch.testing.assert_close(restored["model_state_dict"][k], v, rtol=0, atol=0)
    assert restored["optimizer_state_dict"]["param_groups"][0]["betas"] == (0.9, 0.9)
    rows = (ckpt_dir / "logged_metrics.csv").read_text().splitlines()
    assert rows == [",train_loss,eval_loss", "0,0.5,0.4", "1,0.25,"]


# -- the trainer -------------------------------------------------------------


def test_skip_nonfinite_updates_keeps_params_and_adam_state():
    """A step whose loss is NaN applies no update: after [good, NaN] the
    parameters and Adam state are bit-identical to those after [good]."""
    x = np.ones((1, 1, 4, 4), np.float32)
    good, bad = (x, np.zeros_like(x)), (x, np.full_like(x, np.nan))

    def run(batches):
        trainer = NNTrainer(t_losses.MSE(None), [], None, MetricsLogger(t_losses.MSE(None), []),
                            clamp_admm_params=False, skip_nonfinite_updates=True)
        trainer.run(_Lin(), make_optimizer(1e-2), 1, batches)
        return trainer

    only_bad = run([bad])
    assert only_bad.skipped_updates == 1 and only_bad.optimizer.state_dict()["state"] == {}
    assert only_bad.model.w.item() == 1.0
    after_good = run([good])
    good_then_bad = run([good, bad])
    assert after_good.skipped_updates == 0 and good_then_bad.skipped_updates == 1
    assert after_good.model.w.item() != 1.0
    _assert_same_state(_state(after_good), _state(good_then_bad))
    # without the guard the NaN step poisons the parameters
    plain = NNTrainer(t_losses.MSE(None), [], None, MetricsLogger(t_losses.MSE(None), []),
                      clamp_admm_params=False)
    plain.run(_Lin(), make_optimizer(1e-2), 1, [good, bad])
    assert math.isnan(plain.model.w.item())


def test_accum_matches_large_batch_and_masks_nonfinite():
    """One accum-3 update over three batch-1 micro-batches equals one
    batch-3 update (the mean-loss gradient decomposes); a non-finite
    micro-batch is excluded from the mean; an all-bad group applies no
    update."""
    rng = np.random.default_rng(0)
    xs = rng.random((3, 1, 1, 4, 4)).astype(np.float32)
    ys = rng.random((3, 1, 1, 4, 4)).astype(np.float32)

    def run(batches, accum):
        trainer = NNTrainer(t_losses.MSE(None), [], None, MetricsLogger(t_losses.MSE(None), []),
                            clamp_admm_params=False, accum_steps=accum)
        trainer.run(_Lin(), make_optimizer(1e-2), 1, batches)
        return trainer

    accum = run([(xs[i], ys[i]) for i in range(3)], 3)
    big = run([(xs.reshape(3, 1, 4, 4), ys.reshape(3, 1, 4, 4))], 1)
    np.testing.assert_allclose(accum.model.w.item(), big.model.w.item(), rtol=1e-6)

    ys_bad = ys.copy()
    ys_bad[1] = np.nan
    masked = run([(xs[i], ys_bad[i]) for i in range(2)], 2)
    solo = run([(xs[0], ys[0])], 1)
    np.testing.assert_allclose(masked.model.w.item(), solo.model.w.item(), rtol=1e-6)
    none = run([(xs[i], np.full_like(ys[i], np.nan)) for i in range(2)], 2)
    assert none.model.w.item() == 1.0 and none.skipped_updates == 1


def test_accum_matches_jax_update():
    """The accumulated update equals the JAX trainer's on the same
    micro-batches (one with a NaN target), to 1e-6."""
    rng = np.random.default_rng(1)
    xs = rng.random((2, 1, 1, 4, 4)).astype(np.float32)
    ys = rng.random((2, 1, 1, 4, 4)).astype(np.float32)
    ys[1, 0, 0, 0, 0] = np.nan

    class JLin(flax_nn.Module):
        @flax_nn.compact
        def __call__(self, x):
            return x * self.param("w", lambda k, s: jnp.ones(s, jnp.float32), (1,))

    j_tr = j_train.NNTrainer(j_losses.MSE(None), [], saver=None, clamp_admm_params=False,
                             accum_steps=2)
    tx = j_train.make_optimizer(1e-2)
    params = JLin().init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    step, _ = j_tr._build_steps(JLin(), tx)
    p2, _, _, _ = step(params, tx.init(params), jnp.asarray(xs), jnp.asarray(ys), 1e-2,
                       j_tr._fresh_acc("train"))
    t_tr = NNTrainer(t_losses.MSE(None), [], None, MetricsLogger(t_losses.MSE(None), []),
                     clamp_admm_params=False, accum_steps=2)
    t_tr.run(_Lin(), make_optimizer(1e-2), 1, [(xs[0], ys[0]), (xs[1], ys[1])], base_lr=1e-2)
    np.testing.assert_allclose(t_tr.model.w.item(), float(p2["params"]["w"][0]), rtol=1e-6)


def test_accum_epoch_loop_drops_the_trailing_group(capsys):
    loss = t_losses.MSE("cpu")
    logger = MetricsLogger(loss, [])
    trainer = NNTrainer(loss, [], None, logger, accum_steps=2)
    trainer.run(_conv(), make_optimizer(3e-3), 2, _Loader(n_batches=5),
                _Loader(n_batches=2, seed=1), base_lr=3e-3)
    assert "dropped 1 trailing batches" in capsys.readouterr().out
    train_losses = logger.metrics["train"][loss.m_name]
    assert len(train_losses) == 2 and train_losses[-1] < train_losses[0], train_losses


def test_full_state_resume_continues_exactly(tmp_path):
    """Two epochs, then a resume from the epoch-1 checkpoint for two more,
    ends bit-identical to four uninterrupted epochs."""
    loss = t_losses.MSE("cpu")
    loader = _Loader(n_batches=2)

    def trainer(name):
        saver = NNSaver(str(tmp_path), name, SaveMode.Each, use_time_date=False)
        return NNTrainer(loss, [], saver, MetricsLogger(loss, []))

    straight = trainer("straight")
    straight.run(_conv(), make_optimizer(1e-2), 4, loader, loader, base_lr=1e-2)
    first = trainer("resumed")
    first.run(_conv(), make_optimizer(1e-2), 2, loader, loader, base_lr=1e-2)
    ckpt = sorted((tmp_path / "resumed").glob("*_epoch01_*.tar"))[0]
    second = trainer("resumed")
    second.run(_conv(seed=5), make_optimizer(1e-2), 4, loader, loader, base_lr=1e-2,
               resume_ckpt=str(ckpt))
    assert len(second.logger.metrics["train"][loss.m_name]) == 2  # epochs 2 and 3
    _assert_same_state(_state(straight), _state(second))


def test_scheduler_steps_per_eval_batch_and_nonfinite_raise():
    loss = t_losses.MSE("cpu")
    trainer = NNTrainer(loss, [], None, MetricsLogger(loss, []))
    trainer.run(_conv(), make_optimizer(1e-3), 2, _Loader(n_batches=3), _Loader(n_batches=2),
                lr_scheduler=cosine_annealing_warm_restarts(1e-3, 100), base_lr=1e-3)
    assert trainer._sched_count == 4  # 2 epochs x 2 eval batches
    per_step = NNTrainer(loss, [], None, MetricsLogger(loss, []), scheduler_step_per="train_step")
    per_step.run(_conv(), make_optimizer(1e-3), 2, _Loader(n_batches=3), _Loader(n_batches=2),
                 lr_scheduler=cosine_annealing_warm_restarts(1e-3, 100), base_lr=1e-3)
    assert per_step._sched_count == 6

    bad = [(x, np.full_like(y, np.nan)) for x, y in _Loader(n_batches=2)]
    raising = NNTrainer(loss, [], None, MetricsLogger(loss, []), on_nonfinite="raise")
    with pytest.raises(FloatingPointError):
        raising.run(_conv(), make_optimizer(1e-3), 1, bad)


def test_light_train_metrics_skip_monitoring_on_train():
    loss = t_losses.MSE("cpu")
    metrics = [t_losses.PSNRMetric("cpu"), t_losses.SSIMLoss("cpu")]
    logger = MetricsLogger(loss, metrics)
    trainer = NNTrainer(loss, metrics, None, logger, light_train_metrics=True)
    assert [m.m_name for m in trainer.metrics] == ["psnr", "ssim_loss", "mse"]
    trainer.run(_conv(), make_optimizer(1e-2), 1, _Loader(n_batches=2), _Loader(n_batches=2))
    train, evalm = trainer.get_epoch_metrics("train"), trainer.get_epoch_metrics("eval")
    assert math.isfinite(train["mse"]) and math.isfinite(train["psnr"])
    assert math.isnan(train["ssim_loss"]) and math.isfinite(evalm["ssim_loss"])


class _JNet(flax_nn.Module):
    @flax_nn.compact
    def __call__(self, x):
        x = j_admm.ADMMDeconv(max_iters=5, name="admm")(x)
        return jax.nn.sigmoid(j_lc.Conv2d(3, 3, 1, name="conv")(x))


class _TNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.admm = t_admm.ADMMDeconv(max_iters=5, device="cpu")
        self.conv = t_lc.Conv2d(3, 3, 1, device="cpu")

    def forward(self, x):
        return torch.sigmoid(self.conv(self.admm(x)))


def test_trainer_losses_match_the_jax_trainer(tmp_path):
    """Four epochs of one train and one eval batch ('compat' ADMM layer at
    batch 2, a 1x1 conv, sigmoid) from converted parameters, with the warm-
    restart schedule, SSIMLabColorLoss, PSNR and SSIM and the clamp: every
    epoch's train loss (one step's), eval loss and PSNR to 1e-4 relative,
    SSIM (near 0 here) to 1e-5 absolute, lambda and rho in the clamp
    range."""
    train = _Loader(n_batches=1, size=32, seed=2)
    evals = _Loader(n_batches=1, size=32, seed=3)
    params = _JNet().init(jax.random.PRNGKey(0), jnp.asarray(train.batches[0][0]))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    sched_args = (3e-2, 3)

    def metrics(pkg):
        return [pkg.PSNRMetric(None), pkg.SSIMMetric(None)]

    j_loss = j_losses.SSIMLabColorLoss(None)
    j_logger = j_train.MetricsLogger(j_loss, metrics(j_losses))
    j_train.NNTrainer(j_loss, metrics(j_losses), None, j_logger).run(
        _JNet(), j_train.make_optimizer(3e-2), 4, train, evals,
        lr_scheduler=j_train.cosine_annealing_warm_restarts(*sched_args), base_lr=3e-2,
        init_params=jax.tree_util.tree_map(jnp.asarray, params))

    t_loss = t_losses.SSIMLabColorLoss(None)
    t_logger = MetricsLogger(t_loss, metrics(t_losses))
    trainer = NNTrainer(t_loss, metrics(t_losses),
                        NNSaver(str(tmp_path), "twin", use_time_date=False), t_logger)
    trainer.run(_TNet(), make_optimizer(3e-2), 4, train, evals,
                lr_scheduler=cosine_annealing_warm_restarts(*sched_args), base_lr=3e-2,
                init_params=flax_to_torch(params))
    got, want = t_logger.get_logged(), j_logger.get_logged()
    for key in ("train_color_lab_loss", "eval_color_lab_loss", "eval_psnr", "eval_ssim"):
        assert len(got[key]) == 4
        atol = 1e-5 if key == "eval_ssim" else 0.0
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=atol, err_msg=key)
    train_losses = got["train_color_lab_loss"]
    assert train_losses[-1] < train_losses[0], train_losses
    for p in (trainer.model.admm.lmbda, trainer.model.admm.rho):
        assert 1e-12 <= p.item() <= 5.0
    assert (tmp_path / "twin" / "logged_metrics.csv").exists()
