"""Steps on one fixed batch at the training LR, through both trainers.

On the card, four steps on one fixed batch at the flagship's training LR
(8.8e-4), two epochs into training, raised that batch's loss. Whether the
JAX trainer does the same is the question here. The reduced flagship of
tests/test_torch_train_parity.py ([2, 4] branches, 16 filters, two
20-iteration 'compat' ADMM layers under remat), with the parameters of one
Flax init converted by ``flax_to_torch``, takes the same warm-up epoch and
then four steps on one fixed batch at lr 8.8e-4 in ``NNTrainer`` of each
package: SSIMLabColorLoss, clipping by value, AdamW, the clamp.

Float64 on both sides: in float32 the gates' spatial mode counts accidental
float ties, so the two packages take different modes and their gradients
are not comparable (tests/test_torch_train_parity.py).
"""

import numpy as np
import pytest
import torch

from tests._threads import one_torch_thread  # noqa: F401 (autouse)
from torch_admm_deconv_tpu_torch import train as t_train
from torch_admm_deconv_tpu_torch.convert import flax_to_torch
from torch_admm_deconv_tpu_torch.metrics import SSIMLabColorLoss as TLoss
from torch_admm_deconv_tpu_torch.models import denoiser as t_den

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from torch_admm_deconv_tpu import train as j_train  # noqa: E402
from torch_admm_deconv_tpu.metrics import SSIMLabColorLoss as JLoss  # noqa: E402
from torch_admm_deconv_tpu.models import denoiser as j_den  # noqa: E402

LR = 8.8e-4  # configs/train_cfg.json's training LR
FIXED_STEPS = 4


def _reduced(module, act, **kw):
    admm = {"kern_size": (), "max_iters": 20, "iso": True, "remat": True}
    return module.DivergentRestorer(
        level_branches=[2, 4], in_channels=3, final_channels=3, filters=16, gate_channels=16,
        attention_reduction=4, output_activation=act, admms=[dict(admm), dict(admm)],
        remat_levels=True, **kw)


def _pairs(rng, n, size):
    """n batches of 2 float64 pairs: y piecewise-smooth, x with AWGN 15/255."""
    out = []
    for _ in range(n):
        y = rng.random((2, 3, size // 8, size // 8)).repeat(8, 2).repeat(8, 3)
        x = np.clip(y + rng.normal(0.0, 15.0 / 255.0, y.shape), 0.0, 1.0)
        out.append((x, y))
    return out


def _losses(trainer, logger, warmup, fixed, run):
    """The warm-up epoch, then the fixed batch's loss before each of the
    fixed steps and after the last."""
    run(warmup)
    losses = []
    for _ in range(FIXED_STEPS):
        trainer.train(fixed)
        losses.append(logger.get_avg_metrics("train")["color_lab_loss"])
    trainer.eval(fixed)
    losses.append(logger.get_avg_metrics("eval")["color_lab_loss"])
    return np.asarray(losses)


def test_fixed_batch_losses_match_the_jax_trainer_at_the_training_lr():
    """Both trainers' fixed-batch loss sequences agree to 1e-6 relative
    (measured 4e-8, the port's epoch sums being float32): step for step the
    port's trainer does what the reference's does at this LR. On this
    reduced model, one epoch in, the sequence falls in both (1.281 -> 1.092);
    the rise seen on the card (the full-width flagship two epochs in) is not
    reproduced at this size, and with the two trainers in step it is the
    reference's algorithm, not a port fault."""
    rng = np.random.default_rng(0)
    warmup, fixed = _pairs(rng, 1, 32), _pairs(rng, 1, 32)
    j_model = _reduced(j_den, jax.nn.sigmoid)
    params = jax.jit(j_model.init)(jax.random.PRNGKey(0),
                                   jnp.asarray(fixed[0][0][:, :, :16, :16], jnp.float32))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)

    j_loss = JLoss()
    j_logger = j_train.MetricsLogger(j_loss, [])
    j_trainer = j_train.NNTrainer(j_loss, [], None, j_logger)
    want = _losses(j_trainer, j_logger, warmup, fixed, lambda loader: j_trainer.run(
        j_model, j_train.make_optimizer(LR), 1, loader, None, base_lr=LR,
        init_params=jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)))

    t_model = _reduced(t_den, torch.sigmoid, device="cpu")
    t_model.load_state_dict(flax_to_torch(params))
    t_model.to(torch.float64)
    t_loss = TLoss()
    t_logger = t_train.MetricsLogger(t_loss, [])
    t_trainer = t_train.NNTrainer(t_loss, [], None, t_logger)
    got = _losses(t_trainer, t_logger, warmup, fixed, lambda loader: t_trainer.run(
        t_model, t_train.make_optimizer(LR), 1, loader, None, base_lr=LR))

    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-6)
