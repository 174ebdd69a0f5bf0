"""The rest of the model zoo held against the JAX package's Flax modules on
the CPU: the shared layers (JAX's cubic resize, unfold, fold, the variance
map), ``DepthwiseDownBlock``, ``MultiScaleConvPool``,
``ParallelUpsampleReduce``, ``LocalAttentionPatch``, ``Autoencoder``,
``UpDownScale``, ``Restorer``, ``Deconvs``, ``ADMMFusion`` and
``RestorerV2``, at the constructions of tests/test_models.py and
tests/test_misc.py. Weights come from one Flax init through
``convert.flax_to_torch``, inputs from numpy seeds, cast to float32 (or
float64 where stated) on both sides."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests._threads import one_torch_thread  # noqa: F401 (autouse)
from torch_admm_deconv_tpu_torch import models as T
from torch_admm_deconv_tpu_torch.convert import flax_to_torch
from torch_admm_deconv_tpu_torch.models import layers_common as t_layers

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from torch_admm_deconv_tpu import models as M  # noqa: E402
from torch_admm_deconv_tpu.models import layers_common as j_layers  # noqa: E402

CPU = dict(device="cpu")


def _gelu_tanh(v):
    return F.gelu(v, approximate="tanh")


def _img(rng, shape, dtype=np.float32):
    return (rng.normal(size=shape) * 0.1 + 0.5).astype(dtype)


def _load(j_module, t_module, x):
    """Init the Flax module on ``x`` and apply it, in one jitted call; load
    the converted params into the port's module (strict). Returns the Flax
    output and params."""
    out, params = jax.jit(j_module.init_with_output)(jax.random.PRNGKey(0), jnp.asarray(x))
    t_module.load_state_dict(flax_to_torch(jax.tree_util.tree_map(np.asarray, params)))
    return np.asarray(out), params


# --- the shared layers --------------------------------------------------------


@pytest.mark.parametrize("shape,scale", [((1, 2, 8, 8), 2), ((2, 3, 5, 7), 3)])
def test_interpolate_bicubic_is_jax_resize_not_torch_bicubic(rng, shape, scale):
    """Against ``jax.image.resize(method="cubic")`` itself: 1e-5 (float32
    weights of a 1-D product each way; measured 1.5e-6 at scale 3, whose
    sample offsets are not binary fractions). ``F.interpolate``'s bicubic
    (a = -0.75, clamped borders) is not that function: it differs by more
    than 0.1 on these inputs."""
    x = rng.normal(size=shape).astype(np.float32)
    b, c, h, w = shape
    want = np.asarray(jax.image.resize(jnp.asarray(x), (b, c, h * scale, w * scale),
                                       method="cubic"))
    got = t_layers.interpolate_bicubic(torch.from_numpy(x), scale).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    torch_bicubic = F.interpolate(torch.from_numpy(x), scale_factor=scale, mode="bicubic")
    assert float(np.abs(torch_bicubic.numpy() - want).max()) > 0.1


@pytest.mark.parametrize("kernel,stride", [(3, 2), ((2, 3), (1, 2)), (4, 4)])
def test_unfold_and_fold_match_jax(rng, kernel, stride):
    """Patch extraction and overlap-add: exact (the same additions)."""
    x = rng.normal(size=(2, 3, 9, 10)).astype(np.float32)
    want = np.asarray(j_layers.unfold(jnp.asarray(x), kernel, stride))
    got = t_layers.unfold(torch.from_numpy(x), kernel, stride)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        t_layers.fold(got, (9, 10), kernel, stride).numpy(),
        np.asarray(j_layers.fold(jnp.asarray(want), (9, 10), kernel, stride)))


@pytest.mark.parametrize("kernel,stride,padding", [(3, 1, 1), (5, 2, 2), (3, 1, 0)])
def test_channelwise_variance_matches_jax(rng, kernel, stride, padding):
    """Windowed E[x^2] - E[x]^2 on values of order 1: 1e-5."""
    x = rng.normal(size=(2, 3, 11, 9)).astype(np.float32)
    want = np.asarray(M.channelwise_variance(jnp.asarray(x), kernel, stride, padding))
    got = T.ChannelwiseVariance(kernel, stride, padding)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_channel_pool_module_and_the_sequential(rng):
    """``ChannelPool`` is ``channel_pool`` (held against JAX in
    tests/test_torch_models.py); ``Sequential`` registers its modules under
    Flax's list names."""
    xt = torch.from_numpy(rng.normal(size=(2, 5, 6, 6)).astype(np.float32))
    torch.testing.assert_close(T.ChannelPool()(xt), T.channel_pool(xt), rtol=0, atol=0)
    conv = T.Conv2d(5, 2, 1, device="cpu")
    seq = t_layers.Sequential([conv, torch.relu])
    assert [n for n, _ in seq.named_parameters()] == ["layers_0.weight", "layers_0.bias"]
    torch.testing.assert_close(seq(xt), torch.relu(conv(xt)))


# --- the models ---------------------------------------------------------------


def _restorer_args():
    return dict(autoencoder_args=dict(in_channels=6, enc_out_channels=[8, 8],
                                      dec_out_channels=[8, 4], kernel_sizes=[3, 3]),
                updownscale_args=dict(in_channels=6, out_channels=[8, 8], kernel_sizes=[3, 3]),
                deconvs_args=[{"kern_size": (), "max_iters": 2}] * 2)


_FUSION = [{"kern_size": (), "max_iters": 2}, {"kern_size": (), "max_iters": 3}]
_V2 = dict(blocks_filters=[8, 8], blocks_gate_channels=[8, 8], blocks_attention_reduction=[2, 2],
           admms=[{"kern_size": (), "max_iters": 2, "iso": True}])

# name: (Flax module, the port's, input shape)
CASES = {
    "depthwise_down_block": (lambda: M.DepthwiseDownBlock(4, 8, 3, activation=jax.nn.relu),
                             lambda: T.DepthwiseDownBlock(4, 8, 3, activation=torch.relu, **CPU),
                             (1, 4, 10, 10)),
    "multiscale_conv_pool": (lambda: M.MultiScaleConvPool(4, 6, 8, [3, 5, 7]),
                             lambda: T.MultiScaleConvPool(4, 6, 8, [3, 5, 7], **CPU),
                             (2, 4, 10, 10)),
    "parallel_upsample_reduce": (lambda: M.ParallelUpsampleReduce(4, 2, 3, [3, 5, 7]),
                                 lambda: T.ParallelUpsampleReduce(4, 2, 3, [3, 5, 7], **CPU),
                                 (1, 4, 8, 8)),
    "local_attention_patch": (
        lambda: M.LocalAttentionPatch(patch_size=4, stride=4, num_processors=2,
                                      features_multiplier=2, downscale_kernel=2,
                                      downscale_stride=2),
        lambda: T.LocalAttentionPatch(4, 4, 2, 3, features_multiplier=2, downscale_kernel=2,
                                      downscale_stride=2, **CPU),
        (2, 3, 4, 8)),
    "autoencoder": (lambda: M.Autoencoder(3, [8, 16], [8, 3], [3, 3], activation=jax.nn.gelu),
                    lambda: T.Autoencoder(3, [8, 16], [8, 3], [3, 3], activation=_gelu_tanh,
                                          **CPU),
                    (1, 3, 20, 20)),
    "updownscale": (lambda: M.UpDownScale(3, [8, 8], [3, 3], activation=jax.nn.gelu),
                    lambda: T.UpDownScale(3, [8, 8], [3, 3], activation=_gelu_tanh, **CPU),
                    (1, 3, 16, 16)),
    "restorer": (lambda: M.Restorer(inc_channels=3, **_restorer_args()),
                 lambda: T.Restorer(3, **_restorer_args(), **CPU), (1, 3, 16, 16)),
    "deconvs": (lambda: M.Deconvs([{"kern_size": (), "max_iters": 2, "iso": False}] * 2),
                lambda: T.Deconvs([{"kern_size": (), "max_iters": 2, "iso": False}] * 2, **CPU),
                (1, 3, 8, 8)),
    "admm_fusion": (lambda: M.ADMMFusion(_FUSION, in_channels=3),
                    lambda: T.ADMMFusion(_FUSION, 3, **CPU), (1, 3, 8, 8)),
    "admm_fusion_with_admms": (lambda: M.ADMMFusion(_FUSION, in_channels=3, with_admms=True),
                               lambda: T.ADMMFusion(_FUSION, 3, with_admms=True, **CPU),
                               (1, 3, 8, 8)),
    "restorer_v2": (lambda: M.RestorerV2(in_channels=3, **_V2),
                    lambda: T.RestorerV2(3, **_V2, **CPU), (1, 3, 16, 16)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_model_forward_matches_jax(rng, name):
    """float32 forward at 1e-5 (the same float32 formulas, sums and FFTs in
    other orders; measured at most 4.5e-7)."""
    j_ctor, t_ctor, shape = CASES[name]
    x = _img(rng, shape)
    j_module, t_module = j_ctor(), t_ctor()
    want, _ = _load(j_module, t_module, x)
    got = t_module(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("name", ["restorer", "admm_fusion", "restorer_v2"])
def test_model_gradients_match_jax_in_float64(rng, name):
    """d mean((out - 0.5)^2) for every parameter, ADMM layers' lambda and rho
    included, against ``jax.grad`` in float64, where the top-k channel
    choice behind the ADMM layers does not hinge on float32 collisions
    (ROADMAP §3): 1e-6 relative to the largest gradient of the leaf."""
    j_ctor, t_ctor, shape = CASES[name]
    x = _img(rng, shape, np.float64)
    j_module, t_module = j_ctor(), t_ctor()
    _, params = _load(j_module, t_module, x.astype(np.float32))
    # lambda 0.05 and rho 1 in every ADMM layer: at their U(0, 1) init the
    # shrinkage can zero every difference, and lambda's gradient with it
    admm = {"lmbda": np.float32(0.05), "rho": np.float32(1.0)}  # flax_to_torch copies float32
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.full(v.shape, admm.get(path[-1].key, 0.0), jnp.float64)
        if path[-1].key in admm else jnp.asarray(v, jnp.float64), params)
    t_module.load_state_dict(flax_to_torch(jax.tree_util.tree_map(np.asarray, params)))
    want = jax.jit(jax.grad(lambda p: jnp.mean((j_module.apply(p, jnp.asarray(x)) - 0.5) ** 2)))(
        params)
    want = flax_to_torch(jax.tree_util.tree_map(np.asarray, want))
    t_module.double()
    torch.mean((t_module(torch.from_numpy(x)) - 0.5) ** 2).backward()
    # parameters that reach the output only through top-k indices (the
    # channel attention of AttentionChannelPooling) get no gradient here and
    # zeros in JAX
    got = {n: torch.zeros_like(p) if p.grad is None else p.grad
           for n, p in t_module.named_parameters()}
    assert set(got) == set(want)
    for n, g in got.items():
        w = want[n].double()
        scale = max(float(w.abs().max()), 1e-12)
        assert float((g - w).abs().max()) <= 1e-6 * scale, n
    assert any(float(g.abs().max()) > 0 for n, g in got.items() if n.endswith("lmbda"))


def test_state_dict_keys_keep_the_jax_child_names():
    """The children named as the JAX modules name them, so flax_to_torch
    paths match: spot checks on each model's tree."""
    restorer = T.Restorer(3, **_restorer_args(), **CPU)
    names = dict(restorer.named_parameters())
    for key in ("deconvs.block_1.lmbda", "autoencoder.encoder.block_0.down_conv.weight",
                "autoencoder.decoder.block_1.up_conv.weight", "updownscale.second_0.chx.bias",
                "out_block.up_block.up_conv.weight"):
        assert key in names, key
    # the autoencoder's 4, the updownscale's 8 and the two deconvolutions' 3 + 3
    assert names["out_block.chx.weight"].shape == (3, 4 + 8 + 6, 1, 1)
    fusion = dict(T.ADMMFusion(_FUSION, 3, **CPU).named_parameters())
    assert "admm_1.rho" in fusion and fusion["acp.cwa.conv1.weight"].shape == (12, 6, 1, 1)
    v2 = dict(T.RestorerV2(3, **_V2, **CPU).named_parameters())
    assert v2["block_0.norm.weight"].shape == (6,) and "block_0.admms.admm_0.lmbda" in v2
    assert v2["block_0.msconv1.cwa_pool.cwa.conv1.weight"].shape == (48, 24, 1, 1)
    lap = dict(T.LocalAttentionPatch(4, 4, 2, 3, **CPU).named_parameters())
    assert lap["processor_1.linear.weight"].shape == (3, 48)
    assert lap["processor_0.conv1d_a_1.weight"].shape == (3, 3, 1)
    assert lap["processor_0.conv2d_b_1.weight"].shape == (3, 3, 5, 5)
    assert T.conv2d_pooling_output_shape((8, 8), 3, 2, 1, pooling_size=2) == (2, 2)
    assert T.compute_depth_enc_in_out_channels(3, [2, 2]) == ([3, 6], [6, 12])


# --- validation errors, word for word -------------------------------------------


def _jax_error(module, shape):
    with pytest.raises(ValueError) as err:
        module.init(jax.random.PRNGKey(0), jnp.zeros(shape, jnp.float32))
    return str(err.value)


SRA_ERRORS = [dict(num_branches=3, branch_kernel_size=[3, 5]),
              dict(num_branches=2, branch_kernel_size=3, scale_factor=0),
              dict(num_branches=2, branch_kernel_size=3, scale_factor=1.5),
              dict(num_branches=0, branch_kernel_size=3),
              dict(num_branches=3, branch_kernel_size=[3, 4, 5]),
              dict(num_branches=2, branch_kernel_size=4)]


@pytest.mark.parametrize("kw", SRA_ERRORS, ids=["lengths", "scale0", "scale1.5", "branches0",
                                                "even", "even_int"])
def test_parallel_upsample_reduce_errors_match_jax(kw):
    kw = dict(dict(in_channels=2, scale_factor=2), **kw)
    want = _jax_error(M.ParallelUpsampleReduce(**kw), (1, 2, 4, 4))
    with pytest.raises(ValueError) as err:
        T.ParallelUpsampleReduce(**kw, **CPU)
    assert str(err.value) == want


# (constructor arguments, input shape)
PATCH_ERRORS = {
    "patch_size": (dict(patch_size=0, stride=4, num_processors=4), (1, 3, 8, 8)),
    "stride": (dict(patch_size=4, stride=0, num_processors=4), (1, 3, 8, 8)),
    "num_processors": (dict(patch_size=4, stride=4, num_processors=0), (1, 3, 8, 8)),
    "features_multiplier": (dict(patch_size=4, stride=4, num_processors=4,
                                 features_multiplier=0), (1, 3, 8, 8)),
    "ndim": (dict(patch_size=4, stride=4, num_processors=4), (3, 8, 8)),
    "channels": (dict(patch_size=4, stride=4, num_processors=4, channels=4), (1, 3, 8, 8)),
    "no_patches": (dict(patch_size=16, stride=4, num_processors=1), (1, 3, 8, 8)),
    "processors": (dict(patch_size=4, stride=4, num_processors=3), (1, 3, 8, 8)),
    "downscale_kernel": (dict(patch_size=4, stride=4, num_processors=4, downscale_kernel=0),
                         (1, 3, 8, 8)),
    "downscale_stride": (dict(patch_size=4, stride=4, num_processors=4,
                              downscale_stride=(1, 0)), (1, 3, 8, 8)),
}


@pytest.mark.parametrize("case", list(PATCH_ERRORS))
def test_local_attention_patch_errors_match_jax(case):
    """Every ValueError of JAX local_patch.py, the same words, at the port's
    construction or at its first call."""
    kw, shape = PATCH_ERRORS[case]
    want = _jax_error(M.LocalAttentionPatch(**kw), shape)
    t_kw = dict(kw, channels=kw.get("channels", 3))
    with pytest.raises(ValueError) as err:
        T.LocalAttentionPatch(**t_kw, **CPU)(torch.zeros(shape))
    assert str(err.value) == want
