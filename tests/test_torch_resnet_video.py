"""The BatchNorm video family of the PyTorch port (SlowFast, Slow, X3D,
``VideoBatchNorm``, ``roi_align`` and the RoI head) against the JAX
package's ``models/resnet_video.py`` and ``ops/roi_align.py``.

The weight bridge: the port's ``state_dict()`` goes through JAX's
``convert_resnet_video`` into ``(params, batch_stats)``, and
``weights.resnet_state_from_jax`` takes them back exactly.  Every BN has
random running statistics and affine parameters, so eval normalises with
non-trivial ones.  Geometry: depth 50 (the only stage plan besides 101),
``WIDTH_PER_GROUP`` 8, 4 frames (SlowFast ``ALPHA`` 4: one slow frame),
32^2 crops, 2 clips; X3D ``DIM_C5`` 64.  fp32, atol = rtol = 2e-5;
gradients 5e-5, a deep train step's against its float32 rounding floor
(see the test).  The JAX sides run under ``jit``.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procedurevrl_tpu.models import resnet_video as jr
from procedurevrl_tpu.ops import roi_align as jroi
from procedurevrl_tpu.utils.converter import convert_resnet_video
from procedurevrl_torch.config import load_config
from procedurevrl_torch.engine.steps import make_train_step
from procedurevrl_torch.models import resnet_video as pr
from procedurevrl_torch.models.build import build_model
from procedurevrl_torch.ops.roi_align import roi_align
from procedurevrl_torch.solver.optimizer import construct_optimizer
from procedurevrl_torch.utils import weights

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
BASE = dict(depth=50, width_per_group=8, num_frames=4, crop_size=32,
            num_classes=9, alpha=4, beta_inv=8, dropout_rate=0.0)
SLOWFAST = dict(num_block_temp_kernel=((3, 3), (4, 4), (6, 6), (3, 3)),
                spatial_strides=((1, 1), (2, 2), (2, 2), (2, 2)),
                spatial_dilations=((1, 1), (1, 1), (1, 1), (1, 1)),
                nonlocal_location=(((), ()),) * 4,
                nonlocal_group=((1, 1),) * 4,
                nonlocal_pool=(((1, 2, 2), (1, 2, 2)),) * 4)
MODELS = {
    # non-local blocks (softmax) after res3's blocks 0 and 2
    "slow_nonlocal": ("slow", pr.ResNetModel, jr.ResNetModel, dict(
        nonlocal_location=(((),), ((0, 2),), ((),), ((),)),
        nonlocal_instantiation="softmax")),
    # non-local blocks (dot product) on both pathways of res3, the fast
    # one's over groups of 2 frames
    "slowfast_nonlocal": ("slowfast", pr.SlowFastModel, jr.SlowFastModel,
                          {**SLOWFAST,
                           "nonlocal_location": ((((), ()), ((1,), (0, 2)))
                                                 + (((), ()),) * 2),
                           "nonlocal_group": ((1, 1), (1, 2), (1, 1), (1, 1))}),
    "x3d": ("x3d", pr.X3DModel, jr.X3DModel, dict(
        trans_func="x3d_transform", x3d_dim_c5=64)),
}


def _randomize(model: torch.nn.Module, seed: int) -> None:
    """Random running statistics and affine parameters in every BN."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, pr.VideoBatchNorm):
                m.running_mean.normal_(0.0, 0.5, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.weight.normal_(1.0, 0.2, generator=gen)
                m.bias.normal_(0.0, 0.2, generator=gen)


def _pair(name: str, seed: int = 0, **over):
    arch, pcls, jcls, extra = MODELS[name]
    rc = pr.ResNetFamilyConfig(arch=arch, **{**BASE, **extra, **over})
    port = pcls(rc)
    port.reset_parameters(torch.Generator().manual_seed(seed))
    _randomize(port, seed + 1)
    jmodel = jcls(rc=jr.ResNetFamilyConfig(**dataclasses.asdict(rc)))
    return port, jmodel


def _jax_variables(port: torch.nn.Module):
    params, stats = convert_resnet_video(
        {k: v.numpy() for k, v in port.state_dict().items()})
    return {"params": params, "batch_stats": stats}


def _clip(seed: int, b: int = 2) -> np.ndarray:
    return np.random.RandomState(seed).randn(b, 4, 32, 32, 3).astype(
        np.float32)


# ------------------------------------------------------------ BatchNorm


def _bn_pair(splits=1, frozen=False, c=5):
    port = pr.VideoBatchNorm(c, splits=splits, frozen=frozen)
    _randomize(port, splits)
    jbn = jr.VideoBatchNorm(splits=splits, frozen=frozen)
    variables = {"params": {"scale": port.weight.detach().numpy(),
                            "bias": port.bias.detach().numpy()},
                 "batch_stats": {"mean": port.running_mean.numpy().copy(),
                                 "var": port.running_var.numpy().copy()}}
    return port, jbn, variables


def _ncdhw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous()


@pytest.mark.parametrize("splits,frozen", [(1, False), (2, False),
                                           (4, False), (1, True), (2, True)])
def test_video_batch_norm_matches_jax(splits, frozen):
    """Train mode (output, gradients, running statistics) and eval mode
    (split statistics aggregated) against JAX's ``VideoBatchNorm``."""
    x = np.random.RandomState(splits).randn(8, 2, 3, 3, 5).astype(np.float32)
    g = np.random.RandomState(9).randn(*x.shape).astype(np.float32)
    port, jbn, variables = _bn_pair(splits, frozen)

    def train(p, xx):
        return jbn.apply({"params": p,
                          "batch_stats": variables["batch_stats"]}, xx, True,
                         mutable=["batch_stats"])

    def grads(p, xx, gg):
        return jax.vjp(lambda p, xx: train(p, xx)[0], p, xx)[1](gg)

    out, mut = jax.jit(train)(variables["params"], jnp.asarray(x))
    dp, dx = jax.jit(grads)(variables["params"], jnp.asarray(x),
                            jnp.asarray(g))
    xt = _ncdhw(x).requires_grad_(True)
    got = port(xt, True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).detach().numpy(),
                               np.asarray(out), **TOL)
    got.backward(_ncdhw(g))
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(dx), **GRAD_TOL)
    np.testing.assert_allclose(port.weight.grad.numpy(),
                               np.asarray(dp["scale"]), **GRAD_TOL)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]), **TOL)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]), **TOL)
    want = jax.jit(lambda v, xx: jbn.apply(v, xx, False))(
        {"params": variables["params"], "batch_stats": mut["batch_stats"]},
        jnp.asarray(x))
    with torch.no_grad():
        got = port(_ncdhw(x), False)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(want), **TOL)


def test_norm_builder_and_the_config():
    cfg = load_config(None, ["BN.NORM_TYPE", "sync_batchnorm", "NUM_GPUS",
                             "4", "BN.NUM_SYNC_DEVICES", "2", "BN.FROZEN",
                             "True"])
    rc = pr.ResNetFamilyConfig.from_cfg(cfg)
    assert (rc.bn_num_groups, rc.bn_frozen) == (2, True)
    bn = rc.norm_builder()(6)
    assert (bn.splits, bn.frozen, tuple(bn.running_mean.shape)) == (2, True,
                                                                    (2, 6))
    with pytest.raises(NotImplementedError, match="Norm type"):
        pr.get_norm_builder("group_norm", 1, 1)
    with pytest.raises(ValueError, match="does not split"):
        pr.VideoBatchNorm(3, splits=3)(torch.zeros(4, 3, 1, 1, 1), True)


# ---------------------------------------------------------------- models


# Slow and SlowFast, each with blocks with and without a non-local block
# after them (softmax and dot product), and X3D: every block, stem, head
# and fusion kind of the family, one JAX compile each
@pytest.mark.parametrize("name", sorted(MODELS))
def test_eval_logits_match_jax(name):
    port, jmodel = _pair(name)
    variables = _jax_variables(port)
    x = _clip(3)
    want = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the bridge back: JAX's trees give the port's state dict exactly
    back = weights.resnet_state_from_jax(variables["params"],
                                         variables["batch_stats"])
    own = port.state_dict()
    assert set(back) == set(own)
    for k, v in own.items():
        assert torch.equal(back[k], v), k


def _train_cfg():
    return load_config(None, [
        "MODEL.MODEL_NAME", "ResNet", "MODEL.ARCH", "slow",
        "MODEL.NUM_CLASSES", "9", "MODEL.DROPOUT_RATE", "0.0",
        "MODEL.LOSS_FUNC", "cross_entropy", "RESNET.WIDTH_PER_GROUP", "8",
        "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32",
        "TRAIN.DATASET", "kinetics", "TRAIN.LABEL_EMB", "",
        "TPU.COMPUTE_DTYPE", "float32", "SOLVER.OPTIMIZING_METHOD", "sgd",
        "SOLVER.MOMENTUM", "0.9", "SOLVER.WEIGHT_DECAY", "1e-4",
        "BN.WEIGHT_DECAY", "0.0", "SOLVER.BASE_LR", "0.1"])


def _float64_grads(port: torch.nn.Module, x: np.ndarray, labels):
    """The gradients of the same loss through a float64 copy of ``port``,
    and the copy's updated running statistics."""
    ref = copy.deepcopy(port).double()
    ref.compute_dtype = torch.float64
    loss = torch.nn.functional.cross_entropy(
        ref(torch.from_numpy(x).double(), train=True),
        torch.from_numpy(labels))
    loss.backward()
    return {n: p.grad for n, p in ref.named_parameters()}, ref.bn_state()


def _worst(got, want, names):
    """The largest difference of any tensor over its largest value."""
    return max(float((got[n].double() - want[n].double()).abs().max()
                     / want[n].double().abs().max()) for n in names)


def test_one_sgd_step_matches_jax():
    """One SGD step of Slow through the port's ``make_train_step`` against
    JAX's loss, gradients and updated ``batch_stats`` of the same batch
    (train-mode BN over the batch).  Train-mode BN through 53 layers of
    random weights amplifies float32 rounding: the port's own float32
    gradients differ from its float64 ones by ~2e-4 of each tensor's
    largest value here (up to 0.2 at other sizes), so the gradients are
    held to within 4x that floor of JAX's, and to 1e-3 of the largest; the
    updated running statistics likewise, or to 2e-5."""
    cfg = _train_cfg()
    port, _ = build_model(cfg, "cpu")
    _randomize(port, 5)
    x = _clip(4, b=3)
    labels = np.array([1, 7, 3])
    exact, exact_stats = _float64_grads(port, x, labels)
    rc = pr.ResNetFamilyConfig.from_cfg(cfg)
    jmodel = jr.ResNetModel(rc=jr.ResNetFamilyConfig(**dataclasses.asdict(rc)))
    variables = _jax_variables(port)

    def loss_fn(p):
        logits, mut = jmodel.apply(
            {"params": p, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits, axis=-1)
        loss = -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(labels)[:, None], axis=1))
        return loss, mut["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    optimizer = construct_optimizer(port, cfg)
    step = make_train_step(port, optimizer, cfg, None, lambda s: 0.1)
    metrics = step({"frames": torch.from_numpy(x),
                    "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(metrics["loss"]), float(loss), **TOL)
    want = weights.resnet_state_from_jax(jax.tree_util.tree_map(
        np.asarray, grads), jax.tree_util.tree_map(np.asarray, stats))
    got = {n: p.grad for n, p in port.named_parameters()}
    floor = _worst(got, exact, got)
    assert _worst(got, want, got) <= min(4 * floor, 1e-3), floor
    stats = port.bn_state()
    floor = _worst(stats, exact_stats, stats)
    assert _worst(stats, want, stats) <= max(4 * floor, 2e-5), floor


# --------------------------------------------------------- RoI, pathways


def test_roi_align_on_grid_points_and_midpoints():
    feats = np.arange(2 * 4 * 4 * 3, dtype=np.float32).reshape(2, 4, 4, 3)
    cases = [(np.array([[1.0, 1.0, 1.0, 3.0, 3.0]]), 2, 1, True),
             (np.array([[0.0, 1.5, 1.5, 2.5, 2.5]]), 1, 1, True),
             (np.array([[1.0, 0.3, 0.7, 2.9, 3.6], [0.0, 2.0, 1.0, 2.2, 1.1]]),
              3, 2, False),
             (np.array([[0.0, -1.0, 0.5, 5.0, 3.0]]), 2, 2, True)]
    for boxes, out, ratio, aligned in cases:
        want = jax.jit(lambda f, b: jroi.roi_align(
            f, b, out, spatial_scale=1.0, sampling_ratio=ratio,
            aligned=aligned))(jnp.asarray(feats), jnp.asarray(boxes))
        got = roi_align(torch.from_numpy(feats), torch.from_numpy(boxes),
                        out, 1.0, ratio, aligned)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # exact on the pixel grid; a half-pixel box averages its 4 neighbours
    got = roi_align(torch.from_numpy(feats[..., :1]),
                    torch.tensor([[1.0, 1.0, 1.0, 3.0, 3.0]]), 2, 1.0, 1)
    base = feats[1, :, :, 0]
    assert got[0, :, :, 0].tolist() == [[base[1, 1], base[1, 2]],
                                        [base[2, 1], base[2, 2]]]
    got = roi_align(torch.from_numpy(feats[..., :1]),
                    torch.tensor([[0.0, 1.5, 1.5, 2.5, 2.5]]), 1, 1.0, 1)
    assert float(got) == np.mean(feats[0, 1:3, 1:3, 0])


def test_roi_head_matches_jax():
    rng = np.random.RandomState(6)
    inputs = [rng.randn(2, 2, 4, 4, 16).astype(np.float32),
              rng.randn(2, 8, 4, 4, 2).astype(np.float32)]
    boxes = np.array([[0, 0, 0, 32, 32], [1, 16, 16, 63, 63],
                      [0, 8, 8, 40, 56]], np.float32)
    jhead = jr.ResNetRoIHead(num_classes=6, pool_size=((2, 1, 1), (8, 1, 1)),
                             resolution=((2, 2), (2, 2)), scale_factor=(16, 16))
    xs, bx = [jnp.asarray(a) for a in inputs], jnp.asarray(boxes)
    v = jax.jit(lambda a, b: jhead.init(jax.random.PRNGKey(0), a, b,
                                        False))(xs, bx)
    want = jax.jit(lambda p, a, b: jhead.apply(p, a, b, False))(v, xs, bx)
    port = pr.ResNetRoIHead((16, 2), 6, ((2, 1, 1), (8, 1, 1)),
                            ((2, 2), (2, 2)), (16, 16))
    kernel = np.asarray(v["params"]["projection"]["kernel"])
    port.projection.weight.data = torch.from_numpy(kernel.T.copy())
    port.projection.bias.data = torch.from_numpy(
        np.asarray(v["params"]["projection"]["bias"]).copy())
    with torch.no_grad():
        got = port([_ncdhw(a) for a in inputs], torch.from_numpy(boxes),
                   False)
    assert got.shape == (3, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("t,alpha", [(32, 8), (8, 4), (10, 3)])
def test_pack_pathways_matches_jax(t, alpha):
    x = np.arange(2 * t * 3, dtype=np.float32).reshape(2, t, 1, 1, 3)
    want = jr.pack_pathways(jnp.asarray(x), "slowfast", alpha, True)
    got = pr.pack_pathways(torch.from_numpy(x), "slowfast", alpha, True)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert len(pr.pack_pathways(torch.from_numpy(x), "x3d", alpha)) == 1
