"""Training the BatchNorm video family with the port's entry points: the
port's counterpart of ``tests/test_backbone_train_e2e.py:58`` (SlowFast on
dummy Kinetics through ``train_net.train``, precise BN, a checkpoint,
``TRAIN.AUTO_RESUME`` restoring the running statistics bit for bit, then
``test_net.test``), a checkpoint written by the JAX package loading into
the port, and ``utils/bn.py`` against JAX's ``utils/bn.py``.

Geometry: ``WIDTH_PER_GROUP`` 8, 4 or 8 frames (``ALPHA`` 4), 32^2
crops, 5 classes, fp32, 2 loader threads.  Tolerances fp32 atol = rtol = 2e-5.
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from procedurevrl_tpu.config import get_cfg as jax_get_cfg
from procedurevrl_tpu.engine.steps import TrainState
from procedurevrl_tpu.models import resnet_video as jr
from procedurevrl_tpu.utils import bn as jbn
from procedurevrl_tpu.utils import checkpoint as jax_cu
from procedurevrl_tpu.utils.converter import convert_resnet_video
from procedurevrl_torch.config import load_config
from procedurevrl_torch.datasets import kinetics
from procedurevrl_torch.datasets.build import build_dataset
from procedurevrl_torch.models import resnet_video as pr
from procedurevrl_torch.models.build import build_model
from procedurevrl_torch.tools import test_net
from procedurevrl_torch.tools.train_net import train
from procedurevrl_torch.utils import bn
from procedurevrl_torch.utils import checkpoint as cu

TOL = dict(atol=2e-5, rtol=2e-5)
SLOWFAST = ["SLOWFAST.ALPHA", "4", "SLOWFAST.BETA_INV", "8",
            "RESNET.NUM_BLOCK_TEMP_KERNEL", "[[3, 3], [4, 4], [6, 6], [3, 3]]",
            "RESNET.SPATIAL_STRIDES", "[[1, 1], [2, 2], [2, 2], [2, 2]]",
            "RESNET.SPATIAL_DILATIONS", "[[1, 1], [1, 1], [1, 1], [1, 1]]",
            "NONLOCAL.LOCATION", "[[[], []], [[], []], [[], []], [[], []]]",
            "NONLOCAL.GROUP", "[[1, 1], [1, 1], [1, 1], [1, 1]]",
            "NONLOCAL.POOL", "[[[1, 2, 2], [1, 2, 2]], [[1, 2, 2], [1, 2, 2]], "
            "[[1, 2, 2], [1, 2, 2]], [[1, 2, 2], [1, 2, 2]]]"]


def _cfg(tmp_path, model="SlowFast", *opts):
    return load_config(None, [
        "DEV.LOAD_DUMMY_DATA", "True", "TRAIN.DATASET", "kinetics",
        "TEST.DATASET", "kinetics", "TRAIN.BATCH_SIZE", "16",
        "GLOBAL_BATCH_SIZE", "16", "TEST.BATCH_SIZE", "32",
        "SOLVER.MAX_EPOCH", "1", "SOLVER.OPTIMIZING_METHOD", "sgd",
        "SOLVER.LR_POLICY", "cosine", "MODEL.MODEL_NAME", model,
        "MODEL.ARCH", "slowfast" if model == "SlowFast" else "slow",
        "MODEL.NUM_CLASSES", "5", "MODEL.LOSS_FUNC", "cross_entropy",
        "MODEL.PRETRAINED", "False", "TRAIN.LABEL_EMB", "",
        "RESNET.WIDTH_PER_GROUP", "8", "BN.USE_PRECISE_STATS", "True",
        "BN.NUM_BATCHES_PRECISE", "2", "DATA.NUM_FRAMES", "8",
        "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
        "DATA.TRAIN_JITTER_SCALES", "[36, 40]",
        "DATA.PATH_TO_DATA_DIR", "/nonexistent", "LOG_PERIOD", "4",
        "TRAIN.EVAL_PERIOD", "1", "TRAIN.CHECKPOINT_PERIOD", "1",
        "TRAIN.AUTO_RESUME", "True", "TEST.NUM_ENSEMBLE_VIEWS", "2",
        "TEST.NUM_SPATIAL_CROPS", "1", "TPU.COMPUTE_DTYPE", "float32",
        "DATA_LOADER.NUM_WORKERS", "2", "OUTPUT_DIR", str(tmp_path),
        *(SLOWFAST if model == "SlowFast" else []), *opts])


def test_slowfast_trains_on_dummy_kinetics_and_resumes(tmp_path, monkeypatch):
    """An epoch of 2 steps (16 dummy videos, 4 frames), precise BN over 2
    batches before the checkpoint, a resume that restores the running
    statistics bit for bit, and the multi-view test of the file."""
    monkeypatch.setattr(kinetics, "NUM_DUMMY", 16)
    calls = []
    orig = bn.compute_precise_bn_stats
    monkeypatch.setattr("procedurevrl_torch.tools.train_net."
                        "compute_precise_bn_stats",
                        lambda *a, **k: calls.append(a[3]) or orig(*a, **k))
    small = ("TRAIN.BATCH_SIZE", "8", "GLOBAL_BATCH_SIZE", "8",
             "DATA.NUM_FRAMES", "4", "TRAIN.EVAL_PERIOD", "2")
    out = train(_cfg(tmp_path, "SlowFast", *small), "cpu")
    assert out["steps"] == 2 and not out["val"]
    assert calls == [2]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    model = out["model"]
    stats = {k: v.clone() for k, v in model.bn_state().items()}
    saved = torch.load(out["checkpoints"][0], weights_only=False)
    for k, v in stats.items():
        assert torch.equal(saved["model_state"][k], v), k
    # MAX_EPOCH reached: restore only
    again = train(_cfg(tmp_path, "SlowFast", *small), "cpu")
    assert again["steps"] == 0 and again["start_epoch"] == 1
    for k, v in again["model"].bn_state().items():
        assert torch.equal(v, stats[k]), k
    res = test_net.test(_cfg(tmp_path, "SlowFast", *small), "cpu")
    assert 0.0 <= float(res["top1_acc"]) <= 100.0


def test_the_dummy_split_is_jax_s():
    """Kinetics' dummy split: 64 seeded videos, the test views' indices
    (JAX ``datasets/kinetics.py``)."""
    from procedurevrl_tpu.datasets import kinetics as jk

    cfg = load_config(None, ["DEV.LOAD_DUMMY_DATA", "True",
                             "MODEL.NUM_CLASSES", "5", "DATA.NUM_FRAMES",
                             "4", "DATA.TRAIN_CROP_SIZE", "32",
                             "DATA.TEST_CROP_SIZE", "32",
                             "DATA.TRAIN_JITTER_SCALES", "[36, 40]",
                             "TEST.NUM_ENSEMBLE_VIEWS", "2",
                             "TEST.NUM_SPATIAL_CROPS", "3"])
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(["DEV.LOAD_DUMMY_DATA", "True", "MODEL.NUM_CLASSES",
                          "5", "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE",
                          "32", "DATA.TEST_CROP_SIZE", "32",
                          "DATA.TRAIN_JITTER_SCALES", "[36, 40]",
                          "TEST.NUM_ENSEMBLE_VIEWS", "2",
                          "TEST.NUM_SPATIAL_CROPS", "3"])
    for mode in ("train", "test"):
        ds, jds = build_dataset("kinetics", cfg, mode), jk.Kinetics(jcfg, mode)
        assert len(ds) == len(jds) == 64 * (6 if mode == "test" else 1)
        for i in (0, 7, len(ds) - 1):
            got, want = ds[i], jds[i]
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:3] == want[1:3]
    with pytest.raises(NotImplementedError, match="short cycle"):
        build_dataset("kinetics", cfg, "train")[(0, 1)]


def test_a_jax_checkpoint_loads_with_its_batch_stats(tmp_path):
    """A checkpoint the JAX package wrote (flax msgpack, ``batch_stats``
    beside the parameters) loads into the port by
    ``TEST.CHECKPOINT_FILE_PATH``: the port's eval logits equal JAX's."""
    cfg = _cfg(tmp_path, "ResNet", "DATA.NUM_FRAMES", "4")
    source, _ = build_model(cfg, "cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for m in source.modules():
            if isinstance(m, pr.VideoBatchNorm):
                m.running_mean.normal_(0.0, 0.5, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    params, stats = convert_resnet_video(
        {k: v.numpy() for k, v in source.state_dict().items()})
    state = TrainState.create(params, optax.sgd(0.1), stats)
    path = jax_cu.save_checkpoint(str(tmp_path / "jax"), state,
                                  jax_get_cfg(), 0)
    cfg = _cfg(tmp_path, "ResNet", "DATA.NUM_FRAMES", "4", "RNG_SEED", "7",
               "TEST.CHECKPOINT_FILE_PATH", path)
    model, _ = build_model(cfg, "cpu")
    assert cu.load_test_checkpoint(cfg, model) == path
    for k, v in source.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    x = np.random.RandomState(2).randn(2, 4, 32, 32, 3).astype(np.float32)
    rc = pr.ResNetFamilyConfig.from_cfg(cfg)
    jmodel = jr.ResNetModel(rc=jr.ResNetFamilyConfig(
        **{f: getattr(rc, f) for f in rc.__dataclass_fields__}))
    want = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("splits", [1, 2])
def test_precise_bn_stats_match_jax(splits):
    """``compute_precise_bn_stats`` over 3 batches from the same running
    statistics: the recovered batch statistics' average (JAX
    ``utils/bn.py``), and ``aggregate_sub_bn_stats``."""
    rng = np.random.RandomState(splits)
    batches = [(1.5 * rng.randn(4, 2, 2, 2, 3) + 0.5).astype(np.float32)
               for _ in range(3)]
    port = pr.VideoBatchNorm(3, splits=splits)
    with torch.no_grad():
        port.running_mean.normal_(0.0, 0.5)
        port.running_var.uniform_(0.5, 1.5)
    state0 = {"running_mean": port.running_mean.clone(),
              "running_var": port.running_var.clone()}
    jmod = jr.VideoBatchNorm(splits=splits)
    params = {"scale": np.ones(3, np.float32), "bias": np.zeros(3, np.float32)}

    def jax_apply(ms, batch):
        _, mut = jmod.apply({"params": params, "batch_stats": ms},
                            jnp.asarray(batch), True, mutable=["batch_stats"])
        return mut["batch_stats"]

    def port_apply(ms, batch):
        port.running_mean.copy_(ms["running_mean"])
        port.running_var.copy_(ms["running_var"])
        with torch.no_grad():
            port(torch.from_numpy(batch).permute(0, 4, 1, 2, 3), True)
        return {"running_mean": port.running_mean.clone(),
                "running_var": port.running_var.clone()}

    want = jbn.compute_precise_bn_stats(
        jax_apply, {"mean": state0["running_mean"].numpy(),
                    "var": state0["running_var"].numpy()}, iter(batches),
        num_batches=3)
    got = bn.compute_precise_bn_stats(port_apply, state0, iter(batches),
                                      num_batches=3)
    np.testing.assert_allclose(got["running_mean"].numpy(),
                               np.asarray(want["mean"]), **TOL)
    np.testing.assert_allclose(got["running_var"].numpy(),
                               np.asarray(want["var"]), **TOL)
    agg, n = bn.aggregate_sub_bn_stats({"s1.bn." + k: v
                                        for k, v in got.items()})
    jagg, jn = jbn.aggregate_sub_bn_stats(
        {"s1": {"bn": {k: np.asarray(v) for k, v in want.items()}}})
    assert n == jn == (1 if splits > 1 else 0)
    np.testing.assert_allclose(agg["s1.bn.running_mean"].numpy(),
                               np.asarray(jagg["s1"]["bn"]["mean"]), **TOL)
    np.testing.assert_allclose(agg["s1.bn.running_var"].numpy(),
                               np.asarray(jagg["s1"]["bn"]["var"]), **TOL)
