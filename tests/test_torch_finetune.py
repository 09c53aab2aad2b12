"""The COIN finetunes of the PyTorch port against the JAX package: the
cross-entropy loss family, ``ValMeter`` and the accuracy metrics, one
finetune train step of each head (step / task classification, step
forecasting) in ``TRAIN.LINEAR`` and in ``TRAIN.MULT`` mode, and the
port's ``train_net`` and ``run_net`` on the COIN configurations on the CPU.

Train step geometry: encoder width 128, 2 heads of 64, depth 2, 32^2
crops, 2 frames a clip; ``label_dim`` 64, 2 order levels, ``NUM_SEG`` 4,
11 classes; B = 2 samples (8 clips for forecasting), drop path 0, fp32,
SGD with momentum 0.9 and coupled decay.  Both sides take the plain
attention path (JAX ``use_pallas=False``, the port's route likewise): the
linear probe runs the encoder forward only, and the kernels' forwards
are held against JAX in ``test_torch_forecast.py``.  Tolerances: loss and
errors fp32 atol = rtol = 2e-5, gradients and updated parameters 5e-5.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from procedurevrl_tpu.config import get_cfg as jax_get_cfg
from procedurevrl_tpu.engine import losses as jax_losses
from procedurevrl_tpu.engine.steps import TrainState
from procedurevrl_tpu.engine.steps import make_train_step as jax_make_train_step
from procedurevrl_tpu.models.procedurevrl import ProcedureVRL as JaxProcedureVRL
from procedurevrl_tpu.solver import construct_optimizer as jax_optimizer
from procedurevrl_tpu.solver import lr_schedule as jax_lr_schedule
from procedurevrl_tpu.utils import metrics as jax_metrics
from procedurevrl_tpu.utils.converter import convert_procedurevrl
from procedurevrl_tpu.utils.meters import ValMeter as JaxValMeter
from procedurevrl_torch.config import get_cfg, load_config
from procedurevrl_torch.engine import losses
from procedurevrl_torch.engine.steps import make_train_step
from procedurevrl_torch.models.build import build_model
from procedurevrl_torch.models.procedurevrl import ProcedureVRL
from procedurevrl_torch.ops.attention_route import AttentionRoute
from procedurevrl_torch.solver.lr_policy import lr_schedule
from procedurevrl_torch.solver.optimizer import construct_optimizer
from procedurevrl_torch.tools import run_net
from procedurevrl_torch.tools.train_net import train
from procedurevrl_torch.utils import metrics
from procedurevrl_torch.utils.meters import ValMeter
from procedurevrl_torch.utils.weights import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
B, T, S, K, C, SEG = 2, 2, 32, 11, 64, 4
LR = 0.05
GEOM = dict(img_size=S, patch_size=16, embed_dim=128, depth=2, num_heads=2,
            num_frames=T, drop_path_rate=0.0)
HEADS = dict(label_dim=C, num_classes=K, match_lang_emb=False,
             order_max_len=9, order_tfm_layers=2)
ENCODER = ("patch_embed.", "blocks.", "norm.", "cls_token", "pos_embed",
           "time_embed")


def _cfg(cfg, mode, loss="cross_entropy"):
    cfg.TRAIN.LINEAR = mode == "linear"
    cfg.TRAIN.MULT = 1.0 if mode == "linear" else 0.1
    cfg.MODEL.LOSS_FUNC = loss
    cfg.SOLVER.OPTIMIZING_METHOD = "sgd"
    cfg.SOLVER.MOMENTUM = 0.9
    cfg.SOLVER.BASE_LR = LR
    cfg.SOLVER.LR_POLICY = "steps_with_relative_lrs"
    cfg.SOLVER.STEPS = [0, 11, 14]
    cfg.SOLVER.LRS = [1, 0.1, 0.01]
    cfg.SOLVER.MAX_EPOCH = 15
    cfg.SOLVER.WEIGHT_DECAY = 1e-4
    cfg.BN.WEIGHT_DECAY = 1e-3
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def _batch(seg, seed=2):
    rng = np.random.RandomState(seed)
    return {"frames": rng.randint(0, 256, (B, max(seg, 1) * T, S, S, 3)
                                  ).astype(np.uint8),
            "labels": np.array([3, 9], np.int64)}


def _jax_params(model, seg):
    """Parameters of the JAX model's tree, drawn with numpy (no JAX init to
    compile): N(0, 0.05) weights and embeddings, LayerNorm scales around 1,
    biases N(0, 0.02)."""
    x = jnp.zeros((B, max(seg, 1) * T, S, S, 3))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)["params"]
    rng = np.random.RandomState(7 + seg)

    def draw(path, leaf):
        name = path[-1].key
        std = 0.02 if name == "bias" else 0.05
        base = 1.0 if name == "scale" else 0.0
        return (base + std * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("name", ["cross_entropy", "smooth", "soft_target",
                                  "bce", "bce_logit", "milnce"])
def test_loss_family_matches_jax(name):
    rng = np.random.RandomState(4)
    logits = (3 * rng.randn(6, K)).astype(np.float32)
    labels = rng.randint(0, K, 6)
    if name in ("cross_entropy", "smooth"):
        args = (logits, labels)
    elif name == "soft_target":
        soft = rng.rand(6, K).astype(np.float32)
        args = (logits, soft / soft.sum(1, keepdims=True))
    elif name == "bce":
        args = (1 / (1 + np.exp(-logits)), (rng.rand(6, K) > 0.5).astype(
            np.float32))
    elif name == "bce_logit":
        args = (logits, (rng.rand(6, K) > 0.5).astype(np.float32))
    else:
        args = (rng.randn(3, C).astype(np.float32),
                rng.randn(3, 2, C).astype(np.float32))
    want = jax_losses.get_loss_func(name)(*map(jnp.asarray, args))
    got = losses.get_loss_func(name)(*map(torch.from_numpy, args))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    if name == "milnce":  # the single-narration form
        got = losses.milnce(*map(torch.from_numpy, (args[0], args[1][:, 0])))
        want = jax_losses.milnce(jnp.asarray(args[0]), jnp.asarray(args[1][:, 0]))
        np.testing.assert_allclose(float(got), float(want), **TOL)
    if name == "cross_entropy":
        with pytest.raises(KeyError, match="kldiv"):
            losses.get_loss_func("kldiv")


def test_accuracy_metrics_match_jax():
    rng = np.random.RandomState(5)
    preds = rng.rand(40, K).astype(np.float32)
    labels = rng.randint(0, 7, 40)  # classes 7..10 absent
    labels[:12] = preds[:12].argmax(1)
    for ks in ((1, 5), (1, 20)):
        got = metrics.topk_accuracies(torch.from_numpy(preds),
                                      torch.from_numpy(labels), ks)
        want = jax_metrics.topk_accuracies(jnp.asarray(preds),
                                           jnp.asarray(labels), ks)
        np.testing.assert_allclose([float(g) for g in got],
                                   [float(w) for w in want], **TOL)
    got = metrics.mean_class_recall(torch.from_numpy(preds),
                                    torch.from_numpy(labels), K)
    want = jax_metrics.mean_class_recall(jnp.asarray(preds),
                                         jnp.asarray(labels), K)
    assert float(got) > 0
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_val_meter_matches_jax():
    cfg, jcfg = get_cfg(), jax_get_cfg()
    for c in (cfg, jcfg):
        c.LOG_PERIOD = 2
        c.SOLVER.MAX_EPOCH = 3
    meters = (ValMeter(3, cfg), JaxValMeter(3, jcfg))
    stats = []
    for epoch, errs in enumerate(([(50.0, 25.0, 4), (75.0, 0.0, 4),
                                   (100.0, 50.0, 2)],
                                  [(25.0, 0.0, 4), (0.0, 0.0, 4),
                                   (50.0, 50.0, 2)])):
        for it, (e1, e5, n) in enumerate(errs):
            for m in meters:
                m.iter_tic()
                m.update_stats(e1, e5, n)
                m.iter_toc()
                m.log_iter_stats(epoch, it)
        assert meters[0].num_top1_mis == meters[1].num_top1_mis
        assert (meters[0].mb_top1_err.get_win_median()
                == meters[1].mb_top1_err.get_win_median())
        stats.append(meters[0].log_epoch_stats(epoch))
        meters[1].log_epoch_stats(epoch)
        for m in meters:
            m.reset()
    assert stats[0]["top1_err"] == pytest.approx((200 + 300 + 200) / 10)
    assert stats[1]["min_top1_err"] == pytest.approx((100 + 100) / 10)
    for key in ("min_top1_err", "min_top5_err"):
        assert getattr(meters[0], key) == getattr(meters[1], key)
    assert meters[0].num_samples == 0


# (head, mode): the COIN heads on the frozen encoder (LINEAR) or with the
# encoder trained at lr x MULT
STEPS = [("classification", "linear"), ("forecasting", "linear"),
         ("classification", "mult"), ("forecasting", "mult")]


@pytest.mark.parametrize("head,mode", STEPS)
def test_finetune_step_matches_jax(head, mode):
    seg = SEG if head == "forecasting" else 0
    loss = "smooth" if mode == "mult" else "cross_entropy"
    batch = _batch(seg)

    # JAX: the package's own step in its two halves (grad_step into a zero
    # accumulator, then apply_step, which divides by accum_steps = 2: exact
    # for 2 * g), so that the gradients the update uses can be read
    jmodel = JaxProcedureVRL(**GEOM, **HEADS, num_seg=seg, use_pallas=False)
    params = _jax_params(jmodel, seg)
    jcfg = _cfg(jax_get_cfg(), mode, loss)
    sched = jax_lr_schedule(jcfg, 10)
    tx = jax_optimizer(params, jcfg, sched)
    jstep = jax_make_train_step(jmodel, tx, jcfg, None, sched, 2)
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    jgrads, jmetrics, _ = jax.jit(jstep.grad_step)(
        params, 0, zeros, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(5))
    state = jax.jit(jstep.apply_step)(
        TrainState.create(params, tx),
        jax.tree_util.tree_map(lambda g: 2 * g, jgrads))
    jnorm = float(optax.global_norm(jgrads))
    jgrads = flatten_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    new_params = flatten_dict(jax.tree_util.tree_map(np.asarray, state.params))

    # the port
    model = ProcedureVRL(**GEOM, **HEADS, num_seg=seg,
                         route=AttentionRoute.from_env(False))
    model.load_state_dict(params_from_jax(params), strict=True)
    cfg = _cfg(get_cfg(), mode, loss)
    step = make_train_step(model, construct_optimizer(model, cfg), cfg, None,
                           lr_schedule(cfg, 10))
    m = step({k: torch.from_numpy(v) for k, v in batch.items()})

    for k in ("loss", "top1_err", "top5_err"):
        np.testing.assert_allclose(float(m[k]), float(jmetrics[k]), **TOL,
                                   err_msg=k)
    np.testing.assert_allclose(float(m["grad_norm"]), jnorm, **GRAD_TOL)
    assert m["lr"] == pytest.approx(LR)
    trained = {n for n, p in model.named_parameters() if p.requires_grad}
    with_grad = {n for n, p in model.named_parameters() if p.grad is not None}
    assert with_grad == trained
    assert not any(n.startswith("head.") for n in trained)
    encoder = {n for n in dict(model.named_parameters()) if n.startswith(ENCODER)}
    assert encoder.isdisjoint(trained) == (mode == "linear")
    assert "head_cls.weight" in trained
    assert any(n.startswith("order_tfm.") for n in trained) == bool(seg)

    grads = flatten_dict(convert_procedurevrl({
        n: p.grad for n, p in model.named_parameters() if p.requires_grad}))
    for k, g in grads.items():
        # the forecast pads nothing: its pad embedding's gradient is zero
        assert (np.abs(jgrads[k]).max() > 0) != (k == ("order_tfm",
                                                      "pad_embedding")), k
        np.testing.assert_allclose(g, jgrads[k], **GRAD_TOL, err_msg=str(k))
    # JAX's frozen groups take exact zeros: stop_frozen_gradients
    for k, g in jgrads.items():
        if k not in grads:
            assert not np.any(g), k
    after = flatten_dict(convert_procedurevrl(
        {n: p.detach() for n, p in model.named_parameters()}))
    for k, p in after.items():
        np.testing.assert_allclose(p, new_params[k], **GRAD_TOL,
                                   err_msg=str(k))


def test_finetune_step_refuses_what_is_not_ported():
    """Mixup and EPIC-Kitchens, which the port refused until its EPIC
    slice, now run: the classification finetune under ``MIXUP.ENABLED``
    (mixup, then the soft-target cross-entropy) holds against JAX's step
    fed the same mixup draws (JAX's ``mixup`` stream, read into the port's
    ``draws``), and the EPIC config builds its verb and noun heads and its
    step (held against JAX in ``test_torch_epic.py``)."""
    from procedurevrl_tpu.engine import mixup as jax_mixup
    from procedurevrl_tpu.engine.steps import _model_rngs
    from test_torch_epic import _jax_draws

    batch = _batch(0)
    jmodel = JaxProcedureVRL(**GEOM, **HEADS, num_seg=0, use_pallas=False)
    params = _jax_params(jmodel, 0)
    jcfg = _cfg(jax_get_cfg(), "mult")
    cfg = _cfg(get_cfg(), "mult")
    for c in (cfg, jcfg):
        c.MIXUP.ENABLED = True
        c.MODEL.NUM_CLASSES = K  # the mixup's soft targets
    sched = jax_lr_schedule(jcfg, 10)
    tx = jax_optimizer(params, jcfg, sched)
    jstep = jax_make_train_step(jmodel, tx, jcfg, None, sched, 2)
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    rng = jax.random.PRNGKey(5)
    jgrads, jmetrics, _ = jax.jit(jstep.grad_step)(
        params, 0, zeros, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    key = _model_rngs(rng, jnp.asarray(0))["mixup"]
    draws = _jax_draws(jax_mixup.Mixup(
        jcfg.MIXUP.ALPHA, jcfg.MIXUP.CUTMIX_ALPHA, jcfg.MIXUP.PROB,
        jcfg.MIXUP.SWITCH_PROB, 0.1, K), key, S, S)

    model = ProcedureVRL(**GEOM, **HEADS, route=AttentionRoute.from_env(False))
    model.load_state_dict(params_from_jax(params), strict=True)
    step = make_train_step(model, construct_optimizer(model, cfg), cfg, None,
                           lr_schedule(cfg, 10))
    m = step({k: torch.from_numpy(v) for k, v in batch.items()},
             draws={"mixup": draws})
    for k in ("loss", "top1_err", "top5_err"):
        np.testing.assert_allclose(float(m[k]), float(jmetrics[k]), **TOL,
                                   err_msg=k)
    jgrads = flatten_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    grads = flatten_dict(convert_procedurevrl({
        n: p.grad for n, p in model.named_parameters() if p.requires_grad}))
    for k, g in grads.items():
        np.testing.assert_allclose(g, jgrads[k], **GRAD_TOL, err_msg=str(k))

    cfg.TRAIN.DATASET = "Epickitchens"
    cfg.MODEL.MODEL_NAME = "vit_base_patch16_224_develop"
    cfg.TIMESFORMER.DEPTH = 1
    epic, _ = build_model(cfg, "cpu")
    assert epic.head_cls is None
    assert epic.head_v.weight.shape == (97, 512)
    assert epic.head_n.weight.shape == (300, 512)
    make_train_step(epic, construct_optimizer(epic, cfg), cfg, None,
                    lr_schedule(cfg, 10))


@pytest.mark.parametrize("knob", ["LONG_CYCLE", "SHORT_CYCLE"])
def test_train_refuses_the_multigrid_knobs(knob, tmp_path):
    """``MULTIGRID.LONG_CYCLE`` / ``SHORT_CYCLE`` rewrite the schedule in
    JAX (``tools/train_net.py:256-263``); the port's ``train`` raises,
    naming the knob, before it builds anything."""
    from procedurevrl_torch.tools import train_net

    cfg = get_cfg()
    cfg.OUTPUT_DIR = str(tmp_path)
    setattr(cfg.MULTIGRID, knob, True)
    with pytest.raises(NotImplementedError, match=f"MULTIGRID.{knob}"):
        train_net.train(cfg, "cpu")
    assert not any(tmp_path.iterdir())


TINY = ["DEV.LOAD_DUMMY_DATA", "True", "TIMESFORMER.DEPTH", "1",
        "DATA.NUM_FRAMES", "2", "DATA.TRAIN_CROP_SIZE", "32",
        "DATA.TEST_CROP_SIZE", "32", "TRAIN.BATCH_SIZE", "16",
        "GLOBAL_BATCH_SIZE", "32", "TEST.BATCH_SIZE", "32",
        "TEST.NUM_ENSEMBLE_VIEWS", "1", "DEV.ORDER_TFM_LAYERS", "1",
        "LOG_PERIOD", "2"]


@pytest.mark.parametrize("name,classes,seg", [
    ("step_forecasting", 778, 8), ("task_classification", 180, 8),
    ("step_classification", 778, 0)])
def test_train_net_finetunes_on_cpu(name, classes, seg, monkeypatch,
                                    tmp_path):
    """The entry point itself on each COIN configuration, tiny geometry,
    synthetic data, plain path, bf16 and remat, accumulation 2: a run cut
    at 3 steps, which ends with a val epoch.  The frozen encoder runs
    without autograd, so remat checkpoints no block."""
    from procedurevrl_torch.models import timesformer

    cfg = load_config(os.path.join(ROOT, f"configs/COIN/{name}.yaml"),
                      TINY + ["OUTPUT_DIR", str(tmp_path)])
    assert cfg.TRAIN.LINEAR and cfg.MODEL.NUM_SEG == seg
    assert cfg.TPU.COMPUTE_DTYPE == "bfloat16" and cfg.TPU.REMAT
    assert cfg.MODEL.NUM_CLASSES == classes
    checkpointed = []
    monkeypatch.setattr(timesformer, "checkpoint",
                        lambda *a, **k: checkpointed.append(1))
    stats = train(cfg, device="cpu", max_steps=3)
    assert not checkpointed
    assert stats["steps"] == 3 and len(stats["history"]) == 3
    assert stats["clips_per_step"] == 2 * 16 * max(seg, 1)
    for h in stats["history"]:
        for k in ("loss", "grad_norm", "top1_err", "top5_err"):
            assert math.isfinite(h[k]), (k, h)
        assert h["lr"] == pytest.approx(cfg.SOLVER.BASE_LR)
    assert len(stats["val"]) == 1
    val = stats["val"][0]
    assert 0.0 <= val["top5_err"] <= val["top1_err"] <= 100.0
    model = stats["model"]
    assert model.head_cls.weight.shape == (classes, 512)
    assert (model.order_tfm is not None) == bool(seg)
    frozen = [n for n, p in model.named_parameters()
              if not n.startswith(("head_cls.", "order_tfm."))]
    assert all(not dict(model.named_parameters())[n].requires_grad
               and dict(model.named_parameters())[n].grad is None
               for n in frozen)
    assert stats["clips_per_sec"] > 0


def test_run_net_trains_then_tests_on_cpu(capsys, tmp_path):
    """``run_net`` on the task classification configuration: one epoch of
    training (EVAL_PERIOD 1: a val epoch), then the test of the trained
    model, which it loads from the epoch's checkpoint in ``OUTPUT_DIR``.
    The logs share stdout with the two JSON lines of stats."""
    import json

    rc = run_net.main(["--device", "cpu", "--cfg", os.path.join(
        ROOT, "configs/COIN/task_classification.yaml"), *TINY,
        "SOLVER.MAX_EPOCH", "1", "TRAIN.EVAL_PERIOD", "1",
        "GLOBAL_BATCH_SIZE", "64", "OUTPUT_DIR", str(tmp_path)])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert len(lines) == 2
    assert os.listdir(tmp_path / "checkpoints") == [
        "checkpoint_epoch_00001.pyth"]
    assert lines[0]["split"] == "train" and lines[0]["steps"] == 2
    assert math.isfinite(lines[0]["loss"])
    assert 0.0 <= lines[0]["val_top1_err"] <= 100.0
    assert lines[1]["split"] == "test_final"
    assert 0.0 <= float(lines[1]["top1_acc"]) <= 100.0
