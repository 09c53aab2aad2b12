"""Checkpoints of the PyTorch port against the JAX package: the load rule of
a finetune from a pretraining file, AUTO_RESUME, the port's file read by
the JAX package, the directory contract and the writers, the pretrained
encoder init, the test's checkpoint order and its result dumps, and the
NaN check of the train loop.

Geometry: the shipped configurations at depth 1, 2 frames, 32^2 crops,
float32, no CLIP text tower, the order transformer at 1 level, and the
TimeSformer at width 128 in 2 heads (``build_model`` fixes 768; the
tests narrow it) or MViT-v2 at depth 2 on 4 frames of 64^2; 4 synthetic
videos an epoch where a run trains (the HowTo100M / COIN dataset's
``synthetic://`` index cut to 4, ``howto100m.NUM_SYNTHETIC``).
Comparisons with JAX are exact (the load moves tensors, it computes nothing) except the
eval predictions of the port's file in JAX, fp32 atol = rtol = 2e-5.
"""

import logging
import os
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from procedurevrl_tpu.config import get_cfg as jax_get_cfg
from procedurevrl_tpu.engine.steps import TrainState
from procedurevrl_tpu.engine.steps import make_eval_step as jax_make_eval_step
from procedurevrl_tpu.models.procedurevrl import ProcedureVRL as JaxProcedureVRL
from procedurevrl_tpu.utils import checkpoint as jax_cu
from procedurevrl_tpu.utils.converter import convert_procedurevrl
from procedurevrl_torch.config import load_config
from procedurevrl_torch.datasets import howto100m
from procedurevrl_torch.engine.steps import make_eval_step
from procedurevrl_torch.models import procedurevrl as port_models
from procedurevrl_torch.models.build import build_model
from procedurevrl_torch.solver.optimizer import construct_optimizer
from procedurevrl_torch.tools.test_net import test as port_test
from procedurevrl_torch.tools.train_net import train
from procedurevrl_torch.utils import checkpoint as cu
from procedurevrl_torch.utils import misc, weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-5, rtol=2e-5)
WIDTH, HEADS = 128, 2
SMALL = ["DEV.LOAD_DUMMY_DATA", "True", "DATA.NUM_FRAMES", "2",
         "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
         "TIMESFORMER.DEPTH", "1", "MODEL.TEXT_MODEL", "",
         "DEV.ORDER_TFM_LAYERS", "1", "TPU.COMPUTE_DTYPE", "float32",
         "LOG_PERIOD", "2"]
PRETRAIN = "configs/HowTo100M/procedurevrl_adamw.yaml"
MVIT_PRETRAIN = "configs/HowTo100M/procedurevrl_mvitv2_adamw.yaml"
STEP_CLS = "configs/COIN/step_classification.yaml"
MVIT_SMALL = ["MVIT.DEPTH", "2", "MVIT.DIM_MUL", "[[1, 2.0]]",
              "MVIT.HEAD_MUL", "[[1, 2.0]]",
              "MVIT.POOL_Q_STRIDE", "[[0, 1, 1, 1], [1, 1, 2, 2]]",
              "MVIT.POOL_KV_STRIDE_ADAPTIVE", "[1, 4, 4]",
              "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "64"]


class _Narrow(port_models.ProcedureVRL):
    def __init__(self, **kwargs):
        super().__init__(**{**kwargs, "embed_dim": WIDTH,
                            "num_heads": HEADS})


@pytest.fixture
def narrow(monkeypatch):
    """``build_model``'s TimeSformer at width 128 in 2 heads, epochs of 4
    videos."""
    monkeypatch.setattr(port_models, "ProcedureVRL", _Narrow)
    monkeypatch.setattr(howto100m, "NUM_SYNTHETIC", 4)


def _cfg(path, out, *opts):
    return load_config(os.path.join(ROOT, path),
                       SMALL + ["OUTPUT_DIR", str(out), *opts])


def _pretrain_cfg(out, *opts):
    return _cfg(PRETRAIN, out, "TRAIN.BATCH_SIZE", "1", "GLOBAL_BATCH_SIZE",
                "2", "MODEL.NUM_CLASSES", "50", *opts)


def _coin_cfg(out, *opts):
    """The COIN step-classification finetune (``head_cls``, the linear
    probe): epochs of 2 steps of 2 micro-batches of 1 video."""
    return _cfg(STEP_CLS, out, "TRAIN.BATCH_SIZE", "1", "GLOBAL_BATCH_SIZE",
                "2", "TEST.BATCH_SIZE", "32", "TEST.NUM_ENSEMBLE_VIEWS", "1",
                *opts)


def _tree(model):
    """``model``'s parameters as the JAX tree, copied."""
    return jax.tree_util.tree_map(np.copy,
                                  convert_procedurevrl(model.state_dict()))


def _flat(model):
    return flatten_dict(_tree(model))


def _assert_trees_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=str(k))


def _save_reference(model, path, epoch=3):
    """A reference-style file of ``model``: ``model.``-prefixed state, no
    port marker."""
    torch.save({"model_state": {"model." + k: v for k, v in
                                model.state_dict().items()},
                "epoch": epoch}, path)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def logged():
    """The messages the port's logger emits during the test."""
    handler, logger = _Records(), logging.getLogger("procedurevrl_torch")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    yield handler.messages
    logger.removeHandler(handler)
    logger.setLevel(level)


def test_a_finetune_loads_a_pretraining_checkpoint(narrow, tmp_path):
    """The COIN step-classification finetune from the file of an order
    pretraining run, through ``train_net``: ``head_cls``, which the file
    lacks, keeps its seeded init, every other tensor is the file's, as
    JAX ``load_reference_params`` loads the same file into the same
    template."""
    pre = train(_pretrain_cfg(tmp_path / "pre", "SOLVER.MAX_EPOCH", "1"),
                device="cpu")
    path = pre["checkpoints"][-1]
    assert path.endswith("checkpoint_epoch_00001.pyth")
    cfg = _coin_cfg(tmp_path / "ft", "TRAIN.CHECKPOINT_FILE_PATH", path,
                    "TRAIN.CHECKPOINT_EPOCH_RESET", "True")
    init = build_model(cfg, "cpu")[0]
    stats = train(cfg, device="cpu", max_steps=0)
    model = stats["model"]
    assert stats["start_epoch"] == 0 and stats["start_step"] == 0
    file = torch.load(path, weights_only=False)["model_state"]
    for k, v in model.state_dict().items():
        want = init.state_dict()[k] if k.startswith("head_cls.") else file[k]
        assert torch.equal(v, want), k
    ref, epoch = jax_cu.load_reference_params(path, _tree(init))
    assert epoch == 0
    _assert_trees_equal(_flat(model), flatten_dict(ref))


def _history_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x == y


@pytest.mark.parametrize("encoder", ["timesformer", "mvit"])
def test_auto_resume_is_bit_for_bit(encoder, narrow, tmp_path):
    """Two epochs straight against one epoch, then a second ``train`` that
    resumes from ``OUTPUT_DIR`` (AUTO_RESUME, the shipped configs'
    default) at epoch 2 and step 2: the parameters, the optimizer state and
    every metric of epoch 2 (the LR among them) equal bit for bit, for the
    TimeSformer order pretraining and the MViT-v2 one."""
    opts = ("SOLVER.MAX_EPOCH", "2", "TRAIN.CHECKPOINT_PERIOD", "1")
    if encoder == "mvit":
        def cfg(out):
            return _cfg(MVIT_PRETRAIN, out, *MVIT_SMALL, "TRAIN.BATCH_SIZE",
                        "1", "GLOBAL_BATCH_SIZE", "2", "MODEL.NUM_CLASSES",
                        "50", *opts)
    else:
        def cfg(out):
            return _pretrain_cfg(out, *opts)
    straight = train(cfg(tmp_path / "a"), device="cpu")
    assert straight["steps"] == 4 and len(straight["checkpoints"]) == 2
    first = train(cfg(tmp_path / "b"), device="cpu", max_steps=2)
    assert [os.path.basename(p) for p in first["checkpoints"]] == [
        "checkpoint_epoch_00001.pyth"]
    resumed = train(cfg(tmp_path / "b"), device="cpu")
    assert resumed["start_epoch"] == 1 and resumed["start_step"] == 2
    assert resumed["steps"] == 2
    _history_equal(first["history"], straight["history"][:2])
    _history_equal(resumed["history"], straight["history"][2:])
    for k, v in straight["model"].state_dict().items():
        assert torch.equal(resumed["model"].state_dict()[k], v), k
    a, b = (torch.load(run["checkpoints"][-1], weights_only=False)
            for run in (straight, resumed))
    assert a["epoch"] == b["epoch"] == 1 and a["step"] == b["step"] == 4
    assert a["optimizer_state"]["param_groups"] == b["optimizer_state"][
        "param_groups"]
    sa, sb = a["optimizer_state"]["state"], b["optimizer_state"]["state"]
    assert set(sa) == set(sb) and sa
    for i in sa:
        for k, v in sa[i].items():
            assert torch.equal(sb[i][k], v), (i, k)


def test_the_jax_package_reads_the_ports_checkpoint(narrow, tmp_path):
    """A finetune's last checkpoint, read by JAX ``load_test_checkpoint``
    from the same ``OUTPUT_DIR`` (the reference path: it is a ``.pyth``),
    predicts what the port predicts from it."""
    cfg = _coin_cfg(tmp_path, "SOLVER.MAX_EPOCH", "1")
    train(cfg, device="cpu")
    model = build_model(cfg, "cpu")[0]
    assert cu.load_test_checkpoint(cfg, model) == cu.get_last_checkpoint(
        str(tmp_path))
    frames = np.random.RandomState(3).randint(
        0, 256, (2, 2, 32, 32, 3)).astype(np.uint8)
    preds = make_eval_step(model, cfg, None)(
        {"frames": torch.from_numpy(frames)}).numpy()

    jmodel = JaxProcedureVRL(img_size=32, patch_size=16, embed_dim=WIDTH,
                             depth=1, num_heads=HEADS, num_frames=2,
                             drop_path_rate=0.0, num_classes=778,
                             label_dim=512, use_pallas=False)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros(frames.shape))["params"]
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    jcfg = jax_get_cfg()
    jcfg.OUTPUT_DIR = str(tmp_path)
    state = jax_cu.load_test_checkpoint(
        jcfg, TrainState.create(template, optax.sgd(0.1)))
    ref = jax_make_eval_step(jmodel, jcfg, None)(
        state.eval_variables, {"frames": jnp.asarray(frames)})
    assert preds.shape == (2, 778)
    np.testing.assert_allclose(preds, np.asarray(ref), **TOL)


def _model(tmp_path, seed=0, *opts):
    cfg = _coin_cfg(tmp_path, "RNG_SEED", str(seed), *opts)
    model = build_model(cfg, "cpu")[0]
    return cfg, model, construct_optimizer(model, cfg)


def _case_time_embed(tmp_path, logged):
    """A 4-frame ``time_embed`` into a 2-frame model: JAX's nearest
    resize."""
    cfg, model, _ = _model(tmp_path)
    src = build_model(_coin_cfg(tmp_path, "DATA.NUM_FRAMES", "4",
                                "RNG_SEED", "1"), "cpu")[0]
    _save_reference(src, tmp_path / "f.pyth")
    weights.load_reference_params(model, str(tmp_path / "f.pyth"))
    flat_c = {"encoder/time_embed": src.time_embed.detach().numpy()}
    jax_cu._resize_time_embed(flat_c, {
        "encoder/time_embed": np.zeros((1, 2, WIDTH), np.float32)})
    np.testing.assert_array_equal(model.time_embed.detach().numpy(),
                                  flat_c["encoder/time_embed"])
    assert torch.equal(model.time_embed, src.time_embed[:, [0, 2]])
    assert any("time axis 4 -> 2" in m for m in logged)


def _case_clear_pattern(tmp_path, logged):
    """``TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN`` drops the keys it names:
    ``head.*`` keeps its init, as under JAX."""
    cfg, model, opt = _model(tmp_path, 0, "TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN",
                             "['head.']")
    template = _tree(model)
    src = build_model(_coin_cfg(tmp_path, "RNG_SEED", "1"), "cpu")[0]
    path = str(tmp_path / "f.pyth")
    _save_reference(src, path)
    cfg.TRAIN.CHECKPOINT_FILE_PATH = path
    before = model.head.weight.detach().clone()
    assert cu.load_train_checkpoint(cfg, model, opt) == (4, 0)
    assert torch.equal(model.head.weight, before)
    assert torch.equal(model.head_cls.weight, src.head_cls.weight)
    ref, _ = jax_cu.load_reference_params(path, template,
                                          clear_patterns=("head.",))
    _assert_trees_equal(_flat(model), flatten_dict(ref))
    assert any("Cleared 2 keys matching 'head.'" in m for m in logged)


def _case_epoch_reset(tmp_path, logged):
    """``TRAIN.CHECKPOINT_EPOCH_RESET``: a reference file of epoch 3 starts
    the run at epoch 4, or 0; the port's own file of this model restores
    its step either way."""
    cfg, model, opt = _model(tmp_path)
    ref = str(tmp_path / "ref.pyth")
    _save_reference(model, ref, epoch=3)
    own = cu.save_checkpoint(str(tmp_path / "job"), model, opt, cfg, 5, 12)
    for path, start in ((ref, (4, 0)), (own, (6, 12))):
        cfg.TRAIN.CHECKPOINT_FILE_PATH = path
        cfg.TRAIN.CHECKPOINT_EPOCH_RESET = False
        assert cu.load_train_checkpoint(cfg, model, opt) == start
        cfg.TRAIN.CHECKPOINT_EPOCH_RESET = True
        assert cu.load_train_checkpoint(cfg, model, opt) == (0, start[1])


def _case_shape_mismatch(tmp_path, logged):
    """A tensor of another shape (a head of 10 classes) keeps its init;
    torch would raise on it."""
    cfg, model, _ = _model(tmp_path)
    src = build_model(_coin_cfg(tmp_path, "MODEL.NUM_CLASSES", "10",
                                "RNG_SEED", "1"), "cpu")[0]
    _save_reference(src, tmp_path / "f.pyth")
    before = model.head_cls.weight.detach().clone()
    weights.load_reference_params(model, str(tmp_path / "f.pyth"))
    assert torch.equal(model.head_cls.weight, before)
    assert torch.equal(model.head.weight, src.head.weight)
    assert any("shape mismatch" in m and "head_cls.weight" in m
               for m in logged)


def _case_tmp_skipped(tmp_path, logged):
    """A ``.pyth.tmp`` left by a crash mid-save is not a checkpoint."""
    d = cu.make_checkpoint_dir(str(tmp_path))
    for name in ("checkpoint_epoch_00001.pyth",
                 "checkpoint_epoch_00002.pyth.tmp"):
        open(os.path.join(d, name), "wb").close()
    assert cu.get_last_checkpoint(str(tmp_path)) == os.path.join(
        d, "checkpoint_epoch_00001.pyth")
    assert cu.get_last_checkpoint(str(tmp_path / "none")) is None


def _case_async_equals_sync(tmp_path, logged):
    """The writer thread writes the bytes the blocking save writes."""
    cfg, model, opt = _model(tmp_path)
    a = cu.save_checkpoint(str(tmp_path / "sync"), model, opt, cfg, 0, 2)
    writer = cu.AsyncCheckpointer()
    b = writer.save(str(tmp_path / "async"), model, opt, cfg, 0, 2)
    writer.wait()
    assert os.path.basename(a) == os.path.basename(b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def _case_async_snapshot(tmp_path, logged, monkeypatch):
    """The thread writer writes the state as it was at ``save``, though the
    optimizer updates the tensors in place before the write."""
    cfg, model, opt = _model(tmp_path)
    for p in model.parameters():
        if p.requires_grad:
            p.grad = torch.ones_like(p)
    opt.step()
    before = cu._map_tensors({"m": model.state_dict(),
                              "o": opt.state_dict()}, torch.clone)
    gate, write = threading.Event(), cu._write
    monkeypatch.setattr(cu, "_write", lambda path, payload: (
        gate.wait(), write(path, payload))[1])
    writer = cu.AsyncCheckpointer()
    path = writer.save(str(tmp_path), model, opt, cfg, 0, 1)
    opt.step()  # moves the parameters and the momentum in place
    assert not torch.equal(model.head_cls.weight, before["m"][
        "head_cls.weight"])
    gate.set()
    writer.wait()
    blob = torch.load(path, weights_only=False)
    for k, v in before["m"].items():
        assert torch.equal(blob["model_state"][k], v), k
    for i, st in before["o"]["state"].items():
        for k, v in st.items():
            assert torch.equal(blob["optimizer_state"]["state"][i][k], v)


def _case_writer_error(tmp_path, logged, monkeypatch):
    """An error of the writer thread is raised by the next ``wait()``."""
    cfg, model, opt = _model(tmp_path)

    def fail(path, payload):
        raise OSError(f"no space left for {path}")

    monkeypatch.setattr(cu, "_write", fail)
    writer = cu.AsyncCheckpointer()
    writer.save(str(tmp_path), model, opt, cfg, 0, 2)
    with pytest.raises(OSError, match="no space left"):
        writer.wait()
    writer.wait()


def _case_stale_output_dir(tmp_path, logged):
    """AUTO_RESUME from an ``OUTPUT_DIR`` that holds another model's
    checkpoint raises, naming the file."""
    pre = build_model(_pretrain_cfg(tmp_path), "cpu")[0]
    path = cu.save_checkpoint(str(tmp_path), pre,
                              construct_optimizer(pre, _pretrain_cfg(
                                  tmp_path)), _pretrain_cfg(tmp_path), 0, 2)
    cfg, model, opt = _model(tmp_path)
    assert cfg.TRAIN.AUTO_RESUME
    with pytest.raises(ValueError, match="stale OUTPUT_DIR") as err:
        cu.load_train_checkpoint(cfg, model, opt)
    assert path in str(err.value)


def _case_jax_native(tmp_path, logged):
    """A checkpoint of the JAX package is refused by name."""
    jcfg = jax_get_cfg()
    state = TrainState.create({"w": np.zeros(3, np.float32)},
                              optax.sgd(0.1))
    path = jax_cu.save_checkpoint(str(tmp_path / "jax"), state, jcfg, 0)
    with pytest.raises(ValueError, match="checkpoint of the JAX package"):
        weights.read_file(path)
    cfg, model, opt = _model(tmp_path, 0, "TRAIN.CHECKPOINT_FILE_PATH", path)
    with pytest.raises(ValueError, match=path):
        cu.load_train_checkpoint(cfg, model, opt)


LOAD_CASES = {"time_embed": _case_time_embed,
              "clear_pattern": _case_clear_pattern,
              "epoch_reset": _case_epoch_reset,
              "shape_mismatch": _case_shape_mismatch,
              "tmp_skipped": _case_tmp_skipped,
              "async_equals_sync": _case_async_equals_sync,
              "async_snapshot": _case_async_snapshot,
              "writer_error": _case_writer_error,
              "stale_output_dir": _case_stale_output_dir,
              "jax_native": _case_jax_native}


@pytest.mark.parametrize("case", sorted(LOAD_CASES))
def test_load_case(case, narrow, tmp_path, logged, monkeypatch):
    fn = LOAD_CASES[case]
    if case in ("async_snapshot", "writer_error"):
        fn(tmp_path, logged, monkeypatch)
    else:
        fn(tmp_path, logged)


def _timm_vit(rng):
    """A timm ImageNet ViT's state dict at the narrow width: 1 block,
    a 2 x 2 patch grid, a 1000-class head."""
    shapes = {"cls_token": (1, 1, WIDTH), "pos_embed": (1, 5, WIDTH),
              "patch_embed.proj.weight": (WIDTH, 3, 16, 16),
              "patch_embed.proj.bias": (WIDTH,),
              "blocks.0.norm1.weight": (WIDTH,), "blocks.0.norm1.bias": (WIDTH,),
              "blocks.0.attn.qkv.weight": (3 * WIDTH, WIDTH),
              "blocks.0.attn.qkv.bias": (3 * WIDTH,),
              "blocks.0.attn.proj.weight": (WIDTH, WIDTH),
              "blocks.0.attn.proj.bias": (WIDTH,),
              "blocks.0.norm2.weight": (WIDTH,), "blocks.0.norm2.bias": (WIDTH,),
              "blocks.0.mlp.fc1.weight": (4 * WIDTH, WIDTH),
              "blocks.0.mlp.fc1.bias": (4 * WIDTH,),
              "blocks.0.mlp.fc2.weight": (WIDTH, 4 * WIDTH),
              "blocks.0.mlp.fc2.bias": (WIDTH,),
              "norm.weight": (WIDTH,), "norm.bias": (WIDTH,),
              "head.weight": (1000, WIDTH), "head.bias": (1000,)}
    return {k: torch.from_numpy(rng.randn(*s).astype(np.float32))
            for k, s in shapes.items()}


def _mvit_in1k(model, rng):
    """An image MViT-v2's state dict for ``model``'s encoder: the stem and
    the pool kernels without their time axis, no ``rel_pos_t``, block 1's
    ``rel_pos_h`` two rows longer than the model's, a 1000-class head."""
    out = {}
    for k, v in model.state_dict().items():
        if not k.startswith("video_encoder.") or "rel_pos_t" in k:
            continue
        name, shape = k[len("video_encoder."):], list(v.shape)
        if "pool_" in name or name == "patch_embed.proj.weight":
            del shape[2]
        if name == "blocks.1.attn.rel_pos_h":
            shape[0] += 2
        out[name] = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    out["head.weight"] = torch.from_numpy(rng.randn(1000, 768).astype(
        np.float32))
    return out


@pytest.mark.parametrize("source", ["imagenet_vit", "mvit_in1k"])
def test_pretrained_encoder_init_matches_jax(source, narrow, tmp_path,
                                             logged):
    """``MODEL.PRETRAINED`` with ``TIMESFORMER.PRETRAINED_MODEL``: a timm
    ImageNet ViT inflated into the TimeSformer (temporal attention and
    norm from the spatial ones, ``temporal_fc`` zero, ``time_embed`` and
    the head at init) and an image MViT-v2 inflated over time, against
    JAX ``load_pretrained_encoder`` on the same file and template."""
    rng = np.random.RandomState(11)
    path = str(tmp_path / "pretrained.pth")
    opts = ("MODEL.PRETRAINED", "True", "TIMESFORMER.PRETRAINED_MODEL", path)
    if source == "mvit_in1k":
        cfg = _cfg(MVIT_PRETRAIN, tmp_path, *MVIT_SMALL, "MODEL.NUM_CLASSES",
                   "50", *opts)
    else:
        cfg = _coin_cfg(tmp_path, *opts)
    model = build_model(cfg, "cpu")[0]
    init = {k: v.clone() for k, v in model.state_dict().items()}
    state = (_mvit_in1k(model, rng) if source == "mvit_in1k"
             else _timm_vit(rng))
    torch.save(state, path)
    assert weights.load_pretrained_encoder(model, cfg)

    jcfg = jax_get_cfg()
    jcfg.MODEL.MODEL_NAME = cfg.MODEL.MODEL_NAME
    jcfg.MODEL.PRETRAINED = True
    jcfg.TIMESFORMER.PRETRAINED_MODEL = path
    jcfg.MVIT.PATCH_KERNEL = list(cfg.MVIT.PATCH_KERNEL)
    jcfg.DATA.NUM_FRAMES = cfg.DATA.NUM_FRAMES
    ref = jax_cu.load_pretrained_encoder(jcfg, convert_procedurevrl(
        {k: v.clone() for k, v in init.items()}))
    _assert_trees_equal(_flat(model), flatten_dict(ref))
    now = model.state_dict()
    if source == "imagenet_vit":
        for part in ("qkv.weight", "proj.bias"):
            assert torch.equal(now[f"blocks.0.temporal_attn.{part}"],
                               state[f"blocks.0.attn.{part}"])
        assert torch.equal(now["blocks.0.temporal_norm1.weight"],
                           state["blocks.0.norm1.weight"])
        assert not now["blocks.0.temporal_fc.weight"].any()
        for k in ("time_embed", "head.weight", "head_cls.weight"):
            assert torch.equal(now[k], init[k]), k
    else:
        key = "video_encoder.patch_embed.proj.weight"
        assert torch.equal(now[key][:, :, 1], state[key[14:]])
        for k in ("video_encoder.blocks.1.attn.rel_pos_h",
                  "video_encoder.blocks.0.attn.rel_pos_t", "head.weight"):
            assert torch.equal(now[k], init[k]), k
    assert any("kept at init" in m for m in logged)


def test_pretrained_encoder_missing_file_keeps_the_init(narrow, tmp_path,
                                                        logged):
    cfg = _coin_cfg(tmp_path, "TIMESFORMER.PRETRAINED_MODEL",
                    str(tmp_path / "absent.pth"))
    model = build_model(cfg, "cpu")[0]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert not weights.load_pretrained_encoder(model, cfg)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert any("not found" in m for m in logged)


def test_test_net_loads_in_order_and_dumps_results(narrow, tmp_path):
    """``load_test_checkpoint`` takes ``TEST.CHECKPOINT_FILE_PATH``, then
    ``OUTPUT_DIR``'s last checkpoint, then ``TRAIN.CHECKPOINT_FILE_PATH``,
    else the random init; ``test`` writes ``TEST.SAVE_RESULTS_PATH`` (a
    pickle) and ``TEST.SAVE_PREDICT_PATH`` (``torch.save``) into
    ``OUTPUT_DIR``."""
    files = {}
    for seed, name in ((1, "test"), (2, "out"), (3, "train")):
        cfg, model, opt = _model(tmp_path, seed)
        files[name] = (cu.save_checkpoint(str(tmp_path / name), model, opt,
                                          cfg, 0, 2),
                       model.head_cls.weight.detach().clone())
    cfg, model, _ = _model(tmp_path / "out", 0,
                           "TEST.CHECKPOINT_FILE_PATH", files["test"][0],
                           "TRAIN.CHECKPOINT_FILE_PATH", files["train"][0])
    init = model.head_cls.weight.detach().clone()
    for name in ("test", "out", "train", None):
        got = cu.load_test_checkpoint(cfg, model)
        if name is None:
            assert got is None
            assert torch.equal(model.head_cls.weight, files["train"][1])
            break
        assert got == files[name][0]
        assert torch.equal(model.head_cls.weight, files[name][1])
        if name == "test":
            cfg.TEST.CHECKPOINT_FILE_PATH = ""
        elif name == "out":
            os.remove(files["out"][0])
        else:
            cfg.TRAIN.CHECKPOINT_FILE_PATH = ""
    assert not torch.equal(init, files["train"][1])

    cfg = _coin_cfg(tmp_path / "dump", "TEST.SAVE_RESULTS_PATH", "res.pkl",
                    "TEST.SAVE_PREDICT_PATH", "preds.pth",
                    "TEST.CHECKPOINT_FILE_PATH", files["test"][0])
    port_test(cfg, device="cpu")
    with open(tmp_path / "dump" / "res.pkl", "rb") as f:
        res = pickle.load(f)
    dump = torch.load(tmp_path / "dump" / "preds.pth")
    assert res["preds"].shape == (4, 778)
    np.testing.assert_array_equal(res["labels"], np.arange(4))
    np.testing.assert_allclose(res["preds"].sum(1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(dump["preds"].numpy(), res["preds"])
    np.testing.assert_array_equal(dump["labels"].numpy(), res["labels"])


def test_check_nan_losses():
    """A NaN loss aborts, an infinite one trains on, as in JAX."""
    with pytest.raises(misc.NaNLossError):
        misc.check_nan_losses(float("nan"))
    misc.check_nan_losses(float("inf"))
    misc.check_nan_losses(1.0)
