"""Zero-shot step forecasting and the MViT-v2 zero-shot eval of the PyTorch
port against the JAX package: ``OrderTransformer.forecast``, the
forecasting eval step, the finetuning heads' forwards (classification and
forecasting), the weight round trip with ``head_cls`` and a forecasting
``order_tfm``, the MViT-v2 eval step, the synthetic splits, and the
port's ``test_net`` on both paths on the CPU.

Geometry: TimeSformer depth 2, width 128, 2 heads of 64, 32^2 crops, 2
frames a clip, ``NUM_SEG`` 4; ``label_dim`` 64, 2 order levels, a 40-step
random bank; MViT-v2 of ``tests/test_torch_mvit_train.py`` (crop 64, 4
frames, depth 2).  Parameters are drawn with numpy on the JAX tree and
carried over with ``params_from_jax``.  The JAX models run their attention
kernels in interpret mode (``PALLAS_MIN_LEN=1``), except in the finetuning
heads' forwards, where both sides take the plain attention path.
Tolerance: fp32 atol = rtol = 2e-5.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from procedurevrl_tpu.config import get_cfg as jax_get_cfg
from procedurevrl_tpu.engine.steps import make_eval_step as jax_make_eval_step
from procedurevrl_tpu.models import mvit as jm
from procedurevrl_tpu.models.order_transformer import (
    OrderTransformer as JaxOrderTransformer,
)
from procedurevrl_tpu.models.procedurevrl import ProcedureVRL as JaxProcedureVRL
from procedurevrl_tpu.utils.converter import convert_procedurevrl
from procedurevrl_torch.config import get_cfg, load_config
from procedurevrl_torch.datasets.synthetic import SyntheticClips
from procedurevrl_torch.engine.steps import make_eval_step
from procedurevrl_torch.models import mvit as pm
from procedurevrl_torch.models.build import build_model
from procedurevrl_torch.models.order_transformer import OrderTransformer
from procedurevrl_torch.models.procedurevrl import (
    ProcedureVRL, ProcedureVRLMViT,
)
from procedurevrl_torch.ops.attention_route import AttentionRoute
from procedurevrl_torch.tools.test_net import test as port_test
from procedurevrl_torch.utils import weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANK = os.path.join(ROOT, "data", "clip_step_emb_coin.pth")
TOL = dict(atol=2e-5, rtol=2e-5)
B, T, S, K, C, SEG = 2, 2, 32, 40, 64, 4
GEOM = dict(img_size=S, patch_size=16, embed_dim=128, depth=2, num_heads=2,
            num_frames=T, drop_path_rate=0.0)
HEADS = dict(label_dim=C, num_classes=K, order_max_len=9, order_tfm_layers=2)
MVIT_GEOM = dict(spatial_size=64, temporal_size=4, embed_dim=8, num_heads=1,
                 depth=2, dim_mul=((1, 2.0),), head_mul=((1, 2.0),),
                 pool_q_stride=((1, 1, 2, 2),),
                 pool_kv_stride_adaptive=(1, 4, 4), pool_kvq_kernel=(3, 3, 3))


def _draw(shapes, seed):
    """numpy parameters for a JAX tree of shapes: N(0, 0.05) weights and
    embeddings, LayerNorm scales around 1, biases N(0, 0.02)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        std = 0.02 if name == "bias" else 0.05
        base = 1.0 if name == "scale" else 0.0
        return (base + std * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _bank(k=K):
    rng = np.random.RandomState(1)
    bank = rng.randn(k, C).astype(np.float32)
    return bank / np.linalg.norm(bank, axis=1, keepdims=True)


def _frames(seg, seed=0, t=T, s=S):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (B, max(seg, 1) * t, s, s, 3)).astype(np.uint8)


def _both(seg, match_lang_emb, use_pallas=True):
    """The JAX model with numpy-drawn parameters and the port's model
    carrying them, both on the kernel route or both on the plain one."""
    jmodel = JaxProcedureVRL(**GEOM, **HEADS, num_seg=seg,
                             match_lang_emb=match_lang_emb,
                             use_pallas=use_pallas)
    bank = jnp.asarray(_bank()) if match_lang_emb else None
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros(_frames(seg).shape), label_emb=bank)
    params = _draw(shapes["params"], 3 + seg)
    model = ProcedureVRL(**GEOM, **HEADS, num_seg=seg,
                         match_lang_emb=match_lang_emb,
                         route=AttentionRoute.from_env(use_pallas))
    model.load_state_dict(weights.params_from_jax(params), strict=True)
    return jmodel, params, model


@pytest.mark.parametrize("num_seg", [4, 8])
def test_forecast_matches_jax(num_seg):
    """The forecast alone, at a short context (the zero token at position
    4 of 9) and the shipped one (position 8, the last)."""
    jmod = JaxOrderTransformer(num_seg=num_seg, tfm_layers=3, hidden_size=C,
                               max_len=9)
    x = np.random.RandomState(num_seg).randn(3 * num_seg, C).astype(np.float32)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = _draw(shapes["params"], num_seg)
    ref = jax.jit(lambda p, xx: jmod.apply({"params": p}, xx,
                                           method=JaxOrderTransformer.forecast)
                  )(params, jnp.asarray(x))

    model = OrderTransformer(num_seg=num_seg, tfm_layers=3, hidden_size=C,
                             max_len=9)
    state = {}
    weights._order_tfm(params, state)
    model.load_state_dict({k[len("order_tfm."):]: v for k, v in state.items()},
                          strict=True)
    out = model.forecast(torch.from_numpy(x))
    assert out.shape == (3, C)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    with pytest.raises(ValueError, match="positions"):
        OrderTransformer(num_seg=num_seg, hidden_size=C,
                         max_len=num_seg).forecast(torch.from_numpy(x))


def test_zero_shot_forecasting_eval_step_matches_jax(monkeypatch):
    monkeypatch.setenv("PALLAS_MIN_LEN", "1")
    jmodel, params, model = _both(SEG, True)
    frames, bank = _frames(SEG), _bank()
    ref = np.asarray(jax.jit(jax_make_eval_step(jmodel, jax_get_cfg(), bank))(
        {"params": params}, {"frames": jnp.asarray(frames)}))
    assert model.head_cls is None and model.order_tfm.num_seg == SEG
    preds = make_eval_step(model.eval(), get_cfg(), torch.from_numpy(bank))(
        {"frames": torch.from_numpy(frames)})
    assert preds.dtype == torch.float32 and preds.shape == (B, K)
    np.testing.assert_allclose(preds.numpy(), ref, **TOL)
    np.testing.assert_allclose(preds.sum(1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("seg", [0, SEG], ids=["classification",
                                               "forecasting"])
def test_finetune_forwards_match_jax(seg):
    """The finetuning heads' train-mode logits (forecasting: no
    temperature), both sides on the plain attention path (the kernels'
    forwards are held above); eval mode gives their softmax."""
    jmodel, params, model = _both(seg, False, use_pallas=False)
    frames = _frames(seg, seed=4)
    x = (frames.astype(np.float32) / 255.0 - 0.45) / 0.225
    ref = jax.jit(lambda p, xx: jmodel.apply(
        {"params": p}, xx, train=True,
        rngs={"droppath": jax.random.PRNGKey(1)}))(params, jnp.asarray(x))
    xt = torch.from_numpy(x)
    logits = model.train()(xt, train=True)
    assert logits.shape == (B, K) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref),
                               **TOL)
    with torch.no_grad():
        probs = model.eval()(xt)
    torch.testing.assert_close(probs, torch.softmax(logits.detach(), dim=-1))


@pytest.mark.parametrize("seg", [0, SEG], ids=["classification",
                                               "forecasting"])
def test_weights_round_trip_with_finetune_heads(seg):
    """JAX tree with ``head_cls`` (and a forecasting ``order_tfm``) ->
    ``params_from_jax`` -> the port's ``state_dict()`` ->
    ``convert_procedurevrl``: the same tree, bit for bit."""
    _, params, model = _both(seg, False)
    assert ("order_tfm" in params) == bool(seg) and "head_cls" in params
    back = convert_procedurevrl(model.state_dict())
    flat, flat_back = flatten_dict(params), flatten_dict(back)
    assert set(flat) == set(flat_back)
    for key, val in flat.items():
        assert flat_back[key].dtype == np.float32
        assert np.array_equal(flat_back[key], val), key


def test_mvit_zero_shot_eval_step_matches_jax(monkeypatch):
    monkeypatch.setenv("PALLAS_MIN_LEN", "1")
    jmodel = JaxProcedureVRL(encoder_name="mvit", num_frames=4,
                             mvit_cfg=jm.MViTConfig(**MVIT_GEOM), label_dim=C,
                             num_classes=K, match_lang_emb=True,
                             use_pallas=True)
    frames, bank = _frames(0, seed=6, t=4, s=64), _bank()
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros(frames.shape), label_emb=bank)
    params = _draw(shapes["params"], 11)
    ref = np.asarray(jax.jit(jax_make_eval_step(jmodel, jax_get_cfg(), bank))(
        {"params": params}, {"frames": jnp.asarray(frames)}))
    model = ProcedureVRLMViT(pm.MViTConfig(**MVIT_GEOM), label_dim=C)
    model.load_state_dict(weights.params_from_jax(params), strict=True)
    preds = make_eval_step(model.eval(), get_cfg(), torch.from_numpy(bank))(
        {"frames": torch.from_numpy(frames)})
    assert preds.shape == (B, K)
    np.testing.assert_allclose(preds.numpy(), ref, **TOL)


def test_synthetic_splits():
    """The test split's samples are NUM_SEG clips end to end; train and
    val hold one sample a video (train EPOCH_MUL times over), labelled
    ``video % NUM_CLASSES``, and draw other clips than the test split."""
    full = load_config(os.path.join(ROOT, "configs/COIN/step_forecasting.yaml"),
                       ["DEV.LOAD_DUMMY_DATA", "True"])
    test = SyntheticClips(full, "test")
    assert (test.frames, test.size, test.clips) == (64, 224, 8)
    assert len(test) == 64 * 4 and test.num_batches(16) == 16
    cfg = load_config(os.path.join(ROOT, "configs/COIN/step_forecasting.yaml"),
                      ["DEV.LOAD_DUMMY_DATA", "True", "DATA.NUM_FRAMES", "2",
                       "DATA.TRAIN_CROP_SIZE", "16",
                       "DATA.TEST_CROP_SIZE", "8"])
    train, val = SyntheticClips(cfg, "train"), SyntheticClips(cfg, "val")
    assert len(train) == 64 * 2 and len(val) == 64
    assert train.num_batches(5) == 25 and val.num_batches(5) == 13
    gen = torch.Generator()
    batch = train.batch(5, 13, gen)
    assert batch["frames"].shape == (5, 16, 16, 16, 3)
    assert batch["frames"].dtype == torch.uint8
    assert batch["labels"].tolist() == [1, 2, 3, 4, 5]  # samples 65..69
    assert torch.equal(train.batch(5, 25 + 13, gen)["frames"], batch["frames"])
    last = val.batch(5, 12, gen)
    assert last["frames"].shape == (4, 16, 8, 8, 3)
    assert last["labels"].tolist() == [60, 61, 62, 63]
    first = SyntheticClips(cfg, "test").batch(1, 0, gen)["frames"]
    assert not torch.equal(val.batch(1, 0, gen)["frames"], first)
    with pytest.raises(ValueError, match="split"):
        SyntheticClips(cfg, "dev")


def _forecast_cfg(*extra):
    return load_config(
        os.path.join(ROOT, "configs/COIN/step_forecasting.yaml"),
        ["TRAIN.ENABLE", "False", "DEV.MATCH_LANG_EMB", "True",
         "DEV.LOAD_DUMMY_DATA", "True", "DEV.TEST_LANG_EMB", BANK,
         "TIMESFORMER.DEPTH", "1", "DATA.NUM_FRAMES", "2",
         "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
         "DEV.ORDER_TFM_LAYERS", "1", "TEST.NUM_ENSEMBLE_VIEWS", "1",
         "TEST.BATCH_SIZE", "32", *extra])


def test_test_net_zero_shot_forecasting_on_cpu(tmp_path):
    """The entry point on the forecasting configuration, tiny geometry,
    bf16 as the config sets it, the real 778-step bank: 64 samples of 8
    clips in batches of 32."""
    cfg = _forecast_cfg()
    model, bank = build_model(cfg, device="cpu")
    assert bank.shape == (778, 512) and model.head_cls is None
    assert model.order_tfm.num_seg == 8 and model.order_tfm.max_len == 9
    cfg.OUTPUT_DIR = str(tmp_path)
    stats = port_test(cfg, device="cpu")
    assert 0.0 <= float(stats["top1_acc"]) <= float(stats["top5_acc"]) <= 100.0
    assert stats["clips_per_sec"] > 0
    # a finetuning configuration builds head_cls and no bank
    model, bank = build_model(_forecast_cfg("DEV.MATCH_LANG_EMB", "False"),
                              device="cpu")
    assert bank is None and model.head_cls.weight.shape == (778, 512)


# TRAIN.TEXT "": the test split then holds one clip a sample, not the
# pretraining config's 9 ASR windows (the dataset's mode, as in JAX)
MVIT_TINY = ["TRAIN.ENABLE", "False", "TEST.ENABLE", "True", "TRAIN.TEXT", "",
             "DEV.MATCH_LANG_EMB", "True", "DEV.TEST_LANG_EMB", BANK,
             "MODEL.NUM_CLASSES", "778", "DEV.LOAD_DUMMY_DATA", "True",
             "MVIT.DEPTH", "2", "MVIT.DIM_MUL", "[[1, 2.0]]",
             "MVIT.HEAD_MUL", "[[1, 2.0]]",
             "MVIT.POOL_Q_STRIDE", "[[0, 1, 1, 1], [1, 1, 2, 2]]",
             "MVIT.POOL_KV_STRIDE_ADAPTIVE", "[1, 4, 4]",
             "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "64",
             "DATA.TEST_CROP_SIZE", "64", "DEV.TEXT_LAYERS", "1",
             "DEV.ORDER_TFM_LAYERS", "2", "TEST.NUM_ENSEMBLE_VIEWS", "1",
             "TEST.BATCH_SIZE", "32"]


@pytest.mark.parametrize("knobs", [{}, {"MVIT_POOL": "kernel",
                                        "MVIT_KT": "1"}],
                         ids=["default", "kernel_kt"])
def test_test_net_mvit_zero_shot_on_cpu(knobs, monkeypatch, tmp_path):
    """The MViT-v2 zero-shot eval through the entry point on the shipped
    MViT configuration, tiny geometry, bf16, on the default route and on
    ``MVIT_POOL=kernel MVIT_KT=1`` (plain versions on the CPU)."""
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    cfg = load_config(os.path.join(
        ROOT, "configs/HowTo100M/procedurevrl_mvitv2_adamw.yaml"),
        MVIT_TINY + ["OUTPUT_DIR", str(tmp_path)])
    stats = port_test(cfg, device="cpu")
    for key in ("top1_acc", "top5_acc"):
        assert math.isfinite(float(stats[key]))
    assert stats["clips_per_sec"] > 0
