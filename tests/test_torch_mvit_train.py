"""Slice 3 of the PyTorch port end to end against the JAX package: the
MViT-v2 order-pretraining AdamW step, the weight round trip with the
encoder under ``video_encoder.``, and the port's ``train_net`` on the MViT
configuration on the CPU.

Train step geometry: the small MViT of ``tests/test_mvit_integration.py``
widened to crop 64 (embed 8, 1 -> 2 heads, depth 2, q stride 2 at block 1,
kv stride adaptive [1, 4, 4]; every block takes the fused kernel route),
4 frames; ``label_dim`` 64, CLIP text tower width 64 with 1 layer and a
300-token vocabulary, 2 order levels; B = 2 samples of M = 9 clips, fp32.
The JAX model runs the pooled attention kernels in interpret mode.  The
diffusion draws are fixed on both sides as in ``tests/test_torch_train.py``;
the recognition subset is every clip.  Tolerances as there: loss, KL, MSE
and gradients fp32 atol = rtol = 2e-5; updated parameters 1e-6 where the
gradient exceeds 1e-6, else within one step (2 lr).
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
from procedurevrl_tpu.engine.steps import TrainState
from procedurevrl_tpu.engine.steps import make_train_step as jax_make_train_step
from procedurevrl_tpu.models import mvit as jm
from procedurevrl_tpu.models.order_transformer import (
    OrderTransformer as JaxOrderTransformer,
)
from procedurevrl_tpu.models.procedurevrl import ProcedureVRL as JaxProcedureVRL
from procedurevrl_tpu.solver import construct_optimizer as jax_optimizer
from procedurevrl_tpu.solver import lr_schedule as jax_lr_schedule
from procedurevrl_tpu.utils.converter import convert_procedurevrl
from procedurevrl_torch.config import get_cfg, load_config
from procedurevrl_torch.datasets.synthetic import SyntheticPretrain
from procedurevrl_torch.engine.steps import make_train_step
from procedurevrl_torch.models import mvit as pm
from procedurevrl_torch.models.build import build_model
from procedurevrl_torch.models.procedurevrl import ProcedureVRLMViT
from procedurevrl_torch.solver.lr_policy import lr_schedule
from procedurevrl_torch.solver.optimizer import construct_optimizer
from procedurevrl_torch.tools.train_net import train
from procedurevrl_torch.utils import weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MVIT_YAML = os.path.join(ROOT, "configs/HowTo100M/procedurevrl_mvitv2_adamw.yaml")
TOL = dict(atol=2e-5, rtol=2e-5)
B, M, T, S, K, C = 2, 9, 4, 64, 40, 64
LR = 1e-3
GEOM = dict(spatial_size=S, temporal_size=T, embed_dim=8, num_heads=1,
            depth=2, dim_mul=((1, 2.0),), head_mul=((1, 2.0),),
            pool_q_stride=((1, 1, 2, 2),), pool_kv_stride_adaptive=(1, 4, 4),
            pool_kvq_kernel=(3, 3, 3))
TOWERS = dict(label_dim=C, match_lang_emb=True, order_pretrain=True,
              order_max_len=M, order_tfm_layers=2, order_recog_batch=M,
              with_text_model=True, text_vocab=300, text_width=64,
              text_heads=2, text_layers=1)


def _cfg(cfg):
    cfg.TRAIN.LABEL_EMB = "bank"
    cfg.TRAIN.TEXT = "asr"
    cfg.TRAIN.TOPK = 5
    cfg.SOLVER.OPTIMIZING_METHOD = "adamw"
    cfg.SOLVER.BASE_LR = LR
    cfg.SOLVER.LR_POLICY = "cosine"
    cfg.SOLVER.COSINE_END_LR = 0.0
    cfg.SOLVER.MAX_EPOCH = 10
    cfg.SOLVER.WARMUP_EPOCHS = 0.0
    cfg.SOLVER.WEIGHT_DECAY = 1e-4
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def _bank():
    rng = np.random.RandomState(1)
    bank = rng.randn(K, C).astype(np.float32)
    return bank / np.linalg.norm(bank, axis=1, keepdims=True)


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {
        "frames": rng.randint(0, 256, (B, M, T, S, S, 3)).astype(np.uint8),
        "labels": np.zeros(B, np.int64),
        "clip_text_ids": rng.randint(1, 300, (B, M, 77)).astype(np.int64),
        "clip_vis_feat": rng.randn(B, M, C).astype(np.float32),
    }


def _draws(seed):
    rng = np.random.RandomState(seed)
    mask = rng.randint(0, M, B)
    mask[-1] = M - 1  # one sample with its mask last: no padding
    pad = np.where(mask + 1 == M, M,
                   [rng.randint(m + 1, M) if m + 1 < M else M for m in mask])
    noise = rng.randn(TOWERS["order_tfm_layers"], B, C).astype(np.float32)
    return {"mask_inds": mask, "pad_start": pad, "level_noise": noise}


def _jax_params(bank):
    model = JaxProcedureVRL(encoder_name="mvit", num_frames=T,
                            mvit_cfg=jm.MViTConfig(**GEOM), **TOWERS,
                            num_classes=K, use_pallas=True)
    text = {"clip_text_ids": jnp.ones((B * M, 77), jnp.int32),
            "clip_vis_feat": jnp.zeros((B * M, C))}
    key = jax.random.PRNGKey(0)
    rngs = {"params": key, "diffusion": jax.random.fold_in(key, 1),
            "subset": jax.random.fold_in(key, 2),
            "droppath": jax.random.fold_in(key, 3)}
    params = jax.jit(lambda: model.init(
        rngs, jnp.zeros((B, M, T, S, S, 3)), text=text,
        label_emb=jnp.asarray(bank), train=True))()["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port_model(params):
    model = ProcedureVRLMViT(pm.MViTConfig(**GEOM), **TOWERS)
    model.load_state_dict(weights.params_from_jax(params), strict=True)
    return model


def _flat(tree, skip="text_model"):
    return {k: v for k, v in flatten_dict(tree).items() if k[0] != skip}


def test_every_block_takes_the_kernel_route(monkeypatch):
    seen = []
    from procedurevrl_torch.ops import mvit_attention as ma

    orig = ma.mvit_attention_hl
    monkeypatch.setattr(ma, "mvit_attention_hl",
                        lambda *a: seen.append(a[0].shape) or orig(*a))
    model = ProcedureVRLMViT(pm.MViTConfig(**GEOM), **TOWERS)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.video_encoder(torch.zeros(1, T, S, S, 3))
    assert [s[1] for s in seen] == [512, 128]


def test_mvit_train_step_matches_jax(monkeypatch):
    bank = _bank()
    batch, draws = _batch(2), _draws(3)
    jmodel, params = _jax_params(bank)
    orig = JaxOrderTransformer.pretrain

    def fixed_pretrain(self, x, mask_inds=None, pad_start=None,
                       level_noise=None):
        return orig(self, x, jnp.asarray(draws["mask_inds"]),
                    jnp.asarray(draws["pad_start"]),
                    jnp.asarray(draws["level_noise"]))

    monkeypatch.setattr(JaxOrderTransformer, "pretrain", fixed_pretrain)
    jcfg = _cfg(jax_get_cfg())
    sched = jax_lr_schedule(jcfg, 10)
    tx = jax_optimizer(params, jcfg, sched)
    jstep = jax_make_train_step(jmodel, tx, jcfg, bank, sched, 2)
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    jgrads, jmetrics, _ = jax.jit(jstep.grad_step)(
        params, 0, zeros, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(5))
    state = jax.jit(jstep.apply_step)(
        TrainState.create(params, tx),
        jax.tree_util.tree_map(lambda g: 2 * g, jgrads))
    jmetrics = dict(jmetrics, grad_norm=optax.global_norm(jgrads),
                    lr=sched(jnp.int32(0)))
    jgrads = _flat(jax.tree_util.tree_map(np.asarray, jgrads))
    new_params = _flat(jax.tree_util.tree_map(np.asarray, state.params))

    model = _port_model(params)
    cfg = _cfg(get_cfg())
    step = make_train_step(model, construct_optimizer(model, cfg), cfg,
                           torch.from_numpy(bank), lr_schedule(cfg, 10))
    metrics = step({k: torch.from_numpy(v) for k, v in batch.items()},
                   draws={k: torch.from_numpy(np.asarray(v))
                          for k, v in draws.items()})

    for k in ("loss", "kl", "mse", "top1_err", "top5_err", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   **TOL, err_msg=k)
    assert math.isfinite(float(metrics["loss"]))
    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
    # the key-norm bias shifts every key of a softmax alike: its gradient is
    # zero in exact arithmetic (chip_smoke.py holds it to a norm, not a
    # cosine)
    for n, p in trained.items():
        if n.endswith("attn.norm_k.bias"):
            assert p.grad.norm() < 1e-5 * float(metrics["grad_norm"]), n
    grads = _flat(convert_procedurevrl({n: p.grad for n, p in trained.items()}))
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        np.testing.assert_allclose(g, jgrads[k], **TOL, err_msg=str(k))
    after = _flat(convert_procedurevrl(
        {n: p.detach() for n, p in model.named_parameters()}))
    for k, p in after.items():
        sure = np.abs(jgrads[k]) > 1e-6
        np.testing.assert_allclose(p[sure], new_params[k][sure], atol=1e-6,
                                   rtol=1e-6, err_msg=str(k))
        np.testing.assert_allclose(p[~sure], new_params[k][~sure],
                                   atol=2 * LR, rtol=0, err_msg=str(k))


def test_mvit_weights_round_trip():
    """JAX-initialised MViT ProcedureVRL -> ``params_from_jax`` (encoder
    keys under ``video_encoder.``) -> the port's ``state_dict()`` ->
    ``convert_procedurevrl``: the same tree, bit for bit."""
    _, params = _jax_params(_bank())
    state = weights.params_from_jax(params)
    assert "video_encoder.blocks.1.attn.pool_q.weight" in state
    assert state["video_encoder.blocks.1.attn.pool_q.weight"].shape == (
        8, 1, 3, 3, 3)
    assert state["video_encoder.patch_embed.proj.weight"].shape == (
        8, 3, 3, 7, 7)
    assert not any(k.startswith(("blocks.", "patch_embed.")) for k in state)
    back = convert_procedurevrl(_port_model(params).state_dict())
    flat, flat_back = flatten_dict(params), flatten_dict(back)
    assert set(flat) == set(flat_back)
    for key, val in flat.items():
        assert flat_back[key].dtype == np.float32
        assert np.array_equal(flat_back[key], val), key


def _tiny_cfg(*extra, yaml=MVIT_YAML):
    return load_config(yaml, [
        "DEV.LOAD_DUMMY_DATA", "True", "MVIT.DEPTH", "2",
        "MVIT.DIM_MUL", "[[1, 2.0]]", "MVIT.HEAD_MUL", "[[1, 2.0]]",
        "MVIT.POOL_Q_STRIDE", "[[0, 1, 1, 1], [1, 1, 2, 2]]",
        "MVIT.POOL_KV_STRIDE_ADAPTIVE", "[1, 4, 4]",
        "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "64",
        "DEV.TEXT_LAYERS", "1", "DEV.ORDER_TFM_LAYERS", "2",
        "MODEL.NUM_CLASSES", "50", "TRAIN.BATCH_SIZE", "1",
        "GLOBAL_BATCH_SIZE", "2", "LOG_PERIOD", "2", *extra])


def test_builder_makes_the_mvit_model():
    model, bank = build_model(_tiny_cfg(), device="cpu")
    assert isinstance(model, ProcedureVRLMViT)
    assert bank.shape == (50, 512)
    assert model.video_encoder.remat
    assert all(k.startswith(("video_encoder.", "head.", "order_tfm.",
                             "text_model.")) for k in model.state_dict())
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(_tiny_cfg("MODEL.MODEL_NAME", "SlowFast"), device="cpu")


def test_full_size_batch_shape():
    """The synthetic batch of the shipped MViT configuration: 2 samples of
    9 clips x 16 frames at 224^2."""
    cfg = load_config(MVIT_YAML, ["DEV.LOAD_DUMMY_DATA", "True"])
    batch = SyntheticPretrain(cfg).batch(2, 0, torch.Generator())
    assert batch["frames"].shape == (2, 9, 16, 224, 224, 3)
    assert batch["frames"].dtype == torch.uint8
    assert pm.MViTConfig.from_cfg(cfg).block_schedule()[1] == [8, 56, 56]


@pytest.mark.parametrize("method", ["adamw", "sgd"])
def test_mvit_train_net_runs_on_cpu(method, monkeypatch, tmp_path):
    """The entry point itself on the MViT configuration, tiny geometry,
    synthetic data, plain path, bf16 compute and remat as the config sets
    them, accumulation 2.  The SGD configuration runs on route D
    (``MVIT_SAVE_PROBS=1 MVIT_DELTA=1``, set while the model is built) with
    block 1 sent head-split, so that block 1 runs K6sp's plain version,
    whose outputs the remat policy keeps for the recomputation."""
    from procedurevrl_torch.ops import mvit_attention as ma

    yaml = MVIT_YAML.replace("adamw", method)
    cfg = _tiny_cfg("OUTPUT_DIR", str(tmp_path), yaml=yaml)
    assert cfg.SOLVER.OPTIMIZING_METHOD == method
    assert cfg.TPU.REMAT and cfg.TPU.COMPUTE_DTYPE == "bfloat16"
    calls = []
    if method == "sgd":
        monkeypatch.setenv("MVIT_SAVE_PROBS", "1")
        monkeypatch.setenv("MVIT_DELTA", "1")
        monkeypatch.setattr(ma, "hl_supported", lambda kn, c, h: h == 1)
        for name in ("mvit_attention_fwd_probs", "mvit_attention_bwd_probs",
                     "mvit_attention_hl_bwd_delta"):
            fn = getattr(ma, name)
            monkeypatch.setattr(ma, name, lambda *a, _f=fn, _n=name:
                                calls.append(_n) or _f(*a))
    stats = train(cfg, device="cpu", max_steps=2)
    if method == "sgd":
        # per step and clip batch: block 1's forward once (JAX's MViT remat
        # policy keeps K6sp's outputs, so the recomputation does not run
        # it again), one backward of each block
        assert calls.count("mvit_attention_fwd_probs") == 2 * 2
        assert calls.count("mvit_attention_bwd_probs") == 2 * 2
        assert calls.count("mvit_attention_hl_bwd_delta") == 2 * 2
    assert stats["steps"] == 2 and len(stats["history"]) == 2
    assert stats["clips_per_step"] == 2 * 9
    for h in stats["history"]:
        for k in ("loss", "kl", "mse", "grad_norm"):
            assert math.isfinite(h[k]), (k, h)
        assert h["loss"] == pytest.approx(h["kl"] + h["mse"], rel=1e-5)
