"""Slice 2 of the PyTorch port end to end against the JAX package: one
order-pretraining AdamW step (and one SGD step: momentum 0.9, Nesterov,
coupled decay), gradient accumulation, the weight round trip
with both towers, and the port's ``train_net`` entry point on the CPU.

Train step geometry: encoder width 128, 2 heads of 64, depth 2, T = 4,
32^2 crops; ``label_dim`` 64, CLIP text tower width 64 with 1 layer and a
300-token vocabulary, 2 order levels; B = 2 samples of M = 9 clips, drop
path 0, fp32.  The JAX model runs both attention kernels in interpret mode
(``PALLAS_MIN_LEN=1``).  The diffusion draws are fixed on both sides: the
port takes them as an argument, and on the JAX side the test wraps
``OrderTransformer.pretrain`` to pass them.  The recognition subset is a
full permutation of the 18 clips on both sides (``ORDER_RECOG_BATCH`` =
M), which the batch-mean KL and the errors do not depend on.

Tolerances: loss, KL, MSE and gradients fp32 atol = rtol = 2e-5 (the
repository's parity tolerance).  The first AdamW update moves a parameter
by ``lr * g / (|g| + 1e-8)`` (+ decay): where |g| > 1e-6 that is
insensitive to the gradient's last bits and the updated parameters agree
to 1e-6; below, a 2e-5 relative gradient difference can still flip the
update, so those entries are only held within one step (2 lr).
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
from procedurevrl_tpu.models.order_transformer import (
    OrderTransformer as JaxOrderTransformer,
)
from procedurevrl_tpu.models.procedurevrl import ProcedureVRL as JaxProcedureVRL
from procedurevrl_tpu.solver import construct_optimizer as jax_optimizer
from procedurevrl_tpu.solver import lr_schedule as jax_lr_schedule
from procedurevrl_tpu.utils.converter import convert_procedurevrl
from procedurevrl_torch.config import get_cfg, load_config
from procedurevrl_torch.engine.steps import make_train_step
from procedurevrl_torch.models.procedurevrl import ProcedureVRL
from procedurevrl_torch.solver.lr_policy import lr_schedule
from procedurevrl_torch.solver.optimizer import construct_optimizer
from procedurevrl_torch.tools.train_net import train
from procedurevrl_torch.utils import weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-5, rtol=2e-5)
B, M, T, S, K, C = 2, 9, 4, 32, 40, 64
LR = 1e-3
GEOM = dict(img_size=S, patch_size=16, embed_dim=128, depth=2, num_heads=2,
            num_frames=T, drop_path_rate=0.0)
TOWERS = dict(label_dim=C, match_lang_emb=True, order_pretrain=True,
              order_max_len=M, order_tfm_layers=2, order_recog_batch=M,
              with_text_model=True, text_vocab=300, text_width=64,
              text_heads=2, text_layers=1)


def _cfg(cfg, method="adamw"):
    cfg.TRAIN.LABEL_EMB = "bank"
    cfg.TRAIN.TEXT = "asr"
    cfg.TRAIN.TOPK = 5
    cfg.SOLVER.OPTIMIZING_METHOD = method
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


def _batch(seed, b=B):
    rng = np.random.RandomState(seed)
    return {
        "frames": rng.randint(0, 256, (b, M, T, S, S, 3)).astype(np.uint8),
        "labels": np.zeros(b, np.int64),
        "clip_text_ids": rng.randint(1, 300, (b, M, 77)).astype(np.int64),
        "clip_vis_feat": rng.randn(b, M, C).astype(np.float32),
    }


def _draws(seed, b=B):
    rng = np.random.RandomState(seed)
    mask = rng.randint(0, M, b)
    mask[-1] = M - 1  # one sample with its mask last: no padding
    pad = np.where(mask + 1 == M, M,
                   [rng.randint(m + 1, M) if m + 1 < M else M for m in mask])
    noise = rng.randn(TOWERS["order_tfm_layers"], b, C).astype(np.float32)
    return {"mask_inds": mask, "pad_start": pad, "level_noise": noise}


def _jax_params(bank):
    model = JaxProcedureVRL(**GEOM, **TOWERS, num_classes=K, use_pallas=True)
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
    model = ProcedureVRL(**GEOM, **TOWERS)
    model.load_state_dict(weights.params_from_jax(params), strict=True)
    return model


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _torch_draws(draws):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()}


def _flat(tree, skip="text_model"):
    return {k: v for k, v in flatten_dict(tree).items() if k[0] != skip}


@pytest.fixture(scope="module")
def jax_grads():
    """The JAX package's gradient half of the step (``grad_step``, which no
    optimizer enters), shared by both update rules: the bank, batch, draws,
    model, initial parameters, gradients and metrics."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PALLAS_MIN_LEN", "1")
        bank = _bank()
        batch, draws = _batch(2), _draws(3)
        jmodel, params = _jax_params(bank)
        # the diffusion draws fixed from outside
        orig = JaxOrderTransformer.pretrain

        def fixed_pretrain(self, x, mask_inds=None, pad_start=None,
                           level_noise=None):
            return orig(self, x, jnp.asarray(draws["mask_inds"]),
                        jnp.asarray(draws["pad_start"]),
                        jnp.asarray(draws["level_noise"]))

        mp.setattr(JaxOrderTransformer, "pretrain", fixed_pretrain)
        jcfg = _cfg(jax_get_cfg())
        sched = jax_lr_schedule(jcfg, 10)
        jstep = jax_make_train_step(jmodel, jax_optimizer(params, jcfg, sched),
                                    jcfg, bank, sched, 2)
        zeros = jax.tree_util.tree_map(np.zeros_like, params)
        jgrads, jmetrics, _ = jax.jit(jstep.grad_step)(
            params, 0, zeros, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(5))
    return bank, batch, draws, jmodel, params, jgrads, jmetrics


@pytest.mark.parametrize("method", ["adamw", "sgd"])
def test_train_step_matches_jax(method, jax_grads, monkeypatch):
    monkeypatch.setenv("PALLAS_MIN_LEN", "1")
    bank, batch, draws, jmodel, params, jgrads, jmetrics = jax_grads

    # JAX: the package's own step in its two halves, so that the gradients
    # the update uses can be read: grad_step into a zero accumulator (the
    # fixture), then apply_step of ``method``, which divides by
    # accum_steps = 2 (exact for 2 * g)
    jcfg = _cfg(jax_get_cfg(), method)
    sched = jax_lr_schedule(jcfg, 10)
    tx = jax_optimizer(params, jcfg, sched)
    jstep = jax_make_train_step(jmodel, tx, jcfg, bank, sched, 2)
    state = jax.jit(jstep.apply_step)(
        TrainState.create(params, tx),
        jax.tree_util.tree_map(lambda g: 2 * g, jgrads))
    jmetrics = dict(jmetrics, grad_norm=optax.global_norm(jgrads),
                    lr=sched(jnp.int32(0)))
    jgrads = _flat(jax.tree_util.tree_map(np.asarray, jgrads))
    new_params = _flat(jax.tree_util.tree_map(np.asarray, state.params))

    # the port
    model = _port_model(params)
    cfg = _cfg(get_cfg(), method)
    optimizer = construct_optimizer(model, cfg)
    step = make_train_step(model, optimizer, cfg, torch.from_numpy(bank),
                           lr_schedule(cfg, 10))
    metrics = step(_torch_batch(batch), draws=_torch_draws(draws))

    for k in ("loss", "kl", "mse", "top1_err", "top5_err", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   **TOL, err_msg=k)
    assert metrics["lr"] == pytest.approx(float(jmetrics["lr"]), rel=1e-6)
    assert math.isfinite(float(metrics["loss"]))

    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
    assert not any(n.startswith("text_model.") for n in trained)
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
    # the frozen text tower took no gradient and did not move
    assert all(p.grad is None for p in model.text_model.parameters())
    np.testing.assert_array_equal(
        model.text_model.token_embedding.weight.detach().numpy(),
        params["text_model"]["token_embedding"])


def test_gradient_accumulation_matches_one_big_step():
    """accum_steps=2 over two micro-batches == one step on their
    concatenation: the mean of the micro-batch gradients is the gradient of
    the mean loss, and the draws of the big step are the micro draws
    concatenated."""
    bank = torch.from_numpy(_bank())
    gen = torch.Generator().manual_seed(11)
    ref_model = ProcedureVRL(**GEOM, **TOWERS)
    ref_model.reset_parameters(gen)
    state = ref_model.state_dict()
    halves = [_batch(20), _batch(21)]
    draws = [_draws(22), _draws(23)]
    full = {k: np.concatenate([h[k] for h in halves]) for k in halves[0]}
    full_draws = {k: np.concatenate([d[k] for d in draws],
                                    axis=1 if k == "level_noise" else 0)
                  for k in draws[0]}

    results = []
    for accum in (1, 2):
        model = ProcedureVRL(**GEOM, **TOWERS)
        model.load_state_dict(state)
        cfg = _cfg(get_cfg())
        opt = construct_optimizer(model, cfg)
        step = make_train_step(model, opt, cfg, bank, lr_schedule(cfg, 10),
                               accum_steps=accum)
        if accum == 1:
            m = step(_torch_batch(full), draws=_torch_draws(full_draws))
        else:
            m = step([_torch_batch(h) for h in halves],
                     draws=[_torch_draws(d) for d in draws])
        results.append((m, {n: (p.grad.clone(), p.detach().clone())
                            for n, p in model.named_parameters()
                            if p.requires_grad}))
    (m1, p1), (m2, p2) = results
    for k in ("loss", "kl", "mse", "grad_norm"):
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), **TOL,
                                   err_msg=k)
    for n, (g, p) in p1.items():
        g2, q = p2[n]
        np.testing.assert_allclose(g2.numpy(), g.numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=n)
        sure = g.abs() > 1e-6
        np.testing.assert_allclose(q[sure].numpy(), p[sure].numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=n)
    with pytest.raises(ValueError, match="micro-batches"):
        step(_torch_batch(full))


def test_weights_round_trip_with_both_towers():
    """JAX-initialised ProcedureVRL with ``order_tfm`` and ``text_model``
    -> ``params_from_jax`` -> the port's ``state_dict()`` ->
    ``convert_procedurevrl``: the same tree, bit for bit."""
    bank = _bank()
    _, params = _jax_params(bank)
    assert {"order_tfm", "text_model"} <= set(params)
    back = convert_procedurevrl(_port_model(params).state_dict())
    flat, flat_back = flatten_dict(params), flatten_dict(back)
    assert set(flat) == set(flat_back)
    for key, val in flat.items():
        assert flat_back[key].dtype == np.float32
        assert np.array_equal(flat_back[key], val), key


def _tiny_train_cfg(*extra):
    return load_config(
        os.path.join(ROOT, "configs/HowTo100M/procedurevrl_adamw.yaml"),
        ["DEV.LOAD_DUMMY_DATA", "True", "TIMESFORMER.DEPTH", "1",
         "DATA.NUM_FRAMES", "2", "DATA.TRAIN_CROP_SIZE", "32",
         "DEV.TEXT_LAYERS", "1", "DEV.ORDER_TFM_LAYERS", "2",
         "MODEL.NUM_CLASSES", "50", "TRAIN.BATCH_SIZE", "1",
         "GLOBAL_BATCH_SIZE", "2", "LOG_PERIOD", "2", *extra])


def test_train_net_runs_on_cpu():
    """The entry point itself, tiny geometry, synthetic data, plain path,
    bf16 compute and remat as the config sets them, accumulation 2."""
    cfg = _tiny_train_cfg()
    assert cfg.TPU.REMAT and cfg.TPU.COMPUTE_DTYPE == "bfloat16"
    stats = train(cfg, device="cpu", max_steps=3)
    assert stats["steps"] == 3 and len(stats["history"]) == 3
    assert stats["clips_per_step"] == 2 * 9
    for h in stats["history"]:
        for k in ("loss", "kl", "mse", "grad_norm", "top1_err", "top5_err"):
            assert math.isfinite(h[k]), (k, h)
        assert h["loss"] == pytest.approx(h["kl"] + h["mse"], rel=1e-5)
        assert h["lr"] == pytest.approx(5e-5)
    assert stats["clips_per_sec"] > 0


def test_train_net_needs_the_card_unless_asked_for_cpu(monkeypatch):
    from procedurevrl_torch.tools import run_net

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(_tiny_train_cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_net.main(["--cfg", os.path.join(
            ROOT, "configs/HowTo100M/procedurevrl_adamw.yaml"),
            "DEV.LOAD_DUMMY_DATA", "True"])
