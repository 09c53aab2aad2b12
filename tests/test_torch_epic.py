"""The EPIC-Kitchens-100 full finetune of the PyTorch port against the JAX
package: ``epic_loss`` and the multitask (action) accuracies, ``Mixup``
fed the JAX package's draws on its mixup, CutMix and not-applied branches,
one EPIC train step (verb + noun heads on a trained encoder, AdamW,
accumulation 2) against JAX ``make_train_step``, the eval tuple, the two
EPIC meters, the synthetic EPIC split, the optimizer groups, the weight
bridge, and ``run_net`` on ``configs/EK/egocentric_action_classification
.yaml`` through train, val and test on the CPU.

Train step geometry: width 128, 2 heads of 64, depth 1, 32^2 crops,
T = 32 frames, so that the temporal pass takes the plain path as EK's does
(T > 16) and K1 runs through ``PALLAS_MIN_LEN=1`` (JAX in interpret
mode); ``label_dim`` 64; remat on under the config's default policy; B = 2
clips a micro-batch, fp32, ``MIXUP.ENABLED`` as the EK config sets it
(the EPIC branch applies no mixup, in JAX as in the port).  Tolerances:
fp32 atol = rtol = 2e-5 for losses, accuracies and outputs, 5e-5 for
gradients; updated parameters 1e-6 where |g| > 1e-6, else within one step
(2 lr), as ``test_torch_train.py`` reasons.
"""

import json
import math
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from procedurevrl_tpu.config import get_cfg as jax_get_cfg
from procedurevrl_tpu.engine import losses as jax_losses
from procedurevrl_tpu.engine import mixup as jax_mixup
from procedurevrl_tpu.engine.steps import TrainState
from procedurevrl_tpu.engine.steps import make_train_step as jax_make_train_step
from procedurevrl_tpu.engine.steps import normalize_frames as jax_normalize
from procedurevrl_tpu.models.procedurevrl import ProcedureVRL as JaxProcedureVRL
from procedurevrl_tpu.solver import construct_optimizer as jax_optimizer
from procedurevrl_tpu.solver import lr_schedule as jax_lr_schedule
from procedurevrl_tpu.solver import optimizer as jax_opt
from procedurevrl_tpu.utils import checkpoint as jax_cu
from procedurevrl_tpu.utils import meters as jax_meters
from procedurevrl_tpu.utils import metrics as jax_metrics
from procedurevrl_tpu.utils.converter import convert_procedurevrl
from procedurevrl_torch.config import get_cfg, load_config
from procedurevrl_torch.datasets.synthetic import SyntheticClips
from procedurevrl_torch.engine import losses, mixup, steps
from procedurevrl_torch.engine.steps import make_train_step, normalize_frames
from procedurevrl_torch.models.procedurevrl import ProcedureVRL
from procedurevrl_torch.ops.attention_route import AttentionRoute
from procedurevrl_torch.solver import optimizer as opt
from procedurevrl_torch.solver.lr_policy import lr_schedule
from procedurevrl_torch.solver.optimizer import construct_optimizer
from procedurevrl_torch.tools import run_net
from procedurevrl_torch.utils import meters, metrics, weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EK_CFG = os.path.join(ROOT, "configs/EK/egocentric_action_classification.yaml")
TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
B, T, S, C = 2, 32, 32, 64
LR = 1e-4
GEOM = dict(img_size=S, patch_size=16, embed_dim=128, depth=1, num_heads=2,
            num_frames=T, drop_path_rate=0.0)
HEADS = dict(label_dim=C, num_classes=97, match_lang_emb=False)


def _np(t):
    return np.array(t, dtype=np.float32)


@pytest.mark.parametrize("name", ["cross_entropy", "smooth"])
def test_epic_loss_matches_jax(name):
    rng = np.random.RandomState(1)
    v = (3 * rng.randn(6, 97)).astype(np.float32)
    n = (3 * rng.randn(6, 300)).astype(np.float32)
    vl, nl = rng.randint(0, 97, 6), rng.randint(0, 300, 6)
    want = jax_losses.epic_loss(*map(jnp.asarray, (v, n, vl, nl)),
                                jax_losses.get_loss_func(name))
    got = losses.epic_loss(*map(torch.from_numpy, (v, n, vl, nl)),
                           losses.get_loss_func(name))
    np.testing.assert_allclose([float(x) for x in got],
                               [float(x) for x in want], **TOL)
    assert float(got[0]) == pytest.approx(0.5 * float(got[1] + got[2]))


@pytest.mark.parametrize("ks", [(1, 5), (1, 150)])
def test_multitask_accuracies_match_jax(ks):
    """A sample counts only when both its verb and its noun are in their
    top k; k clamps to the smaller class count (97)."""
    rng = np.random.RandomState(2)
    v, n = rng.rand(40, 97).astype(np.float32), rng.rand(40, 300).astype(
        np.float32)
    vl, nl = rng.randint(0, 97, 40), rng.randint(0, 300, 40)
    vl[:15], nl[5:20] = v[:15].argmax(1), n[5:20].argmax(1)
    got = metrics.multitask_topk_accuracies(
        (torch.from_numpy(v), torch.from_numpy(n)),
        (torch.from_numpy(vl), torch.from_numpy(nl)), ks)
    want = jax_metrics.multitask_topk_accuracies(
        (jnp.asarray(v), jnp.asarray(n)), (jnp.asarray(vl), jnp.asarray(nl)),
        ks)
    np.testing.assert_allclose([float(x) for x in got],
                               [float(x) for x in want], **TOL)
    assert float(got[0]) == pytest.approx(100 * 10 / 40)  # rows 5..14


def _jax_draws(fn, key, h, w):
    """The draws JAX ``Mixup.__call__`` makes from ``key``, as the port's
    ``draws`` mapping (``engine/mixup.py:DRAWS``)."""
    k_apply, k_switch, k_lam, k_box = jax.random.split(key, 4)
    switch = jax.random.uniform(k_switch)
    use_cutmix = (switch < fn.switch_prob if fn.cutmix_alpha > 0.0
                  and fn.mixup_alpha > 0.0 else fn.mixup_alpha <= 0.0)
    alpha = jnp.where(use_cutmix, fn.cutmix_alpha, fn.mixup_alpha)
    ky, kx = jax.random.split(k_box)
    return {"apply": _np(jax.random.uniform(k_apply)), "switch": _np(switch),
            "lam": _np(jax.random.beta(k_lam, alpha, alpha)),
            "cy": np.int64(jax.random.randint(ky, (), 0, h)),
            "cx": np.int64(jax.random.randint(kx, (), 0, w))}


# branch -> (prob, the draws' condition)
BRANCHES = {"mixup": (1.0, lambda d: d["switch"] >= 0.5),
            "cutmix": (1.0, lambda d: d["switch"] < 0.5),
            "not_applied": (0.5, lambda d: d["apply"] >= 0.5)}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_mixup_matches_jax(branch):
    prob, wanted = BRANCHES[branch]
    kw = dict(mixup_alpha=0.8, cutmix_alpha=1.0, prob=prob, switch_prob=0.5,
              label_smoothing=0.1, num_classes=11)
    jfn, fn = jax_mixup.Mixup(**kw), mixup.Mixup(**kw)
    rng = np.random.RandomState(3)
    frames = rng.randn(4, 2, 16, 12, 3).astype(np.float32)
    labels = np.array([1, 5, 5, 10])
    seed = next(s for s in range(200) if wanted(
        _jax_draws(jfn, jax.random.PRNGKey(s), 16, 12)))
    key = jax.random.PRNGKey(seed)
    draws = _jax_draws(jfn, key, 16, 12)
    want_x, want_y = jfn(key, jnp.asarray(frames), jnp.asarray(labels))
    got_x, got_y = fn(torch.from_numpy(frames), torch.from_numpy(labels),
                      draws=draws)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **TOL)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    assert got_y.sum(1).numpy() == pytest.approx(np.ones(4), rel=1e-6)
    changed = not np.array_equal(got_x.numpy(), frames)
    assert changed == (branch != "not_applied")
    # the port's own draws: a generator on the frames' device, every value
    # in range, Beta-distributed lambda in [0, 1]
    d = fn.draw(torch.Generator().manual_seed(0), torch.device("cpu"), 16, 12)
    assert 0 <= float(d["lam"]) <= 1 and 0 <= int(d["cy"]) < 16
    assert 0 <= int(d["cx"]) < 12 and 0 <= float(d["apply"]) < 1


def test_the_mixup_stream_comes_last():
    """``mixup`` joined the streams at the end, so the others keep their
    index, and so their seeds; a later stream (``dropout``) comes after
    it."""
    assert steps.STREAMS[:4] == ("diffusion", "subset", "droppath", "mixup")


def _ek_cfg(cfg):
    cfg.TRAIN.DATASET = "Epickitchens"
    cfg.TEST.DATASET = "Epickitchens"
    cfg.MODEL.LOSS_FUNC = "cross_entropy"
    cfg.MIXUP.ENABLED = True
    cfg.MIXUP.ALPHA = 0.1
    cfg.SOLVER.OPTIMIZING_METHOD = "adamw"
    cfg.SOLVER.BASE_LR = LR
    cfg.SOLVER.LR_POLICY = "steps_with_relative_lrs"
    cfg.SOLVER.STEPS = [0, 30, 40]
    cfg.SOLVER.LRS = [1, 0.1, 0.01]
    cfg.SOLVER.MAX_EPOCH = 50
    cfg.SOLVER.WEIGHT_DECAY = 5e-2
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def _jax_params(model, x):
    """The JAX model's parameters drawn with numpy: N(0, 0.05) weights,
    LayerNorm scales around 1, biases N(0, 0.02)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)["params"]
    rng = np.random.RandomState(11)

    def draw(path, leaf):
        name = path[-1].key
        base = 1.0 if name == "scale" else 0.0
        std = 0.02 if name == "bias" else 0.05
        return (base + std * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_epic_train_step_and_eval_match_jax(monkeypatch):
    monkeypatch.setenv("PALLAS_MIN_LEN", "1")
    rng = np.random.RandomState(12)
    batch = {"frames": rng.randint(0, 256, (B, T, S, S, 3)).astype(np.uint8),
             "verb": np.array([3, 96]), "noun": np.array([299, 7])}
    jmodel = JaxProcedureVRL(**GEOM, **HEADS, epic_heads=True,
                             use_pallas=True, remat=True,
                             remat_save_temporal=True)
    params = _jax_params(jmodel, jnp.zeros((B, T, S, S, 3)))
    jcfg = _ek_cfg(jax_get_cfg())
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
    x = jax_normalize(jnp.asarray(batch["frames"]), jcfg)
    jeval = jax.jit(lambda p, xx: jmodel.apply({"params": p}, xx,
                                               train=False))(params, x)
    jgrads = flatten_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    new_params = flatten_dict(jax.tree_util.tree_map(np.asarray,
                                                     state.params))

    model = ProcedureVRL(**GEOM, **HEADS, epic_heads=True, remat=True,
                         remat_save_temporal=True,
                         route=AttentionRoute.from_env())
    model.load_state_dict(weights.params_from_jax(params), strict=True)
    assert model.head_cls is None
    cfg = _ek_cfg(get_cfg())
    model.eval()
    verb, noun = model(normalize_frames(torch.from_numpy(batch["frames"]),
                                        cfg), train=False)
    np.testing.assert_allclose(verb.detach().numpy(), np.asarray(jeval[0]),
                               **TOL)
    np.testing.assert_allclose(noun.detach().numpy(), np.asarray(jeval[1]),
                               **TOL)

    # the EPIC branch builds the config's mixup but must not call it
    monkeypatch.setattr(mixup.Mixup, "__call__", lambda *a, **k: pytest.fail(
        "the EPIC step applied mixup"))
    step = make_train_step(model, construct_optimizer(model, cfg), cfg, None,
                           lr_schedule(cfg, 10))
    m = step({k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "verb_loss", "noun_loss", "verb_top1_acc",
              "verb_top5_acc", "noun_top1_acc", "noun_top5_acc", "top1_acc",
              "top5_acc"):
        np.testing.assert_allclose(float(m[k]), float(jmetrics[k]), **TOL,
                                   err_msg=k)
    np.testing.assert_allclose(float(m["grad_norm"]), jnorm, **GRAD_TOL)
    trained = {n for n, p in model.named_parameters() if p.requires_grad}
    assert {"head_v.weight", "head_n.bias"} <= trained
    assert not any(n.startswith("head.") for n in trained)
    grads = flatten_dict(convert_procedurevrl({
        n: p.grad for n, p in model.named_parameters() if p.requires_grad}))
    for k, g in grads.items():
        np.testing.assert_allclose(g, jgrads[k], **GRAD_TOL, err_msg=str(k))
    for k, g in jgrads.items():  # JAX's frozen head: exact zeros
        if k not in grads:
            assert k[0] == "head" and not np.any(g), k
    after = flatten_dict(convert_procedurevrl(
        {n: p.detach() for n, p in model.named_parameters()}))
    for k, p in after.items():
        sure = np.abs(jgrads[k]) > 1e-6
        np.testing.assert_allclose(p[sure], new_params[k][sure], atol=1e-6,
                                   rtol=1e-6, err_msg=str(k))
        np.testing.assert_allclose(p[~sure], new_params[k][~sure],
                                   atol=2 * LR, rtol=0, err_msg=str(k))


def test_epic_groups_and_weights_match_jax(tmp_path):
    """The EK optimizer groups (not the ``finetune`` branch: ``head`` is
    frozen, ``head_v`` and ``head_n`` go to ``main`` with
    ``SOLVER.WEIGHT_DECAY``) equal JAX ``_group_of`` on every parameter's
    tree path; the weight bridge carries the EPIC heads both ways; a
    pretraining file loaded into the EK model (JAX ``load_reference_params``
    rule) leaves both heads at their init."""
    cfg = _ek_cfg(get_cfg())
    model = ProcedureVRL(**GEOM, **HEADS, epic_heads=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    tree = convert_procedurevrl(model.state_dict())
    want: dict = {}
    for path, leaf in flatten_dict(tree).items():
        group = jax_opt._group_of("/".join(path), cfg)
        want[group] = want.get(group, 0) + leaf.size
    got: dict = {}
    for name, p in model.named_parameters():
        group = opt._group_of(name, cfg)
        got[group] = got.get(group, 0) + p.numel()
    assert got == want and set(got) == {"main", "frozen"}
    assert {opt._group_of(n, cfg) for n in ("head.weight", "head_v.weight",
                                            "head_n.bias")} == {
        "frozen", "main"}
    assert opt._group_of("head.weight", cfg) == "frozen"
    groups = {g["name"]: g for g in opt.param_groups(model, cfg)}
    assert set(groups) == {"main"}
    assert groups["main"]["weight_decay"] == 5e-2
    assert {"head_v", "head_n"} <= set(tree) and "head_cls" not in tree
    back = weights.params_from_jax(tree)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k

    pre = ProcedureVRL(**GEOM, label_dim=C, match_lang_emb=True)
    pre.reset_parameters(torch.Generator().manual_seed(1))
    path = str(tmp_path / "pretrain.pyth")
    torch.save({"model_state": pre.state_dict(), "epoch": 3}, path)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    assert weights.load_reference_params(model, path) == 3
    for k, v in model.state_dict().items():
        want = init[k] if k.startswith(("head_v.", "head_n.")) else (
            pre.state_dict()[k])
        assert torch.equal(v, want), k
    ref, _ = jax_cu.load_reference_params(
        path, jax.tree_util.tree_map(np.asarray, convert_procedurevrl(init)))
    got = flatten_dict(convert_procedurevrl(model.state_dict()))
    for k, v in flatten_dict(ref).items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=str(k))


def test_epic_val_meter_matches_jax():
    cfg, jcfg = get_cfg(), jax_get_cfg()
    for c in (cfg, jcfg):
        c.LOG_PERIOD = 2
        c.SOLVER.MAX_EPOCH = 2
    ours, theirs = meters.EPICValMeter(3, cfg), jax_meters.EPICValMeter(3,
                                                                         jcfg)
    rng = np.random.RandomState(13)
    for epoch in range(2):
        for it in range(3):
            top1 = tuple(float(x) for x in rng.choice([0.0, 25.0, 50.0], 3))
            top5 = tuple(float(x) for x in rng.choice([50.0, 75.0, 100.0], 3))
            n = int(rng.randint(1, 5))
            for m in (ours, theirs):
                m.iter_tic()
                m.update_stats(top1, top5, n)
                m.iter_toc()
                m.log_iter_stats(epoch, it)
            for k in ours.mb:
                assert (ours.mb[k].get_win_median()
                        == theirs.mb[k].get_win_median()), k
        stats = ours.log_epoch_stats(epoch)
        best = theirs.log_epoch_stats(epoch)
        assert stats["is_best"] == best
        for k in ("verb_top1_acc", "noun_top5_acc", "top1_acc",
                  "max_top5_acc", "max_verb_top1_acc"):
            assert stats[k] == pytest.approx(theirs.stats[k]), k
        ours.reset()
        theirs.reset()
    assert ours.max_acc == pytest.approx(theirs.max_acc)


def test_epic_test_meter_matches_jax():
    """Each video's verb and noun logits summed over its 6 clips, then
    verb, noun and action top-1 / top-5 over the videos."""
    rng = np.random.RandomState(14)
    videos, clips = 10, 6
    ours = meters.EPICTestMeter(videos, clips, [97, 300], 3)
    theirs = jax_meters.EPICTestMeter(videos, clips, [97, 300], 3)
    order = rng.permutation(videos * clips)
    for part in np.array_split(order, 3):
        v = rng.randn(len(part), 97).astype(np.float32)
        n = rng.randn(len(part), 300).astype(np.float32)
        vids = part // clips
        labels = (vids % 97, (vids * 7) % 300)
        for m in (ours, theirs):
            m.update_stats((v, n), labels, None, part)
    np.testing.assert_allclose(ours.verb_preds, theirs.verb_preds, **TOL)
    np.testing.assert_allclose(ours.noun_preds, theirs.noun_preds, **TOL)
    assert (ours.clip_count == clips).all()
    assert ours.finalize_metrics() == theirs.finalize_metrics()


def test_synthetic_epic_split():
    """The JAX dummy split's labels (video v: verb v % 97, noun v % 300),
    ``NUM_ENSEMBLE_VIEWS x NUM_SPATIAL_CROPS`` clips a test video, and the
    shipped EK config's epoch: 64 videos make 2 micro-batches of 32, fewer
    than the 4 ``GLOBAL_BATCH_SIZE 128`` accumulates, until ``TRAIN.
    EPOCH_MUL 2``."""
    cfg = load_config(EK_CFG, ["DEV.LOAD_DUMMY_DATA", "True",
                               "TEST.NUM_ENSEMBLE_VIEWS", "2",
                               "TEST.NUM_SPATIAL_CROPS", "3",
                               "DATA.TEST_CROP_SIZE", "16",
                               "DATA.TRAIN_CROP_SIZE", "16",
                               "DATA.NUM_FRAMES", "2"])
    test = SyntheticClips(cfg, "test")
    assert test.epic and test.num_clips == 6 and len(test) == 64 * 6
    batch = test.batch(16, 4, torch.Generator())  # clips 64..79: videos 10-13
    assert set(batch) == {"frames", "verb", "noun", "index"}
    vids = batch["index"] // 6
    assert torch.equal(batch["verb"], vids % 97)
    assert torch.equal(batch["noun"], vids % 300)
    train = SyntheticClips(cfg, "train")
    assert train.num_batches(cfg.TRAIN.BATCH_SIZE) == 2
    assert cfg.GLOBAL_BATCH_SIZE // cfg.TRAIN.BATCH_SIZE == 4
    cfg.TRAIN.EPOCH_MUL = 2
    assert SyntheticClips(cfg, "train").num_batches(32) == 4
    big = SyntheticClips(cfg, "train").batch(32, 3, torch.Generator())
    assert big["verb"].tolist() == [v % 97 for v in range(32, 64)]
    assert big["noun"].tolist() == list(range(32, 64))


TINY = ["DEV.LOAD_DUMMY_DATA", "True", "TIMESFORMER.DEPTH", "1",
        "DATA.NUM_FRAMES", "2", "DATA.TRAIN_CROP_SIZE", "32",
        "DATA.TEST_CROP_SIZE", "32", "TRAIN.BATCH_SIZE", "16",
        "GLOBAL_BATCH_SIZE", "32", "TEST.BATCH_SIZE", "32",
        "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.NUM_SPATIAL_CROPS", "2",
        "SOLVER.MAX_EPOCH", "1", "TRAIN.EVAL_PERIOD", "1", "LOG_PERIOD", "1",
        "TEST.SAVE_RESULTS_PATH", "results.pkl"]


def test_run_net_ek_trains_validates_and_tests_on_cpu(capsys, tmp_path):
    """``run_net`` on the EK configuration at tiny widths (bf16, remat and
    mixup as it sets them): one epoch of 2 optimizer steps of 2
    micro-batches, a val epoch of verb, noun and action accuracies, then
    the test of the epoch's checkpoint with 2 views a video, which writes
    ``{"verb", "noun"}``."""
    rc = run_net.main(["--device", "cpu", "--cfg", EK_CFG, *TINY,
                       "OUTPUT_DIR", str(tmp_path)])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [x["split"] for x in lines] == ["train", "test_final"]
    train, test = lines
    assert train["steps"] == 2
    for k in ("loss", "verb_loss", "noun_loss", "grad_norm"):
        assert math.isfinite(train[k]), k
    assert train["loss"] == pytest.approx(
        0.5 * (train["verb_loss"] + train["noun_loss"]), rel=1e-5)
    for k in ("val_verb_top1_acc", "val_noun_top5_acc", "val_top1_acc",
              "val_max_top5_acc"):
        assert 0.0 <= train[k] <= 100.0, k
    for k in ("verb", "noun", "action"):
        assert 0.0 <= float(test[f"{k}_top1_acc"]) <= float(
            test[f"{k}_top5_acc"]) <= 100.0
    with open(tmp_path / "results.pkl", "rb") as f:
        res = pickle.load(f)
    assert set(res) == {"verb", "noun"}
    assert res["verb"].shape == (64, 97) and res["noun"].shape == (64, 300)
