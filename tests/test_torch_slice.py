"""Slice 1 of the PyTorch port end to end against the JAX package: the
zero-shot step-classification eval step, the multi-view TestMeter, and the
port's ``test_net`` entry point on the CPU.

Eval step: uint8 frames, the real 778 x 512 COIN step bank, depth 2, width
128, 2 heads, T = 4, 32^2 crops, fp32; the JAX model runs both attention
kernels in interpret mode.  Tolerance on the post-softmax predictions: fp32,
atol = rtol = 2e-5 (the repository's parity tolerance).
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procedurevrl_tpu.config import get_cfg as jax_get_cfg
from procedurevrl_tpu.engine.steps import make_eval_step as jax_make_eval_step
from procedurevrl_tpu.models.build import load_embedding_bank, normalize_bank
from procedurevrl_tpu.models.procedurevrl import ProcedureVRL as JaxProcedureVRL
from procedurevrl_tpu.utils.meters import TestMeter as JaxTestMeter
from procedurevrl_torch.config import get_cfg, load_config
from procedurevrl_torch.engine.steps import make_eval_step
from procedurevrl_torch.models.procedurevrl import ProcedureVRL
from procedurevrl_torch.tools.test_net import test as port_test
from procedurevrl_torch.utils.meters import TestMeter
from procedurevrl_torch.utils.weights import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANK = os.path.join(ROOT, "data", "clip_step_emb_coin.pth")
TOL = dict(atol=2e-5, rtol=2e-5)
GEOM = dict(img_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=2,
            num_frames=4, drop_path_rate=0.0)


def test_eval_step_matches_jax(monkeypatch):
    monkeypatch.setenv("PALLAS_MIN_LEN", "1")
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, (2, 4, 32, 32, 3)).astype(np.uint8)
    bank = normalize_bank(load_embedding_bank(BANK))
    assert bank.shape == (778, 512)

    jmodel = JaxProcedureVRL(**GEOM, num_classes=778, label_dim=512,
                             match_lang_emb=True, use_pallas=True)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros(frames.shape), label_emb=bank)["params"]
    params = jax.tree_util.tree_map(
        lambda s: (0.05 * rng.randn(*s.shape)).astype(np.float32), shapes)
    ref = np.asarray(jax_make_eval_step(jmodel, jax_get_cfg(), bank)(
        {"params": params}, {"frames": jnp.asarray(frames)}))

    model = ProcedureVRL(**GEOM).eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    preds = make_eval_step(model, get_cfg(), torch.from_numpy(bank))(
        {"frames": torch.from_numpy(frames)})
    assert preds.dtype == torch.float32 and preds.shape == (2, 778)
    np.testing.assert_allclose(preds.numpy(), ref, **TOL)
    np.testing.assert_allclose(preds.sum(1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("method", ["sum", "max"])
def test_test_meter_matches_jax(method):
    rng = np.random.RandomState(1)
    videos, clips, classes = 10, 3, 20
    meters = [cls(videos, clips, classes, 2, ensemble_method=method)
              for cls in (TestMeter, JaxTestMeter)]
    order = rng.permutation(videos * clips)
    preds = rng.rand(videos * clips, classes).astype(np.float32)
    labels = (np.arange(videos * clips) // clips) % 7 + 1
    for part in np.array_split(order, 2):
        for m in meters:
            m.update_stats(preds[part], labels[part], part)
    stats = [m.finalize_metrics() for m in meters]
    assert stats[0] == stats[1]
    np.testing.assert_array_equal(meters[0].video_preds, meters[1].video_preds)
    np.testing.assert_array_equal(meters[0].video_labels,
                                  meters[1].video_labels)


def test_test_net_runs_on_cpu(tmp_path):
    """The entry point itself, tiny geometry, synthetic data, plain path."""
    cfg = load_config(os.path.join(ROOT, "configs/COIN/step_classification.yaml"),
                      ["TRAIN.ENABLE", "False", "DEV.MATCH_LANG_EMB", "True",
                       "DEV.LOAD_DUMMY_DATA", "True", "DEV.TEST_LANG_EMB", BANK,
                       "TIMESFORMER.DEPTH", "1", "DATA.NUM_FRAMES", "2",
                       "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
                       "TEST.NUM_ENSEMBLE_VIEWS", "2", "TEST.BATCH_SIZE", "24",
                       "TPU.COMPUTE_DTYPE", "bfloat16",
                       "OUTPUT_DIR", str(tmp_path)])
    stats = port_test(cfg, device="cpu")
    for key in ("top1_acc", "top5_acc"):
        assert math.isfinite(float(stats[key]))
    assert 0.0 <= float(stats["top1_acc"]) <= float(stats["top5_acc"]) <= 100.0
    # 128 clips in batches of 24: 6 batches, the first untimed
    assert stats["clips_per_sec"] > 0
