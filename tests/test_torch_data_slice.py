"""The host data pipeline as a whole: the port's ``test_net.test`` and JAX
``tools/test_net.py:test`` on the same dummy COIN test split from one
checkpoint the port wrote.

Geometry of ``tests/test_torch_slice.py``: the zero-shot step
classification configuration at depth 2, width 128 in 2 heads, T = 4,
32^2 crops, float32, the real 778-step bank; 64 videos x 2 views in
batches of 48 (the last one padded, 32 valid).  Both load the file through
``TEST.CHECKPOINT_FILE_PATH``; the sequence of 5 tokens is under
``PALLAS_MIN_LEN``, so JAX takes its XLA attention and the port its plain
path.  The ``TEST.SAVE_RESULTS_PATH`` predictions agree at fp32 atol =
rtol = 2e-5 and top-1 / top-5 are equal.
"""

import os
import pickle
import sys

import numpy as np
import pytest

from procedurevrl_tpu.config import get_cfg as jax_get_cfg
from procedurevrl_tpu.models import procedurevrl as jax_models
from procedurevrl_torch.config import load_config
from procedurevrl_torch.models import procedurevrl as port_models
from procedurevrl_torch.models.build import build_model
from procedurevrl_torch.solver.optimizer import construct_optimizer
from procedurevrl_torch.tools.test_net import test as port_test
from procedurevrl_torch.utils import checkpoint as cu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
BANK = os.path.join(ROOT, "data", "clip_step_emb_coin.pth")
CFG = os.path.join(ROOT, "configs/COIN/step_classification.yaml")
TOL = dict(atol=2e-5, rtol=2e-5)
WIDTH, HEADS = 128, 2
OPTS = ["TRAIN.ENABLE", "False", "DEV.MATCH_LANG_EMB", "True",
        "DEV.LOAD_DUMMY_DATA", "True", "DEV.TEST_LANG_EMB", BANK,
        "TIMESFORMER.DEPTH", "2", "DATA.NUM_FRAMES", "4",
        "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
        "TEST.NUM_ENSEMBLE_VIEWS", "2", "TEST.BATCH_SIZE", "48",
        "TPU.COMPUTE_DTYPE", "float32", "DATA_LOADER.NUM_WORKERS", "2",
        "TEST.SAVE_RESULTS_PATH", "results.pkl"]


class _Narrow(port_models.ProcedureVRL):
    def __init__(self, **kwargs):
        super().__init__(**{**kwargs, "embed_dim": WIDTH,
                            "num_heads": HEADS})


@pytest.fixture
def narrow(monkeypatch):
    """Both packages' ``build_model`` TimeSformer at width 128 in 2
    heads."""
    monkeypatch.setattr(port_models, "ProcedureVRL", _Narrow)
    wide = jax_models.ProcedureVRL
    monkeypatch.setattr(jax_models, "ProcedureVRL", lambda **kw: wide(
        **{**kw, "embed_dim": WIDTH, "num_heads": HEADS}))


def test_jax_and_the_port_test_one_checkpoint_alike(narrow, tmp_path):
    from tools.test_net import test as jax_test

    # the writer trains the encoder (no linear probe), so that its
    # optimizer has parameters; the model is the test's
    cfg = load_config(CFG, OPTS + ["RNG_SEED", "7", "TRAIN.LINEAR", "False",
                                   "OUTPUT_DIR", str(tmp_path / "w")])
    model = build_model(cfg, "cpu")[0]
    path = cu.save_checkpoint(cfg.OUTPUT_DIR, model,
                              construct_optimizer(model, cfg), cfg, 0, 1)

    cfg = load_config(CFG, OPTS + ["TEST.CHECKPOINT_FILE_PATH", path,
                                   "OUTPUT_DIR", str(tmp_path / "port")])
    ours = port_test(cfg, device="cpu")
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(CFG)
    jcfg.merge_from_list(OPTS + ["TEST.CHECKPOINT_FILE_PATH", path,
                                 "OUTPUT_DIR", str(tmp_path / "jax")])
    theirs = jax_test(jcfg)

    res = []
    for out in ("port", "jax"):
        with open(tmp_path / out / "results.pkl", "rb") as f:
            res.append(pickle.load(f))
    assert res[0]["preds"].shape == (64, 778)
    np.testing.assert_array_equal(res[0]["labels"], res[1]["labels"])
    np.testing.assert_allclose(res[0]["preds"], res[1]["preds"], **TOL)
    assert (ours["top1_acc"], ours["top5_acc"]) == (theirs["top1_acc"],
                                                    theirs["top5_acc"])
