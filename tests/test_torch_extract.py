"""The two extract tools of the PyTorch port against the JAX package's on
the CPU.

- ``emb_extract``: a seeded OpenAI-layout CLIP state dict (2 layers,
  width 64 in one head of 64, projection to 32, a ``visual.*`` tensor and
  ``logit_scale`` that the text tower leaves) saved by ``torch.save`` and a
  written BPE merges file; the port's bank and JAX ``get_step_emb``'s on
  the same files and steps, fp32 2e-5, and the ``.npy`` / ``.pth`` files
  each writes.
- ``feat_extract``: the zero-shot COIN step classification configuration
  at width 128 in 2 heads, depth 1, T = 4, 32^2 crops, float32, 64 dummy
  videos x 1 view in batches of 48 (the last one padded), both from one
  checkpoint the port wrote; the pickles of the port's ``extract`` and
  JAX's agree (predictions fp32 2e-5, labels and indices equal), and the
  port's per-view predictions summed per video are its ``test_net``'s
  ensembled predictions.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from procedurevrl_tpu.config import get_cfg as jax_get_cfg
from procedurevrl_tpu.models import procedurevrl as jax_models
from procedurevrl_torch.config import load_config
from procedurevrl_torch.models import procedurevrl as port_models
from procedurevrl_torch.models.build import build_model
from procedurevrl_torch.solver.optimizer import construct_optimizer
from procedurevrl_torch.tools import emb_extract, feat_extract
from procedurevrl_torch.tools.test_net import test as port_test
from procedurevrl_torch.utils import checkpoint as cu

from test_torch_data_units import _write_merges

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
BANK = os.path.join(ROOT, "data", "clip_step_emb_coin.pth")
CFG = os.path.join(ROOT, "configs/COIN/step_classification.yaml")
TOL = dict(atol=2e-5, rtol=2e-5)
STEPS = ["hello the cut", "cut it", "open the lid and pour water in",
         "naïve café"]


def _clip_state(seed=0, width=64, layers=2, embed=32, vocab=49408):
    """An OpenAI CLIP state dict with seeded weights: the text tower, a
    visual tensor and ``logit_scale``."""
    g = torch.Generator().manual_seed(seed)

    def n(*shape, std=0.02):
        return torch.randn(*shape, generator=g) * std

    sd = {"token_embedding.weight": n(vocab, width),
          "positional_embedding": n(77, width, std=0.01),
          "text_projection": n(width, embed, std=width ** -0.5),
          "ln_final.weight": 1 + n(width), "ln_final.bias": n(width),
          "logit_scale": torch.tensor(4.6), "visual.proj": n(width, embed)}
    for i in range(layers):
        p = f"transformer.resblocks.{i}."
        sd.update({p + "attn.in_proj_weight": n(3 * width, width),
                   p + "attn.in_proj_bias": n(3 * width),
                   p + "attn.out_proj.weight": n(width, width),
                   p + "attn.out_proj.bias": n(width),
                   p + "ln_1.weight": 1 + n(width), p + "ln_1.bias": n(width),
                   p + "ln_2.weight": 1 + n(width), p + "ln_2.bias": n(width),
                   p + "mlp.c_fc.weight": n(4 * width, width),
                   p + "mlp.c_fc.bias": n(4 * width),
                   p + "mlp.c_proj.weight": n(width, 4 * width),
                   p + "mlp.c_proj.bias": n(width)})
    return sd


def test_emb_extract_matches_jax(tmp_path):
    from tools.emb_extract import get_step_emb as jax_get_step_emb

    ckpt = str(tmp_path / "clip.pt")
    torch.save(_clip_state(), ckpt)
    bpe = _write_merges(tmp_path / "merges.txt.gz")
    steps = tmp_path / "steps.txt"
    steps.write_text("\n".join(STEPS) + "\n\n")
    out = str(tmp_path / "port" / "bank.pth")
    os.makedirs(tmp_path / "port")
    assert emb_extract.main(["--steps", str(steps), "--out", out,
                             "--clip_ckpt", ckpt, "--bpe", bpe,
                             "--device", "cpu"]) == 0
    os.makedirs(tmp_path / "jax")
    want = jax_get_step_emb(STEPS, str(tmp_path / "jax" / "bank.pth"), ckpt,
                            bpe)
    got = np.load(str(tmp_path / "port" / "bank.npy"))
    assert got.shape == (len(STEPS), 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    saved = torch.load(out)
    assert torch.equal(saved, torch.from_numpy(got))
    assert emb_extract.PROMPTS == __import__(
        "tools.emb_extract", fromlist=["PROMPTS"]).PROMPTS
    with pytest.raises(FileNotFoundError):
        emb_extract.get_step_emb(STEPS, out, ckpt, "", "cpu")


WIDTH, HEADS = 128, 2
OPTS = ["TRAIN.ENABLE", "False", "DEV.MATCH_LANG_EMB", "True",
        "DEV.LOAD_DUMMY_DATA", "True", "DEV.TEST_LANG_EMB", BANK,
        "TIMESFORMER.DEPTH", "1", "DATA.NUM_FRAMES", "4",
        "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
        "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.BATCH_SIZE", "48",
        "TPU.COMPUTE_DTYPE", "float32", "DATA_LOADER.NUM_WORKERS", "2"]


class _Narrow(port_models.ProcedureVRL):
    def __init__(self, **kwargs):
        super().__init__(**{**kwargs, "embed_dim": WIDTH,
                            "num_heads": HEADS})


def test_feat_extract_matches_jax_and_test_net(monkeypatch, tmp_path):
    from tools.feat_extract import extract as jax_extract

    monkeypatch.setattr(port_models, "ProcedureVRL", _Narrow)
    wide = jax_models.ProcedureVRL
    monkeypatch.setattr(jax_models, "ProcedureVRL", lambda **kw: wide(
        **{**kw, "embed_dim": WIDTH, "num_heads": HEADS}))
    cfg = load_config(CFG, OPTS + ["RNG_SEED", "7", "TRAIN.LINEAR", "False",
                                   "OUTPUT_DIR", str(tmp_path / "w")])
    model = build_model(cfg, "cpu")[0]
    path = cu.save_checkpoint(cfg.OUTPUT_DIR, model,
                              construct_optimizer(model, cfg), cfg, 0, 1)
    opts = OPTS + ["TEST.CHECKPOINT_FILE_PATH", path]

    cfg = load_config(CFG, opts + ["OUTPUT_DIR", str(tmp_path / "port")])
    ours = feat_extract.extract(cfg, "cpu")
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(CFG)
    jcfg.merge_from_list(opts + ["OUTPUT_DIR", str(tmp_path / "jax")])
    jax_extract(jcfg)
    res = []
    for out in ("port", "jax"):
        with open(tmp_path / out / "features.pkl", "rb") as f:
            res.append(pickle.load(f))
    got, want = res
    assert set(got) == set(want) == {"preds", "labels", "index"}
    assert got["preds"].shape == (64, 778)
    np.testing.assert_allclose(got["preds"], want["preds"], **TOL)
    for k in ("labels", "index"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in got:
        np.testing.assert_array_equal(got[k], ours[k])

    cfg = load_config(CFG, opts + ["OUTPUT_DIR", str(tmp_path / "test"),
                                   "TEST.SAVE_RESULTS_PATH", "results.pkl"])
    port_test(cfg, "cpu")
    with open(tmp_path / "test" / "results.pkl", "rb") as f:
        tested = pickle.load(f)
    per_video = np.zeros_like(tested["preds"])
    np.add.at(per_video, got["index"] // 1, got["preds"])
    np.testing.assert_allclose(per_video, tested["preds"], **TOL)
