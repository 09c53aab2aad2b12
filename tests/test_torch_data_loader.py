"""The HowTo100M / COIN dataset and the loader of the PyTorch port against
the JAX package on the CPU, and the port's ``train`` / ``test`` on decoded
files.

``Howto100mDevelop.__getitem__`` in every mode (order pretraining,
single-clip pretraining, finetune train and val, the multi-view test,
``DATA.FIX_END`` forecasting), on the ``synthetic://`` index and on clips
written by ``cv2.VideoWriter`` under a temporary ``DATA.PATH_PREFIX``
(with per-video ASR CSVs, one with an empty text field, CLIP feature
files, a BPE merges file, and a row whose file does not decode, which
resamples); then ``construct_loader``'s batches (train at epochs 0 and 1,
val with its padded last batch and ``n_valid``, test), with
``TPU.HOST_UINT8`` True and False.  Every comparison is bit for bit.
Geometry: 2 frames, 32^2 crops from scale jitter [36, 40], 64x48 clips of
12 s at 30 fps, 2 loader threads.
"""

import math
import os
import threading
import time

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from procedurevrl_tpu.config import get_cfg as jax_get_cfg
from procedurevrl_tpu.datasets.build import build_dataset as jax_build_dataset
from procedurevrl_tpu.datasets.loader import construct_loader as jax_construct_loader
from procedurevrl_torch.config import load_config
from procedurevrl_torch.datasets import howto100m
from procedurevrl_torch.datasets.build import build_dataset
from procedurevrl_torch.datasets.loader import (
    construct_loader, prefetch_to_device, shuffle_dataset,
)
from procedurevrl_torch.tools.test_net import test as port_test
from procedurevrl_torch.tools.train_net import train

from test_torch_data_units import _write_merges

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANK = os.path.join(ROOT, "data", "clip_step_emb_coin.pth")
PRETRAIN = "configs/HowTo100M/procedurevrl_adamw.yaml"
STEP_CLS = "configs/COIN/step_classification.yaml"
FORECAST = "configs/COIN/step_forecasting.yaml"
SMALL = ["DATA.NUM_FRAMES", "2", "DATA.TRAIN_CROP_SIZE", "32",
         "DATA.TEST_CROP_SIZE", "32", "DATA.TRAIN_JITTER_SCALES", "[36, 40]",
         "DATA_LOADER.NUM_WORKERS", "2"]
DUMMY = ["DEV.LOAD_DUMMY_DATA", "True"] + SMALL
FPS, W, H, DUR = 30.0, 64, 48, 12
N_CLIPS = 3


def _cfgs(path, opts):
    """The port's and the JAX package's config of ``path`` + ``opts``."""
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(os.path.join(ROOT, path))
    jcfg.merge_from_list(list(opts))
    return load_config(os.path.join(ROOT, path), list(opts)), jcfg


def _same_sample(a, b):
    frames, label, index, meta = a
    assert frames.dtype == b[0].dtype and frames.shape == b[0].shape
    np.testing.assert_array_equal(frames, b[0])
    assert (label, index) == (b[1], b[2])
    assert set(meta) == set(b[3])
    for k in meta:
        np.testing.assert_array_equal(meta[k], b[3][k], err_msg=k)
        assert np.asarray(meta[k]).dtype == np.asarray(b[3][k]).dtype, k


def _same_samples(path, opts, split, indices, epochs=(0,)):
    cfg, jcfg = _cfgs(path, opts)
    ours = build_dataset(cfg.TRAIN.DATASET, cfg, split)
    theirs = jax_build_dataset(jcfg.TRAIN.DATASET, jcfg, split)
    assert len(ours) == len(theirs)
    for epoch in epochs:
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in indices:
            _same_sample(ours[i], theirs[i])
    return ours


@pytest.mark.parametrize("mode", [
    "order_pretrain", "clip_pretrain", "finetune_train", "finetune_val",
    "multi_view_test", "fix_end_test", "fix_end_train"])
def test_getitem_on_the_synthetic_index(mode):
    """Every mode of ``__getitem__`` on the ``DEV.LOAD_DUMMY_DATA`` index:
    frames, label, index and the pretraining meta (token ids, CLIP
    features) equal JAX's; train draws move with the epoch."""
    path, split, opts = {
        "order_pretrain": (PRETRAIN, "train", ()),
        "clip_pretrain": (PRETRAIN, "train",
                          ("DEV.ORDER_PRETRAIN_ENABLED", "False",
                           "MODEL.MIN_LEN", "6")),
        "finetune_train": (STEP_CLS, "train", ("TRAIN.EPOCH_MUL", "2")),
        "finetune_val": (STEP_CLS, "val", ("TPU.HOST_UINT8", "False")),
        "multi_view_test": (STEP_CLS, "test",
                            ("TEST.NUM_ENSEMBLE_VIEWS", "2",
                             "TEST.NUM_SPATIAL_CROPS", "3")),
        "fix_end_test": (FORECAST, "test", ("TEST.NUM_ENSEMBLE_VIEWS", "1")),
        "fix_end_train": (FORECAST, "train", ()),
    }[mode]
    ds = _same_samples(path, DUMMY + list(opts), split, (0, 5, 127 % 64 + 64
                       if mode == "finetune_train" else 63),
                       epochs=(0, 1) if split == "train" else (0,))
    ds.set_epoch(0)
    frames, _, _, meta = ds[0]
    if mode == "order_pretrain":
        assert frames.shape == (9, 2, 32, 32, 3) and ds.clips == 9
        assert meta["clip_text_ids"].shape == (9, 77)
        assert meta["clip_vis_feat"].shape == (9, 512)
        assert 0 < meta["clip_text_ids"].max() < 49408
        ds.set_epoch(1)
        assert not np.array_equal(ds[0][0], frames)
    elif mode.startswith("fix_end"):
        assert frames.shape == (16, 32, 32, 3) and ds.clips == 8


def _write_video(path: str, seed: int) -> None:
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), FPS, (W, H))
    ramp = np.arange(W, dtype=np.int64)[None, :, None]
    for i in range(int(FPS * DUR)):
        img = ((ramp * (seed + 2) + i) % 256).astype(np.uint8)
        w.write(np.broadcast_to(img, (H, W, 3)).copy())
    w.release()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Clips, CSV indexes (windowed for COIN, 3-column for pretraining, a
    row whose file does not decode in train), ASR CSVs, CLIP features, a
    merges file."""
    d = tmp_path_factory.mktemp("howto100m")
    for i in range(N_CLIPS):
        _write_video(str(d / f"clip{i}.mp4"), i)
    (d / "broken.mp4").write_bytes(b"not a video")
    windowed = [f"clip{i} {i} {DUR} {2 + i} {8 + i}" for i in range(N_CLIPS)]
    for split in ("train", "val", "test"):
        os.makedirs(d / "coin", exist_ok=True)
        rows = windowed + (["broken 1 12 2 10"] if split == "train" else [])
        (d / "coin" / f"{split}.csv").write_text("\n".join(rows) + "\n")
    os.makedirs(d / "ht", exist_ok=True)
    (d / "ht" / "train.csv").write_text("\n".join(
        f"clip{i} 0 {DUR}" for i in range(N_CLIPS)) + "\n")
    os.makedirs(d / "asr", exist_ok=True)
    # clip0: integer times; clip1: float times and an empty text field;
    # clip2: a quoted field with a comma, and an NA string
    (d / "asr" / "clip0.csv").write_text(
        "start,end,text\n" + "".join(f"{s},{s + 2},step {s} of the cut\n"
                                     for s in range(0, 12, 2)))
    (d / "asr" / "clip1.csv").write_text(
        "start,end,text\n0.5,2.5,hello there\n2.5,4.0,\n4.0,6.5,the cut\n"
        "6.5,9.0,cut it\n9.0,11.5,done\n")
    (d / "asr" / "clip2.csv").write_text(
        "start,end,text\n0,3,\"one, two\"\n3,6,NA\n6,9,three\n9,12,four\n")
    os.makedirs(d / "feat", exist_ok=True)
    for i in range(N_CLIPS):
        r = np.random.RandomState(i)
        torch.save({"mid_time": list(range(DUR + 1)),
                    "clip_instances": [r.randn(512).astype(np.float32)
                                       for _ in range(DUR + 1)]},
                   str(d / "feat" / f"clip{i}.pth"))
    return {"dir": str(d), "bpe": _write_merges(d / "merges.txt.gz")}


def _real(files, *opts):
    d = files["dir"]
    return SMALL + ["DEV.LOAD_DUMMY_DATA", "False",
                    "DATA.PATH_TO_DATA_DIR", os.path.join(d, "coin"),
                    "DATA.PATH_PREFIX", d, "DATA.DECODING_BACKEND", "cv2",
                    *opts]


def _real_pretrain(files, *opts):
    d = files["dir"]
    return _real(files, "DATA.PATH_TO_DATA_DIR", os.path.join(d, "ht"),
                 "TRAIN.TEXT", os.path.join(d, "asr") + "/",
                 "DEV.CLIP_VIS_FEAT_PATH", os.path.join(d, "feat") + "/",
                 "DATA.BPE_PATH", files["bpe"], *opts)


@pytest.mark.parametrize("mode", [
    "order_pretrain", "clip_pretrain", "finetune_train", "multi_view_test",
    "fix_end_val"])
def test_getitem_on_written_clips(files, mode):
    """The same on decoded files through ``cv2``: the ASR tables (an empty
    text field, integer and float times, quoting, an NA string) read by
    the ``csv`` module as pandas reads them, BPE token ids, CLIP features
    from files; in train the undecodable row resamples as JAX does."""
    path, split, opts = {
        "order_pretrain": (PRETRAIN, "train", _real_pretrain(
            files, "DEV.ORDER_PRETRAIN_MAX_LEN", "4", "MODEL.MIN_LEN", "5")),
        "clip_pretrain": (PRETRAIN, "train", _real_pretrain(
            files, "DEV.ORDER_PRETRAIN_ENABLED", "False")),
        "finetune_train": (STEP_CLS, "train", _real(files)),
        "multi_view_test": (STEP_CLS, "test", _real(
            files, "TEST.NUM_ENSEMBLE_VIEWS", "2", "TEST.NUM_SPATIAL_CROPS",
            "3", "TPU.HOST_UINT8", "False")),
        "fix_end_val": (FORECAST, "val", _real(files)),
    }[mode]
    cfg, _ = _cfgs(path, opts)
    n = len(build_dataset(cfg.TRAIN.DATASET, cfg, split))
    ds = _same_samples(path, opts, split, range(n),
                       epochs=(0, 1) if split == "train" else (0,))
    if mode == "finetune_train":
        assert n == N_CLIPS + 1
        # the undecodable row's sample comes from another video
        assert ds[N_CLIPS][2] != N_CLIPS
    if mode == "order_pretrain":
        _, _, _, meta = ds[1]
        assert meta["clip_text_ids"].shape == (4, 77)
        assert meta["clip_vis_feat"].shape == (4, 512)
        assert np.abs(meta["clip_vis_feat"]).sum() > 0  # read, not zeros


def test_asr_table_reads_as_pandas(files):
    import pandas as pd

    for i in range(N_CLIPS):
        path = os.path.join(files["dir"], "asr", f"clip{i}.csv")
        ours, theirs = howto100m.AsrTable.read(path), pd.read_csv(path)
        assert len(ours) == len(theirs)
        for col in ("start", "end"):
            assert ours.__dict__[col].dtype == theirs[col].values.dtype
            np.testing.assert_array_equal(ours.__dict__[col],
                                          theirs[col].values)
        for a, b in zip(ours.text, theirs["text"].values):
            assert isinstance(a, str) == isinstance(b, str)
            assert a == b or not isinstance(a, str)


def _same_batches(path, opts, split, epochs=(0,)):
    cfg, jcfg = _cfgs(path, opts)
    ours, theirs = construct_loader(cfg, split), jax_construct_loader(
        jcfg, split)
    assert len(ours) == len(theirs) > 0
    valid = []
    for epoch in epochs:
        shuffle_dataset(ours, epoch)
        theirs.set_epoch(epoch)
        n = 0
        for (a, na, ea), (b, nb, eb) in zip(ours, theirs):
            assert na == nb and set(a) == set(b) and set(ea) == set(eb)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            valid.append(na)
            n += 1
        assert n == len(ours)
    return valid, cfg


@pytest.mark.parametrize("uint8", ["True", "False"])
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_loader_batches_on_the_synthetic_index(split, uint8):
    """``construct_loader``'s batches, bit for bit in every key: train at
    epochs 0 and 1 (order pretraining, 9 clips a sample), val (step
    classification: 64 videos in batches of 24, the last padded, n_valid
    16), test (forecasting, 2 views)."""
    path, opts, epochs = {
        "train": (PRETRAIN, ["TRAIN.BATCH_SIZE", "16"], (0, 1)),
        "val": (STEP_CLS, ["TRAIN.BATCH_SIZE", "24"], (0,)),
        "test": (FORECAST, ["TEST.BATCH_SIZE", "48",
                            "TEST.NUM_ENSEMBLE_VIEWS", "2"], (0,)),
    }[split]
    valid, _ = _same_batches(path, DUMMY + opts + ["TPU.HOST_UINT8", uint8],
                             split, epochs)
    assert valid == {"train": [16] * 8, "val": [24, 24, 16],
                     "test": [48, 48, 32]}[split]


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_loader_batches_on_written_clips(files, split):
    valid, _ = _same_batches(STEP_CLS, _real(
        files, "TRAIN.BATCH_SIZE", "2", "TEST.BATCH_SIZE", "4",
        "TEST.NUM_ENSEMBLE_VIEWS", "2", "TPU.HOST_UINT8",
        str(split != "val")), split, (0, 1) if split == "train" else (0,))
    assert valid == {"train": [2, 2] * 2, "val": [2, 1],
                     "test": [4, 2]}[split]


def test_prefetch_on_the_cpu_shares_the_host_arrays():
    """On the CPU the device batch is the host arrays without a copy;
    closing the generator early stops the loader's producer thread."""
    cfg = load_config(os.path.join(ROOT, STEP_CLS),
                      DUMMY + ["TEST.BATCH_SIZE", "40",
                               "TEST.NUM_ENSEMBLE_VIEWS", "1"])
    loader = construct_loader(cfg, "test")
    before = threading.active_count()
    gen = prefetch_to_device(loader, "cpu", size=2)
    dev, n_valid, extra, host = next(gen)
    assert n_valid == 40 and extra == {}
    assert set(dev) == set(host) == {"frames", "index", "labels"}
    for k, t in dev.items():
        assert t.device.type == "cpu"
        assert t.data_ptr() == host[k].ctypes.data
    gen.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    batches = list(prefetch_to_device(loader, "cpu", size=1))
    assert [b[1] for b in batches] == [40, 24]
    np.testing.assert_array_equal(batches[0][0]["frames"].numpy(),
                                  dev["frames"].numpy())


def test_loader_refusals():
    cfg = load_config(os.path.join(ROOT, STEP_CLS), DUMMY)
    cfg.MULTIGRID.SHORT_CYCLE = True
    with pytest.raises(NotImplementedError, match="MULTIGRID.SHORT_CYCLE"):
        construct_loader(cfg, "train")
    cfg.MULTIGRID.SHORT_CYCLE = False
    cfg.TRAIN.DATASET = "kinetics"
    with pytest.raises(KeyError, match="Kinetics"):
        construct_loader(cfg, "train")
    with pytest.raises(ValueError, match="split"):
        construct_loader(cfg, "dev")


def test_train_and_test_on_written_clips(files, tmp_path):
    """``DEV.LOAD_DUMMY_DATA False``: the port's ``train`` takes 2 steps
    and its val epoch on clips decoded through ``cv2``, then ``test``
    ensembles 2 views a clip; no ``NotImplementedError``."""
    opts = _real(files, "TIMESFORMER.DEPTH", "1", "DEV.ORDER_TFM_LAYERS",
                 "1", "TRAIN.BATCH_SIZE", "2", "GLOBAL_BATCH_SIZE", "2",
                 "TEST.BATCH_SIZE", "4", "TEST.NUM_ENSEMBLE_VIEWS", "2",
                 "TRAIN.EVAL_PERIOD", "1", "MODEL.NUM_CLASSES", "778",
                 "OUTPUT_DIR", str(tmp_path))
    cfg = load_config(os.path.join(ROOT, STEP_CLS), opts)
    stats = train(cfg, device="cpu", max_steps=2)
    assert stats["steps"] == 2 and len(stats["val"]) == 1
    assert all(math.isfinite(h["loss"]) for h in stats["history"])
    tcfg = load_config(os.path.join(ROOT, STEP_CLS), opts + [
        "TRAIN.ENABLE", "False", "DEV.MATCH_LANG_EMB", "True",
        "DEV.TEST_LANG_EMB", BANK])
    tstats = port_test(tcfg, device="cpu")
    assert 0.0 <= float(tstats["top1_acc"]) <= float(tstats["top5_acc"])
