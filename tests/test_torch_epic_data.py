"""The EPIC-Kitchens dataset and RandAugment of the PyTorch port against the
JAX package on the CPU, bit for bit.

- Each RandAugment op on a seeded clip with the level the same
  ``RandomState`` draws, and the whole policy (``rand-m9-n2-mstd0.5`` and
  others parsed by ``from_config_str``) on clips of several seeds.
- ``Epickitchens.__getitem__`` in train (RandAugment, colour jitter and
  grayscale on, two epochs), val and test (the view's crop of
  ``NUM_ENSEMBLE_VIEWS x NUM_SPATIAL_CROPS`` records) on three inputs: the
  dummy split (seeded 256x456 frames for the missing video), a tree in
  ``tmp_path`` (a pickled DataFrame of segments of two ``cv2``-written
  MP4s, one of each frame-rate rule, decoded by ``cv2``), and the same
  tree's ``rgb_frames`` JPGs (``DEV.EPIC_USE_FRAME_LOADER``).
- ``construct_loader``'s batches of the tree in every split.
- The refusals: a missing JPG, an unreadable list, an empty split.

Geometry: 2 frames (4 on the tree), 32^2 crops from scale jitter [36, 40],
64x48 videos of 6 s; 2 loader threads.
"""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pd = pytest.importorskip("pandas")
pytest.importorskip("PIL")

from procedurevrl_tpu.config import get_cfg as jax_get_cfg
from procedurevrl_tpu.datasets import rand_augment as jax_ra
from procedurevrl_tpu.datasets.build import build_dataset as jax_build_dataset
from procedurevrl_tpu.datasets.loader import construct_loader as jax_construct_loader
from procedurevrl_torch.config import load_config
from procedurevrl_torch.datasets import rand_augment as ra
from procedurevrl_torch.datasets.build import build_dataset
from procedurevrl_torch.datasets.epickitchens import timestamp_to_sec
from procedurevrl_torch.datasets.loader import construct_loader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EK = os.path.join(ROOT, "configs/EK/egocentric_action_classification.yaml")
SMALL = ["DATA.NUM_FRAMES", "2", "DATA.TRAIN_CROP_SIZE", "32",
         "DATA.TEST_CROP_SIZE", "32", "DATA.TRAIN_JITTER_SCALES", "[36, 40]",
         "DATA_LOADER.NUM_WORKERS", "2", "TRAIN.BATCH_SIZE", "4",
         "TEST.BATCH_SIZE", "4", "TEST.NUM_ENSEMBLE_VIEWS", "2",
         "TEST.NUM_SPATIAL_CROPS", "3", "DATA.COLORJITTER", "True",
         "DATA.GRAYSCALE", "True"]
W, H, DUR = 64, 48, 6
# (video, fps): a three-digit id is EPIC-100's 50 fps, a two-digit one 60
VIDEOS = (("P01_101", 50), ("P02_03", 60))


def _cfgs(*opts):
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(EK)
    jcfg.merge_from_list(list(opts))
    return load_config(EK, list(opts)), jcfg


def _clip(seed, t=3, h=24, w=40):
    return np.random.RandomState(seed).randint(0, 256, (t, h, w, 3)).astype(
        np.uint8)


@pytest.mark.parametrize("name", list(ra.OPS))
def test_each_rand_augment_op_matches_jax(name):
    assert list(ra.OPS) == list(jax_ra._OPS)
    fn, level = ra.OPS[name]
    jfn, jlevel = jax_ra._OPS[name]
    from PIL import Image

    for seed in range(3):
        a, b = (np.random.RandomState(seed) for _ in range(2))
        arg = level(7.3, a) if level else None
        jarg = jlevel(7.3, b) if jlevel else None
        assert arg == jarg
        img = Image.fromarray(_clip(seed)[0])
        np.testing.assert_array_equal(np.asarray(fn(img, arg)),
                                      np.asarray(jfn(img, jarg)))


@pytest.mark.parametrize("policy", ["rand-m9-n2-mstd0.5", "rand-m5-n3",
                                    "rand-mstd0-m10-n1"])
def test_rand_augment_policy_matches_jax(policy):
    ours = ra.RandAugment.from_config_str(policy)
    theirs = jax_ra.RandAugment.from_config_str(policy)
    assert (ours.magnitude, ours.num_layers, ours.magnitude_std) == (
        theirs.magnitude, theirs.num_layers, theirs.magnitude_std)
    for seed in range(6):
        clip = _clip(seed)
        got = ours(clip, np.random.RandomState(seed))
        assert got.dtype == np.uint8 and got.shape == clip.shape
        np.testing.assert_array_equal(
            got, theirs(clip, np.random.RandomState(seed)))


def _same_item(a, b):
    assert a[0].dtype == b[0].dtype == np.float32
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1] and a[2] == b[2] and a[3] == b[3]


def _same_items(opts, split, indices, epochs=(0,)):
    cfg, jcfg = _cfgs(*opts)
    ours = build_dataset("Epickitchens", cfg, split)
    theirs = jax_build_dataset("Epickitchens", jcfg, split)
    assert len(ours) == len(theirs)
    for epoch in epochs:
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in indices:
            _same_item(ours[i], theirs[i])
    return ours


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_dummy_split_items_match_jax(split):
    ds = _same_items(["DEV.LOAD_DUMMY_DATA", "True", *SMALL], split,
                     [0, 5, 63], epochs=(0, 1) if split == "train" else (0,))
    assert len(ds) == 64 * (6 if split == "test" else 1)
    frames, label, index, meta = ds[7]
    assert frames.shape == (2, 32, 32, 3)
    assert label == {"verb": 7 % 97, "noun": 7 % 300} or split == "test"
    assert meta == {"narration_id": str(7 // (6 if split == "test" else 1))}


def _write_video(path, fps, seed):
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
    assert w.isOpened()
    ramp = np.arange(W, dtype=np.int64)[None, :, None]
    for i in range(int(fps * DUR)):
        img = ((ramp * (seed + 2) + 3 * i) % 256).astype(np.uint8)
        w.write(np.broadcast_to(img, (H, W, 3)).copy())
    w.release()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """``<root>/<participant>/videos/<video>.MP4`` and
    ``<root>/<participant>/rgb_frames/<video>/frame_{i:010d}.jpg`` for two
    videos, and annotation pickles of 5 segments each (an empty list, a
    list that is not a pickle)."""
    d = tmp_path_factory.mktemp("epic")
    rows = []
    for v, (video, fps) in enumerate(VIDEOS):
        person = video.split("_")[0]
        os.makedirs(d / person / "videos", exist_ok=True)
        _write_video(str(d / person / "videos" / f"{video}.MP4"), fps, v)
        frames = d / person / "rgb_frames" / video
        os.makedirs(frames)
        for i in range(fps * DUR):
            img = np.full((H, W, 3), (v * 40 + i) % 256, np.uint8)
            img[:, : W // 2, 1] = (i * 7) % 256
            cv2.imwrite(str(frames / f"frame_{i + 1:010d}.jpg"), img)
        for s in range(5):
            start = 0.3 + s * 1.0
            rows.append({"participant_id": person, "video_id": video,
                         "start_timestamp": "00:00:%05.2f" % start,
                         "stop_timestamp": "00:00:%05.2f" % (start + 0.9),
                         "verb_class": 3 * s + v, "noun_class": 11 * s + v})
    df = pd.DataFrame(rows, index=[f"n{i}" for i in range(len(rows))])
    os.makedirs(d / "ann")
    df.to_pickle(str(d / "ann" / "train.pkl"))
    df.iloc[:7].to_pickle(str(d / "ann" / "val.pkl"))
    df.iloc[:0].to_pickle(str(d / "ann" / "empty.pkl"))
    (d / "ann" / "broken.pkl").write_bytes(b"not a pickle")
    return str(d)


def _real(tree, *opts):
    return [*SMALL, "DEV.LOAD_DUMMY_DATA", "False", "DATA.NUM_FRAMES", "4",
            "EPICKITCHENS.VISUAL_DATA_DIR", tree,
            "EPICKITCHENS.ANNOTATIONS_DIR", os.path.join(tree, "ann"),
            "EPICKITCHENS.TRAIN_LIST", "train.pkl",
            "EPICKITCHENS.VAL_LIST", "val.pkl",
            "EPICKITCHENS.TEST_LIST", "val.pkl",
            "DATA.DECODING_BACKEND", "cv2", *opts]


@pytest.mark.parametrize("loader", ["decode", "frames"])
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_tree_items_match_jax(tree, split, loader):
    opts = _real(tree, "DEV.EPIC_USE_FRAME_LOADER",
                 str(loader == "frames"))
    ds = _same_items(opts, split, range(0, 10 if split == "train" else 7, 2),
                     epochs=(0, 1) if split == "train" else (0,))
    frames, label, _, meta = ds[1 if split != "test" else 6]
    assert frames.shape == (4, 32, 32, 3)
    assert label == {"verb": 3, "noun": 11} and meta == {"narration_id": "n1"}


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_tree_loader_batches_match_jax(tree, split):
    cfg, jcfg = _cfgs(*_real(tree))
    ours, theirs = construct_loader(cfg, split), jax_construct_loader(
        jcfg, split)
    assert len(ours) == len(theirs) > 0
    n = 0
    for (a, na, ea), (b, nb, eb) in zip(ours, theirs):
        assert na == nb and set(a) == set(b) == {"frames", "verb", "noun",
                                                 "index"}
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert ea == eb
        n += 1
    assert n == len(ours)


def test_refusals(tree):
    """A missing frame, a list that does not read and an empty split
    raise; a test list without classes labels -1."""
    cfg, _ = _cfgs(*_real(tree, "DEV.EPIC_USE_FRAME_LOADER", "True"))
    ds = build_dataset("Epickitchens", cfg, "val")
    missing = os.path.join(tree, "P02", "rgb_frames", "P02_03",
                           "frame_0000000042.jpg")
    os.rename(missing, missing + ".away")
    try:
        with pytest.raises(RuntimeError, match="missing frame 41"):
            ds[5]
    finally:
        os.rename(missing + ".away", missing)
    cfg.EPICKITCHENS.VAL_LIST = "broken.pkl"
    with pytest.raises(Exception):
        build_dataset("Epickitchens", cfg, "val")
    cfg.EPICKITCHENS.VAL_LIST = "empty.pkl"
    with pytest.raises(ValueError, match="empty EPIC-Kitchens val split"):
        build_dataset("Epickitchens", cfg, "val")
    with pytest.raises(ValueError, match="split"):
        build_dataset("Epickitchens", cfg, "holdout")
    assert timestamp_to_sec("01:02:03.50") == 3723.5
