"""The Kinetics dataset (counterpart of
``procedurevrl_tpu/datasets/kinetics.py``; reference
``lib/datasets/kinetics.py:18-294``).

Rows of ``DATA.PATH_TO_DATA_DIR/{train,val,test}.csv`` are ``path label``
(split by ``DATA.PATH_LABEL_SEPARATOR``), the path under
``DATA.PATH_PREFIX``; a test video is repeated ``NUM_ENSEMBLE_VIEWS x
NUM_SPATIAL_CROPS`` times, one a view, its temporal and spatial indices
``view // NUM_SPATIAL_CROPS`` and ``view % NUM_SPATIAL_CROPS``.  Under
``DEV.LOAD_DUMMY_DATA`` the split is JAX's 64 ``synthetic://k{i}`` videos
of label ``i % NUM_CLASSES``, each ``NUM_FRAMES`` uint8 frames of 240x320
drawn from ``stable_hash`` of its path.  A sample is decoded by
``decoder.decode_full`` (``DATA.DECODING_BACKEND``), normalised to float32
and scale-jittered, cropped and flipped (train, val) or cropped at its view
(test), every draw from the sample's ``RandomState`` in JAX's order, so
the samples equal JAX's bit for bit.  A video that does not decode is
replaced by another drawn from the same stream, ``num_retries`` times.
The multigrid short cycle (an ``(index, short_cycle_idx)`` index) is not
ported and raises.
"""

from __future__ import annotations

import os

import numpy as np

from procedurevrl_torch.datasets import decoder, transform
from procedurevrl_torch.datasets.build import register_dataset
from procedurevrl_torch.datasets.rng import EpochRNG, stable_hash

NUM_DUMMY = 64  # videos of the dummy split (JAX kinetics.py:41-47)


@register_dataset("Kinetics")
class Kinetics(EpochRNG):
    """``__getitem__(i)`` -> (frames [T, crop, crop, 3] float32, label, i,
    {})."""

    clips = 1  # clips a sample holds

    def __init__(self, cfg, mode: str, num_retries: int = 10):
        if mode not in ("train", "val", "test"):
            raise ValueError(f"split {mode!r}: expected train, val or test")
        self.cfg = cfg
        self.mode = mode
        self._num_retries = num_retries
        self._num_clips = (cfg.TEST.NUM_ENSEMBLE_VIEWS
                           * cfg.TEST.NUM_SPATIAL_CROPS
                           if mode == "test" else 1)
        self.dummy = cfg.DEV.LOAD_DUMMY_DATA
        self._construct_loader()

    def _construct_loader(self) -> None:
        self._path_to_videos, self._labels = [], []
        self._spatial_temporal_idx = []
        cfg = self.cfg
        if self.dummy:
            rows = [(f"synthetic://k{i}", i % cfg.MODEL.NUM_CLASSES)
                    for i in range(NUM_DUMMY)]
        else:
            csv = os.path.join(cfg.DATA.PATH_TO_DATA_DIR, f"{self.mode}.csv")
            if not os.path.exists(csv):
                raise FileNotFoundError(csv)
            rows = []
            with open(csv) as f:
                for line in f.read().splitlines():
                    path, label = line.split(cfg.DATA.PATH_LABEL_SEPARATOR)[:2]
                    rows.append((os.path.join(cfg.DATA.PATH_PREFIX, path),
                                 int(label)))
            if not rows:
                raise ValueError(f"empty split {csv}")
        for path, label in rows:
            for idx in range(self._num_clips):
                self._path_to_videos.append(path)
                self._labels.append(label)
                self._spatial_temporal_idx.append(idx)

    def __len__(self) -> int:
        return len(self._path_to_videos)

    def _backend(self) -> str:
        b = self.cfg.DATA.DECODING_BACKEND
        return b if b in ("ffmpeg", "pyav", "cv2") else "auto"

    def _frames(self, path: str, temporal_idx: int, rng) -> np.ndarray:
        cfg = self.cfg
        if path.startswith("synthetic://"):
            r = np.random.RandomState(stable_hash(path))
            return r.randint(0, 256, (cfg.DATA.NUM_FRAMES, 240, 320, 3),
                             np.uint8)
        return decoder.decode_full(
            path, cfg.DATA.SAMPLING_RATE, cfg.DATA.NUM_FRAMES, temporal_idx,
            cfg.TEST.NUM_ENSEMBLE_VIEWS, target_fps=cfg.DATA.TARGET_FPS,
            backend=self._backend(), rng=rng)

    def __getitem__(self, index):
        if isinstance(index, tuple):
            raise NotImplementedError(
                "the multigrid short cycle (utils/multigrid.py) is not "
                "ported yet (ROADMAP.md Queue 1 item 7)")
        cfg = self.cfg
        rng = self.sample_rng(index, 999983, deterministic=self.mode == "test")
        if self.mode in ("train", "val"):
            temporal_idx = spatial_idx = -1
            min_s, max_s = cfg.DATA.TRAIN_JITTER_SCALES
            crop = cfg.DATA.TRAIN_CROP_SIZE
            if cfg.MULTIGRID.DEFAULT_S > 0:
                min_s = int(round(float(min_s) * crop
                                  / cfg.MULTIGRID.DEFAULT_S))
        else:
            view = self._spatial_temporal_idx[index]
            temporal_idx = view // cfg.TEST.NUM_SPATIAL_CROPS
            spatial_idx = view % cfg.TEST.NUM_SPATIAL_CROPS
            min_s = max_s = crop = cfg.DATA.TEST_CROP_SIZE
        for _ in range(self._num_retries):
            try:
                frames = self._frames(self._path_to_videos[index],
                                      temporal_idx, rng)
            except Exception:
                frames = None
            if frames is None:
                index = int(rng.randint(0, len(self._path_to_videos)))
                continue
            frames = transform.tensor_normalize(frames, cfg.DATA.MEAN,
                                                cfg.DATA.STD)
            frames = transform.spatial_sampling(
                frames, spatial_idx=spatial_idx, min_scale=min_s,
                max_scale=max_s, crop_size=crop,
                random_horizontal_flip=cfg.DATA.RANDOM_FLIP,
                rng=rng).astype(np.float32)
            return frames, self._labels[index], index, {}
        raise RuntimeError(
            f"Failed to fetch video after {self._num_retries} retries.")
