"""The EPIC-Kitchens-100 dataset (counterpart of
``procedurevrl_tpu/datasets/epickitchens.py:27-241``; reference
``lib/datasets/epickitchens.py:30-390``).

Records come from the annotation pickles (``pandas.read_pickle`` of
``EPICKITCHENS.ANNOTATIONS_DIR/{TRAIN,VAL,TEST}_LIST``): participant,
video, start and stop timestamps, verb and noun classes.  A test record
is repeated ``NUM_ENSEMBLE_VIEWS x NUM_SPATIAL_CROPS`` times, one a view.
Frames are decoded from ``VISUAL_DATA_DIR/<participant>/videos/<video>.MP4``
by the segment's timestamps (``DATA.DECODING_BACKEND`` ffmpeg, pyav or cv2,
else the first found), or with ``DEV.EPIC_USE_FRAME_LOADER`` read from
``VISUAL_DATA_DIR/<participant>/rgb_frames/<video>/frame_{i:010d}.jpg``.
Under ``DEV.LOAD_DUMMY_DATA`` the split is JAX's 64 dummy segments of
video ``P01_101`` and a missing video becomes seeded 256x456 frames.  The
train split is ``TRAIN.EPOCH_MUL`` times over, as the HowTo100M dataset
reads it (sample ``i`` is record ``i % records``, its draws seeded from
``i``); JAX's EPIC dataset has no such knob, and at 1 the two agree.

A train sample: RandAugment on the uint8 frames (``DATA.USE_RAND_AUGMENT``,
the ``DATA.AUTO_AUGMENT`` policy or ``rand-m9-n2-mstd0.5``), the float
normalisation, colour jitter and grayscale (``DATA.COLORJITTER``,
``DATA.GRAYSCALE``), then the scale jitter, the random crop and the flip;
a test sample the view's crop.  Every draw comes from the sample's
``RandomState`` (``datasets/rng.py``), in JAX's order, so the samples
equal JAX's bit for bit.  A missing frame, an unreadable list or an empty
split raises.  ``pandas``, ``PIL`` and ``cv2`` are imported where used.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from procedurevrl_torch.datasets import decoder, transform
from procedurevrl_torch.datasets.build import register_dataset
from procedurevrl_torch.datasets.rand_augment import RandAugment
from procedurevrl_torch.datasets.rng import EpochRNG

NUM_DUMMY = 64  # segments of the dummy split (JAX epickitchens.py:120)


def timestamp_to_sec(ts: str) -> float:
    """``HH:MM:SS.ff`` -> seconds (reference ``epickitchens_record.py:9-14``)."""
    h, m, s = ts.split(":")
    return int(h) * 3600 + int(m) * 60 + float(s)


class EpicKitchensVideoRecord:
    """One annotated segment (reference ``lib/datasets/epickitchens_record.py``):
    ``tup`` is a ``DataFrame.iterrows()`` pair (narration id, row)."""

    def __init__(self, tup):
        self._index = str(tup[0])
        self._series = tup[1]

    @property
    def participant(self) -> str:
        return self._series["participant_id"]

    @property
    def untrimmed_video_name(self) -> str:
        return self._series["video_id"]

    @property
    def fps(self) -> int:
        """50 for the EPIC-Kitchens-100 extension's videos (three-digit
        ids, ``P01_101``), else 60."""
        return 50 if len(self.untrimmed_video_name.split("_")[1]) == 3 else 60

    @property
    def start_sec(self) -> float:
        return timestamp_to_sec(self._series["start_timestamp"])

    @property
    def end_sec(self) -> float:
        return timestamp_to_sec(self._series["stop_timestamp"])

    @property
    def start_frame(self) -> int:
        return int(round(self.start_sec * self.fps))

    @property
    def end_frame(self) -> int:
        return int(round(self.end_sec * self.fps))

    @property
    def num_frames(self) -> int:
        return self.end_frame - self.start_frame

    @property
    def label(self) -> Dict[str, int]:
        """Verb and noun classes, -1 where the list has none (the test
        split)."""
        return {k: self._series[f"{k}_class"]
                if f"{k}_class" in self._series else -1
                for k in ("verb", "noun")}

    @property
    def metadata(self) -> Dict[str, str]:
        return {"narration_id": self._index}


@register_dataset("Epickitchens")
class Epickitchens(EpochRNG):
    """``__getitem__(i)`` -> (frames [T, crop, crop, 3] float32, {"verb",
    "noun"}, i, {"narration_id"})."""

    clips = 1  # clips a sample holds

    def __init__(self, cfg, mode: str):
        if mode not in ("train", "val", "test", "train+val"):
            raise ValueError(f"split {mode!r}: expected train, val, test or "
                             "train+val")
        self.cfg = cfg
        self.mode = mode
        self.target_fps = 60
        self._num_clips = (cfg.TEST.NUM_ENSEMBLE_VIEWS
                           * cfg.TEST.NUM_SPATIAL_CROPS
                           if mode == "test" else 1)
        self.dummy = cfg.DEV.LOAD_DUMMY_DATA
        self.em = max(cfg.TRAIN.EPOCH_MUL, 1) if mode == "train" else 1
        self._rand_aug = (RandAugment.from_config_str(
            cfg.DATA.AUTO_AUGMENT or "rand-m9-n2-mstd0.5")
            if cfg.DATA.USE_RAND_AUGMENT else None)
        self._construct_loader()

    def _annotation_files(self):
        c = self.cfg.EPICKITCHENS
        names = {"train": [c.TRAIN_LIST], "val": [c.VAL_LIST],
                 "test": [c.TEST_LIST],
                 "train+val": [c.TRAIN_LIST, c.VAL_LIST]}[self.mode]
        return [os.path.join(c.ANNOTATIONS_DIR, f) for f in names]

    def _construct_loader(self) -> None:
        import pandas as pd

        if self.dummy:
            n = NUM_DUMMY
            frames = [pd.DataFrame({
                "participant_id": ["P01"] * n,
                "video_id": ["P01_101"] * n,
                "start_timestamp": ["00:00:%05.2f" % (i * 2.0)
                                    for i in range(n)],
                "stop_timestamp": ["00:00:%05.2f" % (i * 2.0 + 2.0)
                                   for i in range(n)],
                "verb_class": [i % 97 for i in range(n)],
                "noun_class": [i % 300 for i in range(n)],
            })]
        else:
            frames = [pd.read_pickle(f) for f in self._annotation_files()]
        self._video_records = []
        self._spatial_temporal_idx = []
        for df in frames:
            for tup in df.iterrows():
                for idx in range(self._num_clips):
                    self._video_records.append(EpicKitchensVideoRecord(tup))
                    self._spatial_temporal_idx.append(idx)
        if not self._video_records:
            raise ValueError(f"empty EPIC-Kitchens {self.mode} split: "
                             f"{self._annotation_files()}")

    def __len__(self) -> int:
        return len(self._video_records) * self.em

    def _video_path(self, record) -> str:
        return os.path.join(self.cfg.EPICKITCHENS.VISUAL_DATA_DIR,
                            record.participant, "videos",
                            record.untrimmed_video_name + ".MP4")

    def _backend(self) -> str:
        b = self.cfg.DATA.DECODING_BACKEND
        return b if b in ("ffmpeg", "pyav", "cv2") else "auto"

    def __getitem__(self, index: int):
        cfg = self.cfg
        rng = self.sample_rng(index, 7919, deterministic=self.mode == "test")
        record = self._video_records[index % len(self._video_records)]
        if self.mode in ("train", "val", "train+val"):
            spatial_idx = -1
            min_s, max_s = cfg.DATA.TRAIN_JITTER_SCALES
            crop = cfg.DATA.TRAIN_CROP_SIZE
        else:
            spatial_idx = (self._spatial_temporal_idx[index]
                           % cfg.TEST.NUM_SPATIAL_CROPS)
            min_s = max_s = crop = cfg.DATA.TEST_CROP_SIZE

        path = self._video_path(record)
        if self.dummy and not os.path.exists(path):
            frames = np.random.RandomState(index % 2 ** 31).randint(
                0, 256, (cfg.DATA.NUM_FRAMES, 256, 456, 3), np.uint8)
        elif cfg.DEV.EPIC_USE_FRAME_LOADER:
            frames = self._pack_frames_from_dir(record, rng)
        else:
            frames = decoder.decode_window(path, record.start_sec,
                                           record.end_sec,
                                           cfg.DATA.NUM_FRAMES,
                                           backend=self._backend())
        if self.mode == "train" and self._rand_aug is not None:
            # clip-consistent, on uint8 frames (reference
            # epickitchens.py:149-162)
            frames = self._rand_aug(frames.astype(np.uint8), rng)
        frames = transform.tensor_normalize(frames, cfg.DATA.MEAN,
                                            cfg.DATA.STD)
        if self.mode == "train" and (cfg.DATA.COLORJITTER
                                     or cfg.DATA.GRAYSCALE):
            frames = self._frames_augmentation(frames, rng)
        frames = transform.spatial_sampling(
            frames, spatial_idx=spatial_idx, min_scale=min_s,
            max_scale=max_s, crop_size=crop,
            random_horizontal_flip=cfg.DATA.RANDOM_FLIP,
            rng=rng).astype(np.float32)
        label = record.label
        return (frames, {"verb": label["verb"], "noun": label["noun"]},
                index, record.metadata)

    def _pack_frames_from_dir(self, record, rng) -> np.ndarray:
        """The ``rgb_frames`` loader (reference ``lib/datasets/
        frame_loader.py:31-63``): ``NUM_FRAMES`` frames ``SAMPLING_RATE``
        apart at 60 fps, scaled to the video's, from a random offset in the
        segment (train) or its middle, clamped to the segment; each read
        from ``frame_{i + 1:010d}.jpg``.  A frame that does not read
        raises."""
        import cv2

        fps = record.fps
        T, sr = self.cfg.DATA.NUM_FRAMES, self.cfg.DATA.SAMPLING_RATE
        seg_len = record.end_frame - record.start_frame
        clip_len = T * sr * fps / self.target_fps
        if self.mode in ("train", "train+val"):
            offset = rng.uniform(0, max(seg_len - clip_len, 0))
        else:
            offset = max(seg_len - clip_len, 0) / 2.0
        idx = (record.start_frame + offset
               + np.arange(T) * sr * fps / self.target_fps)
        idx = np.clip(np.round(idx), record.start_frame,
                      record.end_frame - 1).astype(int)
        frame_dir = os.path.join(self.cfg.EPICKITCHENS.VISUAL_DATA_DIR,
                                 record.participant, "rgb_frames",
                                 record.untrimmed_video_name)
        frames = []
        for i in idx:
            img = cv2.imread(os.path.join(frame_dir, f"frame_{i + 1:010d}.jpg"))
            if img is None:
                raise RuntimeError(f"missing frame {i} in {frame_dir}")
            frames.append(img[:, :, ::-1])
        return np.stack(frames)

    def _frames_augmentation(self, frames: np.ndarray, rng) -> np.ndarray:
        """Colour jitter and a 0.2 chance of grayscale (reference
        ``epickitchens.py:373-389``)."""
        if self.cfg.DATA.COLORJITTER:
            frames = transform.color_jitter(frames, 0.4, 0.4, 0.4, rng=rng)
        if self.cfg.DATA.GRAYSCALE and rng.uniform() < 0.2:
            frames = transform.grayscale(frames)
        return frames
