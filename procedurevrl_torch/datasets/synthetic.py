"""Synthetic splits drawn on the device from ``RNG_SEED``: no video file is
read and the host moves no frames.  Since the host pipeline was ported
(``howto100m.py``, ``epickitchens.py``, ``loader.py``), the entry points
read every split through it, under ``DEV.LOAD_DUMMY_DATA`` too; this
module serves batches drawn on the card to ``chip_smoke.py`` and the
tests:

- :class:`SyntheticClips`, the train, val and test splits of
  ``procedurevrl_tpu/datasets/howto100m.py`` (:60-115, :155-158): 64
  videos, each one clip in train and val and ``NUM_ENSEMBLE_VIEWS x
  NUM_SPATIAL_CROPS`` clips in test (clip ``i`` of video ``v`` at global
  index ``v * num_clips + i``), ``TRAIN.EPOCH_MUL`` times over in train;
  label ``video % NUM_CLASSES``; uint8 frames ``[T * max(NUM_SEG, 1), S, S,
  3]`` (S = ``DATA.TRAIN_CROP_SIZE`` in train, ``DATA.TEST_CROP_SIZE``
  otherwise): a forecasting sample is its ``NUM_SEG`` observed clips of T
  frames end to end.  The EPIC-Kitchens splits (``TRAIN.DATASET``, for
  test ``TEST.DATASET``, ``Epickitchens``) are the JAX dummy split's
  (``procedurevrl_tpu/datasets/epickitchens.py:115-126``): video ``v``
  has verb ``v % 97`` and noun ``v % 300``, the batches ``verb`` and
  ``noun`` in place of ``labels``.
- :class:`SyntheticPretrain`, the order-pretraining train split: the batch
  ``bench.py`` builds (:366-374) for each step.  A sample is
  ``ORDER_PRETRAIN_MAX_LEN`` (M = 9) clips: uint8 frames
  ``[M, T, S, S, 3]`` (S = ``DATA.TRAIN_CROP_SIZE``), label 0, ASR token
  ids ``[M, 77]`` in [1, 49000) and precomputed CLIP visual features
  ``[M, 512]`` from a standard normal.
"""

from __future__ import annotations

from typing import Dict

import torch

from procedurevrl_torch.models.procedurevrl import EPIC_NOUNS, EPIC_VERBS

NUM_VIDEOS = 64
TEXT_LEN = 77  # CLIP context length
# per-split offsets of the clip seeds, so that the splits draw other clips
_SPLIT_SEED = {"test": 0, "train": 100_003, "val": 200_003}


class SyntheticClips:
    """Index of one synthetic split and its clip generator."""

    def __init__(self, cfg, split: str = "test"):
        if split not in _SPLIT_SEED:
            raise ValueError(f"synthetic split {split!r}: expected train, "
                             "val or test")
        self.split = split
        self.num_clips = (cfg.TEST.NUM_ENSEMBLE_VIEWS
                          * cfg.TEST.NUM_SPATIAL_CROPS if split == "test"
                          else 1)
        self.epochs = max(cfg.TRAIN.EPOCH_MUL, 1) if split == "train" else 1
        self.clips = max(cfg.MODEL.NUM_SEG, 1)  # clips per sample
        self.num_classes = max(cfg.MODEL.NUM_CLASSES, 1)
        self.frames = cfg.DATA.NUM_FRAMES * max(cfg.MODEL.NUM_SEG, 1)
        self.size = (cfg.DATA.TRAIN_CROP_SIZE if split == "train"
                     else cfg.DATA.TEST_CROP_SIZE)
        self.seed = cfg.RNG_SEED
        dataset = cfg.TEST.DATASET if split == "test" else cfg.TRAIN.DATASET
        self.epic = dataset == "Epickitchens"

    def __len__(self) -> int:
        return NUM_VIDEOS * self.num_clips * self.epochs

    def video(self, index: int) -> int:
        return (index // self.num_clips) % NUM_VIDEOS

    def label(self, index: int) -> int:
        return self.video(index) % self.num_classes

    def labels(self, idx) -> Dict[str, list]:
        """The label lists of clips ``idx``: ``labels``, or EPIC's ``verb``
        and ``noun``."""
        if self.epic:
            return {"verb": [self.video(i) % EPIC_VERBS for i in idx],
                    "noun": [self.video(i) % EPIC_NOUNS for i in idx]}
        return {"labels": [self.label(i) for i in idx]}

    def clip(self, index: int, generator: torch.Generator) -> torch.Tensor:
        """uint8 frames [T * max(NUM_SEG, 1), S, S, 3] of clip ``index``, on
        the generator's device."""
        generator.manual_seed(self.seed * 1_000_003 + _SPLIT_SEED[self.split]
                              + index)
        return torch.randint(0, 256, (self.frames, self.size, self.size, 3),
                             generator=generator, dtype=torch.uint8,
                             device=generator.device)

    def num_batches(self, batch_size: int) -> int:
        """Batches of an epoch: train drops the short last batch, val and
        test keep it (JAX ``datasets/loader.py:227-245``)."""
        if self.split == "train":
            return len(self) // batch_size
        return -(-len(self) // batch_size)

    def batch(self, batch_size: int, index: int,
              generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Batch ``index`` of an epoch in index order, on the generator's
        device: ``frames`` [b, T * max(NUM_SEG, 1), S, S, 3] uint8,
        ``labels`` (EPIC: ``verb`` and ``noun``) and ``index`` [b] int64
        (the last val or test batch may be short).  An index past the
        epoch's last batch counts on into the
        next epochs, which hold the same samples."""
        start = index % self.num_batches(batch_size) * batch_size
        idx = list(range(start, min(start + batch_size, len(self))))
        dev = generator.device
        batch = {"frames": torch.stack([self.clip(i, generator)
                                        for i in idx]),
                 "index": torch.tensor(idx, device=dev)}
        for key, vals in self.labels(idx).items():
            batch[key] = torch.tensor(vals, device=dev)
        return batch


class SyntheticPretrain:
    """The synthetic order-pretraining train split: ``NUM_VIDEOS`` samples
    per epoch."""

    def __init__(self, cfg, text_vocab: int = 49408, vis_dim: int = 512):
        self.clips = cfg.DEV.ORDER_PRETRAIN_MAX_LEN
        self.frames = cfg.DATA.NUM_FRAMES
        self.size = cfg.DATA.TRAIN_CROP_SIZE
        self.seed = cfg.RNG_SEED
        self.max_id = min(49000, text_vocab)
        self.vis_dim = vis_dim

    def __len__(self) -> int:
        return NUM_VIDEOS

    def num_batches(self, batch_size: int) -> int:
        return len(self) // batch_size

    def batch(self, batch_size: int, index: int,
              generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Batch ``index`` of an epoch, on the generator's device:
        ``frames`` [B, M, T, S, S, 3] uint8, ``labels`` [B] int64 zeros,
        ``clip_text_ids`` [B, M, 77] int64, ``clip_vis_feat`` [B, M, 512]."""
        generator.manual_seed(self.seed * 1_000_003 + 7919 + index)
        dev = generator.device
        b, m = batch_size, self.clips
        return {
            "frames": torch.randint(0, 256, (b, m, self.frames, self.size,
                                             self.size, 3),
                                    generator=generator, dtype=torch.uint8,
                                    device=dev),
            "labels": torch.zeros(b, dtype=torch.long, device=dev),
            "clip_text_ids": torch.randint(1, self.max_id, (b, m, TEXT_LEN),
                                           generator=generator, device=dev),
            "clip_vis_feat": torch.randn(b, m, self.vis_dim,
                                         generator=generator, device=dev),
        }
