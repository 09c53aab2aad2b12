"""Synthetic multi-view test set: what ``DEV.LOAD_DUMMY_DATA`` gives the
test split of ``procedurevrl_tpu/datasets/howto100m.py`` (:98-114).

64 videos x ``NUM_ENSEMBLE_VIEWS x NUM_SPATIAL_CROPS`` clips, clip ``i``
of video ``v`` at global index ``v * num_clips + i``, label
``video % NUM_CLASSES``.  Each clip's uint8 frames ``[T, S, S, 3]``
(S = ``DATA.TEST_CROP_SIZE``) are drawn from ``RNG_SEED`` and the clip
index, on the device that runs the model, so no video file is read and the
host moves no frames.  Real decoding comes in a later slice.
"""

from __future__ import annotations

from typing import Dict, Iterator, Union

import torch

NUM_VIDEOS = 64


class SyntheticClips:
    """Index of the synthetic test split and its clip generator."""

    def __init__(self, cfg, split: str = "test"):
        if split != "test":
            raise NotImplementedError(
                f"synthetic {split} split: training data comes with slice 2")
        self.num_clips = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        self.num_classes = max(cfg.MODEL.NUM_CLASSES, 1)
        self.frames = cfg.DATA.NUM_FRAMES
        self.size = cfg.DATA.TEST_CROP_SIZE
        self.seed = cfg.RNG_SEED

    def __len__(self) -> int:
        return NUM_VIDEOS * self.num_clips

    def label(self, index: int) -> int:
        return (index // self.num_clips) % self.num_classes

    def clip(self, index: int, generator: torch.Generator) -> torch.Tensor:
        """uint8 frames [T, S, S, 3] of clip ``index``, on the generator's
        device."""
        generator.manual_seed(self.seed * 1_000_003 + index)
        return torch.randint(0, 256, (self.frames, self.size, self.size, 3),
                             generator=generator, dtype=torch.uint8,
                             device=generator.device)

    def batches(self, batch_size: int,
                device: Union[str, torch.device]) -> Iterator[Dict]:
        """Batches in index order: ``frames`` [b, T, S, S, 3] uint8 on
        ``device``, ``labels`` and ``index`` int64 on the CPU.  The last
        batch may be short."""
        gen = torch.Generator(device=device)
        for start in range(0, len(self), batch_size):
            idx = list(range(start, min(start + batch_size, len(self))))
            yield {
                "frames": torch.stack([self.clip(i, gen) for i in idx]),
                "labels": torch.tensor([self.label(i) for i in idx]),
                "index": torch.tensor(idx),
            }

    def num_batches(self, batch_size: int) -> int:
        return -(-len(self) // batch_size)
