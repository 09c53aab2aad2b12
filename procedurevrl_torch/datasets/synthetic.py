"""Synthetic data for ``DEV.LOAD_DUMMY_DATA``: no video file is read, and
every tensor is drawn from ``RNG_SEED`` on the device that runs the model,
so the host moves no frames.  Real decoding comes in a later slice.

- :class:`SyntheticClips`, the multi-view test split of
  ``procedurevrl_tpu/datasets/howto100m.py`` (:98-114): 64 videos x
  ``NUM_ENSEMBLE_VIEWS x NUM_SPATIAL_CROPS`` clips, clip ``i`` of video
  ``v`` at global index ``v * num_clips + i``, label ``video % NUM_CLASSES``,
  uint8 frames ``[T, S, S, 3]`` (S = ``DATA.TEST_CROP_SIZE``).
- :class:`SyntheticPretrain`, the order-pretraining train split: the batch
  ``bench.py`` builds (:366-374) for each step.  A sample is
  ``ORDER_PRETRAIN_MAX_LEN`` (M = 9) clips: uint8 frames
  ``[M, T, S, S, 3]`` (S = ``DATA.TRAIN_CROP_SIZE``), label 0, ASR token
  ids ``[M, 77]`` in [1, 49000) and precomputed CLIP visual features
  ``[M, 512]`` from a standard normal.
"""

from __future__ import annotations

from typing import Dict, Iterator, Union

import torch

NUM_VIDEOS = 64
TEXT_LEN = 77  # CLIP context length


class SyntheticClips:
    """Index of the synthetic test split and its clip generator."""

    def __init__(self, cfg, split: str = "test"):
        if split != "test":
            raise NotImplementedError(
                f"synthetic {split} split: the train split is "
                "SyntheticPretrain; val comes with the finetuning slice")
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
