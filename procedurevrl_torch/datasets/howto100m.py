"""HowTo100M / COIN dataset (counterpart of
``procedurevrl_tpu/datasets/howto100m.py``; reference
``lib/datasets/howto100m.py:58-533``).

The pretraining and COIN finetuning / evaluation dataset.  CSV rows:
``path label duration [start end [text]]`` (space-separated).  Train and
val sample one clip per video; test samples ``NUM_ENSEMBLE_VIEWS x
NUM_SPATIAL_CROPS`` clips.  Order pretraining samples
``ORDER_PRETRAIN_MAX_LEN`` consecutive ASR-aligned windows with stride
``ORDER_STRIDE``.  ``DEV.LOAD_DUMMY_DATA`` indexes :data:`NUM_SYNTHETIC`
``synthetic://`` videos and needs no file: their frames, ASR and CLIP
features are drawn from stable seeds, as the JAX package draws them.

The per-video ASR CSV (``TRAIN.TEXT``) is read by the ``csv`` module into
the columns ``start``, ``end`` and ``text`` (:class:`AsrTable`), as
``pandas.read_csv`` reads it: numeric columns are int64 where every value
is an integer and float64 otherwise, and an empty or NA text field is
NaN, a float, not a ``str``.
"""

from __future__ import annotations

import csv
import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from procedurevrl_torch.datasets import decoder, transform
from procedurevrl_torch.datasets.build import register_dataset
from procedurevrl_torch.datasets.rng import EpochRNG, stable_hash
from procedurevrl_torch.datasets.tokenizer import build_tokenizer, tokenize
from procedurevrl_torch.utils.logging import get_logger

logger = get_logger(__name__)

NUM_SYNTHETIC = 64  # videos of the DEV.LOAD_DUMMY_DATA index
# the strings pandas.read_csv reads as NaN by default
_NA = frozenset(("", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
                 "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA",
                 "NULL", "NaN", "None", "n/a", "nan", "null"))


class AsrTable:
    """One video's ASR sentences: ``start``, ``end`` (numpy arrays) and
    ``text`` (an object array of ``str``, NaN where the field is empty)."""

    def __init__(self, start, end, text):
        self.start, self.end, self.text = start, end, text

    def __len__(self) -> int:
        return len(self.text)

    @classmethod
    def read(cls, path: str) -> "AsrTable":
        with open(path, newline="") as f:
            rows = [r for r in csv.reader(f) if r]
        header, rows = rows[0], rows[1:]
        cols = {name: [r[i] if i < len(r) else "" for r in rows]
                for i, name in enumerate(header)}
        text = np.empty(len(rows), object)
        text[:] = [float("nan") if v in _NA else v for v in cols["text"]]
        return cls(_numeric(cols["start"]), _numeric(cols["end"]), text)


def _numeric(values) -> np.ndarray:
    """A CSV column as pandas types it: int64 where every value is an
    integer, else float64 (NaN for the NA strings)."""
    if values and all(v not in _NA and v.strip().lstrip("+-").isdigit()
                      for v in values):
        return np.asarray([int(v) for v in values], np.int64)
    return np.asarray([float("nan") if v in _NA else float(v)
                       for v in values], np.float64)


_EXTENSIONS = (".webm", ".mkv", ".mp4", ".m4a")


def get_clip_feat(clip_feat_path: str, vidid: str, start: float, end: float,
                  this_video=None) -> np.ndarray:
    """Fetch precomputed per-second CLIP visual features for [start, end]
    (format per reference ``DATASET.md:24-35``; fetch logic
    ``howto100m.py:472-495``)."""
    if this_video is None:
        this_video = torch.load(clip_feat_path + vidid + ".pth",
                                map_location="cpu", weights_only=False)
    mid_time = this_video["mid_time"]
    start = math.ceil(start)
    end = math.floor(end)
    start_ind = mid_time.index(start) if start in mid_time else mid_time.index(start + 1)
    end_ind = mid_time.index(end) if end in mid_time else mid_time.index(end - 1)
    feats = this_video["clip_instances"][start_ind : end_ind + 1]
    return np.stack([np.asarray(f, np.float32) for f in feats])


@register_dataset("Howto100m_develop")
class Howto100mDevelop(EpochRNG):
    """Map-style dataset; ``__getitem__`` returns ``(frames, label, index,
    meta)`` with frames ``[(M,) T, H, W, C]``, uint8 under
    ``TPU.HOST_UINT8``, else normalised float32."""

    def __init__(self, cfg, mode: str, num_retries: int = 20):
        assert mode in ("train", "val", "test"), mode
        self.cfg = cfg
        self.mode = mode
        self._num_retries = num_retries
        self._num_clips = (
            cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
            if mode == "test"
            else 1
        )
        # NUM_SEG multiplies NUM_FRAMES for forecasting (reference :82-83)
        self.num_frames = cfg.DATA.NUM_FRAMES * max(cfg.MODEL.NUM_SEG, 1)
        self.clip_feat_path = cfg.DEV.CLIP_VIS_FEAT_PATH
        self.order_pretrain = cfg.DEV.ORDER_PRETRAIN_ENABLED
        self.order_max_len = cfg.DEV.ORDER_PRETRAIN_MAX_LEN
        self.order_stride = cfg.DEV.ORDER_STRIDE
        self.is_pretrain = len(cfg.TRAIN.TEXT) > 0
        self.min_len = cfg.MODEL.MIN_LEN
        self.em = cfg.TRAIN.EPOCH_MUL
        self.dummy = cfg.DEV.LOAD_DUMMY_DATA
        # clips a sample holds: the order-pretraining windows, else the
        # NUM_SEG forecast clips end to end
        self.clips = (self.order_max_len
                      if self.order_pretrain and self.is_pretrain
                      else max(cfg.MODEL.NUM_SEG, 1))
        if self.is_pretrain:
            self.tokenizer = build_tokenizer(
                cfg.DATA.BPE_PATH, allow_fallback=self.dummy
            )
        self._construct_loader()

    # ------------------------------------------------------------------ index

    def _construct_loader(self):
        self._path_to_videos = []
        self._labels = []
        self._durations = []
        self._start = []
        self._end = []
        self._spatial_temporal_idx = []

        path_to_file = os.path.join(
            self.cfg.DATA.PATH_TO_DATA_DIR, f"{self.mode}.csv"
        )
        if self.dummy:
            # fully synthetic index: 64 videos (no CSV/video files touched —
            # the reference's dummy flag still decoded real files; ours must
            # run in imageless environments). Pretraining rows have no
            # start/end (sampled from ASR); finetune/forecast rows carry a
            # clip window like the 5-column CSVs.
            windowed = not self.is_pretrain
            for clip_idx in range(NUM_SYNTHETIC):
                for idx in range(self._num_clips):
                    self._path_to_videos.append(f"synthetic://video{clip_idx}")
                    self._labels.append(clip_idx % max(self.cfg.MODEL.NUM_CLASSES, 1))
                    self._durations.append(120)
                    self._start.append(20 if windowed else None)
                    self._end.append(20 + max(int(self.cfg.DATA.FD), 9)
                                     if windowed else None)
                    self._spatial_temporal_idx.append(idx)
            logger.info("Constructed synthetic %s dataset (size %d)",
                        self.mode, len(self._path_to_videos))
            return

        assert os.path.exists(path_to_file), f"{path_to_file} not found"
        sep = self.cfg.DATA.PATH_LABEL_SEPARATOR
        with open(path_to_file) as f:
            for clip_idx, line in enumerate(f.read().splitlines()):
                parts = line.split(sep)
                if len(parts) == 3:
                    path, label, dur = parts
                    start = end = None
                elif len(parts) == 5:
                    path, label, dur, start, end = parts
                else:
                    path, label, dur, start, end = parts[:5]
                for idx in range(self._num_clips):
                    full = self._resolve_path(path)
                    if full is None:
                        break
                    self._path_to_videos.append(full)
                    self._labels.append(int(label))
                    self._durations.append(int(float(dur)))
                    self._spatial_temporal_idx.append(idx)
                    self._start.append(None if start is None else int(float(start)))
                    self._end.append(None if end is None else int(float(end)))
        assert self._path_to_videos, f"Failed to load split {self.mode}"
        logger.info("Constructed dataloader (size: %d) from %s",
                    len(self._path_to_videos), path_to_file)

    def _resolve_path(self, path: str) -> Optional[str]:
        """Find the on-disk extension (reference ``howto100m.py:163-176``)."""
        stem = path.split(".")[0]
        for ext in _EXTENSIONS:
            cand = os.path.join(self.cfg.DATA.PATH_PREFIX, stem + ext)
            if os.path.exists(cand):
                return cand
        cand = os.path.join(self.cfg.DATA.PATH_PREFIX, path)
        return cand if os.path.exists(cand) else None

    def __len__(self):
        if self.em > 1 and self.mode == "train":
            return len(self._path_to_videos) * self.em
        return len(self._path_to_videos)

    # --------------------------------------------------------------- sampling

    def _sampling_params(self, index: int):
        if self.mode in ("train", "val"):
            return -1, -1, (
                self.cfg.DATA.TRAIN_JITTER_SCALES[0],
                self.cfg.DATA.TRAIN_JITTER_SCALES[1],
                self.cfg.DATA.TRAIN_CROP_SIZE,
            )
        t_idx = self._spatial_temporal_idx[index] // self.cfg.TEST.NUM_SPATIAL_CROPS
        s_idx = (
            self._spatial_temporal_idx[index] % self.cfg.TEST.NUM_SPATIAL_CROPS
            if self.cfg.TEST.NUM_SPATIAL_CROPS > 1
            else 1
        )
        if self.cfg.TEST.NUM_SPATIAL_CROPS > 1:
            scales = (self.cfg.DATA.TEST_CROP_SIZE,) * 3
        else:
            scales = (
                self.cfg.DATA.TRAIN_JITTER_SCALES[0],
                self.cfg.DATA.TRAIN_JITTER_SCALES[0],
                self.cfg.DATA.TEST_CROP_SIZE,
            )
        return t_idx, s_idx, scales

    def get_video_start_end(self, start, end, duration, temporal_sample_index,
                            rng):
        """reference ``howto100m.py:397-420``."""
        fd = self.cfg.DATA.FD
        if start is None:
            start, end = decoder.get_start_end_idx(
                duration, fd, temporal_sample_index,
                self.cfg.TEST.NUM_ENSEMBLE_VIEWS, rng,
            )
        if end - start < fd - 1:
            start = max((end + start) / 2.0 - fd / 2.0, 0)
            end = min(start + fd, duration)
        if fd == 0.0 and end - start > self.num_frames:
            mid = (end + start) / 2.0
            start, end = mid - self.num_frames / 2.0, mid + self.num_frames / 2.0
        elif fd > 0.0 and end - start > fd:
            base = start
            start, end = decoder.get_start_end_idx(
                end - start, fd, temporal_sample_index,
                self.cfg.TEST.NUM_ENSEMBLE_VIEWS, rng,
            )
            start += base
            end += base
        return start, end

    def get_asr_start_end(self, cap, ind: int):
        """ASR window with min-length expansion
        (reference ``howto100m.py:364-395``)."""
        text_v, start_v, end_v = cap.text, cap.start, cap.end
        q = text_v[ind] if isinstance(text_v[ind], str) else " "
        s, e = start_v[ind], end_v[ind]
        if self.min_len > 0:
            mi = 0
            while len(q.split(" ")) < self.min_len:
                if ind - mi > 0 and isinstance(text_v[ind - mi], str):
                    q = text_v[ind - mi] + " " + q
                    s = start_v[ind - mi]
                if ind + mi < len(cap) and isinstance(text_v[ind + mi], str):
                    q = q + " " + text_v[ind + mi]
                    e = end_v[ind + mi]
                mi += 1
                if not ind - mi > 0 and not ind + mi < len(cap):
                    break
        sen = q if isinstance(q, str) and len(q) > 0 else " "
        ids = tokenize(self.tokenizer, [sen], truncate=True)[0]
        return s, e, ids

    def get_frames(self, path: str, start: float, end: float,
                   spatial_sample_index: int, scales, rng) -> Optional[np.ndarray]:
        """Decode + normalize + spatial sampling
        (reference ``howto100m.py:422-452``). Returns [T, H, W, C] float32."""
        min_scale, max_scale, crop_size = scales
        try:
            if path.startswith("synthetic://"):
                seed = (stable_hash(path) + int(start * 7)) % (2 ** 31)
                r = np.random.RandomState(seed)
                frames = r.randint(
                    0, 256, (self.num_frames, 360, 640, 3), np.uint8
                )
            else:
                frames = decoder.decode_window(
                    path, start, end, self.num_frames,
                    backend=self.cfg.DATA.DECODING_BACKEND
                    if self.cfg.DATA.DECODING_BACKEND in ("ffmpeg", "pyav", "cv2")
                    else "auto",
                )
        except Exception:
            return None
        # single fused native pass (normalize+resize+crop+flip) when the
        # decoded frames are uint8; numpy fallback otherwise. With
        # TPU.HOST_UINT8 the crop ships as uint8 and the device normalizes
        # (4x less transfer; see engine/steps.normalize_frames).
        return transform.spatial_sampling_fused(
            frames,
            spatial_idx=spatial_sample_index,
            min_scale=min_scale,
            max_scale=max_scale,
            crop_size=crop_size,
            mean=self.cfg.DATA.MEAN,
            std=self.cfg.DATA.STD,
            random_horizontal_flip=self.cfg.DATA.RANDOM_FLIP,
            inverse_uniform_sampling=self.cfg.DATA.INV_UNIFORM_SAMPLE,
            rng=rng,
            output_uint8=self.cfg.TPU.HOST_UINT8,
        )

    # ---------------------------------------------------------------- getitem

    def __getitem__(self, index: int):
        # seed from the RAW index (so EPOCH_MUL repeats draw distinct
        # windows) before folding down to the physical clip.
        rng = self.sample_rng(index, 1000003, deterministic=self.mode == "test")
        if self.em > 1:
            index = index % len(self._path_to_videos)
        temporal_sample_index, spatial_sample_index, scales = (
            self._sampling_params(index)
        )

        for i_try in range(self._num_retries):
            path = self._path_to_videos[index]
            vidid = path.split("/")[-1].split(".")[0]
            duration = self._durations[index]
            start, end = self._start[index], self._end[index]
            text: Dict[str, np.ndarray] = {}

            if self.is_pretrain:
                cap = self._load_asr(vidid, rng)
                if self.order_pretrain:
                    ind = rng.randint(
                        0, max(1, len(cap) - 1 - self.order_max_len * self.order_stride) + 1
                    )
                    ids_list, start, end = [], [], []
                    for seq_i in range(self.order_max_len):
                        this_ind = min(ind + seq_i * self.order_stride, len(cap) - 1)
                        s_i, e_i, ids_i = self.get_asr_start_end(cap, this_ind)
                        s_i, e_i = self.get_video_start_end(
                            s_i, e_i, duration, temporal_sample_index, rng
                        )
                        ids_list.append(ids_i)
                        start.append(s_i)
                        end.append(e_i)
                    text["clip_text_ids"] = np.stack(ids_list)
                else:
                    ind = rng.randint(0, len(cap))
                    s, e, ids = self.get_asr_start_end(cap, ind)
                    start, end = self.get_video_start_end(
                        s, e, duration, temporal_sample_index, rng
                    )
                    text["clip_text_ids"] = ids
            else:
                start, end = self.get_video_start_end(
                    start, end, duration, temporal_sample_index, rng
                )

            # step forecasting with fixed clip end (reference :303-307)
            if self.cfg.DATA.FIX_END:
                start = self._start[index]
                end = self._end[index]
                if self.cfg.DATA.FD < end - start:
                    start = end - self.cfg.DATA.FD

            if self.order_pretrain and self.is_pretrain:
                clips = []
                ok = True
                for s_i, e_i in zip(start, end):
                    f = self.get_frames(path, s_i, e_i, spatial_sample_index,
                                        scales, rng)
                    if f is None:
                        ok = False
                        break
                    clips.append(f)
                frames = np.stack(clips) if ok else None  # [M, T, H, W, C]
            else:
                frames = self.get_frames(path, start, end, spatial_sample_index,
                                         scales, rng)
            if frames is None:
                index = self.sample_new_index(index, i_try, rng)
                continue

            label = self._labels[index]

            if self.is_pretrain:
                text["label"] = np.asarray([1], np.int64)
                text["clip_vis_feat"] = self._fetch_clip_feats(
                    vidid, start, end, rng
                )
                return frames, label, index, text
            return frames, label, index, {}
        raise RuntimeError(
            f"Failed to fetch video after {self._num_retries} retries."
        )

    def _load_asr(self, vidid: str, rng) -> AsrTable:
        """Per-video ASR CSV (reference ``howto100m.py:270``), synthetic in
        dummy mode."""
        path = self.cfg.TRAIN.TEXT + vidid + ".csv"
        if self.dummy and not os.path.exists(path):
            n = 40
            starts = np.arange(n) * 4.0
            text = np.empty(n, object)
            text[:] = [f"synthetic narration {vidid} step {i}"
                       for i in range(n)]
            return AsrTable(starts, starts + 4.0, text)
        return AsrTable.read(path)

    def _fetch_clip_feats(self, vidid, start, end, rng) -> np.ndarray:
        """Precomputed CLIP visual features, zero-vector on failure
        (reference ``howto100m.py:341-358``)."""
        dim = 512
        try:
            if self.dummy and not os.path.exists(
                self.clip_feat_path + vidid + ".pth"
            ):
                raise FileNotFoundError
            if self.order_pretrain:
                this_video = torch.load(
                    self.clip_feat_path + vidid + ".pth",
                    map_location="cpu", weights_only=False,
                )
                feats = [
                    get_clip_feat(self.clip_feat_path, vidid, s_i, e_i,
                                  this_video=this_video).mean(axis=0)
                    for s_i, e_i in zip(start, end)
                ]
                return np.stack(feats).astype(np.float32)
            return get_clip_feat(self.clip_feat_path, vidid, start, end).mean(
                axis=0
            ).astype(np.float32)
        except Exception:
            if self.dummy:
                # deterministic pseudo-features keep the teacher non-degenerate
                r = np.random.RandomState(stable_hash(vidid))
                if self.order_pretrain:
                    f = r.randn(self.order_max_len, dim).astype(np.float32)
                else:
                    f = r.randn(dim).astype(np.float32)
                return f / np.linalg.norm(f, axis=-1, keepdims=True)
            if self.order_pretrain:
                return np.zeros((self.order_max_len, dim), np.float32)
            return np.zeros((dim,), np.float32)

    def sample_new_index(self, index: int, i_try: int, rng) -> int:
        """Decode-failure resample (reference ``howto100m.py:454-460``)."""
        logger.warning("Failed to decode video idx %d from %s; trial %d",
                       index, self._path_to_videos[index], i_try)
        if self.mode != "test" or i_try > self._num_retries // 2:
            return int(rng.randint(0, len(self._path_to_videos)))
        return index
