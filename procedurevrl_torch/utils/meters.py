"""Multi-view test meter (counterpart of ``TestMeter`` in
``procedurevrl_tpu/utils/meters.py``; reference ``lib/utils/meters.py:21-204``).

Per-video accumulation (sum or max) of the softmax predictions of its
``num_clips = views x crops`` clips, then top-1/top-5 over videos.  Stats
are logged as ``json_stats: {...}`` lines, the reference's format.
"""

from __future__ import annotations

import datetime
import json
import logging
import time
from typing import Dict

import numpy as np
import torch

from procedurevrl_torch.utils import metrics

logger = logging.getLogger("procedurevrl_torch")


def log_json_stats(stats: Dict) -> None:
    stats = {k: round(v, 5) if isinstance(v, float) else v
             for k, v in stats.items()}
    logger.info("json_stats: %s", json.dumps(stats, sort_keys=True))


class TestMeter:
    """Multi-view test ensembling."""

    __test__ = False  # not a pytest class

    def __init__(self, num_videos: int, num_clips: int, num_cls: int,
                 overall_iters: int, multi_label: bool = False,
                 ensemble_method: str = "sum"):
        if ensemble_method not in ("sum", "max"):
            raise ValueError(f"ensemble_method {ensemble_method!r}")
        self.num_clips = num_clips
        self.overall_iters = overall_iters
        self.multi_label = multi_label
        self.ensemble_method = ensemble_method
        self.video_preds = np.zeros((num_videos, num_cls), np.float32)
        if multi_label:
            self.video_preds -= 1e10
        self.video_labels = np.zeros(
            (num_videos, num_cls) if multi_label else (num_videos,), np.int64)
        self.clip_count = np.zeros((num_videos,), np.int64)
        self.stats: Dict = {}
        self._tic = time.perf_counter()

    def update_stats(self, preds, labels, clip_ids) -> None:
        """preds [N, C]; labels [N]; clip_ids [N] global clip indices."""
        preds, labels, clip_ids = (np.asarray(a) for a in (preds, labels,
                                                           clip_ids))
        for ind in range(preds.shape[0]):
            vid_id = int(clip_ids[ind]) // self.num_clips
            if self.video_labels[vid_id].sum() > 0 and not (
                    self.video_labels[vid_id] == labels[ind]).all():
                raise ValueError(f"video {vid_id}: clips disagree on the label")
            self.video_labels[vid_id] = labels[ind]
            if self.ensemble_method == "sum":
                self.video_preds[vid_id] += preds[ind]
            else:
                self.video_preds[vid_id] = np.maximum(self.video_preds[vid_id],
                                                      preds[ind])
            self.clip_count[vid_id] += 1

    def iter_tic(self) -> None:
        self._tic = time.perf_counter()

    def log_iter_stats(self, cur_iter: int) -> None:
        dt = time.perf_counter() - self._tic
        eta = datetime.timedelta(seconds=int(dt * (self.overall_iters - cur_iter)))
        log_json_stats({"split": "test_iter", "cur_iter": str(cur_iter + 1),
                        "eta": str(eta), "time_diff": dt})

    def finalize_metrics(self, ks=(1, 5)) -> Dict:
        if not (self.clip_count == self.num_clips).all():
            bad = np.argwhere(self.clip_count != self.num_clips).flatten()
            logger.warning("clip count %s ~= num clips %d",
                           ", ".join(f"{i}: {int(self.clip_count[i])}"
                                     for i in bad[:20]), self.num_clips)
        stats = {"split": "test_final"}
        num_correct = metrics.topks_correct(
            torch.from_numpy(self.video_preds),
            torch.from_numpy(self.video_labels), ks)
        for k, nc in zip(ks, num_correct):
            stats[f"top{k}_acc"] = "{:.2f}".format(
                float(nc) / self.video_preds.shape[0] * 100.0)
        log_json_stats(stats)
        self.stats = stats
        return stats
