"""Meters (counterpart of ``TestMeter``, ``TrainMeter`` and ``ValMeter`` in
``procedurevrl_tpu/utils/meters.py``; reference ``lib/utils/meters.py``).

- ``TestMeter``: per-video accumulation (sum or max) of the softmax
  predictions of its ``num_clips = views x crops`` clips, then top-1/top-5
  over videos;
- ``TrainMeter``: window medians of the train metrics (loss, kl, mse,
  top-1/top-5 error, lr, grad_norm) every ``LOG_PERIOD`` iterations and
  sample-weighted epoch means;
- ``ValMeter``: window medians of the validation top-1/top-5 errors and
  their sample-weighted epoch means, with the least epoch errors so far;
- ``EPICValMeter``: the same for EPIC-Kitchens' verb, noun and action
  top-1/top-5 accuracies, with the largest epoch accuracies so far;
- ``EPICTestMeter``: per-video sums of the verb and noun logits of its
  clips, then verb, noun and action top-1/top-5 over videos.
Stats are logged as ``json_stats: {...}`` lines, the reference's format.
"""

from __future__ import annotations

import datetime
import statistics
import time
from collections import defaultdict, deque
from typing import Dict, Optional

import numpy as np
import torch

from procedurevrl_torch.utils import metrics
from procedurevrl_torch.utils.logging import get_logger, log_json_stats

logger = get_logger(__name__)


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


class ScalarMeter:
    """A window of recent values (reference ``lib/utils/meters.py:207-240``)."""

    def __init__(self, window_size: int):
        self.deque: deque = deque(maxlen=window_size)
        self.count = 0

    def reset(self) -> None:
        self.deque.clear()
        self.count = 0

    def add_value(self, value: float) -> None:
        self.deque.append(value)
        self.count += 1

    def get_win_median(self) -> float:
        return statistics.median(self.deque)


class TrainMeter:
    """Training meter (reference ``lib/utils/meters.py:257-420``); values
    arrive as host floats."""

    def __init__(self, epoch_iters: int, cfg):
        self._cfg = cfg
        self.epoch_iters = epoch_iters
        self.max_iter = cfg.SOLVER.MAX_EPOCH * epoch_iters
        self.window = cfg.LOG_PERIOD
        self.reset()
        self._tic = time.perf_counter()
        self.iter_seconds = 0.0

    def reset(self) -> None:
        self.loss = ScalarMeter(self.window)
        self.mb_top1_err = ScalarMeter(self.window)
        self.mb_top5_err = ScalarMeter(self.window)
        self.extra: Dict[str, ScalarMeter] = defaultdict(
            lambda: ScalarMeter(self.window))
        self.loss_total = 0.0
        self.num_top1_mis = 0.0
        self.num_top5_mis = 0.0
        self.num_samples = 0
        self.lr: Optional[float] = None

    def iter_tic(self) -> None:
        self._tic = time.perf_counter()

    def iter_toc(self) -> None:
        self.iter_seconds = time.perf_counter() - self._tic

    def update_stats(self, top1_err: float, top5_err: float, loss: float,
                     lr: float, mb_size: int,
                     extra: Optional[Dict[str, float]] = None) -> None:
        self.loss.add_value(loss)
        self.lr = lr
        self.loss_total += loss * mb_size
        self.num_samples += mb_size
        self.mb_top1_err.add_value(top1_err)
        self.mb_top5_err.add_value(top5_err)
        self.num_top1_mis += top1_err * mb_size
        self.num_top5_mis += top5_err * mb_size
        for k, v in (extra or {}).items():
            self.extra[k].add_value(v)

    def log_iter_stats(self, cur_epoch: int, cur_iter: int) -> None:
        if (cur_iter + 1) % self._cfg.LOG_PERIOD != 0 or not self.loss.count:
            return
        eta = datetime.timedelta(seconds=int(self.iter_seconds * (
            self.max_iter - (cur_epoch * self.epoch_iters + cur_iter + 1))))
        stats = {
            "_type": "train_iter",
            "epoch": f"{cur_epoch + 1}/{self._cfg.SOLVER.MAX_EPOCH}",
            "iter": f"{cur_iter + 1}/{self.epoch_iters}",
            "dt": self.iter_seconds, "eta": str(eta),
            "loss": self.loss.get_win_median(), "lr": self.lr,
            "top1_err": self.mb_top1_err.get_win_median(),
            "top5_err": self.mb_top5_err.get_win_median(),
        }
        for k, m in self.extra.items():
            stats[k] = m.get_win_median()
        log_json_stats(stats)

    def log_epoch_stats(self, cur_epoch: int) -> Dict:
        n = max(self.num_samples, 1)
        stats = {"_type": "train_epoch",
                 "epoch": f"{cur_epoch + 1}/{self._cfg.SOLVER.MAX_EPOCH}",
                 "loss": self.loss_total / n, "lr": self.lr,
                 "top1_err": self.num_top1_mis / n,
                 "top5_err": self.num_top5_mis / n}
        log_json_stats(stats)
        return stats


class ValMeter:
    """Validation meter (reference ``lib/utils/meters.py:423-537``); errors
    arrive as host floats in percent."""

    def __init__(self, max_iter: int, cfg):
        self._cfg = cfg
        self.max_iter = max_iter
        self.min_top1_err = 100.0
        self.min_top5_err = 100.0
        self._tic = time.perf_counter()
        self.iter_seconds = 0.0
        self.reset()

    def reset(self) -> None:
        self.mb_top1_err = ScalarMeter(self._cfg.LOG_PERIOD)
        self.mb_top5_err = ScalarMeter(self._cfg.LOG_PERIOD)
        self.num_top1_mis = 0.0
        self.num_top5_mis = 0.0
        self.num_samples = 0

    def iter_tic(self) -> None:
        self._tic = time.perf_counter()

    def iter_toc(self) -> None:
        self.iter_seconds = time.perf_counter() - self._tic

    def update_stats(self, top1_err: float, top5_err: float,
                     mb_size: int) -> None:
        self.mb_top1_err.add_value(top1_err)
        self.mb_top5_err.add_value(top5_err)
        self.num_top1_mis += top1_err * mb_size
        self.num_top5_mis += top5_err * mb_size
        self.num_samples += mb_size

    def log_iter_stats(self, cur_epoch: int, cur_iter: int) -> None:
        if (cur_iter + 1) % self._cfg.LOG_PERIOD != 0:
            return
        eta = datetime.timedelta(seconds=int(
            self.iter_seconds * (self.max_iter - cur_iter - 1)))
        log_json_stats({
            "_type": "val_iter",
            "epoch": f"{cur_epoch + 1}/{self._cfg.SOLVER.MAX_EPOCH}",
            "iter": f"{cur_iter + 1}/{self.max_iter}",
            "time_diff": self.iter_seconds, "eta": str(eta),
            "top1_err": self.mb_top1_err.get_win_median(),
            "top5_err": self.mb_top5_err.get_win_median()})

    def log_epoch_stats(self, cur_epoch: int) -> Dict:
        n = max(self.num_samples, 1)
        top1, top5 = self.num_top1_mis / n, self.num_top5_mis / n
        self.min_top1_err = min(self.min_top1_err, top1)
        self.min_top5_err = min(self.min_top5_err, top5)
        stats = {"_type": "val_epoch",
                 "epoch": f"{cur_epoch + 1}/{self._cfg.SOLVER.MAX_EPOCH}",
                 "top1_err": top1, "top5_err": top5,
                 "min_top1_err": self.min_top1_err,
                 "min_top5_err": self.min_top5_err}
        log_json_stats(stats)
        return stats


class EPICValMeter:
    """EPIC-Kitchens validation meter (JAX ``utils/meters.py:257``;
    reference ``lib/utils/meters.py:798-978``): accuracies, not errors,
    each the largest over the epochs so far.  ``update_stats`` takes the
    (verb, noun, action) top-1 and top-5 accuracy triplets in percent."""

    KEYS = ("verb", "noun", "action")

    def __init__(self, max_iter: int, cfg):
        self._cfg = cfg
        self.max_iter = max_iter
        self.mb = {f"{k}_top{j}": ScalarMeter(cfg.LOG_PERIOD)
                   for k in self.KEYS for j in (1, 5)}
        self.num_cor = dict.fromkeys(self.mb, 0.0)
        self.max_acc = dict.fromkeys(self.mb, 0.0)
        self.num_samples = 0
        self._tic = time.perf_counter()
        self.iter_seconds = 0.0
        self.stats: Dict = {}

    def reset(self) -> None:
        for m in self.mb.values():
            m.reset()
        self.num_cor = dict.fromkeys(self.mb, 0.0)
        self.num_samples = 0

    def iter_tic(self) -> None:
        self._tic = time.perf_counter()

    def iter_toc(self) -> None:
        self.iter_seconds = time.perf_counter() - self._tic

    def update_stats(self, top1_acc, top5_acc, mb_size: int) -> None:
        for i, k in enumerate(self.KEYS):
            for j, acc in ((1, top1_acc[i]), (5, top5_acc[i])):
                self.mb[f"{k}_top{j}"].add_value(acc)
                self.num_cor[f"{k}_top{j}"] += acc * mb_size
        self.num_samples += mb_size

    @staticmethod
    def stat_name(key: str) -> str:
        """``verb_top1`` -> ``verb_top1_acc``; the action's are plain
        ``top1_acc``, as the reference logs them."""
        return key.replace("action_", "") + "_acc"

    def log_iter_stats(self, cur_epoch: int, cur_iter: int) -> None:
        if (cur_iter + 1) % self._cfg.LOG_PERIOD != 0:
            return
        eta = datetime.timedelta(seconds=int(
            self.iter_seconds * (self.max_iter - cur_iter - 1)))
        stats = {"_type": "val_iter",
                 "epoch": f"{cur_epoch + 1}/{self._cfg.SOLVER.MAX_EPOCH}",
                 "iter": f"{cur_iter + 1}/{self.max_iter}",
                 "time_diff": self.iter_seconds, "eta": str(eta)}
        for k, m in self.mb.items():
            stats[self.stat_name(k)] = m.get_win_median()
        log_json_stats(stats)

    def log_epoch_stats(self, cur_epoch: int) -> Dict:
        """Logs and returns the epoch's accuracies and the largest so far;
        ``is_best`` says whether the action top-1 rose."""
        n = max(self.num_samples, 1)
        accs = {k: self.num_cor[k] / n for k in self.num_cor}
        is_best = accs["action_top1"] > self.max_acc["action_top1"]
        for k, v in accs.items():
            self.max_acc[k] = max(self.max_acc[k], v)
        stats = {"_type": "val_epoch",
                 "epoch": f"{cur_epoch + 1}/{self._cfg.SOLVER.MAX_EPOCH}",
                 "time_diff": self.iter_seconds}
        for k, v in accs.items():
            stats[self.stat_name(k)] = v
            stats["max_" + self.stat_name(k)] = self.max_acc[k]
        log_json_stats(stats)
        self.stats = dict(stats, is_best=is_best)
        return self.stats


class EPICTestMeter:
    """EPIC-Kitchens multi-view test meter (JAX ``utils/meters.py:430``;
    reference ``lib/utils/meters.py:608``): each video's verb and noun
    logits summed over its ``num_clips`` clips."""

    __test__ = False  # not a pytest class

    def __init__(self, num_videos: int, num_clips: int, num_cls,
                 overall_iters: int):
        self.num_clips = num_clips
        self.overall_iters = overall_iters
        self.verb_preds = np.zeros((num_videos, num_cls[0]), np.float32)
        self.noun_preds = np.zeros((num_videos, num_cls[1]), np.float32)
        self.verb_labels = np.zeros((num_videos,), np.int64)
        self.noun_labels = np.zeros((num_videos,), np.int64)
        self.metadata = np.zeros(num_videos, dtype=object)
        self.clip_count = np.zeros((num_videos,), np.int64)
        self.stats: Dict = {}
        self._tic = time.perf_counter()

    def update_stats(self, preds, labels, metadata, clip_ids) -> None:
        """preds (verb [N, 97], noun [N, 300]); labels (verb [N], noun
        [N]); metadata [N] or None; clip_ids [N] global clip indices."""
        verb_p, noun_p = (np.asarray(p) for p in preds)
        verb_l, noun_l = (np.asarray(x) for x in labels)
        for ind, clip in enumerate(np.asarray(clip_ids)):
            vid_id = int(clip) // self.num_clips
            self.verb_labels[vid_id] = verb_l[ind]
            self.noun_labels[vid_id] = noun_l[ind]
            self.verb_preds[vid_id] += verb_p[ind]
            self.noun_preds[vid_id] += noun_p[ind]
            if metadata is not None:
                self.metadata[vid_id] = metadata[ind]
            self.clip_count[vid_id] += 1

    def iter_tic(self) -> None:
        self._tic = time.perf_counter()

    def log_iter_stats(self, cur_iter: int) -> None:
        dt = time.perf_counter() - self._tic
        eta = datetime.timedelta(seconds=int(dt * (self.overall_iters
                                                   - cur_iter)))
        log_json_stats({"split": "test_iter", "cur_iter": str(cur_iter + 1),
                        "eta": str(eta), "time_diff": dt})

    def finalize_metrics(self, ks=(1, 5)) -> Dict:
        stats = {"split": "test_final"}
        vp, np_, vl, nl = (torch.from_numpy(a) for a in (
            self.verb_preds, self.noun_preds, self.verb_labels,
            self.noun_labels))
        verb = metrics.topk_accuracies(vp, vl, ks)
        noun = metrics.topk_accuracies(np_, nl, ks)
        action = metrics.multitask_topk_accuracies((vp, np_), (vl, nl), ks)
        for k, v, n, a in zip(ks, verb, noun, action):
            stats[f"verb_top{k}_acc"] = "{:.2f}".format(float(v))
            stats[f"noun_top{k}_acc"] = "{:.2f}".format(float(n))
            stats[f"action_top{k}_acc"] = "{:.2f}".format(float(a))
        log_json_stats(stats)
        self.stats = stats
        return stats
