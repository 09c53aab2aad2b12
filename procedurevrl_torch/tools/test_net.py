"""Multi-view testing (counterpart of ``tools/test_net.py``; reference
``tools/test_net.py``).

Every test video contributes ``NUM_ENSEMBLE_VIEWS x NUM_SPATIAL_CROPS``
clips; each clip's softmax predictions are ensembled per video by the
TestMeter, then top-1/top-5 are finalised; an EPIC-Kitchens model's verb
and noun logits are summed per video by the EPICTestMeter, which reports
verb, noun and action top-1/top-5 (JAX ``tools/test_net.py:37-70``,
:122-126).  Zero-shot COIN step
classification and step forecasting (``MODEL.NUM_SEG`` observed clips a
sample, ``[B, NUM_SEG * T, ...]`` batches) run this path with the CLIP step
bank as the classifier, the finetuning heads with none.  The weights come
from the first of ``TEST.CHECKPOINT_FILE_PATH``, ``OUTPUT_DIR``'s last
checkpoint and ``TRAIN.CHECKPOINT_FILE_PATH``
(``utils/checkpoint.py:load_test_checkpoint``), over the pretrained encoder
of ``TIMESFORMER.PRETRAINED_MODEL``.  ``TEST.SAVE_RESULTS_PATH`` and
``TEST.SAVE_PREDICT_PATH`` dump the per-video predictions and labels into
``OUTPUT_DIR``.  Batches come from ``construct_loader(cfg, "test")``
through ``prefetch_to_device``, the last one padded; the meter takes each
batch's ``n_valid`` real rows.  In a group of processes every rank's valid
rows reach every rank's meter (rank order: the global batch's rows), and
only rank 0 logs and writes the results.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import time
from typing import Dict, Union

import torch

from procedurevrl_torch.datasets.loader import Loader, construct_loader
from procedurevrl_torch.engine.steps import make_eval_step
from procedurevrl_torch.models.build import build_model
from procedurevrl_torch.models.procedurevrl import EPIC_NOUNS, EPIC_VERBS
from procedurevrl_torch.parallel import ddp
from procedurevrl_torch.parallel.collectives import (
    all_gather_rows, gather_objects, is_master_proc,
)
from procedurevrl_torch.tools.train_net import device_batches
from procedurevrl_torch.utils import checkpoint as cu
from procedurevrl_torch.utils import misc, weights
from procedurevrl_torch.utils.device import resolve_device
from procedurevrl_torch.utils.logging import get_logger, setup_logging
from procedurevrl_torch.utils.meters import EPICTestMeter, TestMeter

logger = get_logger(__name__)


def perform_test(loader: Loader, eval_step,
                 test_meter: Union[TestMeter, EPICTestMeter], cfg,
                 device: torch.device) -> Dict:
    """Run every test clip through ``eval_step`` and finalise the meter.

    Besides the meter's stats, returns ``clips_per_sec``: clips (a
    forecasting sample is ``NUM_SEG`` of them) over host seconds from the
    end of the first batch to the end of the last (each batch ends when its
    predictions reach the host), i.e. the steady rate without the first
    batch's warm-up, the input path included; null with a single batch."""
    n_clips = 0
    t_first = None
    clips = loader.dataset.clips
    test_meter.iter_tic()
    batches = device_batches(loader, device, cfg)
    with contextlib.closing(batches):
        for cur_iter, (batch, n_valid, extra, _host) in enumerate(batches):
            preds = eval_step(batch)

            def rows(t: torch.Tensor):
                return all_gather_rows(t, n_valid).cpu().numpy()

            index = rows(batch["index"])
            if isinstance(preds, tuple):  # EPIC: (verb, noun) logits
                meta = extra.get("narration_id")
                if meta is not None:
                    meta = sum(gather_objects(list(meta[:n_valid])), [])
                test_meter.update_stats(
                    tuple(rows(p) for p in preds),
                    (rows(batch["verb"]), rows(batch["noun"])), meta, index)
            else:
                test_meter.update_stats(rows(preds), rows(batch["labels"]),
                                        index)
            if t_first is None:
                t_first = time.perf_counter()
            else:
                n_clips += len(index) * clips
            test_meter.log_iter_stats(cur_iter)
            test_meter.iter_tic()
    elapsed = time.perf_counter() - t_first
    stats = dict(test_meter.finalize_metrics())
    stats["clips_per_sec"] = n_clips / elapsed if n_clips else None
    if is_master_proc():
        save_results(test_meter, cfg)
    return stats


def save_results(test_meter: Union[TestMeter, EPICTestMeter], cfg) -> None:
    """``TEST.SAVE_RESULTS_PATH``: a pickle of ``{"preds", "labels"}`` (the
    ensembled per-video predictions and labels, numpy; EPIC-Kitchens:
    ``{"verb", "noun"}``, the summed logits); and ``TEST.SAVE_PREDICT_PATH``:
    the same as tensors by ``torch.save``, the reference's
    ``vis_pred_zeroshot_step_cls.pth`` format, not for EPIC-Kitchens (JAX
    ``tools/test_net.py:78-89`` reads ``video_preds``, which its EPIC meter
    lacks); both in ``OUTPUT_DIR`` (JAX :62-89)."""
    epic = isinstance(test_meter, EPICTestMeter)
    if cfg.TEST.SAVE_RESULTS_PATH:
        out = os.path.join(cfg.OUTPUT_DIR, cfg.TEST.SAVE_RESULTS_PATH)
        with open(out, "wb") as f:
            pickle.dump({"verb": test_meter.verb_preds,
                         "noun": test_meter.noun_preds} if epic else
                        {"preds": test_meter.video_preds,
                         "labels": test_meter.video_labels}, f)
        logger.info("Saved results to %s", out)
    if epic:
        return
    if cfg.TEST.SAVE_PREDICT_PATH:
        out = os.path.join(cfg.OUTPUT_DIR, cfg.TEST.SAVE_PREDICT_PATH)
        torch.save({"preds": torch.from_numpy(test_meter.video_preds.copy()),
                    "labels": torch.from_numpy(
                        test_meter.video_labels.copy())}, out)
        logger.info("Saved predictions to %s", out)


def test(cfg, device: Union[str, torch.device, None] = None) -> Dict:
    """Test entry: build the model (random init from ``RNG_SEED``, then the
    pretrained encoder and the checkpoint the module names), run the
    multi-view test, return stats.  ``device`` defaults to the card; pass
    ``"cpu"`` for the plain path.  In a group of processes each rank calls
    it with its card and returns the same stats."""
    ddp.check_mesh(cfg)
    device = resolve_device(device)
    setup_logging(cfg.OUTPUT_DIR)
    logger.info("Test with config:\n%s", cfg.dump())
    model, label_emb = build_model(cfg, device)
    weights.load_pretrained_encoder(model, cfg)
    cu.load_test_checkpoint(cfg, model)
    misc.log_model_info(model, cfg)
    if model.match_lang_emb and label_emb is None:
        raise ValueError("zero-shot testing needs a step bank "
                         "(DEV.TEST_LANG_EMB)")
    loader = construct_loader(cfg, "test")
    num_clips = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    if len(loader.dataset) % num_clips:
        raise ValueError(f"test size {len(loader.dataset)} not divisible by "
                         f"views x crops {num_clips}")
    num_videos = len(loader.dataset) // num_clips
    if cfg.TEST.DATASET == "Epickitchens":
        test_meter = EPICTestMeter(num_videos, num_clips,
                                   [EPIC_VERBS, EPIC_NOUNS], len(loader))
    else:
        test_meter = TestMeter(
            num_videos, num_clips, cfg.MODEL.NUM_CLASSES, len(loader),
            multi_label=cfg.DATA.MULTI_LABEL,
            ensemble_method=cfg.DATA.ENSEMBLE_METHOD)
    return perform_test(loader, make_eval_step(model, cfg, label_emb),
                        test_meter, cfg, device)
