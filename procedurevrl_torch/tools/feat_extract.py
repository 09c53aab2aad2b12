"""Per-view predictions of the test split (counterpart of
``tools/feat_extract.py:33-76``; reference ``tools/feat_extract.py``).

``test_net``'s model and batches, without the per-video ensemble: every
view's predictions (the softmax of a classification head or step bank;
for EPIC-Kitchens the verb and noun logits side by side, [N, 97 + 300]),
its label (EPIC-Kitchens: the verb) and its clip index, in the order of
the test split, pickled by rank 0 as ``{"preds", "labels", "index"}`` into
``OUTPUT_DIR/(TEST.SAVE_PREDICT_PATH or "features.pkl")``.

    python -m procedurevrl_torch.tools.feat_extract \\
        --cfg configs/COIN/step_classification.yaml \\
        DEV.MATCH_LANG_EMB True DEV.LOAD_DUMMY_DATA True OUTPUT_DIR <dir>

runs on the card (``--device cpu`` for the CPU); ``NUM_GPUS``,
``--init_method`` and the other launch options are ``run_net``'s.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import sys
from typing import Dict, Union

import numpy as np
import torch

from procedurevrl_torch.config import load_config
from procedurevrl_torch.datasets.loader import Loader, construct_loader
from procedurevrl_torch.engine.steps import make_eval_step
from procedurevrl_torch.models.build import build_model
from procedurevrl_torch.parallel import ddp
from procedurevrl_torch.parallel.collectives import (
    all_gather_rows, is_master_proc,
)
from procedurevrl_torch.tools.train_net import device_batches
from procedurevrl_torch.utils import checkpoint as cu
from procedurevrl_torch.utils import weights
from procedurevrl_torch.utils.device import resolve_device
from procedurevrl_torch.utils.logging import get_logger, setup_logging
from procedurevrl_torch.utils.misc import launch_job

logger = get_logger(__name__)


def perform_extract(loader: Loader, eval_step, cfg,
                    device: torch.device) -> Dict[str, np.ndarray]:
    """Every test view's predictions, labels and clip indices, the valid
    rows of every rank in the global batch's order (JAX
    ``perform_extract``)."""
    preds_all, labels_all, idx_all = [], [], []
    batches = device_batches(loader, device, cfg)
    with contextlib.closing(batches):
        for cur_iter, (batch, n_valid, _extra, _host) in enumerate(batches):
            preds = eval_step(batch)
            if isinstance(preds, tuple):  # EPIC: verb | noun logits
                preds = torch.cat(preds, dim=1)
            key = "labels" if "labels" in batch else "verb"
            for out, t in ((preds_all, preds), (labels_all, batch[key]),
                           (idx_all, batch["index"])):
                out.append(all_gather_rows(t, n_valid).cpu().numpy())
            if (cur_iter + 1) % cfg.LOG_PERIOD == 0:
                logger.info("extract iter %d/%d", cur_iter + 1, len(loader))
    return {"preds": np.concatenate(preds_all),
            "labels": np.concatenate(labels_all),
            "index": np.concatenate(idx_all)}


def extract(cfg, device: Union[str, torch.device, None] = None
            ) -> Dict[str, np.ndarray]:
    """Build ``test_net``'s model (random init, the pretrained encoder,
    the test checkpoint), extract, and write the pickle on rank 0; returns
    what it holds.  ``device`` defaults to the card; pass ``"cpu"`` for
    the plain path."""
    ddp.check_mesh(cfg)
    device = resolve_device(device)
    setup_logging(cfg.OUTPUT_DIR)
    model, label_emb = build_model(cfg, device)
    weights.load_pretrained_encoder(model, cfg)
    cu.load_test_checkpoint(cfg, model)
    out = perform_extract(construct_loader(cfg, "test"),
                          make_eval_step(model, cfg, label_emb), cfg, device)
    if is_master_proc():
        path = os.path.join(cfg.OUTPUT_DIR,
                            cfg.TEST.SAVE_PREDICT_PATH or "features.pkl")
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(out, f)
        logger.info("Saved %s (%s preds)", path, out["preds"].shape)
    return out


def _run(cfg, device) -> None:
    extract(cfg, device)


def main(argv=None) -> int:
    from procedurevrl_torch.tools.run_net import parse_args

    args = parse_args(argv)
    cfg = load_config(args.cfg_file, [
        *(args.opts or ()), "NUM_SHARDS", str(args.num_shards), "SHARD_ID",
        str(args.shard_id)])
    launch_job(cfg, args.init_method, _run, resolve_device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
