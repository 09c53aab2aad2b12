"""Command-line entry of the port (counterpart of ``tools/run_net.py``).

    python -m procedurevrl_torch.tools.run_net \\
        --cfg configs/HowTo100M/procedurevrl_adamw.yaml \\
        DEV.LOAD_DUMMY_DATA True TRAIN.BATCH_SIZE 2 GLOBAL_BATCH_SIZE 2

runs order pretraining on the card (``TRAIN.ENABLE``; the same with
``configs/HowTo100M/procedurevrl_mvitv2_adamw.yaml`` trains MViT-v2-S), and

    python -m procedurevrl_torch.tools.run_net \\
        --cfg configs/COIN/step_classification.yaml \\
        TRAIN.ENABLE False DEV.MATCH_LANG_EMB True DEV.LOAD_DUMMY_DATA True

runs the multi-view test (``TEST.ENABLE``).  A COIN finetune,

    python -m procedurevrl_torch.tools.run_net \\
        --cfg configs/COIN/step_forecasting.yaml \\
        DEV.LOAD_DUMMY_DATA True SOLVER.MAX_EPOCH 1

(also ``step_classification.yaml``, ``task_classification.yaml``) trains
the heads on the frozen encoder with evaluation on the val split, then
tests the model of the last checkpoint in ``OUTPUT_DIR``.  The
EPIC-Kitchens-100 full finetune (TimeSformer-B, 32 frames, verb and noun
heads, 30 test views a video),

    python -m procedurevrl_torch.tools.run_net \\
        --cfg configs/EK/egocentric_action_classification.yaml \\
        DEV.LOAD_DUMMY_DATA True TRAIN.EPOCH_MUL 2

trains, validates and tests the same way (``TRAIN.EPOCH_MUL 2``: the 64
synthetic videos make 2 micro-batches of 32 an epoch, fewer than the 4
that ``GLOBAL_BATCH_SIZE 128`` accumulates).  A finetune
starts from a pretraining run's file with ``TRAIN.CHECKPOINT_FILE_PATH
<file> TRAIN.CHECKPOINT_EPOCH_RESET True``, and every run resumes from
``OUTPUT_DIR``'s last checkpoint under ``TRAIN.AUTO_RESUME`` (the shipped
configs set it, with ``OUTPUT_DIR .``: give each run its own
``OUTPUT_DIR``).  The logs go to stdout and ``OUTPUT_DIR/stdout.log``;
train and test each print their final stats as one JSON line (a line of
its own that starts with ``{``).  ``--device cpu`` runs the plain PyTorch
path instead.

Data parallel (``parallel/ddp.py``): ``NUM_GPUS N`` spawns N ranks on this
host, joined at ``--init_method`` (``tcp://localhost:<port>`` or
``file://<path>``), rank ``--shard_id x N + d`` on card ``d``, NCCL on the
cards (``DIST_BACKEND gloo`` lets ranks share one) and gloo under
``--device cpu``; ``--num_shards`` hosts run the same command with their
own ``--shard_id``.  ``TRAIN.BATCH_SIZE`` is per host, split over its
ranks; only rank 0 logs, prints and writes.

    python -m procedurevrl_torch.tools.run_net --device cpu \\
        --init_method file:///tmp/pvrl_group \\
        --cfg configs/HowTo100M/procedurevrl_adamw.yaml NUM_GPUS 2 \\
        DEV.LOAD_DUMMY_DATA True TRAIN.BATCH_SIZE 2 GLOBAL_BATCH_SIZE 2
"""

from __future__ import annotations

import argparse
import json
import sys

from procedurevrl_torch.config import load_config
from procedurevrl_torch.parallel.collectives import is_master_proc
from procedurevrl_torch.utils.device import resolve_device
from procedurevrl_torch.utils.logging import setup_logging
from procedurevrl_torch.utils.misc import launch_job


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="ProcedureVRL (PyTorch port) training and testing "
                    "pipeline.")
    parser.add_argument("--cfg", dest="cfg_file", default=None,
                        help="Path to the config file.")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu.")
    parser.add_argument("--shard_id", default=0, type=int,
                        help="The shard id of this host (0-based).")
    parser.add_argument("--num_shards", default=1, type=int,
                        help="Number of hosts in the job.")
    parser.add_argument("--init_method", default="tcp://localhost:9999",
                        help="Where the ranks meet: tcp://host:port or "
                             "file://path.")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None,
                        help="KEY VALUE overrides, see "
                             "procedurevrl_torch/config/defaults.py.")
    return parser.parse_args(argv)


def run(cfg, device) -> None:
    """Train then test, as the config enables them; rank 0 prints each
    one's stats line."""
    if cfg.TRAIN.ENABLE:
        from procedurevrl_torch.tools.train_net import train

        stats = train(cfg, device=device)
        last = stats["history"][-1] if stats["history"] else {}
        val = stats["val"][-1] if stats["val"] else {}
        if is_master_proc():
            print(json.dumps({"split": "train", "steps": stats["steps"],
                              "clips_per_sec": stats["clips_per_sec"],
                              **last,
                              **{f"val_{k}": v for k, v in val.items()
                                 if k.endswith(("_err", "_acc"))}}),
                  flush=True)
    if cfg.TEST.ENABLE:
        from procedurevrl_torch.tools.test_net import test

        stats = test(cfg, device=device)
        if is_master_proc():
            print(json.dumps(stats), flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = load_config(args.cfg_file, [
        *(args.opts or ()), "NUM_SHARDS", str(args.num_shards), "SHARD_ID",
        str(args.shard_id)])
    device = resolve_device(args.device)
    setup_logging(cfg.OUTPUT_DIR)
    launch_job(cfg, args.init_method, run, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
