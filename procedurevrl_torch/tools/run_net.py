"""Command-line entry of the port (counterpart of ``tools/run_net.py``).

    python -m procedurevrl_torch.tools.run_net \\
        --cfg configs/HowTo100M/procedurevrl_adamw.yaml \\
        DEV.LOAD_DUMMY_DATA True TRAIN.BATCH_SIZE 2 GLOBAL_BATCH_SIZE 2

runs order pretraining on the card (``TRAIN.ENABLE``; the same with
``configs/HowTo100M/procedurevrl_mvitv2_adamw.yaml`` trains MViT-v2-S), and

    python -m procedurevrl_torch.tools.run_net \\
        --cfg configs/COIN/step_classification.yaml \\
        TRAIN.ENABLE False DEV.MATCH_LANG_EMB True DEV.LOAD_DUMMY_DATA True

runs the multi-view test (``TEST.ENABLE``).  Each prints its final stats
as one JSON line.  ``--device cpu`` runs the plain PyTorch path instead.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from procedurevrl_torch.config import load_config


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="ProcedureVRL (PyTorch port) training and testing "
                    "pipeline.")
    parser.add_argument("--cfg", dest="cfg_file", default=None,
                        help="Path to the config file.")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu.")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None,
                        help="KEY VALUE overrides, see "
                             "procedurevrl_torch/config/defaults.py.")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = load_config(args.cfg_file, args.opts or ())
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="[%(asctime)s][%(levelname)s] %(message)s")
    if cfg.TRAIN.ENABLE:
        from procedurevrl_torch.tools.train_net import train

        stats = train(cfg, device=args.device)
        last = stats["history"][-1] if stats["history"] else {}
        print(json.dumps({"split": "train", "steps": stats["steps"],
                          "clips_per_sec": stats["clips_per_sec"], **last}))
    if cfg.TEST.ENABLE:
        from procedurevrl_torch.tools.test_net import test

        print(json.dumps(test(cfg, device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
