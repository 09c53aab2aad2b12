"""Command-line entry of the port (counterpart of ``tools/run_net.py``).

    python -m procedurevrl_torch.tools.run_net --cfg configs/COIN/step_classification.yaml \\
        TRAIN.ENABLE False DEV.MATCH_LANG_EMB True DEV.LOAD_DUMMY_DATA True

runs the multi-view test on the card and prints the final top-1/top-5 as
one JSON line.  ``--device cpu`` runs the plain PyTorch path instead.
Training comes with slice 2.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from procedurevrl_torch.config import load_config


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="ProcedureVRL (PyTorch port) testing pipeline.")
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
        raise SystemExit("training is not ported yet: pass TRAIN.ENABLE False")
    if not cfg.TEST.ENABLE:
        return 0
    from procedurevrl_torch.tools.test_net import test

    stats = test(cfg, device=args.device)
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
