"""One pretraining train step over a group of processes against one
process (the port's ``dryrun_multichip``; JAX
``__graft_entry__.py:dryrun_multichip``).

    python -m procedurevrl_torch.tools.dryrun --n 2 [--device cpu]

spawns ``n`` ranks (``utils/misc.py:launch_job``): gloo on the CPU, NCCL
on the cards where ``n <= torch.cuda.device_count()``, else gloo sharing
them.  Each takes its rows of one seeded global batch of ``n`` order-
pretraining samples (9 clips each) and runs the full train step at a
small geometry in float32 (width 128, depth 1, 2 frames of 32^2, AdamW)
with every random stream on; rank 0's loss, gradient norm, averaged
gradients and updated parameters must equal one process's on the whole
batch (fp32: 2e-5 on the metrics, 5e-5 on the gradients and on the
parameters; where a gradient is below 1e-6, AdamW's first step, about
``lr x sign(g)``, may take the other sign, so there within 2 lr), which
catches a wrong gradient average or a draw that is not the global
batch's, not only "it ran".  Extra ``KEY
VALUE`` pairs override the config (``TPU.SHARD_OPT_STATE True`` runs it
under ZeRO-1).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
import time
from typing import Dict, Sequence, Union

import numpy as np
import torch

from procedurevrl_torch.config import load_config
from procedurevrl_torch.engine.steps import make_train_step
from procedurevrl_torch.models.build import build_model
from procedurevrl_torch.parallel import ddp
from procedurevrl_torch.parallel.collectives import (
    get_rank, get_world_size, is_master_proc,
)
from procedurevrl_torch.solver.lr_policy import lr_schedule
from procedurevrl_torch.utils.device import resolve_device
from procedurevrl_torch.utils.misc import launch_job

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PRETRAIN = os.path.join(ROOT, "configs/HowTo100M/procedurevrl_adamw.yaml")
SMALL = ["DEV.LOAD_DUMMY_DATA", "True", "TIMESFORMER.DEPTH", "1",
         "DATA.NUM_FRAMES", "2", "DATA.TRAIN_CROP_SIZE", "32",
         "DEV.TEXT_LAYERS", "1", "DEV.ORDER_TFM_LAYERS", "2",
         "MODEL.NUM_CLASSES", "50", "TPU.COMPUTE_DTYPE", "float32"]
TOL = 2e-5  # loss and gradient norm, relative
GRAD_TOL = 5e-5  # gradients (atol = rtol) and parameters (atol)
SMALL_GRAD = 1e-6  # below it AdamW's first step may flip its sign


def small_cfg(n: int, opts: Sequence[str] = ()):
    """The pretraining config at the dry run's geometry, a global batch of
    ``n`` samples in one optimizer step, ``NUM_GPUS n``."""
    return load_config(PRETRAIN, [*SMALL, "TRAIN.BATCH_SIZE", str(n),
                                  "GLOBAL_BATCH_SIZE", str(n), "NUM_GPUS",
                                  str(n), *opts])


def global_batch(cfg, n: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """``n`` seeded order-pretraining samples."""
    rng = np.random.RandomState(seed)
    m, t, s = (cfg.DEV.ORDER_PRETRAIN_MAX_LEN, cfg.DATA.NUM_FRAMES,
               cfg.DATA.TRAIN_CROP_SIZE)
    return {"frames": rng.randint(0, 256, (n, m, t, s, s, 3)).astype(np.uint8),
            "labels": np.zeros(n, np.int64),
            "clip_text_ids": rng.randint(1, 49000, (n, m, 77)).astype(
                np.int64),
            "clip_vis_feat": rng.randn(n, m, 512).astype(np.float32)}


def one_step(cfg, device: torch.device, batch: Dict[str, np.ndarray]
             ) -> Dict:
    """One train step of this process (its rows of ``batch`` in a group):
    the metrics and the updated parameters, on the host."""
    model, bank = build_model(cfg, device)
    optimizer = ddp.build_optimizer(model, cfg)
    step = make_train_step(ddp.wrap_model(model), optimizer, cfg, bank,
                           lr_schedule(cfg, 10))
    rows = ddp.local_batch_slice(len(batch["labels"]), get_world_size(),
                                 get_rank())
    metrics = step({k: torch.from_numpy(v[rows]).to(device)
                    for k, v in batch.items()})
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "params": {k: p.detach().cpu() for k, p in
                       model.named_parameters() if p.requires_grad},
            "grads": {k: p.grad.cpu() for k, p in model.named_parameters()
                      if p.requires_grad},
            "lr": metrics["lr"],
            "optimizer_bytes": ddp.optimizer_bytes(optimizer)}


def _rank_step(cfg, device, n: int, out: str) -> None:
    result = one_step(cfg, device, global_batch(cfg, n))
    if is_master_proc():
        torch.save(result, out)


def dryrun_multichip(n: int, device: Union[str, torch.device, None] = None,
                     opts: Sequence[str] = (), timeout: float = 600.0
                     ) -> Dict:
    """The dry run on ``n`` ranks; raises ``AssertionError`` where rank 0
    differs from one process.  Returns the numbers compared: the losses,
    gradient norms, the largest parameter difference, rank 0's optimizer
    bytes and the group's wall seconds."""
    device = resolve_device(device)
    cfg = small_cfg(n, opts)
    if device.type == "cuda":
        cfg.DIST_BACKEND = ("nccl" if n <= torch.cuda.device_count()
                            else "gloo")
    batch = global_batch(cfg, n)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pt")
        t0 = time.perf_counter()
        launch_job(cfg, f"file://{tmp}/group",
                   functools.partial(_rank_step, n=n, out=out),
                   device, timeout=timeout, join_timeout=timeout)
        wall = time.perf_counter() - t0
        got = torch.load(out, weights_only=False)
    want = one_step(cfg, device, batch)
    for k in ("loss", "grad_norm"):
        assert abs(got[k] - want[k]) <= TOL * abs(want[k]), (k, got[k],
                                                              want[k])
    grad_diff = param_diff = 0.0
    for k, g in want["grads"].items():
        gd = (got["grads"][k] - g).abs()
        assert bool((gd <= GRAD_TOL * (1 + g.abs())).all()), (k, float(
            gd.max()))
        slack = torch.where(g.abs() > SMALL_GRAD, 0.0, 2 * want["lr"])
        pd = (got["params"][k] - want["params"][k]).abs()
        assert bool((pd <= GRAD_TOL + slack).all()), (k, float(pd.max()))
        grad_diff = max(grad_diff, float(gd.max()))
        param_diff = max(param_diff, float((pd - slack).clamp(min=0).max()))
    return {"n": n, "backend": cfg.DIST_BACKEND if device.type == "cuda"
            else "gloo", "loss": got["loss"], "loss_one": want["loss"],
            "grad_norm": got["grad_norm"], "grad_norm_one": want["grad_norm"],
            "max_grad_diff": grad_diff,
            "max_param_diff_past_slack": param_diff,
            "optimizer_bytes": got["optimizer_bytes"],
            "optimizer_bytes_one": want["optimizer_bytes"],
            "wall_s": wall}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=2, help="ranks")
    p.add_argument("--device", default=None, help="cuda (default) or cpu.")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="KEY VALUE config overrides")
    args = p.parse_args(argv)
    print(json.dumps(dryrun_multichip(args.n, args.device, args.opts or ())),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
