"""The rank programs of ``tests/test_torch_ddp.py``.

Spawned ranks import this module, not the test module, so they import
neither JAX nor pytest.  Each program runs in one process: a rank of a
gloo group (``run_programs`` under ``launch_job``) or, called directly,
the single process it is compared with.  A program returns a dict of host
tensors and numbers.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from procedurevrl_torch.config import get_cfg, load_config
from procedurevrl_torch.datasets import howto100m
from procedurevrl_torch.engine.steps import make_train_step
from procedurevrl_torch.models.build import build_model
from procedurevrl_torch.models.procedurevrl import ProcedureVRL
from procedurevrl_torch.parallel import ddp
from procedurevrl_torch.parallel.collectives import (
    get_rank, get_world_size, sync_global_barrier,
)
from procedurevrl_torch.solver.lr_policy import lr_schedule
from procedurevrl_torch.tools import dryrun
from procedurevrl_torch.utils import checkpoint as cu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EK = os.path.join(ROOT, "configs/EK/egocentric_action_classification.yaml")
STEP_CLS = os.path.join(ROOT, "configs/COIN/step_classification.yaml")
BANK = os.path.join(ROOT, "data/clip_step_emb_coin.pth")
NO_TEXT = ["MODEL.TEXT_MODEL", "none"]  # the frozen CLIP tower left out
TINY = ["TIMESFORMER.DEPTH", "1", "DATA.NUM_FRAMES", "2",
        "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
        "DATA.TRAIN_JITTER_SCALES", "[36, 40]", "TPU.COMPUTE_DTYPE",
        "float32", "DATA_LOADER.NUM_WORKERS", "2", "NUM_GPUS", "2"]


def _host(metrics):
    return {k: float(v) for k, v in metrics.items()}


def _rows(a: np.ndarray, axis: int = 0) -> np.ndarray:
    """This process's rows of a global array."""
    sl = ddp.local_batch_slice(a.shape[axis], get_world_size(), get_rank())
    return np.take(a, range(sl.start, sl.stop), axis=axis)


def _draws_rows(draws):
    return {k: torch.from_numpy(_rows(np.asarray(v),
                                      1 if k == "level_noise" else 0))
            for k, v in draws.items()}


def train_step(cfg, batches, draws=None, model=None, bank=None,
               save_dir=None):
    """One optimizer step of ``cfg`` over the global micro-batches
    ``batches`` (numpy), of which this process takes its rows: the
    metrics, the trained parameters and their gradients, this rank's
    optimizer bytes; with ``save_dir`` every rank calls the checkpoint
    save (rank 0 writes)."""
    if model is None:
        model, bank = build_model(cfg, "cpu")
    optimizer = ddp.build_optimizer(model, cfg)
    step = make_train_step(ddp.wrap_model(model), optimizer, cfg, bank,
                           lr_schedule(cfg, 10), len(batches))
    micro = [{k: torch.from_numpy(_rows(v)) for k, v in b.items()}
             for b in batches]
    dr = None if draws is None else [_draws_rows(d) for d in draws]
    m = step(micro if len(micro) > 1 else micro[0],
             draws=dr if dr is None or len(dr) > 1 else dr[0])
    if save_dir is not None:
        cu.save_checkpoint(save_dir, model, optimizer, cfg, 0, 1)
    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
    return {"metrics": _host(m),
            "params": {n: p.detach().clone() for n, p in trained.items()},
            "grads": {n: p.grad.clone() for n, p in trained.items()},
            "optimizer_bytes": ddp.optimizer_bytes(optimizer)}


def pretrain_cfg(n: int, accum: int = 1, *opts):
    return dryrun.small_cfg(n, ["GLOBAL_BATCH_SIZE", str(n * accum),
                                "MODEL.DROP_PATH", "0.2", "NUM_GPUS", "2",
                                *NO_TEXT, *opts])


def pretrain(n: int = 4, accum: int = 1, opts=(), save_dir=None):
    """The order-pretraining step, every random stream on (drop path 0.2,
    the diffusion draws, the recognition subset)."""
    cfg = pretrain_cfg(n, accum, *opts)
    batches = [dryrun.global_batch(cfg, n, seed) for seed in range(accum)]
    return train_step(cfg, batches, save_dir=save_dir)


def epic(n: int = 4):
    """The EK finetune step (verb + noun heads, ``MIXUP.ENABLED`` as the
    config sets it, drop path on)."""
    cfg = load_config(EK, [*TINY, "TRAIN.BATCH_SIZE", str(n),
                           "GLOBAL_BATCH_SIZE", str(n)])
    rng = np.random.RandomState(7)
    batch = {"frames": rng.randint(0, 256, (n, 2, 32, 32, 3)).astype(
        np.uint8), "verb": rng.randint(0, 97, n), "noun": rng.randint(
        0, 300, n)}
    return train_step(cfg, [batch])


def mixup(n: int = 4):
    """The COIN step-classification head under mixup / CutMix (prob 1):
    row i mixes with row n - 1 - i of the global batch."""
    cfg = load_config(STEP_CLS, [
        *TINY, "TRAIN.BATCH_SIZE", str(n), "GLOBAL_BATCH_SIZE", str(n),
        "MIXUP.ENABLED", "True", "MIXUP.ALPHA", "0.8", "MIXUP.CUTMIX_ALPHA",
        "1.0", "MIXUP.PROB", "1.0", "DEV.TEST_LANG_EMB", BANK])
    rng = np.random.RandomState(8)
    batch = {"frames": rng.randint(0, 256, (n, 2, 32, 32, 3)).astype(
        np.uint8), "labels": np.arange(n) * 7}
    out = {}
    for branch in ("mixup", "cutmix"):
        cfg.MIXUP.SWITCH_PROB = 0.0 if branch == "mixup" else 1.0
        out[branch] = train_step(cfg, [batch])
    return out


def fixed(path: str, method: str = "adamw"):
    """The pretraining step of a model built from the state in the file
    ``path`` on its fixed draws (``tests/test_torch_train.py``'s geometry:
    ``geom``, ``towers``, ``state``, ``bank``, ``batch``, ``draws``), to
    hold against JAX.  The inputs come through a file: a spawned rank's
    arguments travel through a pipe, which must not fill."""
    inputs = torch.load(path, weights_only=False)
    geom, towers, state, bank, batch, draws = (inputs[k] for k in (
        "geom", "towers", "state", "bank", "batch", "draws"))
    cfg = get_cfg()
    cfg.TRAIN.LABEL_EMB, cfg.TRAIN.TEXT, cfg.TRAIN.TOPK = "bank", "asr", 5
    cfg.SOLVER.OPTIMIZING_METHOD = method
    cfg.SOLVER.BASE_LR, cfg.SOLVER.LR_POLICY = 1e-3, "cosine"
    cfg.SOLVER.COSINE_END_LR, cfg.SOLVER.MAX_EPOCH = 0.0, 10
    cfg.SOLVER.WARMUP_EPOCHS, cfg.SOLVER.WEIGHT_DECAY = 0.0, 1e-4
    cfg.TPU.COMPUTE_DTYPE, cfg.NUM_GPUS = "float32", 2
    model = ProcedureVRL(**geom, **towers)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return train_step(cfg, [batch], [draws], model, torch.from_numpy(bank))


def run_test(config: str, opts, out_dir: str, videos: int = 0):
    """``test_net.test`` on the config's dummy test split, its stats and
    the results it wrote."""
    import pickle

    from procedurevrl_torch.tools.test_net import test

    if videos:
        howto100m.NUM_SYNTHETIC = videos
    cfg = load_config(config, [*TINY, *opts, "OUTPUT_DIR", out_dir,
                               "TEST.SAVE_RESULTS_PATH", "results.pkl"])
    stats = test(cfg, "cpu")
    sync_global_barrier()  # rank 0 wrote the results
    with open(os.path.join(out_dir, "results.pkl"), "rb") as f:
        return {"stats": stats, "results": pickle.load(f)}


def resume(out_dir: str, opts=()):
    """Order pretraining through ``train_net.train`` on the dummy index: 2
    epochs straight, and 1 epoch then a resumed second; the parameters
    of both runs and the files of the first."""
    from procedurevrl_torch.tools.train_net import train

    howto100m.NUM_SYNTHETIC = 4
    base = ["DEV.LOAD_DUMMY_DATA", "True", *dryrun.SMALL, "NUM_GPUS", "2",
            "TRAIN.BATCH_SIZE", "2", "GLOBAL_BATCH_SIZE", "2",
            "TPU.ASYNC_CHECKPOINT", "False", "DATA_LOADER.NUM_WORKERS", "2",
            "MODEL.DROP_PATH", "0.2", *NO_TEXT, *opts]
    cfg_file = dryrun.PRETRAIN
    out = {}
    for name, runs in (("straight", (2,)), ("resumed", (1, 2))):
        job = os.path.join(out_dir, name)
        for epochs in runs:
            stats = train(load_config(cfg_file, [*base, "SOLVER.MAX_EPOCH",
                                                 str(epochs), "OUTPUT_DIR",
                                                 job]), "cpu")
        out[name] = {n: p.detach().clone() for n, p in
                     stats["model"].named_parameters()}
        out[name + "_start"] = (stats["start_epoch"], stats["start_step"])
    return out


def fails(seconds: float):
    """Rank 1 raises; rank 0 waits in a barrier for it."""
    if get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()
    time.sleep(seconds)
    return {}


def sleeps(seconds: float):
    time.sleep(seconds)
    return {}


def run_programs(cfg, device, programs, out_dir: str) -> None:
    """A rank of ``utils/misc.py:launch_job``: each ``(name, program,
    kwargs)`` of ``programs`` in turn, its result saved to
    ``out_dir/<name>.<rank>.pt``."""
    del cfg, device
    torch.set_num_threads(2)  # two ranks share the host's cores
    for name, program, kwargs in programs:
        result = globals()[program](**kwargs)
        torch.save(result, os.path.join(out_dir, f"{name}.{get_rank()}.pt"))
