"""Checkpoints of the port (counterpart of
``procedurevrl_tpu/utils/checkpoint.py:32-249``; reference
``lib/utils/checkpoint.py``).

Directory contract, as in JAX and the reference: ``OUTPUT_DIR/checkpoints/
checkpoint_epoch_{:05d}.pyth``, numbered ``epoch + 1``, written at every
``TRAIN.CHECKPOINT_PERIOD``-th epoch and at the last; ``TRAIN.AUTO_RESUME``
takes the newest.  A file is the reference's own ``.pyth``, a
``torch.save`` of ``{"epoch", "model_state", "optimizer_state", "step",
"cfg"}`` whose ``model_state`` is the port's state dict (the reference
names), plus the key :data:`FORMAT_KEY`, which marks the files the port
wrote.  So a reference checkpoint loads into the port by its parameters,
and a port checkpoint loads into the JAX package through its reference path
(``load_reference_params`` -> ``convert_procedurevrl``).  The model state
holds the model's buffers too: the BatchNorm family's running statistics
are in the file, and a resume restores them bit for bit.  A checkpoint of
the JAX package (flax msgpack bytes) loads its parameters, and a
BatchNorm model's ``batch_stats``, by the JAX rule where a file is named
(``TRAIN.CHECKPOINT_FILE_PATH``, ``TEST.CHECKPOINT_FILE_PATH``;
``weights.read_jax_native``); ``TRAIN.AUTO_RESUME`` takes only the port's
own files.

Writes go to ``path + ".tmp"`` and are renamed into place, so a crash
mid-save leaves no half file for AUTO_RESUME to pick.

In a group of processes (``parallel/ddp.py``) every rank calls the saves,
and only rank 0 writes; under ZeRO-1 the optimizer's shards are first
gathered to rank 0 (:func:`ddp.optimizer_state_dict`), so the file has
one process's layout.  Every rank loads, each keeping its ZeRO share;
``TRAIN.AUTO_RESUME`` takes the file rank 0 finds.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Optional, Tuple

import torch

from procedurevrl_torch.parallel import ddp
from procedurevrl_torch.parallel.collectives import (
    broadcast_object, is_master_proc,
)
from procedurevrl_torch.utils import weights
from procedurevrl_torch.utils.logging import get_logger

logger = get_logger(__name__)

FORMAT_KEY = "procedurevrl_torch"  # -> the format version of the file
FORMAT_VERSION = 1


def get_checkpoint_dir(path_to_job: str) -> str:
    return os.path.join(path_to_job, "checkpoints")


def make_checkpoint_dir(path_to_job: str) -> str:
    d = get_checkpoint_dir(path_to_job)
    os.makedirs(d, exist_ok=True)
    return d


def get_path_to_checkpoint(path_to_job: str, epoch: int) -> str:
    name = "checkpoint_epoch_{:05d}.pyth".format(epoch)
    return os.path.join(get_checkpoint_dir(path_to_job), name)


def get_last_checkpoint(path_to_job: str) -> Optional[str]:
    """The newest complete checkpoint of ``path_to_job``, or None; a
    ``.pyth.tmp`` left by a crash mid-save is not one (JAX :48-59)."""
    d = get_checkpoint_dir(path_to_job)
    names = (sorted(f for f in os.listdir(d)
                    if "checkpoint" in f and f.endswith(".pyth"))
             if os.path.isdir(d) else [])
    return os.path.join(d, names[-1]) if names else None


def has_checkpoint(path_to_job: str) -> bool:
    return get_last_checkpoint(path_to_job) is not None


def is_checkpoint_epoch(cfg, cur_epoch: int) -> bool:
    """Every ``TRAIN.CHECKPOINT_PERIOD``-th epoch and the last (JAX
    :66-70)."""
    if cur_epoch + 1 == cfg.SOLVER.MAX_EPOCH:
        return True
    return (cur_epoch + 1) % cfg.TRAIN.CHECKPOINT_PERIOD == 0


def _map_tensors(obj: Any, fn: Callable[[torch.Tensor], torch.Tensor]):
    """``obj`` (nested dicts, lists and tuples) with every tensor replaced
    by ``fn`` of it, and the containers rebuilt."""
    if torch.is_tensor(obj):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


def _payload(model: torch.nn.Module, optimizer: torch.optim.Optimizer, cfg,
             epoch: int, step: int,
             copy: Callable[[torch.Tensor], torch.Tensor]) -> Optional[dict]:
    """What a checkpoint holds, on rank 0; None on the other ranks (a
    collective under ZeRO: every rank calls it)."""
    opt_state = ddp.optimizer_state_dict(optimizer)
    if not is_master_proc():
        return None
    return {"epoch": epoch,
            "model_state": _map_tensors(model.state_dict(), copy),
            "optimizer_state": _map_tensors(opt_state, copy),
            "step": int(step), "cfg": cfg.dump(),
            FORMAT_KEY: FORMAT_VERSION}


def _write(path: str, payload: dict) -> str:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
    os.replace(tmp, path)
    logger.info("Saved checkpoint to %s", path)
    return path


def save_checkpoint(path_to_job: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, cfg, epoch: int,
                    step: int) -> str:
    """Write the state after ``epoch`` (0-based) and optimizer step
    ``step`` to ``checkpoint_epoch_{epoch + 1}``, blocking until it is on
    disk (rank 0; the other ranks return the path)."""
    path = get_path_to_checkpoint(path_to_job, epoch + 1)
    payload = _payload(model, optimizer, cfg, epoch, step,
                       lambda t: t.detach().to("cpu", copy=True))
    if payload is None:
        return path
    make_checkpoint_dir(path_to_job)
    return _write(path, payload)


class AsyncCheckpointer:
    """Checkpoints written by a thread while training goes on
    (``TPU.ASYNC_CHECKPOINT``; JAX :101-150).

    ``save`` snapshots the model and optimizer state on their device (a
    clone on the current stream: the optimizer then updates the live
    tensors in place) and records an event after the clones; the writer
    thread, which has no current stream of its own, waits on that event,
    copies the snapshot to the host and writes it.  At most one save is in
    flight: a second ``save``, or ``wait()``, joins the first, and an error
    of the writer is raised by the next ``wait()``.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        """Block until the save in flight, if any, is on disk."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, path_to_job: str, model: torch.nn.Module,
             optimizer: torch.optim.Optimizer, cfg, epoch: int,
             step: int) -> str:
        self.wait()
        path = get_path_to_checkpoint(path_to_job, epoch + 1)
        snapshot = _payload(model, optimizer, cfg, epoch, step,
                            lambda t: t.detach().clone())
        if snapshot is None:  # not rank 0
            return path
        make_checkpoint_dir(path_to_job)
        device = next(model.parameters()).device
        done = None
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))

        def work():
            try:
                if done is not None:
                    done.synchronize()
                _write(path, _map_tensors(
                    snapshot, lambda t: t if t.device.type == "cpu"
                    else t.to("cpu")))
            except BaseException as e:  # raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, name="ckpt-writer")
        self._thread.start()
        return path


def _is_port_file(blob) -> bool:
    return isinstance(blob, dict) and FORMAT_KEY in blob


def _restore(blob: dict, path: str, model: torch.nn.Module,
             optimizer: torch.optim.Optimizer) -> Tuple[int, int]:
    try:
        if not _is_port_file(blob):
            raise KeyError(f"no {FORMAT_KEY!r} key: not a checkpoint the "
                           "port wrote")
        unused = weights.load_into(model, blob["model_state"])
        if unused:
            raise KeyError(f"{len(unused)} tensors the model lacks, e.g. "
                           f"{unused[:5]}")
        ddp.load_optimizer_state(optimizer, blob["optimizer_state"])
    except (KeyError, RuntimeError, ValueError) as e:
        # the common cause of a mismatch is an AUTO_RESUME from a stale
        # OUTPUT_DIR of another configuration
        raise ValueError(
            f"checkpoint {path!r} does not match the current model/optimizer "
            f"structure (wrong MODEL config or stale OUTPUT_DIR?): {e}"
        ) from e
    return blob["epoch"], blob.get("step", 0)


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer) -> Tuple[int, int]:
    """Restore a checkpoint of the port: model, optimizer, step and epoch,
    strictly.  Returns (epoch, step)."""
    return _restore(weights.read_file(path), path, model, optimizer)


def _matches(blob: dict, model: torch.nn.Module,
             optimizer: torch.optim.Optimizer) -> bool:
    """Whether ``blob``'s model and optimizer have the structure of
    ``model`` and ``optimizer``: the same tensor names and shapes, the
    same parameter groups."""
    own = model.state_dict()
    state = blob["model_state"]
    if set(state) != set(own) or any(
            tuple(state[k].shape) != tuple(v.shape) for k, v in own.items()):
        return False
    groups = blob["optimizer_state"]["param_groups"]
    return [len(g["params"]) for g in groups] == [
        len(g["params"]) for g in optimizer.param_groups]


def _check_type(checkpoint_type: str) -> None:
    if checkpoint_type == "caffe2":
        raise NotImplementedError(
            "CHECKPOINT_TYPE caffe2: Caffe2 checkpoints "
            "(utils/c2_model_loading.py) are not ported yet (ROADMAP.md "
            "Queue 1 item 10)")


def load_train_checkpoint(cfg, model: torch.nn.Module,
                          optimizer: torch.optim.Optimizer
                          ) -> Tuple[int, int]:
    """The start of a training run (JAX :202-229; reference :543-570):

    1. ``TRAIN.AUTO_RESUME`` with a checkpoint in ``OUTPUT_DIR``: its full
       restore, from the epoch after it;
    2. else ``TRAIN.CHECKPOINT_FILE_PATH``: a file of the port whose model
       and optimizer have the run's structure is restored in full; any
       other (the reference's, or the port's of another model, as a
       pretraining file is to a finetune) loads its parameters by
       :func:`weights.load_reference_params`; from the epoch after the
       file's, or 0 under ``TRAIN.CHECKPOINT_EPOCH_RESET``;
    3. else epoch 0.

    Returns (start epoch, optimizer step to continue from: the file's on a
    full restore, else 0)."""
    last = (broadcast_object(get_last_checkpoint(cfg.OUTPUT_DIR)
                             if is_master_proc() else None)
            if cfg.TRAIN.AUTO_RESUME else None)
    if last is not None:
        logger.info("Load from last checkpoint, %s.", last)
        epoch, step = load_checkpoint(last, model, optimizer)
        return epoch + 1, step
    path = cfg.TRAIN.CHECKPOINT_FILE_PATH
    if not path:
        return 0, 0
    logger.info("Load from given checkpoint file %s.", path)
    _check_type(cfg.TRAIN.CHECKPOINT_TYPE)
    blob = weights.read_checkpoint(path)
    if _is_port_file(blob) and _matches(blob, model, optimizer):
        epoch, step = _restore(blob, path, model, optimizer)
    else:
        epoch, step = weights.load_reference_params(
            model, path, cfg.TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN, blob), 0
    if cfg.TRAIN.CHECKPOINT_EPOCH_RESET or epoch is None:
        return 0, step
    return epoch + 1, step


def load_test_checkpoint(cfg, model: torch.nn.Module) -> Optional[str]:
    """The weights of a test (JAX :232-249; reference :505-540), from the
    first of ``TEST.CHECKPOINT_FILE_PATH``, the last checkpoint in
    ``OUTPUT_DIR`` and ``TRAIN.CHECKPOINT_FILE_PATH``: a file of the port
    for this model strictly, any other by its parameters.  With none of
    them the model keeps its random init.  Returns the path loaded."""
    if cfg.TEST.CHECKPOINT_FILE_PATH:
        path = cfg.TEST.CHECKPOINT_FILE_PATH
        _check_type(cfg.TEST.CHECKPOINT_TYPE)
    elif has_checkpoint(cfg.OUTPUT_DIR):
        path = get_last_checkpoint(cfg.OUTPUT_DIR)
    elif cfg.TRAIN.CHECKPOINT_FILE_PATH:
        path = cfg.TRAIN.CHECKPOINT_FILE_PATH
        _check_type(cfg.TRAIN.CHECKPOINT_TYPE)
    else:
        logger.info("Unknown way of loading checkpoint. Using with random "
                    "initialization, only for debugging.")
        return None
    blob = weights.read_checkpoint(path)
    if _is_port_file(blob) and set(blob["model_state"]) == set(
            model.state_dict()):
        weights.load_into(model, blob["model_state"])
    else:
        weights.load_reference_params(model, path, blob=blob)
    logger.info("Loaded %s for the test", path)
    return path
