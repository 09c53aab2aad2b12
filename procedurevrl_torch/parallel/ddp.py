"""Data parallel over processes: the batch rule, DDP and ZeRO-1 (the
port's counterpart of ``procedurevrl_tpu/parallel/mesh.py``; reference
``lib/utils/distributed.py``, ``lib/models/build.py:49-53``).

JAX runs one process per host over a mesh of every device, the batch
sharded over the ``data`` axis.  The port runs one process per card
(``utils/misc.py:launch_job``): ``NUM_GPUS`` ranks on each of
``NUM_SHARDS`` hosts, rank ``SHARD_ID x NUM_GPUS + d`` on card ``d``.

- The batch rule (JAX ``datasets/loader.py:260-271``: "cfg batch sizes
  are per host"): the global batch is ``TRAIN.BATCH_SIZE x NUM_SHARDS``
  (``TEST.BATCH_SIZE`` for the test), split over the host's cards as JAX's
  ``batch_sharding`` splits it over its devices, so each rank takes
  ``BATCH_SIZE / NUM_GPUS`` contiguous rows: rank ``h x NUM_GPUS + d``
  holds the rows JAX gives device ``d`` of host ``h``.  The accumulation
  count is ``GLOBAL_BATCH_SIZE // (BATCH_SIZE x NUM_SHARDS)`` (JAX
  ``tools/train_net.py:86-87``).  One process without a group is one host
  whatever ``NUM_GPUS`` says, as one JAX process on its devices.
- The model is wrapped in ``DistributedDataParallel``: its gradients are
  averaged over the ranks, as JAX's psum of the global-mean loss.
- ``TPU.SHARD_OPT_STATE`` (JAX's ZeRO-1, ``mesh.py:118-175``) wraps the same
  optimizer and parameter groups in ``ZeroRedundancyOptimizer``: each rank
  keeps and updates the moments of its share of the parameters and
  broadcasts them; the parameters are those of the plain optimizer.
- ``TPU.MESH_MODEL > 1`` (JAX's tensor-parallel ``tp_*_shardings``)
  raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.optim import ZeroRedundancyOptimizer
from torch.nn.parallel import DistributedDataParallel

from procedurevrl_torch.parallel.collectives import (
    gather_objects, get_rank, get_world_size, in_group, recv_tensor,
    send_tensor,
)
from procedurevrl_torch.solver.optimizer import optimizer_spec


def check_mesh(cfg) -> None:
    """Refuse a mesh the port does not run: ``TPU.MESH_MODEL > 1``."""
    if cfg.TPU.MESH_MODEL > 1:
        raise NotImplementedError(
            f"TPU.MESH_MODEL {cfg.TPU.MESH_MODEL}: tensor parallelism (JAX "
            "parallel/mesh.py tp_*_shardings) is not ported yet (ROADMAP.md "
            "Queue 1 item 7)")


def num_hosts(cfg) -> int:
    """Hosts of the run: ``NUM_SHARDS`` in a group of ``NUM_GPUS x
    NUM_SHARDS`` ranks, 1 for one process; any other group raises."""
    world = get_world_size()
    if world == 1:
        return 1
    per_host = max(cfg.NUM_GPUS, 1)
    if world != per_host * cfg.NUM_SHARDS:
        raise ValueError(f"a group of {world} processes is not NUM_GPUS "
                         f"{per_host} x NUM_SHARDS {cfg.NUM_SHARDS}")
    return cfg.NUM_SHARDS


def batch_plan(per_host_batch: int, cfg) -> Tuple[int, int]:
    """(global batch, rows of each rank) of a per-host batch size."""
    world = get_world_size()
    global_batch = per_host_batch * num_hosts(cfg)
    if global_batch % world:
        raise ValueError(f"a global batch of {global_batch} does not split "
                         f"over {world} processes")
    return global_batch, global_batch // world


def local_batch_slice(global_batch: int, num_procs: int, rank: int) -> slice:
    """Rank ``rank``'s rows of a global batch (JAX ``mesh.py:
    local_batch_slice``, there per host)."""
    if global_batch % num_procs:
        raise ValueError(f"a global batch of {global_batch} does not split "
                         f"over {num_procs} processes")
    per = global_batch // num_procs
    return slice(rank * per, (rank + 1) * per)


def accumulation(cfg) -> int:
    """Micro-batches an optimizer step takes."""
    per_step = cfg.TRAIN.BATCH_SIZE * num_hosts(cfg)
    return max(cfg.GLOBAL_BATCH_SIZE // max(per_step, 1), 1)


def wrap_model(model: torch.nn.Module) -> torch.nn.Module:
    """``model`` in ``DistributedDataParallel`` in a group, else itself.
    Unused parameters are found each step (the forecasting head's pad
    embedding takes no gradient)."""
    if not in_group():
        return model
    device = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        find_unused_parameters=True)


def build_optimizer(model: torch.nn.Module, cfg) -> torch.optim.Optimizer:
    """``solver/optimizer.py``'s optimizer, or under ``TPU.SHARD_OPT_STATE``
    in a group the same in ``ZeroRedundancyOptimizer``."""
    cls, groups, kwargs = optimizer_spec(model, cfg)
    if cfg.TPU.SHARD_OPT_STATE and in_group():
        return ZeroRedundancyOptimizer(groups, optimizer_class=cls, **kwargs)
    return cls(groups, **kwargs)


def optimizer_state_dict(optimizer: torch.optim.Optimizer) -> Optional[dict]:
    """The optimizer's state in one process's layout.  Under ZeRO every
    rank must call it: each rank sends the state of its share to rank 0
    tensor by tensor (ZeRO's own ``consolidate_state_dict`` pickles the
    state through a byte tensor, seconds for a small model); rank 0 gets
    the state, the others None."""
    if not isinstance(optimizer, ZeroRedundancyOptimizer):
        return optimizer.state_dict()
    rank, index = get_rank(), optimizer._param_to_index
    held = {index[p]: s for p, s in optimizer.optim.state.items()}
    layouts = gather_objects({i: {k: (v.shape, v.dtype, v.device.type)
                                  if torch.is_tensor(v) else v
                                  for k, v in s.items()}
                              for i, s in held.items()})
    device = optimizer._default_device
    state: dict = {}
    for owner, layout in enumerate(layouts):
        for i in sorted(layout):
            if rank == 0:
                state[i] = {}
            for k in sorted(layout[i]):
                spec = layout[i][k]
                if not isinstance(spec, tuple):
                    if rank == 0:
                        state[i][k] = spec
                    continue
                if owner == 0:
                    if rank == 0:
                        state[i][k] = held[i][k].clone()
                elif rank == owner:
                    send_tensor(held[i][k], 0, device)
                elif rank == 0:
                    state[i][k] = recv_tensor(spec, owner, device)
    if rank != 0:
        return None
    groups = []
    for group in optimizer.param_groups:
        packed = {k: v for k, v in group.items() if k != "params"}
        for k, v in optimizer.optim.defaults.items():
            packed.setdefault(k, v)
        packed["params"] = [index[p] for p in group["params"]]
        groups.append(packed)
    return {"state": dict(sorted(state.items())), "param_groups": groups}


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         state: dict) -> None:
    """Load a one-process state; under ZeRO each rank keeps its share."""
    if isinstance(optimizer, ZeroRedundancyOptimizer):
        state = {**state, "state": dict(state["state"])}  # ZeRO edits it
    optimizer.load_state_dict(state)


def optimizer_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Bytes of the optimizer state this rank holds."""
    local = (optimizer.optim if isinstance(optimizer, ZeroRedundancyOptimizer)
             else optimizer)
    return sum(v.numel() * v.element_size() for s in local.state.values()
               for v in s.values() if torch.is_tensor(v))
