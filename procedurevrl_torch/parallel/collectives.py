"""Collectives of the port (counterpart of
``procedurevrl_tpu/parallel/collectives.py:30-90``; reference
``lib/utils/distributed.py``).

JAX runs one program over a mesh of devices and its collectives are
shard_map psums; the port runs one process per card under
``torch.distributed`` (``utils/misc.py:launch_job``).  Without an
initialised process group every helper is the one-process identity, so a
single process runs exactly as it did before the port had ranks.

Gloo reduces and broadcasts tensors on the card, but gathers and
point-to-point sends only host tensors: under gloo a card tensor is
staged through the host for those (:func:`_staged`).

The random draws over the batch axis (drop-path masks, the order
transformer's draws, the recognition subset) follow JAX's global view:
:func:`draw_rows` draws at the global batch's shape from a stream every
rank seeds alike and keeps this rank's rows, so N ranks draw what one
process draws for the global batch.

BatchNorm statistics follow it too (:func:`batch_norm_stats`): JAX's
``VideoBatchNorm`` reduces over the global batch under its global-view
jit, or over contiguous groups of it, so the ranks all-reduce per-channel
sums, then sums of squares about the mean, and the backward all-reduces
the gradients of those sums.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    """Processes of the group, 1 without one (JAX: ``jax.device_count()``,
    one device per process here)."""
    return dist.get_world_size() if is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def in_group() -> bool:
    """Whether this process is one of a group of more than one: the port's
    reading of JAX's ``jax.device_count() > 1``, which switches the K1
    route (``ops/spatial_attention.py``) and MViT's pooling (K8,
    ``models/mvit.py``) to their multi-device branches."""
    return get_world_size() > 1


def is_master_proc() -> bool:
    """reference ``distributed.py:160-166``."""
    return get_rank() == 0


def _gloo() -> bool:
    return dist.get_backend() == "gloo"


def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend can send it: on the host under gloo."""
    return t.cpu() if _gloo() and t.is_cuda else t


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean of ``x`` over the ranks (reference ``distributed.py:53-69``);
    ``x`` itself at world 1."""
    if not in_group():
        return x
    y = x.detach().clone()
    dist.all_reduce(y)
    return y / get_world_size()


def all_reduce_mean_dict(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Every tensor of ``metrics`` (0-d, one device) replaced by its mean
    over the ranks, in one collective; other values pass as they are."""
    if not in_group():
        return metrics
    keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
    if not keys:
        return metrics
    mean = all_reduce_mean(torch.stack([metrics[k].float() for k in keys]))
    return {**metrics, **{k: mean[i] for i, k in enumerate(keys)}}


class _AllGather(torch.autograd.Function):
    """Rows of every rank, rank order; the backward is JAX's transpose of
    ``lax.all_gather``: the summed cotangent's slice of this rank
    (reference ``distributed.py:13-29``)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.rows = x.shape[0]
        parts = [torch.empty_like(_staged(x)) for _ in range(get_world_size())]
        dist.all_gather(parts, _staged(x.contiguous()))
        return torch.cat(parts).to(x.device)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        g = g.contiguous().clone()
        dist.all_reduce(g)
        r = get_rank() * ctx.rows
        return g[r:r + ctx.rows]


def all_gather_batch(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated on the batch axis in
    rank order, differentiable; ``x`` at world 1."""
    if not in_group():
        return x
    return _AllGather.apply(x)


def all_gather_rows(x: torch.Tensor, n_valid: int) -> torch.Tensor:
    """The first ``n_valid`` rows of every rank's ``x`` (equal shapes,
    padded batches), concatenated in rank order: the valid rows of the
    global batch, as one process holding it would see them."""
    if not in_group():
        return x[:n_valid]
    counts = all_gather_batch(torch.tensor([n_valid], device=x.device))
    rows = all_gather_batch(x).reshape((get_world_size(),) + x.shape)
    return torch.cat([rows[i, :int(c)] for i, c in enumerate(counts)])


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """``obj`` of rank ``src`` on every rank (reference
    ``distributed.py:167-178``)."""
    if not in_group():
        return obj
    box: List[Any] = [obj if get_rank() == src else None]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def gather_objects(obj: Any) -> List[Any]:
    """Every rank's picklable ``obj``, rank order."""
    if not in_group():
        return [obj]
    out: List[Any] = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out


def sync_global_barrier() -> None:
    """reference ``synchronize``."""
    if in_group():
        dist.barrier()


def send_tensor(t: torch.Tensor, dst: int, device: torch.device) -> None:
    """Send ``t`` to rank ``dst`` (on ``device`` under NCCL, on the host
    under gloo)."""
    dist.send(t.cpu() if _gloo() else t.to(device), dst)


def recv_tensor(spec, src: int, device: torch.device) -> torch.Tensor:
    """Receive from rank ``src`` the tensor :func:`send_tensor` sent;
    ``spec`` is its (shape, dtype, device type), and it lands on the host
    or on ``device`` as it lay on ``src``."""
    shape, dtype, where = spec
    buf = torch.empty(shape, dtype=dtype,
                      device="cpu" if _gloo() else device)
    dist.recv(buf, src)
    return buf.to(device if where != "cpu" else "cpu")


def mirror_rank() -> int:
    """The rank that holds the rows of the global batch's flip that this
    rank's rows pair with: row ``i`` of a global batch of ``B`` pairs with
    row ``B - 1 - i``."""
    return get_world_size() - 1 - get_rank()


def flip_batch(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the global batch flipped on its first axis
    (JAX ``engine/mixup.py:78``, :93 flip the global batch): the mirror
    rank's rows, flipped; ``x.flip(0)`` at world 1 and on the middle rank
    of an odd world."""
    mirror = mirror_rank()
    if not in_group() or mirror == get_rank():
        return x.flip(0)
    send = _staged(x.contiguous())
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, mirror),
           dist.P2POp(dist.irecv, recv, mirror)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(x.device).flip(0)


def draw_rows(draw: Callable[[int], torch.Tensor], rows: int,
              dim: int = 0) -> torch.Tensor:
    """``draw(n)`` at the global batch's ``n = rows x world`` on axis
    ``dim``, and this rank's ``rows`` of it (rank ``r`` holds rows ``r x
    rows`` onward, as the loader deals them): every rank seeds the
    stream alike, so N ranks draw what one process draws for the global
    batch (JAX draws once for the global batch, ``engine/steps.py:76-79``).
    ``draw(rows)`` at world 1."""
    world = get_world_size()
    if world == 1:
        return draw(rows)
    return draw(rows * world).narrow(dim, get_rank() * rows, rows)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; its backward is the sum of the ranks'
    cotangents (each rank's loss reaches every rank's sums)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = _staged(x.contiguous().clone())
        dist.all_reduce(y)
        return y.to(x.device)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        h = _staged(g.contiguous().clone())
        dist.all_reduce(h)
        return h.to(g.device)


def batch_norm_stats(x: torch.Tensor, splits: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, int,
                                Optional[torch.Tensor]]:
    """BatchNorm statistics of ``x [B, C, ...]`` (float32, B this rank's
    rows) over ``splits`` contiguous groups of the global batch (JAX
    ``VideoBatchNorm``, ``models/resnet_video.py:160-180``): the per-group
    mean and biased variance ``[splits, C]``, the count of values a group
    reduces, and the group of each local row ``[B]`` (None for one
    group).  Rank ``r`` holds
    rows ``r x B`` onward of the global batch, as the loader deals them; a
    group may span ranks and a rank may hold several groups.  One process
    computes each group's mean and variance directly (two passes, as JAX);
    a group of ranks makes the same two passes, all-reducing the sums, then
    the sums of squares about the mean, differentiably.  A global batch
    that does not split raises."""
    world, rank, b = get_world_size(), get_rank(), x.shape[0]
    rows = b * world
    if rows % splits:
        raise ValueError(f"a global batch of {rows} does not split into "
                         f"{splits} BN groups")
    per = rows // splits
    count = per * int(x[0, 0].numel())
    first = rank * b
    groups = (torch.arange(first, first + b, device=x.device) // per
              if splits > 1 else None)
    dims = [0] + list(range(2, x.dim()))
    if world == 1:
        xs = x.reshape((splits, per) + x.shape[1:])
        var, mean = torch.var_mean(xs, dim=[d + 1 for d in dims],
                                   unbiased=False)
        return mean, var, count, groups
    parts = []
    for g in range(splits):
        lo, hi = max(g * per, first) - first, min((g + 1) * per, first + b) - first
        parts.append(x[lo:hi] if hi > lo else x[:0])
    # the mean first, then the sum of squares about it: E[x^2] - mean^2
    # would lose the variance to fp32 rounding where |mean| >> std
    mean = _AllReduceSum.apply(torch.stack(
        [p.sum(dim=dims) for p in parts])) / count
    centre = (1, -1) + (1,) * (x.dim() - 2)
    var = _AllReduceSum.apply(torch.stack(
        [(p - m.reshape(centre)).square().sum(dim=dims)
         for p, m in zip(parts, mean)])) / count
    return mean, var, count, groups
