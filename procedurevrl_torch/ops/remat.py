"""Selective activation checkpointing by name: the port of the JAX
package's ``checkpoint_name`` + ``jax.checkpoint_policies.
save_only_these_names`` remat policies (JAX ``models/timesformer.py:
267-291``, ``models/mvit.py:953-963``).

A block checkpointed with :func:`checkpoint_kwargs` runs under
``torch.utils.checkpoint`` (non-reentrant) with a pair of contexts
(``context_fn``): in the forward the values that carry one of the
policy's names are recorded, in the order they are computed; the
recomputation that the backward runs takes them back in the same order
instead of computing them again, and recomputes everything else.  The
policy is decided by a call's or a region's name, never by a tensor's
shape.  A value is named in one of two ways:

- a **kept call** (:func:`kept`): the outputs of one call carry the
  name.  The attention forwards are called so from their
  ``autograd.Function.forward`` (a kernel launch for a CUDA tensor, the
  plain version for a CPU one), so the recomputation skips their launches
  (``flash_attn_out``, ``flash_attn_lse``, ``flash_attn_probs``: JAX
  ``ops/attention.py:218-219``, :274, :326,
  ``ops/pallas_attention.py:1214``, :1700, ``models/mvit.py:696``,
  ``ops/pallas_mvit_attention.py:626``, :635, :1264, :1333); so is the
  stored GELU derivative (``gelu_grad``, ``ops/common.py``).
- a **named region** (:func:`named`): the values that the operations
  inside it compute carry the name (views are not values: they are
  recomputed for free).  A dispatch mode around the region's few
  operations records them, and in the recomputation returns them to the
  same operations, so autograd still differentiates those operations.
  The qkv projections of K1, K3 and K4 are named ``qkv_out`` (JAX
  ``ops/attention.py:73``, :111), the output projection of the plain
  temporal pass ``temporal_out`` (:291).

Eager PyTorch does not prune the recomputation as XLA does: an operation
that is not kept runs again even where its only consumer is a kept value.
So a name sits on the last operation of what JAX names (the plain temporal
pass ends in its output projection), and what the recomputation runs
again is what XLA's pruned recomputation runs again.  Only the named
calls and regions look at the policy, so the other operations of a block
pay nothing for it.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
from typing import Callable, Iterator, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map


class _Kept:
    """The values one checkpointed call keeps: the names of its policy and
    the recorded values, oldest first."""

    def __init__(self, names: Sequence[str]):
        self.names = frozenset(names)
        self.values: collections.deque = collections.deque()


class _Phase:
    """The context of the forward (``replay`` False: record) or of the
    recomputation (``replay`` True: take the records back)."""

    def __init__(self, kept: _Kept, replay: bool):
        self.kept = kept
        self.replay = replay
        self._token = None

    def __enter__(self):
        self._token = _PHASE.set(self)
        return self

    def __exit__(self, *exc):
        _PHASE.reset(self._token)


_PHASE: contextvars.ContextVar[Optional[_Phase]] = contextvars.ContextVar(
    "procedurevrl_remat_phase", default=None)


def _policy_keeps(name: str) -> Optional[_Phase]:
    """The current phase where its policy keeps ``name``, else None."""
    phase = _PHASE.get()
    return phase if phase is not None and name in phase.kept.names else None


def _detached(out):
    return tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor)
                    else t, out)


def kept(name: str, fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)``, its outputs named ``name``: in a
    checkpointed block whose policy keeps ``name`` the forward records them
    and the recomputation returns them without calling ``fn``."""
    phase = _policy_keeps(name)
    if phase is None:
        return fn(*args, **kwargs)
    if phase.replay:
        return phase.kept.values.popleft()
    out = fn(*args, **kwargs)
    phase.kept.values.append(_detached(out))
    return out


class _Record(TorchDispatchMode):
    def __init__(self, values: collections.deque):
        super().__init__()
        self.values = values

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.values.append(_detached(out))
        return out


class _Replay(TorchDispatchMode):
    def __init__(self, values: collections.deque):
        super().__init__()
        self.values = values

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.is_view:
            return func(*args, **(kwargs or {}))
        return self.values.popleft()


@contextlib.contextmanager
def named(name: str) -> Iterator[None]:
    """Name the values that the operations run inside compute ``name``."""
    phase = _policy_keeps(name)
    if phase is None:
        yield
        return
    mode = _Replay if phase.replay else _Record
    with mode(phase.kept.values):
        yield


def checkpoint_kwargs(names: Sequence[str]) -> dict:
    """The keyword arguments of ``torch.utils.checkpoint.checkpoint`` that
    keep the values named ``names`` across the recomputation; with no name
    the whole block is recomputed (JAX's ``REMAT_SAVE_ATTN False``)."""
    kwargs: dict = {"use_reentrant": False}
    if names:
        def contexts():
            kept_values = _Kept(names)
            return _Phase(kept_values, False), _Phase(kept_values, True)

        kwargs["context_fn"] = contexts
    return kwargs
