"""Which path carries TimeSformer's attention: the JAX package's switches of
``procedurevrl_tpu/ops/attention.py`` and its knobs of
``procedurevrl_tpu/ops/pallas_attention.py``, read once when a model is
built.

Whether a kernel runs at all (``ops/attention.py`` applies the shape rules):

- ``TPU.USE_PALLAS_ATTENTION`` (config, default True): False takes the
  plain row-max paths for both passes, as JAX's XLA paths.
- ``PALLAS_MIN_LEN`` (default 128, JAX ``ops/attention.py:25-29``): the
  spatial pass takes K1 only for ``PALLAS_MIN_LEN <= N <= 1024``.
- ``TEMPORAL_PALLAS`` (default 1, JAX ``ops/attention.py:247``): 0 takes the
  plain path for the temporal pass.

Which kernels, once one runs:

- ``SPATIAL_SAVE_PROBS`` (default 1, :868): under grad the forward saves the
  probabilities (K1sp) and the backward reads them (K1b); 0 takes the
  recompute pair, the forward K1f (or K1p) and the backward K1br.
- ``SPATIAL_DELTA`` (default 0, :900): with saved probabilities, the
  backward K1bd takes delta_i = g_i . o_i from the saved outputs in place of
  the jacobian row sums.
- ``SPATIAL_PIPE`` (default 0, :685): the forward without saved
  probabilities is the pipelined K1p; with ``SPATIAL_SAVE_PROBS=1`` K1sp
  still takes the forward under grad, and a warning says so once.
- ``SPATIAL_PIPE_NBUF`` (default 3, :693): the depth K1p's ring asks for
  (the kernel clamps it to what fits in shared memory).
- ``TEMPORAL_BATCHED`` (default 0, :1476): the temporal pair K2v3f / K2v3b
  (saved probabilities) in place of K2f / K2b, evaluation included.
- ``SPATIAL_FUSED_QKV`` (default 1, JAX ``ops/attention.py:192``): 0 takes
  the split-projection pair K3f / K3b (``ops/flash_attention.py``) for the
  spatial pass, on the q, k, v thirds of the projection; K1's knobs
  ``SPATIAL_SAVE_PROBS``, ``SPATIAL_DELTA`` and ``SPATIAL_PIPE`` then select
  nothing, as in JAX, where they only choose among the fused-qkv kernels.
  JAX's train tool sets it to 0 for tensor-parallel meshes
  (``utils/parser.py:82-89``).

The softmax shifts ``SPATIAL_SHIFT`` and ``TEMPORAL_SHIFT`` (:104, :1362;
``max|clamp|none``, anything else is malformed and raises ``ValueError`` at
build): ``clamp`` (default) exp(min(s, 80)), ``max`` exp(s - rowmax s) (the
reference's softmax), ``none`` exp(s) (inf past s ~ 88.7, as JAX).  JAX
reads them only inside its Pallas kernels, and its XLA paths take the
row-max softmax whatever they say; so here every kernel family takes each
shift as a compile-time switch (``csrc/common.cuh`` ``enum Shift``): K1, K3
and K4 (and K1's function on the pair) under ``SPATIAL_SHIFT``, K2 (and its
function on the pair) under ``TEMPORAL_SHIFT``, and a pass that takes the
plain row-max path runs as in JAX.

``SPATIAL_MXU_DSUM`` (:876), ``PALLAS_SP_GB`` (:851) and ``PALLAS_HPB``
(:161) only choose the TPU's tiling or summation order of the same
function: they select no kernel, and the port does not read them.

JAX reads the knobs each time it traces; the port reads them once, in
:meth:`AttentionRoute.from_env`, when the model is built, and carries the
route down to the attention entries.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from procedurevrl_torch.utils.env import env_flag, env_int

# each softmax shift and its int at the kernels' entry points
# (csrc/common.cuh enum Shift)
SHIFT_CODES = {"clamp": 0, "max": 1, "none": 2}
CLAMP_HI = 80.0  # the clamp shift: exp(min(s, 80)), exact for s < 80


def read_shift(name: str) -> str:
    """A softmax-shift knob (``SPATIAL_SHIFT``, ``TEMPORAL_SHIFT``,
    ``MVIT_SHIFT``): its value, ``clamp`` when unset; a value outside
    ``max|clamp|none`` raises ``ValueError``, as JAX raises on it."""
    mode = os.environ.get(name, "clamp")
    if mode not in SHIFT_CODES:
        raise ValueError(f"{name}={mode!r}: expected max|clamp|none")
    return mode


def shift_code(shift: str) -> int:
    """The kernels' int of a softmax shift; anything but
    ``max|clamp|none`` raises ``ValueError``."""
    if shift not in SHIFT_CODES:
        raise ValueError(f"softmax shift {shift!r}: expected max|clamp|none")
    return SHIFT_CODES[shift]


def shifted_exp(s: torch.Tensor, shift: str) -> torch.Tensor:
    """The exponentials of the scaled fp32 logits ``s`` (keys on the last
    axis, every key valid) under a softmax shift, as JAX ``_shift`` /
    ``_compact_exp`` / the MViT ``_probs`` form them: ``clamp``
    exp(min(s, 80)), ``max`` exp(s - m) with m the row max (detached: a
    constant shift, so autograd's gradient is the softmax's), ``none``
    exp(s)."""
    shift_code(shift)
    if shift == "clamp":
        return torch.exp(torch.clamp(s, max=CLAMP_HI))
    if shift == "max":
        return torch.exp(s - s.amax(dim=-1, keepdim=True).detach())
    return torch.exp(s)


@dataclass(frozen=True)
class AttentionRoute:
    save_probs: bool = True        # SPATIAL_SAVE_PROBS
    delta: bool = False            # SPATIAL_DELTA
    pipe: bool = False             # SPATIAL_PIPE
    pipe_nbuf: int = 3             # SPATIAL_PIPE_NBUF
    temporal_batched: bool = False  # TEMPORAL_BATCHED
    use_pallas: bool = True        # TPU.USE_PALLAS_ATTENTION
    temporal_pallas: bool = True   # TEMPORAL_PALLAS
    min_len: int = 128             # PALLAS_MIN_LEN
    fused_qkv: bool = True         # SPATIAL_FUSED_QKV
    spatial_shift: str = "clamp"   # SPATIAL_SHIFT
    temporal_shift: str = "clamp"  # TEMPORAL_SHIFT

    @classmethod
    def from_env(cls, use_pallas: bool = True) -> "AttentionRoute":
        """The route the environment selects (``use_pallas`` from the
        config); a malformed knob raises ``ValueError``."""
        return cls(save_probs=env_flag("SPATIAL_SAVE_PROBS", True),
                   delta=env_flag("SPATIAL_DELTA", False),
                   pipe=env_flag("SPATIAL_PIPE", False),
                   pipe_nbuf=env_int("SPATIAL_PIPE_NBUF", 3),
                   temporal_batched=env_flag("TEMPORAL_BATCHED", False),
                   use_pallas=bool(use_pallas),
                   temporal_pallas=env_flag("TEMPORAL_PALLAS", True),
                   min_len=env_int("PALLAS_MIN_LEN", 128, minimum=0),
                   fused_qkv=env_flag("SPATIAL_FUSED_QKV", True),
                   spatial_shift=read_shift("SPATIAL_SHIFT"),
                   temporal_shift=read_shift("TEMPORAL_SHIFT"))


DEFAULT_ROUTE = AttentionRoute()
