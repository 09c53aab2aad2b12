"""Which kernels carry TimeSformer's attention: the JAX package's knobs of
``procedurevrl_tpu/ops/pallas_attention.py``, read once when a model is
built.

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

``SPATIAL_MXU_DSUM`` (:876) and ``PALLAS_SP_GB`` (:851) only choose the
TPU's tiling or summation order of the same function: they select no
kernel, and the port does not read them.

JAX reads the knobs each time it traces; the port reads them once, in
:meth:`AttentionRoute.from_env`, when the model is built, and carries the
route down to the attention entries.
"""

from __future__ import annotations

from dataclasses import dataclass

from procedurevrl_torch.utils.env import env_flag, env_int


@dataclass(frozen=True)
class AttentionRoute:
    save_probs: bool = True        # SPATIAL_SAVE_PROBS
    delta: bool = False            # SPATIAL_DELTA
    pipe: bool = False             # SPATIAL_PIPE
    pipe_nbuf: int = 3             # SPATIAL_PIPE_NBUF
    temporal_batched: bool = False  # TEMPORAL_BATCHED

    @classmethod
    def from_env(cls) -> "AttentionRoute":
        """The route the environment selects; a malformed knob raises."""
        return cls(save_probs=env_flag("SPATIAL_SAVE_PROBS", True),
                   delta=env_flag("SPATIAL_DELTA", False),
                   pipe=env_flag("SPATIAL_PIPE", False),
                   pipe_nbuf=env_int("SPATIAL_PIPE_NBUF", 3),
                   temporal_batched=env_flag("TEMPORAL_BATCHED", False))


DEFAULT_ROUTE = AttentionRoute()
