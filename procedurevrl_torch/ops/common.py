"""Elementwise and normalisation primitives shared by the port's models
(counterpart of ``procedurevrl_tpu/ops/common.py``).

- ``layer_norm_fp32``: LayerNorm computed in float32 whatever the compute
  dtype, cast back to the input dtype.  The JAX package's MXU ones-dot
  reductions are a TPU device; here it is the plain LayerNorm.
- ``gelu_exact``: the erf form of GELU (torch ``nn.GELU()`` default).
- ``interpolate_nearest_1d/2d``: torch ``F.interpolate(mode='nearest')``
  index rule ``src = floor(dst * in / out)``, used to resize the position
  and time embeddings.
- ``trunc_normal_init``: timm ``trunc_normal_`` (normal(0, std) truncated
  at +-2 std) drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def layer_norm_fp32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> torch.Tensor:
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def interpolate_nearest_1d(x: torch.Tensor, out_len: int,
                           dim: int) -> torch.Tensor:
    in_len = x.shape[dim]
    if in_len == out_len:
        return x
    # float32 index arithmetic, as the JAX package computes it
    idx = torch.floor(torch.arange(out_len, dtype=torch.float32)
                      * (in_len / out_len)).long().to(x.device)
    return x.index_select(dim, idx)


def interpolate_nearest_2d(x: torch.Tensor, out_hw: Sequence[int],
                           dims: Sequence[int] = (-2, -1)) -> torch.Tensor:
    x = interpolate_nearest_1d(x, out_hw[0], dims[0])
    return interpolate_nearest_1d(x, out_hw[1], dims[1])


def trunc_normal_init(tensor: torch.Tensor, std: float = 0.02,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(tensor, mean=0.0, std=std,
                                           a=-2.0 * std, b=2.0 * std,
                                           generator=generator)
